"""Scripting access to the selected project's files.

The counterpart of `xframe_tpu.database`: after

    from xframe_tpu_torch import database
    database.select_project("fxs", "extract", "tutorial")
    ccd = database.project.load_ccd()

`project` is the selected project's ProjectStore (its `store` module),
built from the merged settings, or None for a project that has no store.
Workers build their own store; this one serves interactive use.
"""
from __future__ import annotations

import importlib

project = None
settings = None


def select_project(project_name, worker, settings_name=None,
                   overrides=None):
    """Load the worker's settings and rebuild `project` and `settings`.
    → the store (or None)."""
    global project, settings
    from xframe_tpu_torch.settings import load_settings
    settings = load_settings(worker, settings_name, overrides,
                             project=project_name)
    name = f"xframe_tpu_torch.projects.{project_name}.store"
    try:
        mod = importlib.import_module(name)
    except ModuleNotFoundError as exc:
        if exc.name not in (name, f"xframe_tpu_torch.projects.{project_name}"):
            raise
        project = None
    else:
        project = mod.ProjectStore(settings.get("structure_name", "default"),
                                   settings)
    return project
