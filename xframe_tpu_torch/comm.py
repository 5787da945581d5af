"""The experiment a project reads its data from: the counterpart of
`xframe_tpu.comm`.

    from xframe_tpu_torch import comm
    comm.select_experiment("SPB", "tutorial", run_folder="/data/r0001")
    for chunk in comm.get_data(selection):
        ...

`select_experiment` binds an ExperimentWorker instance, or one built from
an experiment's name ('SPB': xframe_tpu_torch.experiments.SPB.experiment)
and its settings (xframe_tpu_torch.settings.load_experiment_settings; the
CLI's `-e` and `-eset`). Keyword arguments win over the settings. While an
experiment is bound through its settings, `experiment_settings` holds
them, and every run folder a ProjectStore writes gets their snapshot.
"""
from __future__ import annotations

import importlib

_experiment = None
experiment_settings = None
EXPERIMENT_MODULE = "experiment"
EXPERIMENT_CLASS = "ExperimentWorker"


def select_experiment(name_or_worker, settings_name=None, **kwargs):
    """Bind an experiment (see the module docstring). → the worker."""
    global _experiment, experiment_settings
    if isinstance(name_or_worker, str):
        from xframe_tpu_torch.settings import load_experiment_settings
        mod = importlib.import_module(
            f"xframe_tpu_torch.experiments.{name_or_worker}."
            f"{EXPERIMENT_MODULE}")
        opt = load_experiment_settings(name_or_worker, settings_name)
        cls = getattr(mod, EXPERIMENT_CLASS)
        _experiment = cls.from_settings(opt, **kwargs) \
            if hasattr(cls, "from_settings") else cls(**kwargs)
        experiment_settings = opt
    else:
        _experiment, experiment_settings = name_or_worker, None
    return _experiment


def clear():
    """Unbind the experiment."""
    global _experiment, experiment_settings
    _experiment = experiment_settings = None


def experiment():
    if _experiment is None:
        raise RuntimeError("no experiment selected "
                           "(comm.select_experiment or the CLI's -e)")
    return _experiment


def get_data(selection=None):
    return experiment().get_data(selection)


def get_geometry():
    return experiment().get_geometry()


def get_pixel_grid_reciprocal():
    return experiment().get_pixel_grid_reciprocal()
