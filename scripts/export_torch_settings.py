#!/usr/bin/env python3
"""Write the worker settings of the JAX package as the JSON data of
xframe_tpu_torch/settings/ (the port reads settings without PyYAML).

    python3 scripts/export_torch_settings.py

For each worker of the fxs project (simulate_ccd, extract, reconstruct,
average, correlate) and of the tutorial project (get_started) and each file
(default_0.1, tutorial, and tutorial_2d where the worker has it), and for
the SPB experiment's default_0.01 and tutorial (into
xframe_tpu_torch/experiments/SPB/settings/), the YAML tree is read, its `command:` entries are evaluated as
xframe_tpu.settings.loader.execute_commands evaluates them, and the
documentation keys `_description` and `_possible_values` are dropped. The
default trees keep their `_value` leaves and their `_only_if`, `_copy` and
`_if` directives, which xframe_tpu_torch.settings.load_settings resolves
against the merged settings as the JAX loader does.
tests/test_torch_settings.py holds the result equal to the JAX loader's.
"""
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from xframe_tpu.settings.loader import execute_commands, load_yaml  # noqa: E402

PROJECTS = {"fxs": ("simulate_ccd", "extract", "reconstruct", "average",
                    "correlate"),
            "tutorial": ("get_started",)}
FILES = ("default_0.1", "tutorial", "tutorial_2d")
EXPERIMENTS = {"SPB": ("default_0.01", "tutorial")}
DOC_KEYS = ("_description", "_possible_values")


def plain(tree):
    """Evaluated settings → JSON values, documentation keys dropped."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items() if k not in DOC_KEYS}
    if isinstance(tree, (list, tuple)):
        return [plain(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return plain(tree.tolist())
    if isinstance(tree, np.generic):
        return tree.item()
    return tree


def export(yaml_path, path):
    tree = plain(execute_commands(load_yaml(yaml_path)))
    with open(path, "w") as f:
        json.dump(tree, f, indent=1)
        f.write("\n")
    print(path)


def main():
    for exp, names in EXPERIMENTS.items():
        src = os.path.join(REPO, "xframe_tpu", "experiments", exp,
                           "settings")
        dst = os.path.join(REPO, "xframe_tpu_torch", "experiments", exp,
                           "settings")
        os.makedirs(dst, exist_ok=True)
        for name in names:
            export(os.path.join(src, name + ".yaml"),
                   os.path.join(dst, name + ".json"))
    for project, workers in PROJECTS.items():
        src = os.path.join(REPO, "xframe_tpu", "projects", project,
                           "settings")
        dst = os.path.join(REPO, "xframe_tpu_torch", "settings", project)
        for worker in workers:
            os.makedirs(os.path.join(dst, worker), exist_ok=True)
            for name in FILES:
                yaml_path = os.path.join(src, worker, name + ".yaml")
                if not os.path.exists(yaml_path):
                    continue
                export(yaml_path, os.path.join(dst, worker, name + ".json"))


if __name__ == "__main__":
    main()
