"""Worker settings as data.

The fxs workers' settings trees of the JAX package, stored as JSON under
`settings/fxs/<worker>/` (written by scripts/export_torch_settings.py):
`default_0.1.json`, the versioned defaults with their `_value` leaves and
`_only_if`/`_copy`/`_if` directives, and named settings such as
`tutorial.json`, with every `command:` entry already evaluated.
`load_settings` merges them as `xframe_tpu.settings.loader` does (a copy
of its `apply_defaults`: explicit settings win, directives resolve against
the merged tree) and returns plain nested dicts.
"""
from __future__ import annotations

import copy
import json
import os

import numpy as np

DATA_DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULTS_NAME = "default_0.1"
SETTINGS_VERSION_KEY = "settings_version"

_SAFE_BUILTINS = {
    "abs": abs, "min": min, "max": max, "range": range, "len": len,
    "int": int, "float": float, "bool": bool, "list": list, "tuple": tuple,
    "dict": dict, "sum": sum, "round": round, "True": True, "False": False,
    "None": None,
}


def _eval_expr(expr, extra=None):
    ns = {"np": np, "numpy": np, "__builtins__": _SAFE_BUILTINS}
    if extra:
        ns.update(extra)
    return eval(expr, ns)  # noqa: S307 — restricted builtins


def deep_update(base: dict, override: dict) -> dict:
    """Merge `override` into `base` recursively (override wins)."""
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


def _resolve_path(current_path, relative_path):
    rel = str(relative_path)
    if rel.startswith("/"):
        return rel[1:].split("/")
    parts = rel.split("../")
    up = len(parts) - 1
    base = current_path[: len(current_path) - up] if up else list(current_path)
    return base + parts[-1].split("/")


def _get_value(tree, current_path, relative_path):
    node = tree
    for key in _resolve_path(current_path, relative_path):
        node = node[key]
    return node


def _apply_directives(entry, out_root, defaults_root, path):
    """→ (entry, skip): `_only_if`, then `_copy`, then `_if`."""
    if not isinstance(entry, dict):
        return entry, False
    if "_only_if" in entry:
        spec = entry["_only_if"]
        try:
            x = _get_value(out_root, path[:-1], spec["x"])
        except (KeyError, TypeError):
            return entry, True
        if not bool(_eval_expr(str(spec["condition"]), {"x": x})):
            return entry, True
        entry = {k: v for k, v in entry.items() if k != "_only_if"}
    if "_copy" in entry:
        return copy.deepcopy(_get_value(defaults_root, path[:-1],
                                        entry["_copy"])), False
    if "_if" in entry:
        spec = entry["_if"]
        try:
            x = _get_value(out_root, path[:-1], spec["x"])
        except (KeyError, TypeError):
            x = None
        conditions = spec["condition"]
        if not isinstance(conditions, list):
            conditions = [conditions]
        index = len(conditions)
        for i, cond in enumerate(conditions):
            if bool(_eval_expr(str(cond), {"x": x})):
                index = i
                break
        return {"_value": spec["values"][index]}, False
    return entry, False


def _is_leaf(entry):
    return (not isinstance(entry, dict)) or ("_value" in entry)


def _leaf_value(entry, out_root, path):
    value = entry["_value"]
    if isinstance(value, dict) and "_copy" in value:
        return copy.deepcopy(_get_value(out_root, path[:-1], value["_copy"]))
    return copy.deepcopy(value)


def apply_defaults(defaults, settings, out=None, path=None, out_root=None,
                   defaults_root=None):
    """Merge the defaults tree into `settings` (settings win); directive
    paths resolve against the merged output, in the defaults' key order."""
    if out is None:
        out = copy.deepcopy(settings)
        out_root, defaults_root, path = out, defaults, []
    for key, entry in list(defaults.items()):
        if key.startswith("_") or key == SETTINGS_VERSION_KEY:
            continue
        p = path + [key]
        entry, skip = _apply_directives(entry, out_root, defaults_root, p)
        if skip:
            continue
        if key in settings:
            sub = settings[key]
            if isinstance(sub, dict) and isinstance(entry, dict) \
                    and not _is_leaf(entry):
                apply_defaults(entry, sub, out[key], p, out_root,
                               defaults_root)
        elif isinstance(entry, dict) and not _is_leaf(entry):
            out[key] = {}
            apply_defaults(entry, {}, out[key], p, out_root, defaults_root)
        elif isinstance(entry, dict):
            out[key] = _leaf_value(entry, out_root, p)
        else:
            out[key] = copy.deepcopy(entry)
    return out


def _read(path):
    with open(path) as f:
        return json.load(f)


def settings_path(worker, name, project="fxs"):
    """The JSON file of settings `name` of a worker, or `name` itself when
    it is a path."""
    if os.sep in str(name) or str(name).endswith(".json"):
        path = str(name)
    else:
        path = os.path.join(DATA_DIR, project, worker, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no settings {name!r} for the {project} "
                                f"worker {worker!r} ({path})")
    return path


def load_settings(worker, name=None, overrides=None, project="fxs") -> dict:
    """The merged settings of a worker ('correlate', 'simulate_ccd',
    'extract', 'reconstruct' or 'average'): the named settings (None:
    none), then `overrides` (a nested dict of plain values), completed by
    the defaults. → plain nested dicts."""
    settings = _read(settings_path(worker, name, project)) if name else {}
    if overrides:
        deep_update(settings, overrides)
    defaults = _read(settings_path(worker, DEFAULTS_NAME, project))
    return apply_defaults(defaults, settings)
