"""Worker settings as data.

The workers' settings trees of the JAX package, stored as JSON under
`settings/<project>/<worker>/` (written by scripts/export_torch_settings.py):
`default_0.1.json`, the versioned defaults with their `_value` leaves and
`_only_if`/`_copy`/`_if` directives, and named settings such as
`tutorial.json`, with every `command:` entry already evaluated.
`load_settings` finds a named file and the defaults through the folders of
`xframe_tpu.settings.loader` (the home folder first, then the user's project
folder, then the package's own), evaluates `command:` entries of a user's
file, and merges them as that loader does (a copy of its `apply_defaults`:
explicit settings win, directives resolve against the merged tree). It
returns plain nested dicts. `load_experiment_settings` does the same for
an experiment's settings (`experiments/<name>/settings/`, after the home
folder's `settings/experiments/<name>/` and `experiments/<name>/settings/`).
`archive_settings` writes the snapshot of the settings a run used into its
folder.
"""
from __future__ import annotations

import copy
import glob
import json
import os
import re

import numpy as np

DATA_DIR = os.path.dirname(os.path.abspath(__file__))
PACKAGE_DIR = os.path.dirname(DATA_DIR)
SETTINGS_VERSION_KEY = "settings_version"
_DEFAULT_RE = re.compile(r"default_([0-9.]+?)\.json$")
# the general settings a home's settings/general.json may override
GENERAL_DEFAULTS = {"loglevel": "WARNING", "load_projects": "all"}

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


def home_dir() -> str:
    return os.environ.get("XFRAME_TPU_HOME",
                          os.path.join(os.path.expanduser("~"), ".xframe_tpu"))


def settings_folders(project: str, worker: str) -> list:
    """The folders searched for a worker's settings, first wins."""
    return [
        os.path.join(home_dir(), "settings", "projects", project, worker),
        os.path.join(home_dir(), "projects", project, "settings", worker),
        os.path.join(DATA_DIR, project, worker),
    ]


def find_settings_file(folders, name):
    """The file of settings `name`: `name` itself when it is a path (it
    holds a path separator or ends in .json), else the first
    `<folder>/<name>.json`."""
    if str(name).endswith((".yaml", ".yml")):
        raise ValueError(f"settings {str(name)!r}: the port reads JSON "
                         "settings (<name>.json), not YAML")
    if os.sep in str(name) or str(name).endswith(".json"):
        if os.path.exists(name):
            return str(name)
        raise FileNotFoundError(f"settings file {name!r} not found")
    for folder in folders:
        path = os.path.join(folder, f"{name}.json")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no settings file {name}.json in any of "
                            f"{folders}")


def find_default_file(folders, version=None):
    """The highest-version default_<ver>.json across the folders (an
    earlier folder wins a tie), or the version pinned by `version`."""
    candidates = {}
    for folder in reversed(folders):
        for path in glob.glob(os.path.join(folder, "default_*.json")):
            m = _DEFAULT_RE.search(os.path.basename(path))
            if m:
                candidates[m.group(1)] = path
    if not candidates:
        return None
    if version is not None and str(version) in candidates:
        return candidates[str(version)]
    return candidates[max(candidates, key=lambda v: [
        int(x) for x in v.split(".") if x.isdigit()] or [0])]


def execute_commands(tree):
    """Every mapping that holds a `command` string → its evaluation."""
    if isinstance(tree, dict):
        if isinstance(tree.get("command"), str):
            return _eval_expr(tree["command"])
        return {k: execute_commands(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [execute_commands(v) for v in tree]
    return tree


def load_general_settings() -> dict:
    """GENERAL_DEFAULTS, overridden by <home>/settings/general.json."""
    merged = dict(GENERAL_DEFAULTS)
    path = os.path.join(home_dir(), "settings", "general.json")
    if os.path.exists(path):
        user = execute_commands(_read(path))
        if isinstance(user, dict):
            merged.update(user)
    merged["home"] = home_dir()
    return merged


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


def plain(tree):
    """Settings or overrides → JSON values (arrays as lists)."""
    if isinstance(tree, dict):
        return {str(k): plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [plain(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return plain(tree.tolist())
    if isinstance(tree, np.generic):
        return tree.item()
    return tree


def load_settings(worker, name=None, overrides=None, project="fxs") -> dict:
    """The merged settings of a worker of `project`: the named settings
    (None: none), then `overrides` (a nested dict of plain values), with
    their `command:` entries evaluated, completed by the defaults.
    → plain nested dicts, plus the keys `_settings_path`,
    `_default_settings_path`, `_settings_name`, and `_settings_text` (the
    named file's text) and `_overrides` where there are any, which
    `archive_settings` reads."""
    return _load_tree(settings_folders(project, worker), name, overrides)


def experiment_settings_folders(experiment: str) -> list:
    """The folders searched for an experiment's settings, first wins."""
    return [
        os.path.join(home_dir(), "settings", "experiments", experiment),
        os.path.join(home_dir(), "experiments", experiment, "settings"),
        os.path.join(PACKAGE_DIR, "experiments", experiment, "settings"),
    ]


def load_experiment_settings(experiment, name=None, overrides=None) -> dict:
    """The merged settings of `experiment` (e.g. 'SPB'), as load_settings
    merges a worker's: the named file (None: the defaults alone) found
    through experiment_settings_folders."""
    return _load_tree(experiment_settings_folders(experiment), name,
                      overrides)


def _load_tree(folders, name, overrides):
    path = find_settings_file(folders, name) if name else None
    text = None
    settings = {}
    if path:
        with open(path) as f:
            text = f.read()
        settings = json.loads(text)
    default_path = find_default_file(folders,
                                     settings.get(SETTINGS_VERSION_KEY))
    if overrides:
        deep_update(settings, overrides)
    settings = execute_commands(settings)
    defaults = execute_commands(_read(default_path)) if default_path else {}
    merged = apply_defaults(defaults, settings)
    merged.update(_settings_path=path or "",
                  _default_settings_path=default_path or "",
                  _settings_name=name or "")
    if text is not None:
        merged["_settings_text"] = text
    if overrides:
        merged["_overrides"] = copy.deepcopy(overrides)
    return merged


def archive_settings(run_folder, settings, prefix="settings"):
    """Write the snapshot of `settings` (load_settings' or
    load_experiment_settings' result) into `run_folder`:

    <prefix>.json         the named settings file's text as read, or, with
                          runtime overrides, its tree with them under
                          `_runtime_overrides`; without a named file the
                          merged tree (with `_runtime_overrides`)
    <prefix>_merged.json  the merged tree in effect

    prefix="experiment_settings" writes the bound experiment's settings
    beside the worker's, as the JAX package does."""
    os.makedirs(run_folder, exist_ok=True)
    merged = {k: v for k, v in settings.items()
              if not str(k).startswith("_")}
    text = settings.get("_settings_text")
    overrides = settings.get("_overrides")
    snap = os.path.join(run_folder, f"{prefix}.json")
    if text is not None and not overrides:
        with open(snap, "w") as f:
            f.write(text)
    else:
        body = json.loads(text) if text is not None else dict(merged)
        if overrides:
            body["_runtime_overrides"] = overrides
        _write_json(snap, body)
    _write_json(os.path.join(run_folder, f"{prefix}_merged.json"), merged)


def _write_json(path, tree):
    with open(path, "w") as f:
        json.dump(plain(tree), f, indent=1)
        f.write("\n")
