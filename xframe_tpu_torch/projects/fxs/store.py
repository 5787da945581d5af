"""Input and result files of the fxs workers as numpy `.npz` archives.

The counterpart of the parts of `xframe_tpu.projects.fxs._database_` that
the workers use, without HDF5. A nested dict is
stored flat: its keys joined by '/', lists by their indices plus a
'<key>/_list' entry holding their length, scalars and strings as 0-d
arrays; `None` entries are left out. Archives are written with
allow_pickle=False to '<path>.tmp' and moved over '<path>', so a reader
never finds half a file.

Layout under the home directory (XFRAME_TPU_HOME, default ~/.xframe_tpu):

    data/fxs/ccd/<structure_name>/run_<n>/ccd.npz
    data/fxs/invariants/<structure_name>/run_<n>/proj_data.npz
    data/fxs/reconstructions/<structure_name>/run_<n>/data.npz
    data/fxs/averages/<structure_name>/run_<n>/data.npz
"""
from __future__ import annotations

import os
import re

import numpy as np

FOLDERS = {"ccd": ("ccd", "ccd.npz"),
           "invariants": ("invariants", "proj_data.npz"),
           "reconstructions": ("reconstructions", "data.npz"),
           "average_results": ("averages", "data.npz")}
LIST_KEY = "_list"
_RUN = re.compile(r"run_(\d+)$")


def home_dir() -> str:
    return os.environ.get("XFRAME_TPU_HOME",
                          os.path.join(os.path.expanduser("~"), ".xframe_tpu"))


# ------------------------------------------------------------- flat archives
def _is_scalar(x):
    return isinstance(x, (bool, int, float, complex, str, np.generic))


def _flatten(tree, prefix, out):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        if tree and all(_is_scalar(v) for v in tree):
            out[prefix[:-1]] = np.asarray(tree)
            return
        out[prefix + LIST_KEY] = np.asarray(len(tree))
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        arr = np.asarray(tree)
        if arr.dtype == object:
            raise TypeError(f"cannot store an object array at {prefix[:-1]!r}")
        out[prefix[:-1]] = arr


def flatten(tree: dict) -> dict:
    """Nested dict → {'a/b/c': array}."""
    out = {}
    _flatten(tree, "", out)
    return out


def _value(arr):
    if arr.ndim:
        return arr
    v = arr[()]
    return str(v) if isinstance(v, np.str_) else v


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if LIST_KEY in node:
        return [node[str(i)] for i in range(int(node[LIST_KEY]))]
    return node


def unflatten(flat: dict) -> dict:
    """The inverse of flatten: 0-d arrays come back as scalars or str."""
    tree = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _value(arr)
    return _lists(tree)


def save_npz(path, tree: dict):
    """Write a nested dict to `path` through `path.tmp`."""
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(tmp)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flatten(tree))
    os.replace(tmp, path)


def load_npz(path, skip=()) -> dict:
    """The nested dict of an archive; leaves named in `skip` (the last key
    part) are not read."""
    with np.load(path, allow_pickle=False) as d:
        return unflatten({k: d[k] for k in d.files
                          if k.rsplit("/", 1)[-1] not in skip})


# ------------------------------------------------------------------- layout
class ProjectStore:
    """Run-numbered archives of one structure under <home>/data/fxs."""

    def __init__(self, structure_name="default"):
        self.structure_name = str(structure_name)
        self.data_root = os.path.join(home_dir(), "data", "fxs")

    def folder(self, kind):
        return os.path.join(self.data_root, FOLDERS[kind][0],
                            self.structure_name)

    def latest_run(self, kind):
        folder = self.folder(kind)
        if not os.path.isdir(folder):
            return 0
        runs = [int(m.group(1)) for m in map(_RUN.match, os.listdir(folder))
                if m]
        return max(runs, default=0)

    def path(self, kind, run=None, new_run=False):
        """→ (path, run): `run` (default: the latest, or the next one for a
        save)."""
        if run is None:
            run = self.latest_run(kind) + (1 if new_run else 0)
        if run == 0:
            raise FileNotFoundError(f"no runs of {kind!r} under "
                                    f"{self.folder(kind)}")
        return os.path.join(self.folder(kind), f"run_{int(run)}",
                            FOLDERS[kind][1]), int(run)

    def save(self, kind, results):
        """Archive `results` as the next run of `kind`. → (path, run)."""
        path, run = self.path(kind, new_run=True)
        save_npz(path, results)
        return path, run

    def load(self, kind, run=None, path=None, skip=()):
        if path is None:
            path, _ = self.path(kind, run=run)
        return load_npz(path, skip=skip)

    def load_ccd(self, run=None, path=None):
        """A cross-correlation dataset (simulate_ccd's output, extract's
        input); a bare cross_correlation array is read as {'I1I1': it}."""
        data = self.load("ccd", run=run, path=path)
        cc = data.get("cross_correlation")
        if cc is not None and not isinstance(cc, dict):
            data["cross_correlation"] = {"I1I1": np.asarray(cc)}
        return data

    def load_invariants(self, run=None, path=None):
        return load_invariants(path or self.path("invariants", run=run)[0])

    def load_reconstructions(self, run=None, path=None, skip=()):
        return self.load("reconstructions", run=run, path=path, skip=skip)


def load_invariants(path) -> dict:
    """The invariants the reconstruct worker reads: data_radial_points,
    max_order, data_projection_matrices {dataset: [V_l]},
    average_intensity, xray_wavelength and, where present,
    number_of_particles, data_projection_matrices_q_id_limits and
    data_low_resolution_intensity_coefficients."""
    data = load_npz(path)
    pm = data.get("data_projection_matrices", {})
    data["data_projection_matrices"] = {
        k: [np.asarray(vs[i]) for i in sorted(vs, key=int)]
        if isinstance(vs, dict) else [np.asarray(v) for v in vs]
        for k, vs in pm.items()}
    return data
