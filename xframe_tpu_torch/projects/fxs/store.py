"""Input and result files of the fxs workers: the archives and the host
output the JAX package's `ProjectDB` writes beside them.

The counterpart of `xframe_tpu.projects.fxs._database_`. Where h5py
imports, an archive is the JAX package's HDF5 file (`io/hdf5.py`, the
same names and layout, so that either package reads the other's files);
where it does not, the same tree goes into an `.npz` archive of the same
stem and the save prints one line naming h5py. Readers take whichever of
the two a run folder holds.

In an `.npz` archive a nested dict is stored flat: its keys joined by '/',
lists by their indices plus a '<key>/_list' entry holding their length,
scalars and strings as 0-d arrays; `None` entries are left out. Archives
of either kind are written to '<path>.tmp' and moved over '<path>', so a
reader never finds half a file.

Layout under IO.data_root (default <home>/data/fxs, home = XFRAME_TPU_HOME,
default ~/.xframe_tpu):

    ccd/<structure_name>/run_<n>/ccd.h5
    invariants/<structure_name>/run_<n>/proj_data.h5
    reconstructions/<structure_name>/run_<n>/data.h5
    averages/<structure_name>/run_<n>/average_results.h5

Each run folder also receives the settings snapshot (settings.json,
settings_merged.json, and experiment_settings.json and its merged tree
while an experiment is bound through `comm`), the `.vts` exports and,
where matplotlib imports, the PNG figures that the settings'
IO.files.<name>.options ask for; the ccd and invariants archives get a
link in the structure folder to the newest run's file.
"""
from __future__ import annotations

import os
import re

import numpy as np

from xframe_tpu_torch.io import hdf5, vtk
from xframe_tpu_torch.settings import archive_settings, home_dir

FOLDERS = {"ccd": ("ccd", "ccd"),
           "invariants": ("invariants", "proj_data"),
           "reconstructions": ("reconstructions", "data"),
           "average_results": ("averages", "average_results")}
LIST_KEY = "_list"
H5_EXT = (".h5", ".hdf5")
_RUN = re.compile(r"run_(\d+)$")


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


def archive_ext():
    """The extension of the archives written here: '.h5' where h5py
    imports, else '.npz'."""
    return ".h5" if hdf5.available() else ".npz"


def save_archive(path, tree: dict):
    """Write a nested dict to `path`: HDF5 for a '.h5' path where h5py
    imports; where it does not, the '.npz' of the same stem, with one line
    naming h5py. → the path written."""
    stem, ext = os.path.splitext(path)
    if ext in H5_EXT and not hdf5.available():
        print(f"{os.path.basename(path)}: {hdf5.MISSING}; wrote "
              f"{os.path.basename(stem)}.npz in its place")
        path, ext = stem + ".npz", ".npz"
    if ext not in H5_EXT:
        save_npz(path, tree)
        return path
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(tmp)), exist_ok=True)
    hdf5.save(tmp, tree)
    os.replace(tmp, path)
    return path


def load_archive(path, skip=()) -> dict:
    """The nested dict of an HDF5 or `.npz` archive (by its extension);
    leaves named in `skip` are not read."""
    if os.path.splitext(path)[1] in H5_EXT:
        return hdf5.load(path, skip=skip)
    return load_npz(path, skip=skip)


def existing_archive(path):
    """`path` if it exists, else the archive of the same stem in the
    other format where that one exists, else `path`."""
    if os.path.exists(path):
        return path
    stem, ext = os.path.splitext(path)
    other = stem + (".npz" if ext in H5_EXT else ".h5")
    return other if os.path.exists(other) else path


# ------------------------------------------------------------------- layout
def latest_run(folder):
    """The highest n of the run_<n> folders in `folder`, 0 if none."""
    if not os.path.isdir(folder):
        return 0
    runs = [int(m.group(1)) for m in map(_RUN.match, os.listdir(folder)) if m]
    return max(runs, default=0)


class ProjectStore:
    """Run-numbered archives of one structure under IO.data_root (default
    <home>/data/fxs). `settings` (load_settings' result, or None: no
    snapshot, the options' defaults) decides the host output of a save."""

    def __init__(self, structure_name="default", settings=None):
        self.structure_name = str(structure_name)
        self.settings = settings
        root = (settings or {}).get("IO", {}).get("data_root")
        self.data_root = os.path.expanduser(root) if root else \
            os.path.join(home_dir(), "data", "fxs")

    def folder(self, kind):
        return os.path.join(self.data_root, FOLDERS[kind][0],
                            self.structure_name)

    def latest_run(self, kind):
        return latest_run(self.folder(kind))

    def path(self, kind, run=None, new_run=False):
        """→ (path, run): `run` (default: the latest, or the next one for a
        save). The path has the extension of `archive_ext()`, unless the
        run folder holds the archive in the other format (HDF5 first)."""
        if run is None:
            run = self.latest_run(kind) + (1 if new_run else 0)
        if run == 0:
            raise FileNotFoundError(f"no runs of {kind!r} under "
                                    f"{self.folder(kind)}")
        stem = os.path.join(self.folder(kind), f"run_{int(run)}",
                            FOLDERS[kind][1])
        if new_run:
            return stem + archive_ext(), int(run)
        return existing_archive(stem + archive_ext()), int(run)

    def save(self, kind, results):
        """Archive `results` as the next run of `kind`, with the run's host
        output. → (path, run)"""
        from xframe_tpu_torch import comm
        from xframe_tpu_torch.projects.fxs import figures
        path, run = self.path(kind, new_run=True)
        path = save_archive(os.path.splitext(path)[0] + ".h5", results)
        folder = os.path.dirname(path)
        if self.settings is not None:
            archive_settings(folder, self.settings)
        if comm.experiment_settings:
            archive_settings(folder, comm.experiment_settings,
                             prefix="experiment_settings")
        if kind == "reconstructions":
            self._reconstruction_vtk(results, folder)
        elif kind == "average_results":
            self._average_vtk(results, folder)
        link = {"ccd": "save_symlink", "invariants": "create_symlink"}
        if kind in link and bool(self.io_option(kind, link[kind], True)):
            self._latest_link(path)
        if figures.available():
            figures.draw(kind, results, folder, self.io_option)
        else:
            missing = self._figures(kind, results)
            if missing:
                print(f"{kind}: figures not written ({', '.join(missing)}):"
                      f" {figures.MISSING}")
        return path, run

    def io_option(self, kind, key, default=None):
        """IO.files.<kind>.options.<key>; `default` where unset or None."""
        opt = (self.settings or {}).get("IO", {}).get("files", {}) \
            .get(kind, {}).get("options", {})
        val = opt.get(key, default)
        return default if val is None else val

    def _latest_link(self, path):
        """'<structure folder>/<file name>' → 'run_<n>/<file name>', the
        newest run's file."""
        run_dir = os.path.dirname(path)
        link = os.path.join(os.path.dirname(run_dir), os.path.basename(path))
        if os.path.lexists(link):
            os.remove(link)
        os.symlink(os.path.join(os.path.basename(run_dir),
                                os.path.basename(path)), link)

    def _reconstruction_vtk(self, data, folder):
        """real_density_<key>.vts of the first results: generate_vtk_files
        False writes none, True two, an int that many."""
        gen = self.io_option("reconstructions", "generate_vtk_files", 2)
        if gen is False:
            return
        cap = 2 if gen is True else int(gen)
        grid = data["configuration"]["internal_grid"]
        if "thetas" not in grid:
            # a polar (2D) grid has no θ axis: the JAX package's export
            # fails on it and writes nothing, and so does this one
            return
        results = data.get("reconstruction_results", {})
        for key in sorted(results, key=int)[:max(cap, 0)]:
            vtk.save_spherical(os.path.join(folder, f"real_density_{key}.vts"),
                               grid["real_grid"], grid["thetas"],
                               grid["phis"],
                               {"density": results[key]["real_density"]})

    def _average_vtk(self, data, folder):
        """average_density.vts (generate_average_vtk), aligned_density_<i>
        and input_density_<i>.vts (generate_aligned_vtk,
        generate_input_vtk)."""
        grid = data.get("grid")
        if grid is None:
            return
        files = []
        if bool(self.io_option("average_results", "generate_average_vtk",
                               True)):
            files.append(("average_density.vts",
                          data["average"]["real_density"]))
        for key in ("aligned", "input"):
            if bool(self.io_option("average_results", f"generate_{key}_vtk",
                                   False)):
                files += [(f"{key}_density_{k}.vts", rho)
                          for k, rho in data.get(key, {}).items()]
        for name, rho in files:
            vtk.save_spherical(os.path.join(folder, name), grid["rs"],
                               grid["thetas"], grid["phis"],
                               {"density": rho})

    def _figures(self, kind, data):
        """The PNG files the JAX package would draw for this save (named by
        the notice where matplotlib does not import)."""
        opt = self.io_option
        names = []
        if kind == "invariants" and bool(opt(kind, "plot_first_invariants",
                                             True)):
            names.append("first_invariants.png")
            if bool(opt(kind, "plot_first_invariants_from_proj_matrices",
                        True)):
                names.append("first_invariants_from_proj_matrices.png")
            if bool(opt(kind, "plot_first_projection_matrix_error_estimates",
                        False)):
                names.append("first_projection_matrix_error_estimates.png")
        elif kind == "reconstructions":
            if bool(opt(kind, "plot_error_metrics", True)):
                names.append("errors.png")
            if bool(opt(kind, "plot_first_used_invariants", True)):
                names.append("first_used_invariants.png")
            n_img = opt(kind, "generate_2d_images", 2)
            if n_img is not False:
                cap = 2 if n_img is True else int(n_img)
                keys = sorted(data.get("reconstruction_results", {}),
                              key=int)[:max(cap, 0)]
                names += [f"real_density_{k}.png" for k in keys]
        elif kind == "average_results" and bool(
                opt(kind, "plot_resolution_metrics", True)) \
                and "PRTF" in data.get("resolution_metrics", {}):
            names.append("PRTF.png")
        return names

    def load(self, kind, run=None, path=None, skip=()):
        if path is None:
            path, _ = self.path(kind, run=run)
        return load_archive(path, skip=skip)

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
    data_low_resolution_intensity_coefficients; from an HDF5 or `.npz`
    archive."""
    data = load_archive(path)
    pm = data.get("data_projection_matrices", {})
    data["data_projection_matrices"] = {
        k: [np.asarray(vs[i]) for i in sorted(vs, key=int)]
        if isinstance(vs, dict) else [np.asarray(v) for v in vs]
        for k, vs in pm.items()}
    return data
