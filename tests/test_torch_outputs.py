"""The host output of the port's ProjectStore against the JAX package's
ProjectDB (xframe_tpu.projects.fxs._database_) on the same results dicts,
3D and 2D, on both branches of the archive rule: where h5py and matplotlib
import, the same files in the same places (.yaml read as .json), the
archives and the PNG figures by the JAX package's names; with both
blocked, the JAX package's files after mapping .h5 → .npz, its figures
left out and named by the port's notice, which names matplotlib, beside
one naming h5py. Besides: the .vts bytes equal, the settings snapshot
equal as a tree, the latest-run links, IO.data_root, and every
IO.files.<name>.options toggle and cap the store reads. Then
profiling.enable: a profiled tiny reconstruct writes a torch.profiler
trace and gives bitwise the results of an unprofiled one."""
import glob
import json
import os
import re
import sys

import numpy as np
import pytest
import yaml

import xframe_tpu.settings as jset
from xframe_tpu.projects.fxs._database_ import ProjectDB

from xframe_tpu_torch.main import select_worker
from xframe_tpu_torch.projects.fxs.store import ProjectStore
from xframe_tpu_torch.settings import deep_update, load_settings

WORKER = {"ccd": "simulate_ccd", "invariants": "extract",
          "reconstructions": "reconstruct", "average_results": "average"}
N_R, N_T, N_P = 5, 4, 6


def _grid(dim):
    rs = np.linspace(0.5, 10.0, N_R)
    thetas = np.linspace(0.2, 2.9, N_T) if dim == 3 else np.asarray([])
    phis = 2 * np.pi * np.arange(N_P) / N_P
    return rs, thetas, phis


def results(kind, dim):
    """A results dict of `kind` with the keys the savers read."""
    rng = np.random.default_rng(0)
    shape = (N_R, N_T, N_P) if dim == 3 else (N_R, N_P)
    rs, thetas, phis = _grid(dim)
    qs = rs / 20
    vs = [rng.random((N_R, min(2 * l + 1, N_R))) for l in range(3)]

    def rho():
        return rng.random(shape).astype(np.float32)
    if kind == "ccd":
        return {"dimensions": dim, "radial_points": qs,
                "angular_points": phis, "xray_wavelength": 1.23,
                "average_intensity": np.ones(N_R),
                "cross_correlation": {"I1I1": rng.random((N_R, N_R, N_P))},
                "num_images_processed": 1, "num_images_good": 1}
    if kind == "invariants":
        return {"dimensions": dim, "xray_wavelength": 1.23, "max_order": 2,
                "average_intensity": np.ones(N_R), "data_radial_points": qs,
                "deg_2_invariant": {"I1I1": np.stack([v @ v.T for v in vs])},
                "data_projection_matrices": {"I1I1": vs}}
    if kind == "reconstructions":
        grid = {"real_grid": rs, "reciprocal_grid": qs, "phis": phis}
        if dim == 3:
            grid["thetas"] = thetas
        return {"configuration": {"internal_grid": grid, "dimensions": dim,
                                  "xray_wavelength": 1.23},
                "projection_matrices": vs,
                "average_intensity": np.ones(N_R),
                "reconstruction_results": {
                    str(i): {"real_density": (rho() + 1j * rho()).astype(
                        np.complex64),
                             "support_mask": rho() > 0.5,
                             "error_dict": {"main": np.geomspace(
                                 1, 1e-2, 10).astype(np.float32)}}
                    for i in range(3)}}
    return {"average": {"real_density": rho()},
            "aligned": {str(i): rho() for i in range(2)},
            "input": {str(i): rho() for i in range(2)},
            "resolution_metrics": {"PRTF": np.linspace(1, 0, N_R),
                                   "PRTF_qs": qs},
            "grid": {"rs": rs, "thetas": thetas, "phis": phis, "qs": qs}}


def _files(root, blocked=False):
    """{path relative to root: 'link -> target' or 'file'}, .yaml read as
    .json; `blocked`: figures left out and .h5 read as .npz."""
    out = {}
    h5 = (".h5", ".npz") if blocked else (".h5", ".h5")
    for folder, _, names in os.walk(root):
        for name in names:
            if blocked and name.endswith(".png"):
                continue
            path = os.path.join(folder, name)
            rel = os.path.relpath(path, root)
            rel = rel.replace(*h5).replace(".yaml", ".json")
            out[rel] = ("link -> " + os.readlink(path).replace(*h5)
                        if os.path.islink(path) else "file")
    return out


def block_packages(monkeypatch):
    """Make h5py and matplotlib fail to import, as on a machine that has
    neither."""
    for name in ("h5py", "matplotlib"):
        monkeypatch.setitem(sys.modules, name, None)


def _tree(path, home=None):
    """A snapshot's tree as JSON values, `home` written as <home>."""
    with open(path) as f:
        tree = yaml.safe_load(f) if path.endswith(".yaml") else json.load(f)
    text = json.dumps(tree)
    return json.loads(text.replace(home, "<home>") if home else text)


def _save_both(tmp_path, monkeypatch, kind, dim, overrides, blocked=False):
    """The results saved by the JAX ProjectDB and by the port's
    ProjectStore (with h5py and matplotlib blocked where `blocked`), each
    in its own home, from the same settings. → (JAX root, port root,
    port's path)."""
    data = results(kind, dim)
    roots = {}
    for pkg in ("jax", "torch"):
        home = str(tmp_path / pkg)
        monkeypatch.setenv("XFRAME_TPU_HOME", home)
        ov = deep_update({"structure_name": "pytest"}, overrides)
        root = ov.get("IO", {}).get("data_root")
        if root:
            ov = deep_update(ov, {"IO": {"data_root": os.path.join(home,
                                                                   root)}})
        roots[pkg] = os.path.join(home, root or os.path.join("data", "fxs"))
        if pkg == "jax":
            monkeypatch.setattr(jset, "raw_experiment", {})
            monkeypatch.setattr(jset, "raw_project", {})
            jset.load_settings("fxs", WORKER[kind], None, overrides=ov)
            ProjectDB(jset.project).save(kind, data)
        else:
            if blocked:
                block_packages(monkeypatch)
            s = load_settings(WORKER[kind], None, ov)
            path, run = ProjectStore(s["structure_name"], s).save(kind, data)
            assert run == 1
    return roots["jax"], roots["torch"], path


def _io(kind, **options):
    return {"IO": {"files": {kind: {"options": options}}}}


CASES = {
    "ccd": ("ccd", 3, {}),
    "ccd_no_link": ("ccd", 3, _io("ccd", save_symlink=False)),
    "ccd_data_root": ("ccd", 3, {"IO": {"data_root": "elsewhere"}}),
    "invariants": ("invariants", 3, {}),
    "invariants_toggles": ("invariants", 3, _io(
        "invariants", create_symlink=False,
        plot_first_invariants_from_proj_matrices=False)),
    "invariants_no_figures": ("invariants", 3, _io(
        "invariants", plot_first_invariants=False)),
    "reconstructions": ("reconstructions", 3, {}),
    "reconstructions_vtk_off": ("reconstructions", 3, _io(
        "reconstructions", generate_vtk_files=False, generate_2d_images=1)),
    "reconstructions_vtk_true": ("reconstructions", 3, _io(
        "reconstructions", generate_vtk_files=True, plot_error_metrics=False,
        plot_first_used_invariants=False, generate_2d_images=False)),
    "reconstructions_vtk_1": ("reconstructions", 3, _io(
        "reconstructions", generate_vtk_files=1)),
    "reconstructions_vtk_3": ("reconstructions", 3, _io(
        "reconstructions", generate_vtk_files=3, generate_2d_images=True)),
    "reconstructions_vtk_0": ("reconstructions", 3, _io(
        "reconstructions", generate_vtk_files=0)),
    "reconstructions_2d": ("reconstructions", 2, {}),
    "average": ("average_results", 3, {}),
    "average_all_vtk": ("average_results", 3, _io(
        "average_results", generate_aligned_vtk=True,
        generate_input_vtk=True)),
    "average_no_vtk": ("average_results", 3, _io(
        "average_results", generate_average_vtk=False,
        plot_resolution_metrics=False)),
    "average_2d": ("average_results", 2, {}),
}


@pytest.mark.parametrize("blocked", [False, True],
                         ids=["h5py_matplotlib", "blocked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_output_matches_project_db(tmp_path, monkeypatch, capsys,
                                        case, blocked):
    kind, dim, overrides = CASES[case]
    root_j, root_t, path = _save_both(tmp_path, monkeypatch, kind, dim,
                                      overrides, blocked)
    printed = capsys.readouterr().out
    assert path.startswith(root_t + os.sep)
    assert path.endswith(".npz" if blocked else ".h5")
    assert (re.findall(r"^\S+\.h5: h5py is not installed; wrote \S+\.npz "
                       r"in its place$", printed, flags=re.M)
            == ([f"{os.path.basename(path)[:-4]}.h5: h5py is not installed; "
                 f"wrote {os.path.basename(path)} in its place"]
                if blocked else []))
    got, want = _files(root_t, blocked), _files(root_j, blocked)
    assert got == want
    run = os.path.dirname(path)
    run_j = os.path.join(root_j, os.path.relpath(run, root_t))
    vts = sorted(f for f in os.listdir(run) if f.endswith(".vts"))
    for name in vts:
        with open(os.path.join(run, name), "rb") as a, \
                open(os.path.join(run_j, name), "rb") as b:
            assert a.read() == b.read(), name
    homes = str(tmp_path / "torch"), str(tmp_path / "jax")
    for name in ("settings_merged", "settings"):
        assert _tree(os.path.join(run, name + ".json"), homes[0]) == \
            _tree(os.path.join(run_j, name + ".yaml"), homes[1])
    # the figures the JAX package drew are the ones the port drew, or,
    # blocked, the ones its notice names
    pngs = sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(run_j, "*.png")))
    named = re.findall(rf"^{kind}: figures not written \((.*)\): "
                       r"matplotlib is not installed$", printed, flags=re.M)
    if blocked:
        assert len(named) == (1 if pngs else 0)
        assert sorted(named[0].split(", ") if named else []) == pngs
    else:
        assert not named
        assert sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(run, "*.png"))) == pngs
    expected_vts = {
        "reconstructions_vtk_off": 0, "reconstructions_vtk_0": 0,
        "reconstructions_2d": 0, "reconstructions_vtk_1": 1,
        "reconstructions_vtk_3": 3, "average_all_vtk": 5,
        "average_no_vtk": 0}
    if kind in ("reconstructions", "average_results"):
        assert len(vts) == expected_vts.get(case, 2 if kind ==
                                            "reconstructions" else 1)


def test_snapshot_of_named_settings_and_overrides(tmp_path, monkeypatch):
    """settings.json holds the named file's text as read; with runtime
    overrides, its tree with them under _runtime_overrides."""
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    s = load_settings("average", "tutorial")
    _, run = ProjectStore("t", s).save("average_results",
                                       results("average_results", 3))
    folder = os.path.join(str(tmp_path), "data", "fxs", "averages", "t",
                          "run_1")
    with open(os.path.join(folder, "settings.json")) as f:
        text = f.read()
    with open(s["_settings_path"]) as f:
        assert text == f.read()
    ov = {"l2_error_limit": 0.25, "selection": {"error_limit": 0.5}}
    s = load_settings("average", "tutorial", ov)
    ProjectStore("t", s).save("average_results",
                              results("average_results", 3))
    snap = _tree(os.path.join(folder[:-1] + "2", "settings.json"))
    with open(s["_settings_path"]) as f:
        want = json.load(f)
    assert snap == dict(want, _runtime_overrides=ov)
    merged = _tree(os.path.join(folder[:-1] + "2", "settings_merged.json"))
    assert merged["l2_error_limit"] == 0.25
    assert merged["selection"]["error_limit"] == 0.5
    assert not any(k.startswith("_") for k in merged)


def test_links_follow_the_newest_run(tmp_path, monkeypatch):
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    store = ProjectStore("t", load_settings("extract"))
    for n in (1, 2):
        path, run = store.save("invariants", results("invariants", 3))
        assert run == n
        name = os.path.basename(path)
        assert name == "proj_data.h5"
        link = os.path.join(store.folder("invariants"), name)
        assert os.readlink(link) == os.path.join(f"run_{n}", name)
        assert os.path.samefile(link, path)
    assert store.latest_run("invariants") == 2


def test_vts_decodes_to_the_density(tmp_path, monkeypatch):
    """read_field gives back each complex real_density bitwise (its real
    and imaginary parts), the φ seam closed by the first column."""
    from xframe_tpu_torch.io.vtk import read_field
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    data = results("reconstructions", 3)
    path, _ = ProjectStore("t", load_settings("reconstruct")).save(
        "reconstructions", data)
    for key in ("0", "1"):
        want = data["reconstruction_results"][key]["real_density"]
        for part, values in (("real", want.real), ("imag", want.imag)):
            flat = read_field(os.path.join(os.path.dirname(path),
                                           f"real_density_{key}.vts"),
                              "density_" + part)
            rho = flat.reshape((N_R, N_T, N_P + 1), order="F")
            assert rho.dtype == values.dtype == np.float32
            assert np.array_equal(rho[..., :-1], values)
            assert np.array_equal(rho[..., -1], values[..., 0])


@pytest.fixture
def small_reconstruct(tmp_path, monkeypatch):
    """Overrides of a tiny reconstruct (N_q = 8, L = 4, 2 restarts) on an
    invariants archive of the port's demo problem."""
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    from xframe_tpu_torch.projects.fxs.store import save_npz
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    p = make_demo_problem(8, 4, device="cpu")
    path = str(tmp_path / "inv.npz")
    save_npz(path, {"data_radial_points": p.ft.qs, "max_order": 4,
                    "data_projection_matrices": {
                        "I1I1": p.projection_matrices},
                    "average_intensity": p.average_intensity,
                    "xray_wavelength": 1.0})
    return {"structure_name": "small",
            "particle_radius": float(p.radius * 1.2),
            "grid": {"n_radial_points": 8, "max_order": 4},
            "input": {"invariants_path": path},
            "multi_start": {"n_reconstructions": 2, "seed": 3},
            "main_loop": {"sub_loops": {"order": ["main"], "main": {
                "iterations": 1, "order": ["HIO", "SW", "ER"],
                "methods": {"HIO": {"iterations": 3}, "SW": {"iterations": 1},
                            "ER": {"iterations": 2}}}}}}


@pytest.mark.parametrize("trace_dir", ["", "my_traces"])
def test_profiling_writes_a_trace_and_keeps_the_results(small_reconstruct,
                                                        tmp_path, trace_dir):
    plain = select_worker("fxs", "reconstruct", overrides=small_reconstruct,
                          device="cpu").run()
    folder = str(tmp_path / trace_dir) if trace_dir else \
        str(tmp_path / "traces")
    traced = select_worker("fxs", "reconstruct", overrides=deep_update(
        dict(small_reconstruct), {"profiling": {
            "enable": True, "trace_dir": folder if trace_dir else ""}}),
        device="cpu").run()
    traces = glob.glob(os.path.join(folder, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    for key, res in plain["reconstruction_results"].items():
        other = traced["reconstruction_results"][key]
        for name in ("real_density", "support_mask", "reciprocal_density"):
            assert np.array_equal(res[name], other[name]), name
        assert np.array_equal(res["error_dict"]["main"],
                              other["error_dict"]["main"])
