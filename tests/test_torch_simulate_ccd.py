"""The port's simulate_ccd worker against the JAX package's (CPU).

  * the torch density function against JAX device_density_from_shapes on the
    cases of tests/test_library.py: exact (< 1e-6) without rotation; with
    seeded random orientations, the share of points that disagree (float32
    masks at a shape boundary) below 5e-3, JAX's own bound;
  * the C_n synthesis against JAX's `_synthesize_cc_device` within 2e-5 of
    max (float32 sums in another order), exactly q1↔q2 symmetric;
  * the whole worker at the sizes of tests/test_pipeline_integration.py
    (N = 48, L = 14): CC and average_intensity within 1e-4 of max (the
    float32 SHT and Hankel chain, sums in another order), the same keys,
    shapes and dtypes, the archive read back equal;
  * the noise equal to JAX's bitwise, `_resolve_max_q` equal;
  * pdb and map densities against JAX's (≤ 1e-12 of max), the map written
    by the port's `write_ccp4` copy.
"""
import os

import numpy as np
import pytest
import torch

from xframe_tpu.projects.fxs import simulate_ccd as jsim
from xframe_tpu.library.shapes import spherical_grid
from xframe_tpu.settings.tools import DictNamespace

from xframe_tpu_torch.library import pdb as tpdb
from xframe_tpu_torch.main import run_worker, select_worker
from xframe_tpu_torch.projects.fxs import simulate_ccd as tsim
from xframe_tpu_torch.settings import load_settings

L_SIM, N_SIM = 14, 48
PIPELINE = {
    "structure_name": "pytest", "dimensions": 3,
    "grid": {"n_radial_points": N_SIM, "max_order": L_SIM, "max_q": 0.5},
    "shapes": {"types": ["sphere", "sphere"],
               "centers": [[0, 0, 0], [30, 1.2, 0.7]],
               "sizes": [20, 14], "densities": [1.0, 0.7],
               "random_orientation": [False, False]},
    "cross_correlation": {"method": "back_substitution",
                          "xray_wavelength": 1.23984},
}
ROTATED = {"types": ["sphere", "cube", "tetrahedron"],
           "centers": [[0, 0, 0], [7.0, 1.1, 0.4], [5.0, 2.0, 3.0]],
           "sizes": [6.2, 5.0, 8.0], "densities": [1.0, 0.5, 0.25],
           "random_orientation": [False, True, True]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test processes would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    return str(tmp_path)


def test_device_density_exact_without_rotation():
    axes = (np.linspace(0, 12, 15), np.linspace(0.1, np.pi - 0.1, 8),
            np.linspace(0, 2 * np.pi, 12, endpoint=False))
    opts = {"types": ["sphere", "cube"],
            "centers": [[0, 0, 0], [6.0, 1.0, 0.5]],
            "sizes": [5.5, 4.0], "densities": [1.0, 0.5]}
    want = np.asarray(jsim.device_density_from_shapes(axes, opts))
    got = tsim.device_density_from_shapes(axes, opts, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-6
    host = tsim.build_density_from_shapes(spherical_grid(*axes), opts)
    assert np.abs(got - host).max() < 1e-6


@pytest.mark.parametrize("reference", ["jax_device", "port_host"])
def test_device_density_with_rotation(reference):
    axes = (np.linspace(0, 12, 17), np.linspace(0.05, np.pi - 0.05, 9),
            np.linspace(0, 2 * np.pi, 16, endpoint=False))
    if reference == "jax_device":
        want = np.asarray(jsim.device_density_from_shapes(
            axes, ROTATED, rng=np.random.default_rng(3)))
    else:
        want = tsim.build_density_from_shapes(
            spherical_grid(*axes), ROTATED, rng=np.random.default_rng(3))
    got = tsim.device_density_from_shapes(
        axes, ROTATED, rng=np.random.default_rng(3), device="cpu").numpy()
    disagree = np.abs(got - want) > 1e-6
    assert disagree.mean() < 5e-3
    assert np.abs(got - want).max() <= 1.0 + 1e-6
    assert (want > 0).any()


@pytest.mark.parametrize("n_q,L,n_phi", [(10, 6, 32), (17, 9, 64)])
def test_synthesize_cc_matches_jax(n_q, L, n_phi):
    rng = np.random.default_rng(5)
    qs = np.linspace(0.02, 0.5, n_q)
    v = rng.normal(size=(L + 1, n_q, 3))
    bl = np.einsum("lqa,lpa->lqp", v, v)
    bl[1::2] = 0
    jw = jsim.ProjectWorker.__new__(jsim.ProjectWorker)
    want = jw._synthesize_cc_device(bl.astype(complex), 1.23984, qs, n_phi)
    got = tsim.synthesize_cc(torch.as_tensor(bl.astype(np.float32)),
                             1.23984, qs, n_phi)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() < 2e-5 * np.abs(want).max()
    np.testing.assert_array_equal(got, np.swapaxes(got, 0, 1))


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """The JAX and the port's simulate_ccd on the pipeline test's
    settings, each in its own home. → (JAX ccd, port ccd, port archive)."""
    import xframe_tpu as xf
    old = os.environ.get("XFRAME_TPU_HOME")
    try:
        os.environ["XFRAME_TPU_HOME"] = str(tmp_path_factory.mktemp("jax"))
        xf.select_project("fxs", "simulate_ccd", overrides=PIPELINE)
        want = xf.run()
        os.environ["XFRAME_TPU_HOME"] = str(tmp_path_factory.mktemp("port"))
        w = select_worker("fxs", "simulate_ccd", overrides=PIPELINE,
                          device="cpu")
        got = w.run()
        archive = w.store.load_ccd()
    finally:
        if old is None:
            os.environ.pop("XFRAME_TPU_HOME", None)
        else:
            os.environ["XFRAME_TPU_HOME"] = old
    return want, got, archive


def test_worker_matches_jax(workers):
    want, got, _ = workers
    assert set(got) - {"timing"} == set(want)
    for key in ("radial_points", "angular_points", "average_intensity"):
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
    np.testing.assert_allclose(got["radial_points"], want["radial_points"],
                               rtol=1e-12)
    np.testing.assert_array_equal(got["angular_points"],
                                  want["angular_points"])
    for key in ("dimensions", "xray_wavelength", "num_images_processed",
                "num_images_good"):
        assert got[key] == want[key], key
    a, b = got["average_intensity"], np.asarray(want["average_intensity"])
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    cc, cj = got["cross_correlation"]["I1I1"], \
        np.asarray(want["cross_correlation"]["I1I1"])
    assert cc.shape == cj.shape == (N_SIM, N_SIM, 32)
    assert cc.dtype == cj.dtype == np.float32
    assert np.abs(cc - cj).max() <= 1e-4 * np.abs(cj).max()
    np.testing.assert_array_equal(cc, np.swapaxes(cc, 0, 1))
    assert set(got["timing"]) >= {"weights_s", "density_s",
                                  "intensity_coefficients_s", "bl_s",
                                  "cc_synthesis_s", "save_s"}


def test_archive_reads_back(workers):
    _, got, archive = workers
    np.testing.assert_array_equal(archive["cross_correlation"]["I1I1"],
                                  got["cross_correlation"]["I1I1"])
    for key in ("radial_points", "angular_points", "average_intensity"):
        np.testing.assert_array_equal(archive[key], got[key])
    assert archive["dimensions"] == 3 and "timing" not in archive


@pytest.mark.parametrize("snr,seed", [(50.0, 0), (10.0, 4)])
def test_noise_equals_jax(snr, seed):
    cc = np.random.default_rng(2).normal(size=(6, 6, 16)).astype(np.float32)
    cc = 0.5 * (cc + np.swapaxes(cc, 0, 1))
    opt = {"noise": {"apply": True, "snr": snr, "seed": seed}}
    jw = jsim.ProjectWorker.__new__(jsim.ProjectWorker)
    want = jw._apply_noise(cc, DictNamespace(opt))
    got = tsim._apply_noise(cc, opt)
    np.testing.assert_array_equal(got, want)
    assert tsim._apply_noise(cc, {"noise": {"apply": False}}) is cc


@pytest.mark.parametrize("grid,shapes", [
    ({"max_q": 0.4}, {}),
    ({"max_q": False, "oversampling": 6}, {}),
    ({"max_q": False}, {"shape_size": 90}),
])
def test_resolve_max_q(grid, shapes):
    s = load_settings("simulate_ccd", "tutorial",
                      {"grid": grid, "shapes": shapes})
    jw = jsim.ProjectWorker.__new__(jsim.ProjectWorker)
    assert tsim._resolve_max_q(s, 64) == jw._resolve_max_q(
        DictNamespace(s), 64)


def _write_pdb(path):
    lines = []
    rng = np.random.default_rng(9)
    for i, (x, y, z) in enumerate(rng.uniform(-6, 6, size=(12, 3))):
        elem = ("C", "N", "O", "S")[i % 4]
        lines.append(f"ATOM  {i + 1:5d}  {elem:<3s} ALA A{i + 1:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{20.0:6.2f}"
                     f"          {elem:>2s}\n")
    with open(path, "w") as f:
        f.writelines(lines)


@pytest.mark.parametrize("kind", ["pdb", "map"])
def test_pdb_and_map_densities_match_jax(kind, tmp_path):
    if kind == "pdb":
        src = str(tmp_path / "model.pdb")
        _write_pdb(src)
        opts = {"types": ["pdb"], "pdb_file": src, "resolution": 3.0}
    else:
        src = str(tmp_path / "model.ccp4")
        rng = np.random.default_rng(4)
        tpdb.write_ccp4(src, rng.uniform(0, 1, (12, 10, 14)),
                        cell=(24.0, 20.0, 28.0, 90.0, 90.0, 90.0))
        opts = {"types": ["pdb"], "map_file": src}
    grid = spherical_grid(np.linspace(0.5, 10, 6), np.linspace(0.2, 2.9, 5),
                          np.linspace(0, 6, 7))
    want = jsim.build_density_from_shapes(grid, opts)
    got = tsim.build_density_from_shapes(grid, opts)
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_worker_runs_a_pdb_density(home, tmp_path):
    src = str(tmp_path / "model.pdb")
    _write_pdb(src)
    out = run_worker("fxs", "simulate_ccd", overrides={
        "grid": {"n_radial_points": 16, "max_order": 6, "max_q": 0.5},
        "shapes": {"types": ["pdb"], "pdb_file": src}}, device="cpu")
    cc = out["cross_correlation"]["I1I1"]
    assert cc.shape == (16, 16, 16) and np.isfinite(cc).all()
    assert np.abs(cc).max() > 0


# the 2D path runs (tests/test_torch_pipeline2d.py); atoms of a pdb_file
# are smeared in 3D only, so a 2D simulation from one is refused
@pytest.mark.parametrize("overrides,error,match", [
    ({"dimensions": 2, "grid": {"n_radial_points": 16, "max_order": 6,
                                "max_q": 0.5, "n_phi": 32},
      "shapes": {"types": ["pdb"], "pdb_file": "model.pdb"}},
     NotImplementedError, "2D polar grid"),
])
def test_unported_settings_raise(home, overrides, error, match):
    with pytest.raises(error, match=match):
        run_worker("fxs", "simulate_ccd", overrides=overrides, device="cpu")


def test_cuda_refusals():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        select_worker("fxs", "simulate_ccd", "tutorial")
