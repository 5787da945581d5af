"""The port's 2D (polar) chain against the JAX package's (CPU), at the sizes
and overrides of tests/test_pipeline2d.py, in a temporary XFRAME_TPU_HOME.

  * density: the port's builders agree with the JAX package's everywhere
    except on grid points that lie on a shape's edge to float32 rounding
    (the origin disk's radius 22 is a grid radius here: x² + y² = 484 is
    decided by each library's own cos/sin);
  * simulate_ccd: on the JAX worker's density the port's worker gives its
    CC and averaged intensity within 1e-5 of max;
  * extract: on the JAX worker's CC (convert.save_ccd) B_m within 1e-10 of
    max, v_m v_m† within 1e-8 of max (float64 both);
  * reconstruct: on the JAX worker's invariants the set-up agrees (scales,
    vectors, support, radial mask, SO(2) pin, schedule within 1e-6), the
    first segment from the JAX worker's initial densities within 1e-4,
    with and without SO_freedom; the port's worker meets the JAX test's
    schema and convergence assertions; chunked restarts; shift_to_center;
    fix_orientation rotates each output by its residual SO(2) angle;
  * average: on the JAX worker's reconstructions (convert.save_reconstructions)
    the angles equal, the average within 1e-4 of max and every metric
    within 1e-4; averaging over several files;
  * Aligner2D recovers a rotation, and its batch agrees with the JAX one;
    the ground-truth correlation (fidelity, dim=2) within 1e-5 of JAX's;
    extraction_mode shapes in 2D against the JAX worker.
"""
import os

import numpy as np
import pytest
import torch

import xframe_tpu as xf
from xframe_tpu.projects.fxs import simulate_ccd as jsim
from xframe_tpu.projects.fxs.reconstruct import ProjectWorker as JaxWorker

from xframe_tpu_torch.convert import (save_ccd, save_invariants,
                                      save_reconstructions)
from xframe_tpu_torch.library.shapes import polar_grid
from xframe_tpu_torch.main import run_worker, select_worker
from xframe_tpu_torch.projects.fxs import simulate_ccd as tsim
from xframe_tpu_torch.projects.fxs.reconstruct import rotate_polar_density
from xframe_tpu_torch.projects.fxs.store import archive_ext

SHAPES = {"types": ["sphere", "sphere"], "centers": [[0, 0], [40, 1.0]],
          "sizes": [22, 15], "densities": [1.0, 0.7],
          "random_orientation": [False, False]}
SIMULATE = {"structure_name": "pytest2d", "dimensions": 2,
            "grid": {"n_radial_points": 48, "max_order": 12, "max_q": 0.5,
                     "n_phi": 64},
            "shapes": SHAPES,
            "cross_correlation": {"xray_wavelength": 1.23984}}
EXTRACT = {"structure_name": "pytest2d", "dimensions": 2, "max_order": 12}
AVERAGE = {"structure_name": "pytest2d", "selection": {"error_limit": 10.0},
           "l2_error_limit": 10.0,
           "resolution_metrics": {"PRTF": True, "FSC": True, "FQCB": True}}


def reconstruct_overrides(n=2, seed=5, iterations=2, **extra):
    ov = {"structure_name": "pytest2d", "dimensions": 2,
          "particle_radius": 60,
          "grid": {"n_radial_points": 32, "max_order": 10, "n_phi": 64},
          "multi_start": {"n_reconstructions": n, "seed": seed},
          "main_loop": {"sub_loops": {
              "order": ["main"],
              "main": {"iterations": iterations,
                       "order": ["HIO", "SW", "ER"],
                       "methods": {"HIO": {"iterations": 15},
                                   "SW": {"iterations": 1},
                                   "ER": {"iterations": 10}}}}},
          "projections": {"real": {
              "shrink_wrap": {"sigmas": [False], "thresholds": [0.09]},
              "HIO": {"beta": [[0.5, 0.4, -1 / 50, 100]]}}}}
    from xframe_tpu_torch.settings import deep_update
    return deep_update(ov, extra)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("xf_torch_home_2d"))
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = path
    yield path
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


@pytest.fixture(scope="module")
def chain(home):
    """The JAX chain simulate_ccd → extract → reconstruct (its simulate
    density kept), each result also as the port's archive."""
    seen = {}
    inner = jsim.device_density_from_shapes

    def spy(axes, opt, rng=None):
        seen["density"] = np.asarray(inner(axes, opt, rng))
        return seen["density"]
    jsim.device_density_from_shapes = spy
    try:
        xf.select_project("fxs", "simulate_ccd", overrides=SIMULATE)
        ccd = xf.run()
    finally:
        jsim.device_density_from_shapes = inner
    xf.select_project("fxs", "extract", overrides=EXTRACT)
    inv = xf.run()
    xf.select_project("fxs", "reconstruct",
                      overrides=reconstruct_overrides())
    rec = xf.run()
    paths = {k: os.path.join(home, f"jax_{k}.npz")
             for k in ("ccd", "inv", "rec")}
    paths["jax_rec"] = os.path.join(home, "data", "fxs", "reconstructions",
                                    "pytest2d", "run_1", "data.h5")
    assert os.path.exists(paths["jax_rec"])
    save_ccd(ccd, paths["ccd"])
    save_invariants(inv, paths["inv"])
    save_reconstructions(rec, paths["rec"])
    return dict(ccd=ccd, inv=inv, rec=rec, density=seen["density"],
                paths=paths)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


# ----------------------------------------------------------------- simulate
def test_density_builders_differ_only_on_edges(chain):
    ft = tsim.PolarFourierTransform(48, 12, 64, 0.5,
                                    reciprocity_coefficient=2.0,
                                    device="cpu")
    np.testing.assert_array_equal(ft.qs, chain["ccd"]["radial_points"])
    phis = 2 * np.pi * np.arange(64) / 64
    want = chain["density"]
    got = tsim.device_density_from_shapes((ft.rs, phis), SHAPES,
                                          device="cpu").numpy()
    host = tsim.build_density_from_shapes(polar_grid(ft.rs, phis), SHAPES)
    x = ft.rs[:, None] * np.cos(phis)[None, :]
    y = ft.rs[:, None] * np.sin(phis)[None, :]
    edge = np.zeros(want.shape, bool)
    for (r0, p0), size in zip(SHAPES["centers"], SHAPES["sizes"]):
        d2 = (x - r0 * np.cos(p0)) ** 2 + (y - r0 * np.sin(p0)) ** 2
        edge |= np.abs(d2 - size ** 2) <= 1e-5 * size ** 2
    for d in (got, host):
        differ = np.abs(d - want) > 1e-6
        assert (~differ | edge).all() and edge.sum() < 0.05 * d.size


def test_simulate_matches_jax_on_its_density(chain, monkeypatch):
    monkeypatch.setattr(tsim, "device_density_from_shapes",
                        lambda axes, opt, rng=None, device="cuda":
                        torch.tensor(chain["density"], device=device))
    got = run_worker("fxs", "simulate_ccd",
                     overrides=dict(SIMULATE, structure_name="port2d"),
                     device="cpu")
    want = chain["ccd"]
    assert got["dimensions"] == 2
    cc = got["cross_correlation"]["I1I1"]
    assert cc.shape == (48, 48, 64) and cc.dtype == np.float64
    assert _rel(cc, want["cross_correlation"]["I1I1"]) <= 1e-5
    assert _rel(got["average_intensity"], want["average_intensity"]) <= 1e-5
    np.testing.assert_array_equal(got["radial_points"],
                                  want["radial_points"])
    np.testing.assert_allclose(got["angular_points"], want["angular_points"])


def test_simulate_own_density(home):
    got = run_worker("fxs", "simulate_ccd",
                     overrides=dict(SIMULATE, structure_name="own2d"),
                     device="cpu")
    cc = got["cross_correlation"]["I1I1"]
    assert cc.shape == (48, 48, 64) and np.isfinite(cc).all()
    # B_m(q2, q1) = B_m(q1, q2)*, so CC(q2, q1, Δ) = CC(q1, q2, −Δ)
    mirrored = np.roll(cc.transpose(1, 0, 2)[..., ::-1], 1, axis=-1)
    assert np.abs(cc - mirrored).max() <= 1e-12 * np.abs(cc).max()
    assert set(got["timing"]) >= {"weights_s", "intensity_s", "bm_s",
                                  "cc_synthesis_s", "save_s"}


# ------------------------------------------------------------------ extract
def _gram(v):
    v = np.asarray(v)
    return v @ v.conj().T


def test_extract_matches_jax(chain):
    got = run_worker("fxs", "extract", overrides=dict(
        EXTRACT, structure_name="port2d",
        input={"ccd_path": chain["paths"]["ccd"]}), device="cpu")
    want = chain["inv"]
    assert set(got) - {"timing"} == set(want)
    assert got["dimensions"] == 2 and got["max_order"] == 12
    bm = got["deg_2_invariant"]["I1I1"]
    assert bm.shape == (13, 48, 48)
    assert _rel(bm, want["deg_2_invariant"]["I1I1"]) <= 1e-10
    proj = got["data_projection_matrices"]["I1I1"]
    assert len(proj) == 13
    assert all(np.asarray(v).shape == (48, 1) for v in proj)
    scale = max(np.abs(_gram(v)).max()
                for v in want["data_projection_matrices"]["I1I1"])
    for a, b in zip(proj, want["data_projection_matrices"]["I1I1"]):
        assert np.abs(_gram(a) - _gram(b)).max() <= 1e-8 * scale
    assert got["data_projection_matrix_error_estimates"] == {}
    assert _rel(got["data_low_resolution_intensity_coefficients"],
                want["data_low_resolution_intensity_coefficients"]) <= 1e-12


def test_extract_from_shapes_2d(home):
    ov = {"structure_name": "shapes2d", "dimensions": 2, "max_order": 10,
          "extraction_mode": "shapes",
          "shapes_source": {
              "grid": {"n_radial_points": 32, "max_q": 0.5, "n_phi": 64},
              "shapes": {"types": ["sphere", "sphere"],
                         "centers": [[0, 0], [30, 1.0]],
                         "sizes": [18, 12], "densities": [1.0, 0.7],
                         "random_orientation": [False, False]}}}
    xf.select_project("fxs", "extract", overrides=ov)
    want = xf.run()
    got = run_worker("fxs", "extract", overrides=ov, device="cpu")
    bm = np.asarray(got["deg_2_invariant"]["I1I1"])
    assert bm.shape == (11, 32, 32)
    assert np.abs(bm[1::2]).max() == 0  # Friedel
    assert _rel(bm, want["deg_2_invariant"]["I1I1"]) <= 1e-5
    v = np.asarray(got["data_projection_matrices"]["I1I1"][2])[:, 0]
    assert np.linalg.norm(bm[2] - np.outer(v, v.conj())) \
        / np.linalg.norm(bm[2]) < 1e-3


# -------------------------------------------------------------- reconstruct
def _workers(chain, **extra):
    """Both workers' set-up on the JAX invariants: (JAX (mtip, ft, aux,
    schedule), port (mtip, ft, aux, schedule))."""
    xf.select_project("fxs", "reconstruct",
                      overrides=reconstruct_overrides(**extra))
    jw = JaxWorker()
    jm, jft, jaux = jw.setup_mtip(chain["inv"])
    tw = select_worker("fxs", "reconstruct",
                       overrides=port_overrides(chain, **extra), device="cpu")
    tm, tft, taux = tw.setup_mtip(tw._load_invariants())
    return (jm, jft, jaux, jw._build_schedule(jft)), \
        (tm, tft, taux, tw._build_schedule(tft))


SO_FREEDOM = {"projections": {"reciprocal": {"SO_freedom": {"apply": True}}}}


@pytest.mark.parametrize("extra", [{}, SO_FREEDOM], ids=["free", "so2_pin"])
def test_reconstruct_setup_and_engine_parity(chain, extra):
    (jm, jft, jaux, js), (tm, tft, taux, ts) = _workers(chain, **extra)
    assert taux["data_scale"] == pytest.approx(jaux["data_scale"], rel=1e-6)
    for a, b in zip(taux["proj"], jaux["proj"]):
        assert _rel(a, b) <= 1e-6
    assert _rel(taux["avg_intensity"], jaux["avg_intensity"]) <= 1e-6
    assert taux["total_intensity"] == pytest.approx(jaux["total_intensity"],
                                                    rel=1e-6)
    np.testing.assert_array_equal(taux["initial_support"],
                                  jaux["initial_support"])
    assert taux["so_pin"] == jaux["so_pin"]
    assert (taux["so_pin"] is None) == (not extra)
    assert tm.rc.so_pin_order == jm.rc.so_pin_order
    np.testing.assert_array_equal(tm.rc.radial_mask.numpy(),
                                  np.asarray(jm.rc.radial_mask))
    np.testing.assert_array_equal(tm.rc.use_order.numpy(),
                                  np.asarray(jm.rc.use_order))
    assert _rel(tm.rc.V.numpy(), jm.rc.V) <= 1e-6
    assert tm.real.limit_imag == pytest.approx(jm.real.limit_imag, rel=1e-6)
    assert tm._fi is None and tm.best_mode == "eager"
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        assert (a.method, a.n, a.ft_stab) == (b.method, b.n, b.ft_stab)
        assert a.sigma == pytest.approx(b.sigma, rel=1e-6)
    rho0 = np.array(jaux["initial_density_batch"](7, 2))
    _, je = jm.run_batch(rho0, [js[0]])
    _, te = tm.run_batch(torch.as_tensor(rho0), [ts[0]])
    je, te = np.asarray(je), te.numpy()
    assert te.shape == je.shape == (2, 15, 2)
    assert np.abs(te - je).max() <= 1e-4


def port_overrides(chain, **extra):
    """The reconstruct overrides for the port's worker on the JAX
    invariants, its results under their own structure name."""
    extra.setdefault("structure_name", "port2d")
    return reconstruct_overrides(
        input={"invariants_path": chain["paths"]["inv"]}, **extra)


@pytest.fixture(scope="module")
def port_run(chain):
    return run_worker("fxs", "reconstruct", overrides=port_overrides(chain),
                      device="cpu")


def test_reconstruct_schema(port_run, chain):
    cfg, want = port_run["configuration"], chain["rec"]["configuration"]
    assert cfg["dimensions"] == 2 and cfg["max_order"] == 10
    assert set(cfg["internal_grid"]) == {"real_grid", "reciprocal_grid",
                                         "phis"}
    for k, v in want["internal_grid"].items():
        np.testing.assert_allclose(cfg["internal_grid"][k], v, rtol=1e-12)
    for k in ("reciprocity_coefficient", "fourier_transform_mode", "q_max",
              "seed"):
        assert cfg[k] == want[k]
    results = port_run["reconstruction_results"]
    assert len(results) == 2
    for r in results.values():
        assert r["real_density"].shape == (32, 64)
        assert np.isfinite(r["real_density"]).all()
        assert np.isfinite(r["error_dict"]["main"]).all()
        assert r["fxs_unknowns"].shape == (11,)
        assert set(r) == set(chain["rec"]["reconstruction_results"]["0"])
    e0 = np.asarray(results["0"]["error_dict"]["main"])
    assert e0[-1] < e0[:5].mean()
    d = results["0"]["error_dict"]["deg2_invariant_relative"]
    assert d.shape == (6,) and np.isfinite(d).all()


def test_reconstruct_chunked_restarts(chain):
    res = run_worker("fxs", "reconstruct", overrides=port_overrides(
        chain, n=3, iterations=1, multi_start={"batch_size": 2}),
        device="cpu")
    densities = [np.asarray(r["real_density"])
                 for r in res["reconstruction_results"].values()]
    assert len(densities) == 3
    for d in densities:
        assert d.shape == (32, 64) and np.isfinite(d).all()
    assert not np.allclose(densities[0], densities[2])
    assert len(res["timing"]["chunk_walls_s"]) == 2


def test_shift_to_center(chain):
    res = run_worker("fxs", "reconstruct", overrides=port_overrides(
        chain, n=1, seed=11, iterations=1,
        output_density_modifiers={"shift_to_center": True}), device="cpu")
    rho = np.abs(res["reconstruction_results"]["0"]["real_density"])
    r = res["configuration"]["internal_grid"]["real_grid"]
    phis = 2 * np.pi * np.arange(rho.shape[1]) / rho.shape[1]
    w = rho * r[:, None]
    com = np.array([(w * r[:, None] * np.cos(phis)).sum(),
                    (w * r[:, None] * np.sin(phis)).sum()]) / w.sum()
    assert np.linalg.norm(com) < 0.1 * r.max(), com


def test_fix_orientation(chain):
    """fix_orientation under SO_freedom rotates each saved density by the
    residual SO(2) angle of its unknowns (the JAX package's host code);
    the run is otherwise the same."""
    from xframe_tpu_torch.projects.fxs.reconstruct import \
        so2_residual_rotation_phase
    plain = run_worker("fxs", "reconstruct",
                       overrides=port_overrides(chain, **SO_FREEDOM),
                       device="cpu")
    fixed = run_worker("fxs", "reconstruct", overrides=port_overrides(
        chain, output_density_modifiers={"fix_orientation": True},
        **SO_FREEDOM), device="cpu")
    # the ranking of orders by strength does not see the data scale
    proj = plain["projection_matrices"]
    qs = plain["configuration"]["internal_grid"]["reciprocal_grid"]
    angles = []
    for k, r in plain["reconstruction_results"].items():
        phi0 = so2_residual_rotation_phase(r["fxs_unknowns"], proj, qs)
        angles.append(phi0)
        want = rotate_polar_density(r["real_density"], phi0) if phi0 \
            else r["real_density"]
        got = fixed["reconstruction_results"][k]["real_density"]
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert any(angles)


# ------------------------------------------------------------------ average
@pytest.fixture(scope="module")
def averages(chain):
    xf.select_project("fxs", "average", overrides=dict(
        AVERAGE, reconstruction_files=[chain["paths"]["jax_rec"]]))
    want = xf.run()
    got = run_worker("fxs", "average", overrides=dict(
        AVERAGE, structure_name="port2d",
        reconstruction_files=[chain["paths"]["rec"]]), device="cpu")
    return got, want


METRICS = ["PRTF", "PRTF_from_density", "PRTF_fxs", "PRTF_from_ft_density",
           "PRTF_ftI", "pseudo_FSC", "FSC", "FSC_half_bit",
           "FQCB_from_density", "FQCB_from_density_with_zero_order"]


def test_average_matches_jax(averages):
    got, want = averages
    np.testing.assert_allclose(got["rotation_metric"]["angles"],
                               want["rotation_metric"]["angles"])
    assert len(got["aligned"]) == len(want["aligned"]) == 2
    assert _rel(got["average"]["real_density"],
                want["average"]["real_density"]) <= 1e-4
    assert got["average"]["real_density"].shape == (32, 64)
    np.testing.assert_allclose(got["so3_grid"]["alphas"],
                               want["so3_grid"]["alphas"])
    prtf = got["resolution_metrics"]["PRTF"]
    assert prtf.shape == (32,) and (prtf <= 1 + 1e-6).all()


@pytest.mark.parametrize("name", METRICS)
def test_average_metric_matches_jax(averages, name):
    got, want = averages
    a = np.asarray(got["resolution_metrics"][name])
    b = np.asarray(want["resolution_metrics"][name])
    assert a.shape == b.shape and np.abs(a - b).max() <= 1e-4


def test_average_multiple_files(chain, home):
    for seed in (5, 9):
        run_worker("fxs", "reconstruct", overrides=port_overrides(
            chain, seed=seed, iterations=1, structure_name="multi2d"),
            device="cpu")
    base = os.path.join(home, "data", "fxs", "reconstructions", "multi2d")
    files = sorted(os.path.join(base, d, "data" + archive_ext())
                   for d in os.listdir(base))
    avg = run_worker("fxs", "average", overrides=dict(
        AVERAGE, structure_name="multi2d", reconstruction_files=files[:2]),
        device="cpu")
    assert len(avg["input"]) == 4
    assert {m["file_index"] for m in avg["input_meta"].values()} == {0, 1}


# ---------------------------------------------------- alignment, fidelity
def test_aligner2d_recovers_rotation():
    from xframe_tpu_torch.projects.fxs.alignment import Aligner2D
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem_2d
    p = make_demo_problem_2d(24, 10, 64, device="cpu")
    aligner = Aligner2D(p.ft, p.integrator._w)
    k0 = 13
    rho = torch.as_tensor(p.rho_true, dtype=torch.complex64)
    rho_rot = torch.as_tensor(np.roll(p.rho_true, k0, axis=-1),
                              dtype=torch.complex64)
    ref = aligner.coefficients(rho_rot)
    aligned, _, info = aligner.align(rho, ref)
    assert np.isclose(info["angles"][0], 2 * np.pi * k0 / 64, atol=1e-6)
    assert (aligned - rho_rot).abs().max() < 1e-3
    batch, _, l2, infos = aligner.align_batch(
        torch.stack([rho, torch.roll(rho, 5, -1)]), ref, ref_rho=rho_rot)
    assert [i["angles"][0] for i in infos] == pytest.approx(
        [2 * np.pi * k0 / 64, 2 * np.pi * (k0 - 5) / 64])
    assert torch.equal(batch[0], rho_rot) and l2.max() < 1e-6


def test_aligner2d_batch_and_fidelity_match_jax():
    import jax.numpy as jnp
    from xframe_tpu.projects.fxs.alignment import Aligner2D as JAligner
    from xframe_tpu.projects.fxs.demo import make_demo_problem_2d as jprob
    from xframe_tpu.projects.fxs.fidelity import \
        align_to_ground_truth as jalign
    from xframe_tpu_torch.projects.fxs.alignment import Aligner2D
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem_2d
    from xframe_tpu_torch.projects.fxs.fidelity import align_to_ground_truth
    pj = jprob(24, 10, 64)
    pt = make_demo_problem_2d(24, 10, 64, device="cpu")
    ja = JAligner(pj.ft, np.asarray(pj.integrator._w))
    ta = Aligner2D(pt.ft, pt.integrator._w)
    rng = np.random.default_rng(0)
    rhos = (np.roll(pj.rho_true, 9, -1)[None]
            * (1 + 0.1 * rng.random((3, 24, 64)))).astype(np.complex64)
    ref = pj.rho_true.astype(np.complex64)
    jc, _, jcoms = ja.center_batch(jnp.asarray(rhos))
    tc, _, tcoms = ta.center_batch(torch.as_tensor(rhos))
    assert _rel(tcoms.numpy(), jcoms) < 1e-5
    assert _rel(tc.numpy(), jc) < 1e-4
    jr, _, jl2, jinfo = ja.align_batch(jc, ja.coefficients(jnp.asarray(ref)),
                                       ref_rho=jnp.asarray(ref))
    tr, _, tl2, tinfo = ta.align_batch(
        torch.as_tensor(np.asarray(jc)),
        ta.coefficients(torch.as_tensor(ref)), ref_rho=torch.as_tensor(ref))
    assert [i["angles"] for i in tinfo] == [i["angles"] for i in jinfo]
    assert _rel(tr.numpy(), jr) < 1e-5 and _rel(tl2, jl2) < 1e-5
    dens = rhos[0]
    cj = jalign(dens, pt.shapes, pj.ft, np.asarray(pj.integrator._w), dim=2)
    ct = align_to_ground_truth(dens, pt.shapes, pt.ft, pt.integrator._w,
                               dim=2)
    assert abs(ct[0] - cj[0]) < 1e-5 and ct[0] > 0.5
