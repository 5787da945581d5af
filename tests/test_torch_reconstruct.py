"""The port's reconstruct worker against the JAX package's (CPU).

The JAX chain simulate_ccd → extract runs at the sizes of
tests/test_pipeline_integration.py in a temporary XFRAME_TPU_HOME, and its
invariants go into the port's `.npz` layout (convert.save_invariants).
Both workers then take the reconstruct overrides of that test (SW_center in
the refinement loop included):

  * set-up: data_scale, the regridded projection matrices, the average
    intensity, the radial mask, the initial support and the schedule agree
    within rtol 1e-6;
  * engine: both MTIPs from the JAX worker's first initial densities agree
    on the first iteration's errors within 1e-4 (the port's bound for its
    slice against the JAX package);
  * SW_center: the centered densities agree within 1e-4 of their maximum
    and the new supports away from the threshold;
  * end to end: the port's worker meets the schema assertions of
    test_reconstruct_schema, and its best restart correlates with the
    simulated truth above 0.75 (the JAX gate);
  * checkpointing: a checkpointed run equals an unchunked plain one
    bitwise and removes its checkpoint.
"""
import os

import numpy as np
import pytest
import torch

import xframe_tpu as xf
from xframe_tpu.projects.fxs.reconstruct import ProjectWorker as JaxWorker

from xframe_tpu_torch.convert import save_invariants
from xframe_tpu_torch.main import run_worker, select_worker
from xframe_tpu_torch.projects.fxs import phasing as tph
from xframe_tpu_torch.projects.fxs.fidelity import align_to_ground_truth

L_SIM, N_SIM, L_REC, N_REC = 14, 48, 10, 24
SHAPES = {"types": ["sphere", "sphere"],
          "centers": [[0, 0, 0], [30, 1.2, 0.7]],
          "sizes": [20, 14], "densities": [1.0, 0.7],
          "random_orientation": [False, False]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: on tensors this small, parallel test processes
    that each start a thread per core oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reconstruct_overrides(inv_path=None, **extra):
    """The reconstruct overrides of tests/test_pipeline_integration.py, the
    invariants read from inv_path (the port's archive; None: the JAX
    package's latest invariants run)."""
    ov = {
        "structure_name": "pytest", "dimensions": 3, "particle_radius": 50,
        "grid": {"n_radial_points": N_REC, "max_order": L_REC},
        "multi_start": {"n_reconstructions": 3, "seed": 7},
        "main_loop": {"sub_loops": {
            "order": ["main", "refinement"],
            "main": {"iterations": 2, "order": ["HIO", "SW", "ER"],
                     "methods": {"HIO": {"iterations": 15},
                                 "SW": {"iterations": 1},
                                 "ER": {"iterations": 10}}},
            "refinement": {"iterations": 1, "order": ["SW_center", "ER"],
                           "methods": {"SW_center": {"iterations": 1},
                                       "ER": {"iterations": 15}}},
        }},
        "projections": {"real": {
            "shrink_wrap": {"sigmas": [False, False],
                            "thresholds": [0.09, 0.09]},
            "HIO": {"beta": [[0.5, 0.4, -1 / 50, 100],
                             [0.01, 0.002, -1 / 50, 50]]},
        }},
    }
    if inv_path is not None:
        ov["input"] = {"invariants_path": inv_path}
    for k, v in extra.items():
        ov[k] = dict(ov.get(k, {}), **v) if isinstance(v, dict) else v
    return ov


def jax_invariants(home):
    """simulate_ccd → extract of the JAX package in `home`; the invariants
    written as the port's archive. → (invariants dict, archive path)."""
    xf.select_project("fxs", "simulate_ccd", overrides={
        "structure_name": "pytest", "dimensions": 3,
        "grid": {"n_radial_points": N_SIM, "max_order": L_SIM,
                 "max_q": 0.5},
        "shapes": SHAPES,
        "cross_correlation": {"method": "back_substitution",
                              "xray_wavelength": 1.23984},
    })
    xf.run()
    xf.select_project("fxs", "extract", overrides={
        "structure_name": "pytest", "dimensions": 3, "max_order": L_SIM})
    inv = xf.run()
    path = os.path.join(home, "port_invariants.npz")
    save_invariants(inv, path)
    return inv, path


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("xf_torch_home"))
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = path
    yield path
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


@pytest.fixture(scope="module")
def chain(home):
    return jax_invariants(home)


@pytest.fixture(scope="module")
def workers(chain):
    """Both workers' set-up on the same invariants: (JAX (mtip, ft, aux,
    schedule), port worker after setup)."""
    inv, path = chain
    ov = reconstruct_overrides(path)
    xf.select_project("fxs", "reconstruct", overrides=reconstruct_overrides())
    jw = JaxWorker()
    jm, jft, jaux = jw.setup_mtip(inv)
    jsched = jw._build_schedule(jft)
    tw = select_worker("fxs", "reconstruct", overrides=ov, device="cpu")
    tm, tft, taux = tw.setup_mtip(tw._load_invariants())
    tw.mtip, tw.ft, tw.aux = tm, tft, taux
    tw.schedule = tw._build_schedule(tft)
    return (jm, jft, jaux, jsched), tw


@pytest.fixture(scope="module")
def port_run(chain):
    return run_worker("fxs", "reconstruct",
                      overrides=reconstruct_overrides(chain[1]),
                      device="cpu")


def _rclose(a, b, rtol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= rtol * max(
        np.abs(b).max(initial=0.0), 1e-300)


def test_setup_parity(workers):
    (jm, jft, jaux, jsched), tw = workers
    taux = tw.aux
    assert taux["data_scale"] == pytest.approx(jaux["data_scale"], rel=1e-6)
    assert len(taux["proj"]) == len(jaux["proj"])
    for a, b in zip(taux["proj"], jaux["proj"]):
        _rclose(a, b)
    _rclose(taux["avg_intensity"], jaux["avg_intensity"])
    _rclose(taux["total_intensity"], jaux["total_intensity"])
    assert np.array_equal(np.asarray(taux["initial_support"]),
                          np.asarray(jaux["initial_support"]))
    assert np.array_equal(tw.mtip.rc.radial_mask.numpy(),
                          np.asarray(jm.rc.radial_mask))
    _rclose(tw.ft.rs, jft.rs)
    _rclose(tw.ft.qs, jft.qs)
    assert tw.mtip.enforce_limit == jm.enforce_limit
    assert tw.mtip.real.limit_imag == pytest.approx(jm.real.limit_imag,
                                                    rel=1e-6)
    assert len(tw.schedule) == len(jsched)
    for a, b in zip(tw.schedule, jsched):
        assert (a.method, a.n, a.ft_stab) == (b.method, b.n, b.ft_stab)
        assert a.sigma == pytest.approx(b.sigma, rel=1e-6)
        assert a.threshold == pytest.approx(b.threshold, rel=1e-6)
        if b.betas is not None:
            _rclose(a.betas, b.betas)
    assert any(s.method == "SW_center" for s in tw.schedule)
    assert tw.mtip._fi is not None and tw.mtip.best_mode == "replay"


def _jax_rho0(workers, n=3):
    (jm, jft, jaux, jsched), tw = workers
    return np.array(jaux["initial_density_batch"](7, n))


def test_engine_parity(workers):
    """The first segment (HIO 15) from the JAX worker's densities."""
    (jm, jft, jaux, jsched), tw = workers
    rho0 = _jax_rho0(workers)
    seg = jsched[0]
    _, je = jm.run_batch(rho0, [seg])
    tseg = tw.schedule[0]
    _, te = tw.mtip.run_batch(torch.as_tensor(rho0), [tseg])
    je, te = np.asarray(je), te.numpy()
    assert je.shape == te.shape == (3, seg.n, 2)
    rel = np.abs(je - te) / (np.abs(je) + 1e-9)
    assert rel[:, 0].max() < 1e-4
    assert np.isfinite(te).all()


def test_sw_center_parity(workers):
    """SW_center from the same densities: per restart the centered density
    and the new support."""
    (jm, jft, jaux, jsched), tw = workers
    rho0 = _jax_rho0(workers)
    jseg = next(s for s in jsched if s.method == "SW_center")
    tseg = next(s for s in tw.schedule if s.method == "SW_center")
    js, _ = jm.run_batch(rho0, [jseg])
    ts, _ = tw.mtip.run_batch(torch.as_tensor(rho0), [tseg])
    jrho, trho = np.asarray(js.rho), ts.rho.numpy()
    for r in range(rho0.shape[0]):
        assert np.abs(trho[r] - jrho[r]).max() \
            <= 1e-4 * np.abs(jrho[r]).max()
        assert np.abs(trho[r] - rho0[r]).max() > 1e-3 * np.abs(rho0[r]).max()
    # the supports agree wherever the blur is not at the threshold
    m = tw.mtip
    blurred = m.ft.inverse(m.ft.forward(ts.rho.abs().to(torch.complex64))
                           * m.sw.gaussian_values(tseg.sigma)).real
    c = torch.clamp(blurred, min=0.0)
    lo = c.amin(dim=(-3, -2, -1), keepdim=True)
    hi = c.amax(dim=(-3, -2, -1), keepdim=True)
    level = ((c - lo) / (hi - lo)).numpy()
    clear = np.abs(level - tseg.threshold) > 1e-4
    jsup = np.broadcast_to(np.asarray(js.support), trho.shape)
    assert np.array_equal(ts.support.numpy()[clear], jsup[clear])
    assert clear.mean() > 0.99


def test_sw_center_replay_matches_eager(workers):
    """A replayed chunk that ends in SW_center gives eager's state."""
    (_, _, _, _), tw = workers
    m = tw.mtip
    rho0 = torch.as_tensor(_jax_rho0(workers, 2))
    sched = [s for s in tw.schedule[:2]] + \
        [next(s for s in tw.schedule if s.method == "SW_center")]
    eager = tph.MTIP(m.ft, m.rc, m.real, m.sw, m._w_err.numpy(),
                     m.initial_support.numpy(),
                     enforce_initial_support_limit=m.enforce_limit,
                     best_mode="eager", device="cpu")
    eager.enable_centering(m._r_cart.numpy(), m._q_cart.numpy())
    se, ee = eager.run_batch(rho0, sched)
    sr, er = m.run_batch(rho0, sched)
    assert torch.equal(ee, er)
    assert torch.equal(se.rho, sr.rho) and torch.equal(se.support,
                                                       sr.support)
    assert torch.equal(se.best_rho, sr.best_rho)
    assert torch.equal(se.best_err, sr.best_err)


def test_reconstruct_schema(port_run, chain, home):
    res = port_run
    cfg = res["configuration"]
    assert cfg["internal_grid"]["real_grid"].shape == (N_REC,)
    assert cfg["internal_grid"]["reciprocal_grid"].shape == (N_REC,)
    results = res["reconstruction_results"]
    assert len(results) == 3
    n_theta = len(cfg["internal_grid"]["thetas"])
    n_phi = len(cfg["internal_grid"]["phis"])
    for key, r in results.items():
        assert r["real_density"].shape == (N_REC, n_theta, n_phi)
        assert r["support_mask"].dtype == bool
        err = np.asarray(r["error_dict"]["main"])
        assert err.shape == (2 * 25 + 15,)
        assert np.isfinite(err).all()
    finals = [results[str(i)]["error_dict"]["final"] for i in range(3)]
    assert finals[0] == min(finals)
    e0 = np.asarray(results["0"]["error_dict"]["main"])
    assert e0[-1] < e0[:5].mean()
    assert set(res["timing"]) >= {"setup_s", "phasing_s", "collect_s",
                                  "sec_per_iteration_per_restart",
                                  "chunk_walls_s", "steady_sec_per_restart"}
    from xframe_tpu_torch.projects.fxs.store import archive_ext
    path = os.path.join(home, "data", "fxs", "reconstructions", "pytest",
                        "run_1", "data" + archive_ext())
    assert os.path.exists(path)


def test_reconstruct_archive_round_trip(port_run, home):
    from xframe_tpu_torch.projects.fxs.store import ProjectStore
    back = ProjectStore("pytest").load_reconstructions(run=1)
    r0, b0 = port_run["reconstruction_results"]["0"], \
        back["reconstruction_results"]["0"]
    for k in ("real_density", "reciprocal_density", "support_mask",
              "fxs_unknowns"):
        assert np.array_equal(r0[k], b0[k])
    assert b0["error_dict"]["final"] == r0["error_dict"]["final"]
    assert len(back["projection_matrices"]) == L_SIM + 1
    assert back["configuration"]["fourier_transform_mode"] == "midpoint"


def test_best_restart_matches_truth(port_run):
    """The JAX gate (tests/test_pipeline_integration.py:214-217) on the
    port's best restart."""
    from xframe_tpu_torch.ops.fourier import SphericalFourierTransform
    from xframe_tpu_torch.ops.integrate import SphericalIntegrator
    cfg = port_run["configuration"]
    g = cfg["internal_grid"]
    ft = SphericalFourierTransform(
        N_REC, L_REC, q_max=float(cfg["q_max"]), mode="midpoint",
        reciprocity_coefficient=float(cfg["reciprocity_coefficient"]),
        n_theta=len(g["thetas"]), n_phi=len(g["phis"]), device="cpu")
    np.testing.assert_allclose(ft.rs, g["real_grid"], rtol=1e-12)
    integ = SphericalIntegrator(ft.rs, len(g["thetas"]), len(g["phis"]),
                                device="cpu")
    best = port_run["reconstruction_results"]["0"]["real_density"]
    corr = align_to_ground_truth(best, SHAPES, ft, integ.w_broadcast)[0]
    assert corr > 0.75


def test_checkpointed_run_equals_plain(chain, home):
    """batch_size 0: a checkpointed run equals the plain one bitwise."""
    runs = {}
    for ck in (False, True):
        ov = reconstruct_overrides(
            chain[1], structure_name=f"ck_{ck}",
            multi_start={"n_reconstructions": 2, "seed": 3,
                         "batch_size": 0},
            checkpointing={"enable": ck})
        runs[ck] = run_worker("fxs", "reconstruct", overrides=ov,
                              device="cpu")
    a, b = (runs[k]["reconstruction_results"] for k in (False, True))
    for key in a:
        for f in ("real_density", "last_real_density", "support_mask"):
            assert np.array_equal(a[key][f], b[key][f])
        assert np.array_equal(a[key]["error_dict"]["main"],
                              b[key]["error_dict"]["main"])
    ck_dir = os.path.join(home, "data", "fxs", "checkpoints")
    from xframe_tpu_torch.projects.fxs.store import archive_ext
    assert not os.path.exists(os.path.join(ck_dir, "ck_True_phasing"
                                           + archive_ext()))


# ------------------------------------------- options on a small archive
@pytest.fixture(scope="module")
def small_archive(home):
    """An invariants archive of the port's demo problem at N_q = 8, L = 4,
    with an isotropic low-resolution intensity vector and q-id limits."""
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    from xframe_tpu_torch.projects.fxs.store import save_npz
    p = make_demo_problem(8, 4, device="cpu")
    path = os.path.join(home, "small_invariants.npz")
    save_npz(path, {
        "data_radial_points": p.ft.qs, "max_order": 4,
        "data_projection_matrices": {"I1I1": p.projection_matrices},
        "average_intensity": p.average_intensity, "xray_wavelength": 1.0,
        "data_low_resolution_intensity_coefficients":
            p.average_intensity * 2 * np.sqrt(np.pi),
        "data_projection_matrices_q_id_limits":
            np.stack([np.zeros(5, int), np.full(5, 7)], axis=1)})
    return p, path


def _small_overrides(p, path, **extra):
    ov = {"structure_name": "small", "particle_radius": float(p.radius * 1.2),
          "grid": {"n_radial_points": 8, "max_order": 4},
          "input": {"invariants_path": path},
          "multi_start": {"n_reconstructions": 3, "batch_size": 2,
                          "seed": 1},
          "main_loop": {"sub_loops": {"order": ["main"], "main": {
              "iterations": 1, "order": ["HIO", "SW_center", "ER"],
              "methods": {"HIO": {"iterations": 3},
                          "SW_center": {"iterations": 1},
                          "ER": {"iterations": 2}}}}}}
    for k, v in extra.items():
        ov[k] = v
    return ov


OPTIONS = {
    "auto_correlation_support": {"projections": {"real": {"projections": {
        "support": {"initial_support": {"type": "auto_correlation"}}}}}},
    "ball_guess": {"density_guess": {"type": "ball",
                                     "amplitude_function": "uniform"}},
    "low_resolution_guess": {"density_guess": {
        "type": "low_resolution_autocorrelation"}},
    "shift_to_center": {"output_density_modifiers": {"shift_to_center": True},
                        "multi_start": {"n_reconstructions": 3, "seed": 1,
                                        "batch_size": 2,
                                        "results_to_keep": 2}},
    "q_mask_from_data": {"projections": {"reciprocal": {
        "q_mask": {"type": "from_projection_matrices"}}}},
    "stepwise_eager": {"fourier_transform": {"fused_sht": False},
                       "main_loop": {"best_tracking": "eager"}},
    # once refused; the stepwise iteration runs the particle-number
    # estimate and the non-default error metrics, as in the JAX package
    "particle_estimation": {"projections": {"reciprocal": {
        "number_of_particles": {"estimate": {"apply": True}}}}},
    "bucketed_shrink_wrap": {"projections": {"real": {"shrink_wrap": {
        "mode": "fixed_volume", "fixed_volume": {"method": "bucketed"}}}}},
    "ns_sigma_min": {"projections": {"reciprocal": {"ns_sigma_min": 1e-5}}},
    "deg2_error_metric": {"main_loop": {"error": {"methods": {
        "reciprocal": {"calculate": ["deg2_invariant_l2_diff"]}}}}},
    # once refused: float64 runs the plain transforms and the stepwise
    # iteration, in 3D and in 2D (the archive names no dimensions, so the
    # settings' 2 builds the polar set-up)
    "float64": {"precision": "float64"},
    "two_dimensions": {"dimensions": 2, "precision": "float64"},
    # once refused: the kernels' bf16 Legendre tables, on the CPU their
    # plain version (tests/test_torch_bf16_tables.py)
    "fused_bf16_tables": {"fourier_transform": {"fused_bf16_tables": True}},
}
STEPWISE_OPTIONS = ("stepwise_eager", "particle_estimation",
                    "deg2_error_metric", "float64", "two_dimensions")


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_worker_options_run(small_archive, name):
    """Each option runs the worker to finite, ranked, archived results."""
    from xframe_tpu_torch.settings import deep_update
    p, path = small_archive
    ov = deep_update(_small_overrides(p, path), OPTIONS[name])
    w = select_worker("fxs", "reconstruct", overrides=ov, device="cpu")
    built = []  # the MTIP the worker sets up, which it does not keep
    setup = w.setup_mtip
    w.setup_mtip = lambda inv: built.append(setup(inv)) or built[-1]
    res = w.run()
    mtip = built[0][0]
    results = res["reconstruction_results"]
    keep = ov["multi_start"].get("results_to_keep", "all")
    assert len(results) == (3 if keep == "all" else keep)
    finals = [results[str(i)]["error_dict"]["final"]
              for i in range(len(results))]
    assert finals == sorted(finals)
    for r in results.values():
        assert np.isfinite(r["real_density"]).all()
        assert r["error_dict"]["main"].shape == (5,)
    assert (mtip._fi is None) == (name in STEPWISE_OPTIONS)
    assert os.path.exists(w.saved[0])
    if name == "auto_correlation_support":
        assert not mtip.initial_support.all()
        assert mtip._k4_weights().dim() == 3      # B5's grid of weights
    if name == "particle_estimation":
        for r in results.values():
            hist = r["n_particles_history"]
            assert hist.shape == (5,) and (hist >= 1.0).all()
            assert r["n_particles"] == hist[-1]
    if name == "deg2_error_metric":
        for r in results.values():
            deg2 = r["error_dict"]["reciprocal_deg2_invariant_l2_diff"]
            assert deg2.shape == (5,) and (deg2 >= 0).all()
            assert np.isfinite(r["error_dict"]["real_l2_projection_diff"]
                               ).all()
    if name == "ns_sigma_min":
        assert len(mtip.rc.ns_schedule) == 11
    if name == "bucketed_shrink_wrap":
        assert mtip.sw.fixed_volume_method == "bucketed"
        for r in results.values():
            assert r["last_support_mask"].sum() < r["initial_support"].sum()
    if name == "fused_bf16_tables":
        assert mtip.ft.harmonic.table_dtype == torch.bfloat16
        assert mtip._fi is not None and mtip._fi.f is mtip.ft.harmonic
    if name in ("float64", "two_dimensions"):
        assert mtip.rdtype == torch.float64
        assert mtip.initial_support.dim() == (2 if name == "two_dimensions"
                                              else 3)
        for r in results.values():
            assert r["real_density"].dtype == np.complex128
            assert r["error_dict"]["main"].dtype == np.float64


def test_store_round_trip(tmp_path):
    from xframe_tpu_torch.projects.fxs.store import (flatten, load_npz,
                                                     save_npz)
    tree = {"a": {"b": np.arange(3), "s": "text", "x": 1.5, "n": None,
                  "flag": True, "ragged": [np.ones((2, 2)), np.zeros(3)],
                  "floats": [0.25, 0.5], "empty": []},
            "results": {"0": {"rho": np.ones((2, 3), np.complex64)}}}
    path = str(tmp_path / "tree.npz")
    save_npz(path, tree)
    assert "a/ragged/_list" in flatten(tree) and "a/n" not in flatten(tree)
    back = load_npz(path)
    assert back["a"]["s"] == "text" and back["a"]["x"] == 1.5
    assert bool(back["a"]["flag"]) and "n" not in back["a"]
    assert isinstance(back["a"]["ragged"], list) and back["a"]["empty"] == []
    assert np.array_equal(back["a"]["ragged"][1], np.zeros(3))
    assert np.array_equal(back["a"]["floats"], [0.25, 0.5])
    assert back["results"]["0"]["rho"].dtype == np.complex64
    assert "rho" not in load_npz(path, skip=("rho",))["a"]
    assert "rho" not in load_npz(path, skip=("rho",)).get("results", {})
    assert not os.path.exists(path + ".tmp")
