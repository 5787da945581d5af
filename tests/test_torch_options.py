"""The reconstruct options the port once refused, against the JAX package
(CPU).

  * error configurations: each metric set and combiner of the JAX `MTIP`
    (reciprocal l2_projection_diff, deg2_invariant_l2_diff at orders 0 and
    2, 'mean', 'min', 'max', 'prod', the real error outside the initial
    support) over three stepwise iterations, every column within 1e-4
    relative, and 'main' equal to its combiner of the columns;
  * the particle-number estimate: n_hat and the projected intensity of two
    restarts against the JAX estimate under vmap (n_hat exactly, I within
    1e-6 of max), and estimate_in gating (tests/test_reference_options.py:
    481);
  * the bucketed fixed-volume keep-mask against the JAX one and the sort
    (tests/test_phasing.py:618), two restarts in one call;
  * the minimax Newton–Schulz schedule at ns_sigma_min 1e-5 against the
    JAX generator within 1e-12;
  * the worker: the JAX chain simulate_ccd → extract at the pipeline
    test's sizes feeds both reconstruct workers, and with each option the
    set-up and the first iterations from the JAX worker's densities agree:
    the auto-correlation support away from its threshold (B5's grid of
    weights on the fused iteration), the error columns, the particle-number
    estimate (n_hat equal or next in the scan), the bucketed support, the
    computed schedule and a linked ft-stab schedule.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import xframe_tpu as xf
from xframe_tpu.ops import polar_schedule as jpolar
from xframe_tpu.projects.fxs import phasing as jph
from xframe_tpu.projects.fxs import projections as jp
from xframe_tpu.projects.fxs.demo import make_demo_problem as jax_demo
from xframe_tpu.projects.fxs.reconstruct import ProjectWorker as JaxWorker

from xframe_tpu_torch.convert import (mtip_arrays, mtip_from_numpy,
                                      save_invariants)
from xframe_tpu_torch.main import select_worker
from xframe_tpu_torch.ops import polar_schedule as tpolar
from xframe_tpu_torch.projects.fxs import phasing as tph
from xframe_tpu_torch.projects.fxs import projections as tp
from xframe_tpu_torch.settings import deep_update

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def demo():
    return jax_demo(12, 6, fused_sht=True)


def _segments(mod, specs, sigma=1.0):
    out = []
    for spec in specs:
        if spec[0] == "SW":
            out.append(mod.Segment("SW", sigma=sigma, threshold=0.1))
        else:
            m, n, beta = spec
            out.append(mod.Segment(m, n, betas=np.full(n, beta),
                                   ft_stab=True))
    return out


# ------------------------------------------------------- error metrics
COMBINED = {"real": ["l2_projection_diff"],
            "reciprocal": ["l2_projection_diff"]}
ERROR_CONFIGS = {
    "reciprocal_l2": {"reciprocal": ["l2_projection_diff"]},
    "deg2_order0": {"reciprocal": ["deg2_invariant_l2_diff"],
                    "deg2_order": 0},
    "deg2_order2": {"reciprocal": ["l2_projection_diff",
                                   "deg2_invariant_l2_diff"],
                    "main": {"metrics": {
                        "real": [], "reciprocal":
                            ["deg2_invariant_l2_diff"]}, "type": "mean"}},
    "mean": {"reciprocal": ["l2_projection_diff"],
             "main": {"metrics": COMBINED, "type": "mean"}},
    "min": {"reciprocal": ["l2_projection_diff"],
            "main": {"metrics": COMBINED, "type": "min"}},
    "max": {"reciprocal": ["l2_projection_diff"],
            "main": {"metrics": COMBINED, "type": "max"}},
    "prod": {"reciprocal": ["l2_projection_diff"],
             "main": {"metrics": COMBINED, "type": "prod"}},
    "unmasked_real": {"real_inside_initial_support": False},
}
COMBINERS = {"mean": np.mean, "min": np.min, "max": np.max, "prod": np.prod}


@pytest.mark.parametrize("name", sorted(ERROR_CONFIGS))
def test_error_config_matches_jax(demo, name):
    cfg = ERROR_CONFIGS[name]
    p = demo
    jm = jph.MTIP(p.ft, p.mtip.rc, p.mtip.real, p.mtip.sw,
                  p.integrator.w_broadcast, p.initial_support,
                  error_config=cfg)
    tm = mtip_from_numpy(*mtip_arrays(jm), device="cpu")
    assert tm._fi is None and tm.error_names == jm.error_names
    if "deg2_order" in cfg:
        assert tm._deg2_ref[0] == 0
    sigma = p.mtip.sw.default_sigma
    specs = [("HIO", 2, 0.5), ("SW",), ("ER", 1, 0.0)]
    r0 = np.array(p.initial_density_batch(6, 2))
    _, e_j = jax.jit(lambda r: jm.run_batch(
        r, _segments(jph, specs, sigma)))(r0)
    _, e_t = tm.run_batch(torch.as_tensor(r0), _segments(tph, specs, sigma))
    e_j, e_t = np.asarray(e_j), e_t.numpy()
    assert e_t.shape == e_j.shape == (2, 3, len(jm.error_names))
    np.testing.assert_allclose(e_t, e_j, rtol=TOL)
    names = tm.error_names
    if name in COMBINERS:
        cols = [names.index("real_l2_projection_diff"),
                names.index("reciprocal_l2_projection_diff")]
        np.testing.assert_allclose(
            e_t[..., 0], COMBINERS[name](e_t[..., cols], axis=-1), rtol=1e-6)
    if name == "deg2_order2":
        np.testing.assert_allclose(
            e_t[..., 0],
            e_t[..., names.index("reciprocal_deg2_invariant_l2_diff")],
            rtol=1e-6)


# ------------------------------------------------- particle number
def _pn_pair(pn_project):
    """The JAX test's ball problem (N = 16, L = 4) with the estimate's
    tables, and the port's MTIP on the same tables."""
    from xframe_tpu.ops.fourier import SphericalFourierTransform
    from xframe_tpu.library.shapes import spherical_grid, ball_density
    from xframe_tpu.projects.fxs import invariants as itools
    N, L = 16, 4
    ft = SphericalFourierTransform(N, L, q_max=0.4, mode="midpoint",
                                   reciprocity_coefficient=2.0,
                                   real_dtype=jnp.float32)
    grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
    radius = ft.r_max / 2.5
    rho = ball_density(grid, radius / 2, center=(radius / 2, 1.2, 0.7))
    psi = ft.forward(jnp.asarray(rho, dtype=jnp.complex64))
    coeff = np.asarray(ft.sht.forward((psi * psi.conj()).real))
    bl = itools.harmonic_coeff_to_deg2_invariants_3d(coeff).real.astype(
        complex)
    bl[1::2] = 0
    proj, _ = itools.deg2_invariant_to_projection_matrices(bl)
    avg = np.sqrt(np.abs(np.diag(bl[0]).real) / (4 * np.pi))
    rc = jp.ReciprocalConstraint.build(
        proj, ft.qs, L, average_intensity=avg, use_averaged_intensity=True,
        schmidt_scaling=False, pn_scan_space=(1.0, 9.0, 16),
        pn_project=pn_project)
    support = np.asarray(grid[..., 0] < radius * 1.3)
    w = np.ones_like(rho) * support
    jm = jph.MTIP(ft, rc, jp.RealConstraint(limit_imag=2.0),
                  jp.ShrinkWrap.build(ft.qs), w, support,
                  pn_estimate_in=("ER",))
    return jm, mtip_from_numpy(*mtip_arrays(jm), device="cpu"), rho, support


@pytest.mark.parametrize("pn_project", [False, True])
def test_particle_number_estimate_matches_jax(pn_project):
    """n_hat and the projected intensity of two restarts, the JAX estimate
    under vmap on the same intensities."""
    jm, tm, rho, _ = _pn_pair(pn_project)
    assert tm._pn_enabled and tm.rc.pn_project == pn_project
    rng = np.random.default_rng(4)
    psi = np.asarray(jm.ft.forward(jnp.asarray(rho, jnp.complex64)))
    base = np.asarray(jm.sht.inverse_real(jm.rc(jm.sht.forward_real(
        jnp.asarray(np.abs(psi) ** 2)))))
    I = np.stack([base, base + 0.2 * np.abs(base).max()
                  * rng.standard_normal(base.shape)]).astype(np.float32)
    n_j, I_j = jax.jit(jax.vmap(jm.rc.particle_number_estimate))(I)
    n_t, I_t = tm.rc.particle_number_estimate(torch.as_tensor(I))
    assert n_t.shape == (2,)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    I_j = np.asarray(I_j)
    assert np.abs(I_t.numpy() - I_j).max() <= 1e-6 * np.abs(I_j).max()


def test_particle_estimate_in_gating():
    """estimate_in ('ER'): HIO iterations report n_hat = 0, ER ones an
    estimate, on both restarts, as the JAX MTIP's."""
    jm, tm, rho, support = _pn_pair(False)
    rho0 = np.stack([rho * support, 0.8 * rho * support]).astype(
        np.complex64)
    sup = np.broadcast_to(support, rho0.shape)
    for method, beta in (("HIO", 0.5), ("ER", 0.0)):
        want = jax.vmap(lambda r, s: jm.mtip_iteration(
            r, s, beta, method, False))(jnp.asarray(rho0), jnp.asarray(sup))
        _, err, err_rec, extras = tm.mtip_iteration(
            torch.as_tensor(rho0), torch.as_tensor(sup.copy()), beta, method,
            False)
        n_hat = extras[0].numpy()
        np.testing.assert_array_equal(n_hat, np.asarray(want[3]))
        if method == "HIO":
            assert (n_hat == 0.0).all()
        else:
            assert (n_hat >= 1.0).all()
        np.testing.assert_allclose(err.numpy(), np.asarray(want[1]),
                                   rtol=TOL)


# ------------------------------------------------- bucketed shrink-wrap
def test_fixed_volume_bucketed_matches_jax_and_sort():
    """Two restarts in one call: the masks equal the sort's and the JAX
    bucketed ones on generic values; under heavy ties and on all-equal
    values the kept volume lies within one point's weight above the
    target."""
    rng = np.random.default_rng(7)
    shape = (24, 18, 36)
    conv = rng.gamma(2.0, 1.0, size=(2,) + shape).astype(np.float32)
    w_int = rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
    init = np.ones(shape, bool)
    for frac in (0.1, 0.37, 0.8):
        kw = dict(mode="fixed_volume", volume_fraction=frac,
                  integration_weights=w_int, initial_support=init)
        qs = np.linspace(0.01, 1, 24)
        j_b = jp.ShrinkWrap.build(qs, **kw, fixed_volume_method="bucketed")
        t_b = tp.ShrinkWrap.build(qs, **kw, fixed_volume_method="bucketed",
                                  device="cpu")
        t_s = tp.ShrinkWrap.build(qs, **kw, device="cpu")
        m_j = np.stack([np.asarray(jax.jit(j_b.new_support_fixed_volume)(
            jnp.asarray(c))) for c in conv])
        m_b = t_b.new_support_fixed_volume(torch.as_tensor(conv)).numpy()
        m_s = t_s.new_support_fixed_volume(torch.as_tensor(conv)).numpy()
        assert (m_b == m_s).all(), f"frac={frac}: bucketed against sort"
        assert (m_b == m_j).all(), f"frac={frac}: port against JAX"
    target = 0.5 * w_int.sum()
    w = torch.as_tensor(w_int.reshape(-1))
    for c in (np.floor(rng.uniform(0, 8, size=(2,) + shape)),
              np.ones((2,) + shape)):
        keep = tp.fixed_volume_keep_bucketed(
            torch.as_tensor(c.astype(np.float32).reshape(2, -1)), w,
            torch.full((2, 1), float(target)))
        vol = (keep.numpy() * w_int.reshape(-1)).sum(-1)
        assert ((vol - target >= 0)
                & (vol - target < w_int.max() * 1.001)).all(), (vol, target)


def test_polar_schedule_matches_jax():
    got = tpolar.default_or_computed_schedule(1e-5)
    want = jpolar.default_or_computed_schedule(1e-5)
    assert len(got) == len(want) == 11
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12,
                               atol=0)
    assert tpolar.default_or_computed_schedule(1e-7) \
        is tpolar.DEFAULT_SCHEDULE


# ------------------------------------------------------------ workers
L_SIM, N_SIM, L_REC, N_REC = 14, 48, 10, 24


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The JAX chain simulate_ccd → extract at the pipeline test's sizes in
    a temporary XFRAME_TPU_HOME; the invariants as the port's archive."""
    home = str(tmp_path_factory.mktemp("xf_options_home"))
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = home
    xf.select_project("fxs", "simulate_ccd", overrides={
        "structure_name": "opts", "dimensions": 3,
        "grid": {"n_radial_points": N_SIM, "max_order": L_SIM,
                 "max_q": 0.5},
        "shapes": {"types": ["sphere", "sphere"],
                   "centers": [[0, 0, 0], [30, 1.2, 0.7]],
                   "sizes": [20, 14], "densities": [1.0, 0.7],
                   "random_orientation": [False, False]},
        "cross_correlation": {"method": "back_substitution",
                              "xray_wavelength": 1.23984}})
    xf.run()
    xf.select_project("fxs", "extract", overrides={
        "structure_name": "opts", "dimensions": 3, "max_order": L_SIM})
    inv = xf.run()
    path = os.path.join(home, "opts_invariants.npz")
    save_invariants(inv, path)
    yield inv, path
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


def _overrides(extra, inv_path=None):
    ov = {"structure_name": "opts", "dimensions": 3, "particle_radius": 50,
          "grid": {"n_radial_points": N_REC, "max_order": L_REC},
          "multi_start": {"n_reconstructions": 2, "seed": 7},
          "main_loop": {"sub_loops": {
              "order": ["main"],
              "main": {"iterations": 1, "order": ["HIO", "SW", "ER"],
                       "methods": {"HIO": {"iterations": 3},
                                   "SW": {"iterations": 1},
                                   "ER": {"iterations": 3}}}}}}
    if inv_path is not None:
        ov["input"] = {"invariants_path": inv_path}
    return deep_update(ov, extra)


def _workers(chain, extra):
    """Both workers' MTIP, aux and schedule under the same overrides."""
    inv, path = chain
    xf.select_project("fxs", "reconstruct", overrides=_overrides(extra))
    jw = JaxWorker()
    jm, jft, jaux = jw.setup_mtip(inv)
    js = jw._build_schedule(jft)
    tw = select_worker("fxs", "reconstruct",
                       overrides=_overrides(extra, path), device="cpu")
    tm, tft, taux = tw.setup_mtip(tw._load_invariants())
    return (jm, jaux, js), (tm, taux, tw._build_schedule(tft))


def _first_iterations(j, t, n_seg=3):
    """The first n_seg schedule entries of both MTIPs from the JAX
    worker's densities. → (JAX state, errors, port state, errors)."""
    (jm, jaux, js), (tm, taux, ts) = j, t
    rho0 = np.array(jaux["initial_density_batch"](7, 2))
    s_j, e_j = jax.jit(lambda r: jm.run_batch(r, js[:n_seg]))(rho0)
    s_t, e_t = tm.run_batch(torch.as_tensor(rho0), ts[:n_seg])
    return s_j, np.asarray(e_j), s_t, e_t.numpy()


def _first_errors_close(e_j, e_t, cols=None):
    """Every column's first iteration and the first after the
    shrink-wrap within TOL relative."""
    cols = slice(None) if cols is None else cols
    for i in (0, 3):
        np.testing.assert_allclose(e_t[:, i, cols], e_j[:, i, cols],
                                   rtol=TOL)


WORKER_OPTIONS = {
    "auto_correlation_support": {"projections": {"real": {"projections": {
        "support": {"initial_support": {"type": "auto_correlation"}}}}}},
    "error_metrics": {"main_loop": {"error": {"methods": {
        "reciprocal": {"calculate": ["l2_projection_diff",
                                     "deg2_invariant_l2_diff"]},
        "main": {"metrics": COMBINED, "type": "max"}}}}},
    "particle_number": {"projections": {"reciprocal": {
        "number_of_particles": {"estimate": {
            "apply": True, "estimate_in": ["ER"], "project": True}}}}},
    "particle_number_bool_schema": {"projections": {"reciprocal": {
        "number_of_particles": {"estimate": True, "settings": {
            "estimate_in": ["ER"], "scan_space": [1.0, 6.0, 32]}}}}},
    "bucketed_shrink_wrap": {"projections": {"real": {"shrink_wrap": {
        "mode": "fixed_volume", "fixed_volume": {"method": "bucketed"}}}}},
    "ns_sigma_min": {"projections": {"reciprocal": {"ns_sigma_min": 1e-5}}},
    "linked_ft_stab": {
        "main_loop": {"sub_loops": {"main": {"methods": {
            "ER": {"iterations": 3,
                   "ft_stab": "link_to_enforce_initial_support",
                   "link_to_enforce_initial_support": {"delay": 1}}}}}}},
}


@pytest.mark.parametrize("name", sorted(WORKER_OPTIONS))
def test_worker_option_matches_jax(chain, name):
    j, t = _workers(chain, WORKER_OPTIONS[name])
    (jm, jaux, js), (tm, taux, ts) = j, t
    # the JAX worker on the CPU runs its stepwise iteration; the port's
    # leaves the fused one where the JAX MTIP does
    assert (tm._fi is None) == (name.startswith("particle_number")
                                or name == "error_metrics")
    assert tm.error_names == jm.error_names
    assert [(a.method, a.n, a.ft_stab_link_delay) for a in ts] \
        == [(b.method, b.n, b.ft_stab_link_delay) for b in js]
    s_j, e_j, s_t, e_t = _first_iterations(j, t)
    assert e_t.shape == e_j.shape
    if name == "auto_correlation_support":
        sup_j = np.asarray(jaux["initial_support"])
        sup_t = np.asarray(taux["initial_support"])
        assert not sup_t.all() and tm._fi is not None
        assert tm._k4_weights().dim() == 3
        # points where A is within 1e-5·max A of the threshold may flip
        A = tm.ft.inverse(tm.sht.inverse(torch.as_tensor(
            _dense(taux, tm)))).real.numpy()
        thr = 0.01 * A.max()
        clear = np.abs(A - thr) > 1e-5 * A.max()
        assert clear.mean() > 0.99
        assert np.array_equal(sup_t[clear], sup_j[clear])
    if name.startswith("particle_number"):
        # HIO does not estimate; the first ER iteration's estimate equals
        # JAX's or lies next to it in the scan (later ones follow a
        # projected, hence diverging, intensity)
        nj, nt = e_j[..., 2], e_t[..., 2]
        assert (nt[:, :3] == 0).all() and (nt[:, 3:] >= 1).all()
        Ns = tm.rc.pn_Ns.numpy()
        idx_j = np.searchsorted(Ns, nj[:, 3])
        idx_t = np.searchsorted(Ns, nt[:, 3])
        assert np.abs(idx_j - idx_t).max() <= 1, (nj, nt)
        _first_errors_close(e_j, e_t, cols=slice(0, 2))
    else:
        _first_errors_close(e_j, e_t)
    if name == "bucketed_shrink_wrap":
        assert tm.sw.fixed_volume_method == "bucketed"
        sup_j = np.broadcast_to(np.asarray(s_j.support), s_t.support.shape)
        assert (s_t.support.numpy() == sup_j).mean() > 0.999
    if name == "ns_sigma_min":
        np.testing.assert_allclose(np.asarray(tm.rc.ns_schedule),
                                   np.asarray(jm.rc.ns_schedule),
                                   rtol=1e-12, atol=0)
    if name == "linked_ft_stab":
        assert tm._fi is not None and tm._link_hist_len == 1
        assert np.array_equal(s_t.enforce_hist.numpy(),
                              np.asarray(s_j.enforce_hist))


def _dense(aux, tm):
    """The padded data coefficients the auto-correlation support
    synthesizes."""
    from xframe_tpu_torch.projects.fxs.reconstruct import pad_coeff_dense
    return pad_coeff_dense(aux["proj"], tm.ft.qs.shape[0],
                           tm.sht.l_max).astype(np.complex64)


@pytest.mark.parametrize("name", ["error_metrics", "particle_number"])
def test_worker_option_results(chain, name, tmp_path, monkeypatch):
    """The port's worker end to end with the option: the extra error
    curves under the JAX package's names, n_particles_history and the
    final n_particles."""
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    ov = _overrides(WORKER_OPTIONS[name], chain[1])
    res = select_worker("fxs", "reconstruct", overrides=ov,
                        device="cpu").run()
    for r in res["reconstruction_results"].values():
        ed = r["error_dict"]
        assert ed["main"].shape == (6,)
        if name == "error_metrics":
            np.testing.assert_allclose(
                ed["main"], np.maximum(ed["real_l2_projection_diff"],
                                       ed["reciprocal_l2_projection_diff"]),
                rtol=1e-6)
            assert (ed["reciprocal_deg2_invariant_l2_diff"] >= 0).all()
        else:
            assert r["n_particles_history"].shape == (6,)
            assert r["n_particles"] == r["n_particles_history"][-1] >= 1.0


# ------------------------------------------------------------------ C.2
# phase options' run (i): the fused iteration on the auto-correlation
# support (B5's weight grid) with linked ft-stab of delay 2 (the gate)
C2_OPTIONS = deep_update(
    {"main_loop": {"sub_loops": {"main": {"methods": {
        m: {"iterations": 3, "ft_stab": "link_to_enforce_initial_support",
            "link_to_enforce_initial_support": {"delay": 2}}
        for m in ("HIO", "ER")}}}}},
    WORKER_OPTIONS["auto_correlation_support"])


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _c2_runs(chain):
    """The first iteration of C2_OPTIONS from the JAX worker's densities
    and support in float32 and float64, in both packages. → ({(package,
    float64): error columns}, {(package, float64): (ft, sht, fused)},
    ρ0)."""
    inv, path = chain
    errors, modules = {}, {}
    for wide in (False, True):
        extra = deep_update(dict(C2_OPTIONS),
                            {"precision": "float64"} if wide else {})
        with jax.enable_x64(wide):
            xf.select_project("fxs", "reconstruct",
                              overrides=_overrides(extra))
            jw = JaxWorker()
            jm, jft, jaux = jw.setup_mtip(inv)
            js = jw._build_schedule(jft)
            if not wide:
                rho0 = np.array(jaux["initial_density_batch"](7, 2))
                support = np.asarray(jaux["initial_support"])
            r0 = rho0.astype(np.complex128 if wide else np.complex64)
            e = jax.jit(lambda r: jm.run_batch(r, js[:1])[1])(r0)
            errors["jax", wide] = np.asarray(e, np.float64)[:, 0]
            modules["jax", wide] = (jm.ft, jm.sht, None)
        tw = select_worker("fxs", "reconstruct",
                           overrides=_overrides(extra, path), device="cpu")
        tm, tft, _ = tw.setup_mtip(tw._load_invariants())
        assert (tm._fi is not None) == (not wide)
        assert wide or tm._k4_weights().dim() == 3
        tm.set_initial_support(support)
        e = tm.run_batch(torch.as_tensor(r0), tw._build_schedule(tft)[:1])[1]
        errors["torch", wide] = e.double().numpy()[:, 0]
        modules["torch", wide] = (tft, tm.sht, tm._fi)
    return errors, modules, rho0.astype(np.complex128)


def _local_step_errors(modules, rho):
    """Each step of the first iteration's forward half in float32 on the
    float64 run's inputs, against the float64 step, as relative L2
    distances: analysis, Hankel transform + synthesis, |ψ|² analysis."""
    out = {}
    for pkg in ("jax", "torch"):
        ft64, sht64, _ = modules[pkg, True]
        ft32, sht32, fi = modules[pkg, False]
        if pkg == "jax":
            with jax.enable_x64(True):
                def steps64(r):
                    c0 = ft64._analysis(r)
                    psi = ft64._synthesis(ft64.hankel.forward(c0))
                    return c0, psi, sht64.forward_real(
                        (psi * psi.conj()).real)
                ref = [np.asarray(x) for x in jax.vmap(steps64)(
                    jnp.asarray(rho))]
            low = [jax.vmap(ft32._analysis),
                   jax.vmap(lambda c: ft32._synthesis(ft32.hankel.forward(c))),
                   jax.vmap(lambda p: sht32.forward_real(
                       (p * p.conj()).real))]
            got = [np.asarray(f(jnp.asarray(x, jnp.complex64)))
                   for f, x in zip(low, (rho, ref[0], ref[1]))]
        else:
            r = torch.as_tensor(rho)
            c0 = ft64._analysis(r)
            psi = ft64._synthesis(ft64.hankel.forward(c0))
            ref = [c0.numpy(), psi.numpy(),
                   sht64.forward_real((psi * psi.conj()).real).numpy()]
            x32 = [torch.as_tensor(x).to(torch.complex64)
                   for x in (rho, ref[0], ref[1])]
            got = [ft32._analysis(x32[0]).numpy(),
                   fi.hankel_synthesize_plain(x32[1])[0].numpy(),
                   sht32.forward_real_abs2(x32[2]).numpy()]
        out[pkg] = [float(np.linalg.norm(g - w) / np.linalg.norm(w))
                    for g, w in zip(got, ref)]
    return out


def test_c2_float32_gap_is_the_reference_rounding(chain):
    """C.2 (ROADMAP §C): the port's plain float32 fused iteration on phase
    options' run (i) sits no farther from float64 than the JAX package's
    float32 run sits from its own float64 run; the two float64 runs agree
    to 1e-9; and each step's float32 rounding is the JAX step's within a
    factor 2 (scripts/torch_c2_float32.py runs the same at wider grids)."""
    errors, modules, rho0 = _c2_runs(chain)
    assert _rel(errors["torch", True], errors["jax", True]) <= 1e-9
    port = _rel(errors["torch", False], errors["torch", True])
    ref = _rel(errors["jax", False], errors["jax", True])
    assert 0 < port <= ref, (port, ref)
    local = _local_step_errors(modules, rho0)
    for step, (p, j) in enumerate(zip(local["torch"], local["jax"])):
        assert 0 < p <= 2 * j, (step, local)
