"""The port's MTIP slice against the JAX package's stepwise path (CPU).

The JAX side is make_demo_problem(16, 8, fused_sht=True, Newton–Schulz with
the minimax schedule) rebuilt as MTIP(..., fused_pipeline=False): it runs the
four SHT Pallas kernels in interpret mode. The port is built from the same
host tables through xframe_tpu_torch.convert, and both start from the same
numpy densities. Tolerances as tests/test_transforms.py:565-586: relative
error-series difference < 1e-4 on iteration 1 and < 0.05 overall, final ρ
within 0.05·max.
"""
import numpy as np
import pytest
import jax
import torch

from xframe_tpu.ops.polar_schedule import DEFAULT_SCHEDULE
from xframe_tpu.projects.fxs.demo import make_demo_problem as jax_demo
from xframe_tpu.projects.fxs import phasing as jph

from xframe_tpu_torch.convert import (mtip_arrays, mtip_from_numpy,
                                      state_from_numpy)
from xframe_tpu_torch.ops.fused_sht import METHODS
from xframe_tpu_torch.projects.fxs import phasing as tph
from xframe_tpu_torch.projects.fxs.demo import make_demo_problem


def _schedules(sigma, specs):
    """The same schedule for both packages from (method, n, beta, ft_stab)
    tuples; SW, SNAPSHOT and RESET_TO_BEST as markers."""
    out = {"jax": [], "torch": []}
    for spec in specs:
        for pkg, mod in (("jax", jph), ("torch", tph)):
            if spec[0] == "SW":
                out[pkg].append(mod.Segment("SW", sigma=sigma, threshold=0.1))
            elif spec[0] in ("SNAPSHOT", "RESET_TO_BEST"):
                out[pkg].append(mod.Segment(spec[0]))
            else:
                m, n, beta, fts = spec
                out[pkg].append(mod.Segment(m, n, betas=np.full(n, beta),
                                            ft_stab=fts))
    return out["jax"], out["torch"]


def _stepwise(p):
    return jph.MTIP(p.ft, p.mtip.rc, p.mtip.real, p.mtip.sw,
                    p.integrator.w_broadcast, p.initial_support,
                    enforce_initial_support_limit=6e-3, fused_pipeline=False)


@pytest.fixture(scope="module")
def jax_problem():
    return jax_demo(16, 8, fused_sht=True, procrustes_method="newton_schulz",
                    ns_schedule=DEFAULT_SCHEDULE)


def _compare(s0, e0, s1, e1):
    e0, e1 = np.asarray(e0), e1.numpy()
    assert e0.shape == e1.shape
    rel = np.abs(e0 - e1) / (np.abs(e0) + 1e-9)
    assert rel[:, 0, :2].max() < 1e-4
    assert rel.max() < 0.05
    d0, d1 = np.asarray(s0.rho), s1.rho.numpy()
    assert np.abs(d0 - d1).max() < 0.05 * np.abs(d0).max()


def test_slice_tracks_jax_stepwise(jax_problem):
    p = jax_problem
    jm = _stepwise(p)
    assert jm._fi is None and jm.sht is p.ft._fused
    tm = mtip_from_numpy(*mtip_arrays(jm), device="cpu")
    js, ts = _schedules(p.mtip.sw.default_sigma, [
        ("HIO", 4, 0.5, True), ("SW",), ("ER", 2, 0.0, True),
        ("RAAR", 2, 0.7, False)])
    r0 = np.array(p.initial_density_batch(0, 2))
    s0, e0 = jax.jit(lambda r: jm.run_batch(r, js))(r0)
    s1, e1 = tm.run_batch(torch.as_tensor(r0), ts)
    _compare(s0, e0, s1, e1)
    assert tm.ft.harmonic.launches == dict.fromkeys(METHODS, 0)


def test_svd_path_with_best_markers_tracks_jax():
    """Plain (unfused) JAX MTIP with the SVD Procrustes, SNAPSHOT/RESET
    markers and no ft-stab in one segment; the port resumes a run from a
    state carried across as numpy and lands on the same place."""
    p = jax_demo(16, 8)
    js, ts = _schedules(p.mtip.sw.default_sigma, [
        ("HIO", 3, 0.5, False), ("SNAPSHOT",), ("ER", 3, 0.0, True),
        ("SW",), ("RESET_TO_BEST",), ("RAAR", 2, 0.7, True)])
    tm = mtip_from_numpy(*mtip_arrays(p.mtip), device="cpu")
    r0 = np.array(p.initial_density_batch(3, 2))
    s0, e0 = jax.jit(lambda r: p.mtip.run_batch(r, js))(r0)
    s1, e1 = tm.run_batch(torch.as_tensor(r0), ts)
    _compare(s0, e0, s1, e1)
    assert np.array_equal(np.asarray(s0.support), s1.support.numpy())
    b0, b1 = np.asarray(s0.best_err), s1.best_err.numpy()
    assert np.abs(b0 - b1).max() < 0.05 * np.abs(b0).max()
    # resume: first two segments, carry the state across, run the rest
    sa, ea = tm.run_batch(torch.as_tensor(r0), ts[:2])
    state = state_from_numpy(sa.rho.numpy(), sa.support.numpy(), "cpu",
                             best_rho=sa.best_rho.numpy(),
                             best_mask=sa.best_mask.numpy(),
                             best_err=sa.best_err.numpy(),
                             last_err=sa.last_err.numpy())
    state = state._replace(err_snapshot=sa.err_snapshot)
    sb, eb = tm.run_from(state, ts[2:])
    assert torch.equal(torch.cat([ea, eb], dim=1), e1)
    assert torch.equal(sb.rho, s1.rho)


def test_restarts_are_independent(jax_problem):
    """Each restart of a batch runs as it would alone (per-restart anchor,
    errors, shrink-wrap thresholds and best tracking)."""
    tm = mtip_from_numpy(*mtip_arrays(_stepwise(jax_problem)), device="cpu")
    _, ts = _schedules(jax_problem.mtip.sw.default_sigma, [
        ("HIO", 2, 0.5, True), ("SW",), ("ER", 2, 0.0, True)])
    r0 = torch.as_tensor(np.array(jax_problem.initial_density_batch(1, 2)))
    r0[1] *= 3.0
    s2, e2 = tm.run_batch(r0, ts)
    for r in range(2):
        s1, e1 = tm.run_batch(r0[r:r + 1], ts)
        assert torch.allclose(e1[0], e2[r], rtol=1e-4, atol=0)
        assert torch.equal(s1.support[0], s2.support[r])


def test_demo_problem_builds_jax_tables(jax_problem):
    """The port's own make_demo_problem reproduces the JAX problem's tables
    and data (≤1e-5·max); projection matrices compare as V_l V_l†, which the
    eigenvector phase convention does not touch."""
    j = jax_problem
    t = make_demo_problem(16, 8, fused_sht=True,
                          procrustes_method="newton_schulz",
                          ns_schedule=DEFAULT_SCHEDULE, device="cpu")

    def close(got, want, tol=1e-5):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol * np.abs(want).max()

    arrays, _ = mtip_arrays(_stepwise(j))
    close(t.ft.rs, arrays["rs"])
    close(t.ft.qs, arrays["qs"])
    close(t.ft.sht._P.numpy(), arrays["sht_P"])
    close(t.ft.sht._PW.numpy(), arrays["sht_PW"])
    close(t.ft.hankel._wf.numpy(), arrays["h_wf"])
    close(t.ft.hankel._wi.numpy(), arrays["h_wi"])
    for name in ("E_re", "E_im", "I_re", "I_im", "PW", "P_t"):
        close(getattr(t.ft.harmonic, "_" + name).numpy(),
              arrays["fused_" + name])
    assert np.array_equal(t.initial_support, j.initial_support)
    close(t.mtip._w_err.numpy(),
          arrays["w_err"] * arrays["initial_support"])
    close(t.mtip._w_rec.numpy(), arrays["w_rec"])
    close(t.mtip.sw.q_radii.numpy(), arrays["q_radii"])
    close(t.bl, j.bl)
    close(t.average_intensity, j.average_intensity)
    assert abs(t.total_intensity - j.total_intensity) \
        <= 1e-5 * abs(j.total_intensity)
    for vt, vj in zip(t.projection_matrices, j.projection_matrices):
        close(vt @ vt.conj().T, vj @ vj.conj().T)
    vt, vj = t.mtip.rc.V_pad.numpy(), np.asarray(j.mtip.rc.V_pad)
    close(vt @ vt.conj().transpose(0, 2, 1), vj @ vj.conj().transpose(0, 2, 1))
    assert t.mtip.sw.default_sigma == pytest.approx(j.mtip.sw.default_sigma)
    rho0 = t.initial_density_batch(0, 2)
    assert rho0.shape == (2,) + t.ft.grid_shape
    assert torch.isfinite(torch.view_as_real(rho0)).all()


def test_build_schedule_matches_jax():
    main = {"order": ["a", "b"],
            "a": {"iterations": 2, "order": ["HIO", "SW", "ER"],
                  "methods": {"HIO": {"iterations": 3}, "SW": 1,
                              "ER": {"iterations": 2, "ft_stab": False}},
                  "best_density_not_in_first_n_iterations": 1},
            "b": {"iterations": 1, "order": ["SW", "RAAR", "ER_non_FXS"],
                  "methods": {"SW": 2, "RAAR": 4, "ER_non_FXS": 1}}}
    args = (main, [[0.9, 0.5, 0.01, 10], [0.7, 0.7, -0.01, 10]],
            [[2.0, [1.0, 3]], False], [0.2, [0.1, [0.05, 2]]],
            {"a": {"HIO": True}, "b": {"RAAR": True}}, 1.5)
    js, ts = jph.build_schedule(*args), tph.build_schedule(*args)
    assert len(js) == len(ts) > 0
    for a, b in zip(js, ts):
        assert (a.method, a.n, a.ft_stab, a.sigma, a.threshold,
                a.ft_stab_link_delay) == (b.method, b.n, b.ft_stab, b.sigma,
                                          b.threshold, b.ft_stab_link_delay)
        if a.betas is not None:
            assert np.array_equal(a.betas, b.betas)


def test_unported_paths_raise(jax_problem):
    """Once refused: a linked segment now runs, stepwise eager and fused
    replay, and before any shrink-wrap its gate is shut, so it equals the
    segment without ft-stab (tests/test_torch_dynamic_ft_stab.py holds the
    rest)."""
    p = jax_problem
    tm = mtip_from_numpy(*mtip_arrays(_stepwise(p)), device="cpu")
    r0 = torch.as_tensor(np.array(p.initial_density_batch(2, 1)))
    replay = tph.MTIP(tm.ft, tm.rc, tm.real, tm.sw, tm._w_err.numpy(),
                      tm.initial_support.numpy(), fused_pipeline=True,
                      best_mode="replay", device="cpu")
    for m in (tm, replay):
        linked, e_l = m.run_batch(r0, [tph.Segment(
            "HIO", 2, betas=np.ones(2), ft_stab=True, ft_stab_link_delay=2)])
        assert linked.enforce_hist.shape == (1, 2)
        _, e_off = m.run_batch(r0, [tph.Segment("HIO", 2, betas=np.ones(2),
                                                ft_stab=False)])
        np.testing.assert_allclose(e_l.numpy(), e_off.numpy(), rtol=1e-5)


# ------------------------------------------------- error_config (ROADMAP C.1)
def _demo_mtip(error_config):
    p = make_demo_problem(8, 4, procrustes_method="newton_schulz",
                          device="cpu")
    m = p.mtip
    return p, tph.MTIP(p.ft, m.rc, m.real, m.sw,
                       p.integrator.w_broadcast.numpy(), p.initial_support,
                       enforce_initial_support_limit=m.enforce_limit,
                       error_config=error_config, device="cpu")


def test_worker_default_error_config_runs_fused():
    """The reconstruct worker's default error_config is the default: the
    fused iteration, and the same five errors bitwise as with None."""
    from xframe_tpu_torch.projects.fxs.reconstruct import _error_config
    from xframe_tpu_torch.settings import load_settings
    cfg = _error_config(load_settings("reconstruct"))
    assert cfg["real"] == ["l2_projection_diff"] and cfg["main"]
    errs = {}
    for key, ec in (("default", cfg), ("none", None)):
        p, m = _demo_mtip(ec)
        assert m._fi is not None
        _, errs[key] = m.run_batch(
            p.initial_density_batch(0, 2),
            [tph.Segment("HIO", 5, betas=np.full(5, 0.5), ft_stab=True)])
    assert errs["default"].shape == (2, 5, 2)
    assert torch.equal(errs["default"], errs["none"])


@pytest.mark.parametrize("error_config,exc", [
    ({"real": ["l1_diff"]}, ValueError),
    ({"reciprocal": ["no_such_metric"]}, ValueError),
    ({"main": {"metrics": {"real": ["l2_projection_diff"],
                           "reciprocal": ["unknown"]}}}, ValueError),
    ({"reciprocal": ["deg2_invariant_l2_diff"]}, None),
    ({"reciprocal": ["l2_projection_diff"]}, None),
    ({"main": {"metrics": {"real": ["l2_projection_diff"]},
               "type": "max"}}, None),
    ({"main": {"type": "prod"}}, None),
    ({"real_inside_initial_support": False}, None),
])
def test_error_config_refusals(jax_problem, error_config, exc):
    """Unknown metrics raise ValueError; the configurations the port once
    refused build the stepwise MTIP with the JAX package's error columns,
    and two iterations match the JAX MTIP's within 1e-4 relative."""
    if exc is not None:
        with pytest.raises(exc):
            _demo_mtip(error_config)
        return
    p = jax_problem
    jm = jph.MTIP(p.ft, p.mtip.rc, p.mtip.real, p.mtip.sw,
                  p.integrator.w_broadcast, p.initial_support,
                  error_config=error_config)
    tm = mtip_from_numpy(*mtip_arrays(jm), device="cpu")
    assert jm._fi is None and tm._fi is None
    assert tm.error_names == jm.error_names
    js, ts = _schedules(p.mtip.sw.default_sigma, [("HIO", 2, 0.5, True)])
    r0 = np.array(p.initial_density_batch(4, 2))
    _, e0 = jax.jit(lambda r: jm.run_batch(r, js))(r0)
    _, e1 = tm.run_batch(torch.as_tensor(r0), ts)
    e0 = np.asarray(e0)
    assert e1.shape == e0.shape == (2, 2, len(jm.error_names))
    np.testing.assert_allclose(e1.numpy(), e0, rtol=1e-4)
