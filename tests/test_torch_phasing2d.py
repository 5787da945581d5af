"""The port's 2D (polar) MTIP against the JAX package's (CPU).

  * set-up: make_demo_problem_2d builds the same problem (the true density
    exactly, the averaged intensity and v_m v_m† within 1e-6 of max, the
    supports and weights exactly);
  * the iteration: from the JAX problem's initial densities both MTIPs give
    the first iteration's errors within 1e-4 for HIO, ER and RAAR with and
    without ft-stab, and eight iterations of each within 1e-4 (the
    small-slice series is chaotic past a shrink-wrap, so longer runs are
    held by their convergence, below);
  * convert: the port's MTIP built from the JAX one's arrays
    (mtip_arrays / mtip_from_numpy) computes the same first iteration;
  * tests/test_phasing2d.py's convergence, invariant fingerprint and
    multi-start checks, and tests/test_pipeline2d.py's SO(2) gauge pin,
    repeated on the port.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from xframe_tpu.projects.fxs.demo import make_demo_problem_2d as jax_problem
from xframe_tpu.projects.fxs.phasing import Segment as JSegment

from xframe_tpu_torch.convert import mtip_arrays, mtip_from_numpy
from xframe_tpu_torch.projects.fxs import invariants as itools
from xframe_tpu_torch.projects.fxs.demo import make_demo_problem_2d
from xframe_tpu_torch.projects.fxs.phasing import MTIP, Segment

TOL = 1e-4


@pytest.fixture(scope="module")
def problems():
    return jax_problem(24, 12, 64), make_demo_problem_2d(24, 12, 64,
                                                         device="cpu")


def _gram(V):
    return np.einsum("mq,mp->mqp", V, V.conj())


def test_setup_matches_jax(problems):
    pj, pt = problems
    np.testing.assert_array_equal(pt.rho_true, pj.rho_true)
    np.testing.assert_array_equal(pt.initial_support, pj.initial_support)
    np.testing.assert_array_equal(pt.ft.rs, pj.ft.rs)
    avg = pj.average_intensity
    assert np.abs(pt.average_intensity - avg).max() <= 1e-6 * np.abs(avg).max()
    gj = _gram(np.asarray(pj.mtip.rc.V))
    gt = _gram(pt.mtip.rc.V.numpy())
    assert np.abs(gt - gj).max() <= 1e-6 * np.abs(gj).max()
    assert np.abs(pt.bm - pj.bm).max() <= 1e-6 * np.abs(pj.bm).max()
    np.testing.assert_array_equal(pt.mtip._w_err.numpy(),
                                  np.asarray(pj.mtip._w_err))
    np.testing.assert_array_equal(pt.mtip._w_rec.numpy(),
                                  pj.mtip._w_rec_host)
    assert pt.mtip._fi is None and pt.mtip.best_mode == "eager"
    assert pt.mtip.sw.default_sigma == pytest.approx(pj.mtip.sw.default_sigma)


def _jax_errors(mtip, rho0, schedule):
    return np.stack([np.asarray(mtip.run(jnp.asarray(r), schedule)[1])
                     for r in rho0])


@pytest.mark.parametrize("method,beta", [("HIO", 0.5), ("ER", 0.0),
                                         ("RAAR", 0.7)])
@pytest.mark.parametrize("ft_stab", [True, False])
@pytest.mark.parametrize("n", [1, 8])
def test_iterations_match_jax(problems, method, beta, ft_stab, n):
    pj, pt = problems
    rho0 = np.array(pj.initial_density_batch(3, 2))
    want = _jax_errors(pj.mtip, rho0, [JSegment(
        method, n, betas=np.full(n, beta), ft_stab=ft_stab)])
    state, got = pt.mtip.run_from(pt.mtip.initial_state_batch(rho0), [
        Segment(method, n, betas=np.full(n, beta), ft_stab=ft_stab)])
    assert got.shape == (2, n, 2)
    assert np.abs(got.numpy() - want[..., :2]).max() <= TOL


def test_mtip_from_jax_arrays(problems):
    pj, _ = problems
    arrays, config = mtip_arrays(pj.mtip)
    assert config["dimensions"] == 2
    tm = mtip_from_numpy(arrays, config, device="cpu")
    rho0 = np.array(pj.initial_density_batch(5, 2))
    seg = [("HIO", 1, 0.5, True)]
    want = _jax_errors(pj.mtip, rho0, [JSegment(m, n, betas=np.full(n, b),
                                                ft_stab=f)
                                       for m, n, b, f in seg])
    _, got = tm.run_from(tm.initial_state_batch(rho0), [
        Segment(m, n, betas=np.full(n, b), ft_stab=f) for m, n, b, f in seg])
    assert np.abs(got.numpy() - want[..., :2]).max() <= TOL


def test_phasing2d_converges_and_recovers_invariants():
    p = make_demo_problem_2d(32, 16, 64, device="cpu")
    mtip = p.mtip
    schedule = [
        Segment("HIO", 40, betas=np.full(40, 0.5), ft_stab=True),
        Segment("SW", sigma=mtip.sw.default_sigma * 2, threshold=0.09),
        Segment("ER", 20, betas=np.zeros(20), ft_stab=True),
        Segment("SW", sigma=mtip.sw.default_sigma, threshold=0.09),
        Segment("ER", 40, betas=np.zeros(40), ft_stab=True),
    ]
    state, errors = mtip.run_batch(p.initial_density_batch(7, 1), schedule)
    errors = errors.numpy()[0]
    assert np.isfinite(errors).all()
    assert errors[-1, 0] < 0.2 * errors[:5, 0].mean()
    psi = p.ft.forward(state.best_rho[0])
    bm_rec = itools.harmonic_coeff_to_deg2_invariants_2d(
        p.cht.forward((psi * psi.conj()).real)).numpy()
    s = slice(4, None)
    for m in [0, 2, 4]:
        scale = np.abs(p.bm[m][s, s]).max()
        rel = np.abs(np.abs(bm_rec[m][s, s])
                     - np.abs(p.bm[m][s, s])).max() / scale
        assert rel < 0.35, f"m={m}: invariant mismatch {rel}"


def test_phasing2d_multi_start():
    p = make_demo_problem_2d(24, 12, 64, device="cpu")
    schedule = [
        Segment("HIO", 10, betas=np.full(10, 0.5), ft_stab=True),
        Segment("SW", sigma=p.mtip.sw.default_sigma, threshold=0.09),
        Segment("ER", 5, betas=np.zeros(5), ft_stab=True),
    ]
    states, errors = p.mtip.run_batch(p.initial_density_batch(0, 3),
                                      schedule)
    errors = errors.numpy()
    assert errors.shape == (3, 15, 2)
    assert np.isfinite(errors).all()
    assert (errors[:, -1, 0] < errors[:, 0, 0]).all()


def test_so2_gauge_pin():
    """With the pin the pinned order's unknown is exactly 1 and phasing
    still converges."""
    from dataclasses import replace
    p = make_demo_problem_2d(24, 10, 64, device="cpu")
    rc = replace(p.mtip.rc, so_pin_order=2)
    mtip = MTIP(p.ft, rc, p.mtip.real, p.mtip.sw, p.mtip._w_err.numpy(),
                p.initial_support, harmonic=p.cht, device="cpu")
    rho0 = p.initial_density_batch(1, 1)
    psi = p.ft.forward(rho0)
    phases = rc.approximate_unknowns(p.cht.forward(
        (psi * psi.conj()).real)).numpy()[0]
    assert phases[2] == 1.0
    assert np.allclose(np.abs(phases[::2][1:]), 1.0, atol=1e-5)
    sched = [Segment("HIO", 10, betas=np.full(10, 0.5), ft_stab=True),
             Segment("ER", 5, betas=np.zeros(5))]
    _, errors = mtip.run_batch(rho0, sched)
    e = errors.numpy()[0, :, 0]
    assert np.isfinite(e).all() and e[-1] < e[0]


def test_replay_resolves_to_eager(problems):
    """The stepwise 2D iteration has no replay: best_mode 'replay' runs
    eager, as in the JAX package, and a run tracks its best."""
    _, pt = problems
    m = pt.mtip
    mtip = MTIP(pt.ft, m.rc, m.real, m.sw, m._w_err.numpy(),
                pt.initial_support, harmonic=pt.cht, best_mode="replay",
                device="cpu")
    assert mtip.best_mode == "eager"
    state, errors = mtip.run_batch(pt.initial_density_batch(2, 2), [
        Segment("HIO", 4, betas=np.full(4, 0.5), ft_stab=True)])
    assert torch.equal(state.best_err, errors[..., 0].min(dim=1).values)
