"""The port's fused MTIP iteration against the JAX package's (CPU).

The JAX side is make_demo_problem(16, 8, fused_sht=True, Newton–Schulz with
the minimax schedule), whose MTIP runs the fused iteration: the SHT analysis
(B1), the Hankel-fused synthesis (B6), the |ψ|² analysis (B3), the projection
with the ψ_p analysis (B4) and the fused update (B5), all Pallas kernels in
interpret mode. The port is built from the same host tables through
xframe_tpu_torch.convert and starts from the same numpy densities; it runs
the plain versions of its kernels. Tolerances as
tests/test_transforms.py:565-586: relative error-series difference < 1e-4
on iteration 1 and < 0.05 overall, final ρ within 0.05·max. The same
comparison holds the port's fused path to its stepwise path, the two
variants and their combination (JAX: XF_FUSED_K2FWD=0, XF_FUSED_ABS2=1;
port: k2_fwd=False, k1_abs2=True), and the fused path under newton_schulz_pallas at the
smallest size where the fused projection runs (L = 64, N_q = 16, the
smallest grid, on HIO 2 + SW + ER 1) against the JAX fused path with K5
and the polar kernel. MTIP.finalize is held to the JAX package's on the
same densities: ψ_p and V·W within 5e-3·max, the JAX bound for its polar
kernels against the jnp path (tests/test_phasing.py:389).
"""
import numpy as np
import pytest
import jax
import torch

from xframe_tpu.ops.polar_schedule import DEFAULT_SCHEDULE
from xframe_tpu.projects.fxs.demo import make_demo_problem as jax_demo
from xframe_tpu.projects.fxs import phasing as jph

from xframe_tpu_torch.convert import mtip_arrays, mtip_from_numpy
from xframe_tpu_torch.ops import fused_mtip
from xframe_tpu_torch.ops.fused_sht import METHODS
from xframe_tpu_torch.projects.fxs import phasing as tph
from xframe_tpu_torch.projects.fxs.demo import make_demo_problem

SPECS = [("HIO", 4, 0.5, True), ("SW",), ("ER", 2, 0.0, True),
         ("RAAR", 2, 0.7, False)]


def _schedule(mod, sigma):
    out = []
    for spec in SPECS:
        if spec[0] == "SW":
            out.append(mod.Segment("SW", sigma=sigma, threshold=0.1))
        else:
            m, n, beta, fts = spec
            out.append(mod.Segment(m, n, betas=np.full(n, beta),
                                   ft_stab=fts))
    return out


def _compare(s0, e0, s1, e1):
    e0, e1 = np.asarray(e0), np.asarray(e1)
    assert e0.shape == e1.shape
    rel = np.abs(e0 - e1) / (np.abs(e0) + 1e-9)
    assert rel[:, 0, :2].max() < 1e-4
    assert rel.max() < 0.05
    d0, d1 = np.asarray(s0.rho), np.asarray(s1.rho)
    assert np.abs(d0 - d1).max() < 0.05 * np.abs(d0).max()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX fused problem, its starting densities and its run."""
    p = jax_demo(16, 8, fused_sht=True, procrustes_method="newton_schulz",
                 ns_schedule=DEFAULT_SCHEDULE)
    assert p.mtip._fi is not None and p.mtip.best_mode == "eager"
    r0 = np.array(p.initial_density_batch(0, 2))
    sched = _schedule(jph, p.mtip.sw.default_sigma)
    state, errors = jax.jit(lambda r: p.mtip.run_batch(r, sched))(r0)
    return p, r0, state, errors


@pytest.fixture(scope="module")
def port(jax_run):
    """The port's fused MTIP on the JAX problem's tables."""
    arrays, config = mtip_arrays(jax_run[0].mtip)
    assert config["fused_pipeline"]
    return arrays, config, mtip_from_numpy(arrays, config, device="cpu")


def test_fused_slice_tracks_jax_fused(jax_run, port):
    p, r0, s0, e0 = jax_run
    tm = port[2]
    assert tm._fi is not None
    s1, e1 = tm.run_batch(torch.as_tensor(r0),
                          _schedule(tph, p.mtip.sw.default_sigma))
    _compare(s0, e0, s1, e1)
    b0, b1 = np.asarray(s0.best_err), s1.best_err.numpy()
    assert np.abs(b0 - b1).max() < 0.05 * np.abs(b0).max()
    assert tm.ft.harmonic.launches == dict.fromkeys(METHODS, 0)
    assert tm._fi.launches == dict.fromkeys(fused_mtip.METHODS, 0)


def test_fused_slice_tracks_port_stepwise(jax_run, port):
    p, r0, _, _ = jax_run
    arrays, config, tm = port
    stepwise = mtip_from_numpy(arrays, dict(config, fused_pipeline=False),
                               device="cpu")
    assert stepwise._fi is None
    sched = _schedule(tph, p.mtip.sw.default_sigma)
    s0, e0 = stepwise.run_batch(torch.as_tensor(r0), sched)
    s1, e1 = tm.run_batch(torch.as_tensor(r0), sched)
    _compare(s0, e0, s1, e1)


def test_fused_restarts_are_independent(jax_run, port):
    """Each restart of a batch runs as it would alone: per-restart anchor,
    sums, q = 0 rows and best tracking."""
    p, r0, _, _ = jax_run
    tm = port[2]
    sched = _schedule(tph, p.mtip.sw.default_sigma)[:3]
    r = torch.as_tensor(r0).clone()
    r[1] *= 3.0
    s2, e2 = tm.run_batch(r, sched)
    for b in range(2):
        s1, e1 = tm.run_batch(r[b:b + 1], sched)
        assert torch.allclose(e1[0], e2[b], rtol=1e-4, atol=0)
        assert torch.equal(s1.support[0], s2.support[b])


def test_demo_problem_picks_the_fused_iteration():
    """make_demo_problem yields the fused MTIP, as the JAX demo does;
    fused_pipeline=False keeps the stepwise one; 'lazy' best tracking
    resolves to eager, and so does 'replay' on the stepwise path, while the
    fused path keeps it (as the JAX package does)."""
    p = make_demo_problem(8, 4, procrustes_method="newton_schulz",
                          device="cpu")
    m = p.mtip
    assert isinstance(m._fi, fused_mtip.FusedIteration)
    assert m._w2d is not None and tuple(m._w2d.shape) == (8, m.sht.n_theta)

    def build(**kw):
        return tph.MTIP(p.ft, m.rc, m.real, m.sw,
                        p.integrator.w_broadcast.numpy(), p.initial_support,
                        device="cpu", **kw)
    assert build(fused_pipeline=False)._fi is None
    assert build(fused_pipeline=True)._fi is not None
    assert build(best_mode="lazy").best_mode == "eager"
    assert build(fused_pipeline=False, best_mode="replay").best_mode \
        == "eager"
    assert build(best_mode="replay").best_mode == "replay"
    rho0 = p.initial_density_batch(0, 2)
    _, errors = m.run_batch(rho0, [tph.Segment("HIO", 2, betas=np.full(2, 0.5),
                                               ft_stab=True)])
    assert errors.shape == (2, 2, 2) and bool(torch.isfinite(errors).all())
    assert m._fi.launches == dict.fromkeys(fused_mtip.METHODS, 0)


def test_fused_anchor_matches_the_stepwise_anchor(jax_run, port):
    """The anchor scalar from the sums z, z2 rotates ρ as the stepwise
    _anchor_global_phase does."""
    tm = port[2]
    rho = torch.as_tensor(jax_run[1]) * torch.tensor(np.exp(0.9j),
                                                     dtype=torch.complex64)
    c = tm._anchor_scalar(*tm._anchor_stats(rho))
    want = tm._anchor_global_phase(rho)
    got = rho * c[:, None, None, None]
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("variant,env", [
    ("k2_fwd", "XF_FUSED_K2FWD"), ("k1_abs2", "XF_FUSED_ABS2"),
    ("both", "XF_FUSED_K2FWD,XF_FUSED_ABS2")])
def test_fused_variants_track_jax(monkeypatch, variant, env):
    """The fused iteration without the ψ_p analysis in the projection (B11,
    then B1), with the |ψ|²-fused synthesis (B12), and with both, each
    against the JAX package run with its environment switches."""
    settings = {"XF_FUSED_K2FWD": "0", "XF_FUSED_ABS2": "1"}
    for name in env.split(","):
        monkeypatch.setenv(name, settings[name])
    p = jax_demo(16, 8, fused_sht=True, procrustes_method="newton_schulz",
                 ns_schedule=DEFAULT_SCHEDULE)
    assert p.mtip._fi is not None
    r0 = np.array(p.initial_density_batch(0, 2))
    sched = _schedule(jph, p.mtip.sw.default_sigma)
    s0, e0 = jax.jit(lambda r: p.mtip.run_batch(r, sched))(r0)
    arrays, config = mtip_arrays(p.mtip)
    tm = mtip_from_numpy(arrays, config, device="cpu")
    assert (tm.k2_fwd, tm.k1_abs2) == {"k2_fwd": (False, False),
                                       "k1_abs2": (True, True),
                                       "both": (False, True)}[variant]
    s1, e1 = tm.run_batch(torch.as_tensor(r0),
                          _schedule(tph, p.mtip.sw.default_sigma))
    _compare(s0, e0, s1, e1)
    assert tm._fi.launches == dict.fromkeys(fused_mtip.METHODS, 0)


@pytest.fixture(scope="module")
def pallas_run():
    """The JAX fused problem under newton_schulz_pallas at L = 64, N_q = 16
    on the smallest grid (θ ≥ L+1, φ ≥ 2L+1), its run, and the port's MTIP
    on its tables."""
    p = jax_demo(16, 64, n_theta=65, n_phi=130, fused_sht=True,
                 procrustes_method="newton_schulz_pallas",
                 ns_schedule=DEFAULT_SCHEDULE)
    assert p.mtip._fi is not None and p.mtip.rc.k5_active
    r0 = np.array(p.initial_density_batch(0, 2))
    sigma = p.mtip.sw.default_sigma
    sched = [jph.Segment("HIO", 2, betas=np.full(2, 0.5), ft_stab=True),
             jph.Segment("SW", sigma=sigma, threshold=0.1),
             jph.Segment("ER", 1, betas=np.zeros(1), ft_stab=True)]
    state, errors = jax.jit(lambda r: p.mtip.run_batch(r, sched))(r0)
    arrays, config = mtip_arrays(p.mtip)
    tm = mtip_from_numpy(arrays, config, device="cpu")
    return p, r0, state, errors, tm


def test_pallas_slice_tracks_jax_fused(pallas_run):
    p, r0, s0, e0, tm = pallas_run
    assert tm._fi is not None and tm.rc.k5_active
    sigma = p.mtip.sw.default_sigma
    sched = [tph.Segment("HIO", 2, betas=np.full(2, 0.5), ft_stab=True),
             tph.Segment("SW", sigma=sigma, threshold=0.1),
             tph.Segment("ER", 1, betas=np.zeros(1), ft_stab=True)]
    s1, e1 = tm.run_batch(torch.as_tensor(r0), sched)
    _compare(s0, e0, s1, e1)


def test_finalize_matches_jax(pallas_run):
    """ψ_p and the unknowns of the JAX run's best densities; W is compared
    as V·W, which is what the projection uses (W itself is not comparable
    where 2l+1 > n_q, ROADMAP §C)."""
    p, _, s0, _, tm = pallas_run
    rho = np.array(s0.best_rho)
    psi_p, W = tm.finalize(torch.as_tensor(rho))
    assert psi_p.shape == rho.shape
    vw = (tm.rc.V_pad @ W).numpy()
    jv = np.asarray(p.mtip.rc.V_pad)
    for r in range(2):
        pp_ref, w_ref = jax.jit(p.mtip.finalize)(rho[r])
        pp_ref = np.asarray(pp_ref)
        assert np.abs(psi_p[r].numpy() - pp_ref).max() \
            < 5e-3 * np.abs(pp_ref).max()
        vw_ref = jv @ np.asarray(w_ref)
        assert np.abs(vw[r] - vw_ref).max() < 5e-3 * np.abs(vw_ref).max()
