"""The port's MTIP projection operators against the JAX package's (CPU).

Same numpy inputs through both; tolerance 1e-5·max (float32 matmuls and
reductions in another order). The Newton–Schulz crop path of
`approximate_unknowns` only runs for 2L+1 > 128, so it is tested at L=64.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from xframe_tpu.ops.polar_schedule import DEFAULT_SCHEDULE
from xframe_tpu.projects.fxs import projections as jp
from xframe_tpu_torch.projects.fxs import projections as tp

TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


@pytest.mark.parametrize("schedule", [None, DEFAULT_SCHEDULE],
                         ids=["fixed", "minimax"])
def test_newton_schulz_polar(schedule):
    """In float64 the two packages run the same iteration (≤1e-5·max; the
    schedule's coefficients are float32-rounded in both). In float32 both
    sit at the iteration's rounding floor, ~1e-5 from the float64 result
    for the minimax schedule, whose first step has coefficients up to 24:
    the port must stay within 1e-4 of it there."""
    m = _cplx(np.random.default_rng(0), (3, 12, 12))
    with jax.enable_x64(True):
        want = np.asarray(jp.polar_unitary_newton_schulz(
            jnp.asarray(m, dtype=jnp.complex128), 16, schedule=schedule))
    got = tp.polar_unitary_newton_schulz(
        torch.as_tensor(m, dtype=torch.complex128), 16,
        schedule=schedule).numpy()
    assert _rel(got, want) < TOL
    got32 = tp.polar_unitary_newton_schulz(torch.as_tensor(m), 16,
                                           schedule=schedule).numpy()
    assert np.abs(got32 - want).max() < 1e-4
    assert np.abs(got32.conj().transpose(0, 2, 1) @ got32
                  - np.eye(12)).max() < 1e-3


def _constraints(l_max, n_q, method, seed, real_dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    qs = np.linspace(0.05, 0.4, n_q)
    proj = [_cplx(rng, (n_q, min(2 * l + 1, n_q))) for l in range(l_max + 1)]
    avg = rng.random(n_q)
    mask = rng.random((l_max + 1, n_q)) > 0.2
    kw = dict(use_averaged_intensity=True, average_intensity=avg,
              radial_mask=mask, n_particles=2.0, schmidt_scaling=False,
              procrustes_method=method, ns_schedule=DEFAULT_SCHEDULE)
    jrc = jp.ReciprocalConstraint.build(proj, qs, l_max,
                                        real_dtype=real_dtype, **kw)
    trc = tp.ReciprocalConstraint.build(proj, qs, l_max, device="cpu", **kw)
    n_m = 2 * l_max + 1
    lm = np.arange(l_max + 1)[None, :] \
        >= np.abs(np.arange(-l_max, l_max + 1))[:, None]
    ilm = _cplx(rng, (2, n_q, n_m, l_max + 1)) * lm
    return jrc, trc, ilm


# (64, 8): the crop path (2L+1 > 128). Blocks with 2l+1 > n_q are rank
# deficient: float32 rounding leaves ~1e-7 singular values there, which the
# minimax schedule (built to lift 1e-7 to 1) turns into O(1) noise in both
# packages alike, so the Newton–Schulz cases compare in float64. The SVD case
# is full rank (n_q ≥ 2L+1) and compares in float32.
@pytest.mark.parametrize("l_max,n_q,method,x64", [
    (64, 8, "newton_schulz", True), (8, 17, "newton_schulz", True),
    (4, 12, "svd", False)])
def test_approximate_unknowns_and_projection(l_max, n_q, method, x64):
    cdt = np.complex128 if x64 else np.complex64
    with jax.enable_x64(x64):
        jrc, trc, ilm = _constraints(l_max, n_q, method, seed=l_max,
                                     real_dtype=jnp.float64 if x64
                                     else jnp.float32)
        ilm = ilm.astype(cdt)
        W_j = [np.array(jrc.approximate_unknowns(jnp.asarray(x)))
               for x in ilm]
        P_j = np.asarray(jrc.project_coefficients(jnp.asarray(ilm[0]),
                                                  jnp.asarray(W_j[0])))
        full_j = np.asarray(jrc(jnp.asarray(ilm[1])))
    if l_max == 64:
        # the crop path runs: one bucket, then the full-width order
        assert tp.crop_buckets(trc.l_max) == [(0, 63, 63), (64, 64, 64)]
    for name in ("V_pad", "PD", "eye_diag"):
        assert _rel(getattr(trc, name).numpy(), getattr(jrc, name)) < 1e-7
    if x64:
        trc.V_pad = trc.V_pad.to(torch.complex128)
        trc.PD = trc.PD.to(torch.complex128)
    W_t = trc.approximate_unknowns(torch.as_tensor(ilm))   # 2 restarts
    for r in range(2):
        assert _rel(W_t[r].numpy(), W_j[r]) < TOL, r
    P_t = trc.project_coefficients(torch.as_tensor(ilm[0]),
                                   torch.as_tensor(W_j[0])).numpy()
    assert _rel(P_t, P_j) < TOL
    assert _rel(trc(torch.as_tensor(ilm))[1].numpy(), full_j) < TOL


def _l66(seed, **kw):
    """The L = 66 fixtures of tests/test_phasing.py:305-395: two crop
    buckets (orders 0-63 on h = 63, 64-65 on h = 65) plus the full-width
    order 66, n_q = 2L+3 so that every block has full rank; the JAX and the
    port's constraint from the same matrices, and two restarts' Ilm."""
    rng = np.random.default_rng(seed)
    L, n_q = 66, 135
    n_m = 2 * L + 1
    mats = [rng.normal(size=(n_q, min(2 * l + 1, n_q)))
            + 1j * rng.normal(size=(n_q, min(2 * l + 1, n_q)))
            for l in range(L + 1)]
    if kw.pop("with_data", False):
        mask = np.ones((L + 1, n_q), dtype=bool)
        mask[:, :3] = False            # masked low-q band keeps the iterate
        kw.update(used_order_ids=np.array([l for l in range(L + 1)
                                           if l != 5]),
                  odd_orders_to_0=True, use_averaged_intensity=True,
                  average_intensity=np.abs(rng.normal(size=n_q)) + 0.5,
                  radial_mask=mask, n_particles=3.0, schmidt_scaling=True)
    else:
        kw.update(odd_orders_to_0=False, use_averaged_intensity=False,
                  schmidt_scaling=False)
    args = (mats, np.linspace(0.1, 1.0, n_q), L)
    jrc = jp.ReciprocalConstraint.build(*args, **kw)
    trc = tp.ReciprocalConstraint.build(*args, device="cpu", **kw)
    ilm = _cplx(rng, (2, n_q, n_m, L + 1))
    for l in range(L + 1):
        ilm[:, :, :L - l, l] = 0
        ilm[:, :, L + l + 1:, l] = 0
    return jrc, trc, ilm


@pytest.mark.parametrize("schedule", [None, DEFAULT_SCHEDULE],
                         ids=["fixed", "minimax"])
def test_newton_schulz_pallas_projection_matches_jax(schedule):
    """The whole projection under newton_schulz_pallas (B8 per bucket, then
    the l = 0 row) against the JAX package's _project_fused (K5 in
    interpret mode), with radial masks, an unused order, odd-order kill,
    the averaged-intensity l = 0 column and N = 3 particles: 5e-3·max, the
    JAX package's bound for K5 against the split path
    (tests/test_phasing.py:389-394), and its structural zeros."""
    jrc, trc, ilm = _l66(21, with_data=True,
                         procrustes_method="newton_schulz_pallas",
                         ns_iterations=16, ns_schedule=schedule)
    assert jrc.k5_active and trc.k5_active
    assert tp.crop_buckets(trc.l_max) == [(0, 63, 63), (64, 65, 65),
                                          (66, 66, 66)]
    got = trc(torch.as_tensor(ilm)).numpy()
    L = trc.l_max
    for r in range(2):
        want = np.asarray(jax.jit(lambda x: jrc(x))(jnp.asarray(ilm[r])))
        scale = np.abs(want).max()
        assert got[r].shape == want.shape
        assert np.abs(got[r] - want).max() < 5e-3 * scale, r
        assert np.abs(got[r][:, :L, 0]).max() < 1e-5 * scale
        assert np.abs(got[r][:, L + 1:, 0]).max() < 1e-5 * scale


@pytest.mark.parametrize("schedule", [None, DEFAULT_SCHEDULE],
                         ids=["fixed", "minimax"])
def test_newton_schulz_pallas_unknowns_match_jax(schedule):
    """approximate_unknowns under newton_schulz_pallas (B7 per bucket)
    against the JAX package's _unknowns_pallas, per order inside its window
    within 5e-3, and the identity outside the window within 1e-5
    (tests/test_phasing.py:305-347)."""
    jrc, trc, ilm = _l66(13, procrustes_method="newton_schulz_pallas",
                         ns_iterations=16, ns_schedule=schedule)
    L, n_m = trc.l_max, 2 * trc.l_max + 1
    want = np.asarray(jax.jit(jrc.approximate_unknowns)(jnp.asarray(ilm[0])))
    got = trc.approximate_unknowns(torch.as_tensor(ilm[:1]))[0].numpy()
    assert got.shape == want.shape
    for l in [2, 40, 63, 64, 65, 66]:
        win = slice(L - l, L + l + 1)
        assert np.abs(got[l][win, win] - want[l][win, win]).max() < 5e-3, l
        out = got[l].copy()
        out[win, win] = 0.0
        eye_out = np.eye(n_m, dtype=out.dtype)
        eye_out[win, win] = 0.0
        np.testing.assert_allclose(out, eye_out, atol=1e-5)


def test_unported_options_raise():
    """Once refused: the particle-number tables build as the JAX package's
    (float32, 1e-7 relative) and the estimate runs per restart; the
    bucketed fixed-volume shrink-wrap runs and keeps the sort's support on
    generic values."""
    rng = np.random.default_rng(3)
    qs = np.linspace(0.1, 1.0, 4)
    avg = rng.uniform(0.5, 1.5, 4)
    kw = dict(average_intensity=avg, pn_scan_space=(1, 4, 8),
              pn_project=True)
    trc = tp.ReciprocalConstraint.build([np.ones((4, 1))], qs, 0, **kw,
                                        device="cpu")
    jrc = jp.ReciprocalConstraint.build([np.ones((4, 1))], qs, 0, **kw)
    assert trc.pn_enabled and trc.pn_project
    for k in ("pn_s", "pn_Ns", "pn_x", "pn_a"):
        np.testing.assert_allclose(getattr(trc, k).numpy(),
                                   np.asarray(getattr(jrc, k)), rtol=1e-7)
    I = rng.normal(size=(2, 4, 3, 5)).astype(np.float32)
    n_hat, I_p = trc.particle_number_estimate(torch.as_tensor(I))
    assert n_hat.shape == (2,) and I_p.shape == I.shape
    assert (I_p >= 0).all()
    conv = rng.gamma(2.0, 1.0, size=(2, 4, 3, 5)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(4, 3, 5)).astype(np.float32)
    sws = {m: tp.ShrinkWrap.build(
        qs, mode="fixed_volume", volume_fraction=0.4, integration_weights=w,
        initial_support=np.ones((4, 3, 5), bool), fixed_volume_method=m,
        device="cpu") for m in ("sort", "bucketed")}
    masks = {m: sw.new_support(torch.as_tensor(conv), 0.1)
             for m, sw in sws.items()}
    assert torch.equal(masks["sort"], masks["bucketed"])


def test_modified_intensity_and_real_constraint():
    rng = np.random.default_rng(5)
    shape = (2, 6, 8, 16)
    psi = _cplx(rng, shape)
    inten = (np.abs(psi) ** 2).astype(np.float32)
    inten.flat[::7] = 0.0
    new = (inten + rng.normal(scale=0.5, size=shape)).astype(np.float32)
    want = np.asarray(jp.project_to_modified_intensity(
        jnp.asarray(psi), jnp.asarray(inten), jnp.asarray(new)))
    got = tp.project_to_modified_intensity(
        torch.as_tensor(psi), torch.as_tensor(inten),
        torch.as_tensor(new)).numpy()
    assert _rel(got, want) < TOL
    rho = (3 * _cplx(rng, shape)).astype(np.complex64)
    sup = rng.random(shape) > 0.3
    for real in (jp.RealConstraint(limit_imag=2.0),
                 jp.RealConstraint(threshold_high=1.5, limit_imag=1.0,
                                   considered_projections=("support",
                                                           "limit_imag")),
                 jp.RealConstraint(apply_assert_real=True)):
        port = tp.RealConstraint(**real.__dict__)
        out_j, inv_j = real(jnp.asarray(rho), jnp.asarray(sup))
        out_t, inv_t = port(torch.as_tensor(rho), torch.as_tensor(sup))
        assert np.array_equal(out_t.numpy(), np.asarray(out_j))
        assert np.array_equal(inv_t.numpy(), np.asarray(inv_j))


@pytest.mark.parametrize("method", ["HIO", "RAAR", "ER"])
def test_io_updates(method):
    rng = np.random.default_rng(6)
    a, b, c = (_cplx(rng, (2, 4, 5, 6)) for _ in range(3))
    inv = rng.random((2, 4, 5, 6)) > 0.5
    if method == "ER":
        want, got = jp.er_update(c), tp.er_update(torch.as_tensor(c))
    else:
        fj = jp.hio_update if method == "HIO" else jp.raar_update
        ft = tp.hio_update if method == "HIO" else tp.raar_update
        want = fj(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                  jnp.asarray(inv), 0.7)
        got = ft(*map(torch.as_tensor, (a, b, c, inv)), 0.7)
    assert _rel(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("mode", ["threshold", "fixed_volume"])
def test_shrink_wrap(mode):
    rng = np.random.default_rng(7)
    n_q, grid = 6, (6, 8, 16)
    qs = np.linspace(0.05, 0.4, n_q)
    w = rng.random(grid).astype(np.float32)
    init = rng.random(grid) > 0.2
    kw = dict(mode=mode, volume_fraction=0.4, integration_weights=w,
              initial_support=init)
    jsw = jp.ShrinkWrap.build(qs, **kw)
    tsw = tp.ShrinkWrap.build(qs, device="cpu", **kw)
    assert _rel(tsw.gaussian_values(0.7).numpy(),
                jsw.gaussian_values(jnp.float32(0.7))) < 1e-6
    conv = _cplx(rng, (2,) + grid)
    cur = rng.random((2,) + grid) > 0.5
    got = tsw.new_support(torch.as_tensor(conv), 0.1,
                          current_support=torch.as_tensor(cur)).numpy()
    for r in range(2):
        want = np.asarray(jsw.new_support(jnp.asarray(conv[r]), 0.1,
                                          current_support=jnp.asarray(cur[r])))
        assert np.array_equal(got[r], want), r
