"""The port's fused-iteration modules against the JAX package's (CPU).

Each module holding a kernel of the fused iteration runs its plain version
here against the JAX package's Pallas kernel in interpret mode, on the same
numpy inputs and tables: FusedSHT.forward_real_abs2 (B3) and
FusedIteration.hankel_synthesize (B6), inverse_real_project_fwd (B4),
synthesize_update (B5), and the variants' inverse_real_project (B11) and
synthesize_abs2 (B12), plus the Hankel inverse_row0 the ft-stab combine
uses. Sizes as tests/test_transforms.py:347-356: L = 6, 16×32 grids, 8 rows
— here 2 restarts × 4 shells, the JAX side under jax.vmap over the restarts
so that its sums are per restart, and the second restart has its own q = 0
row. Tolerances as tests/test_transforms.py:358-563: 1e-5·max for the |ψ|²
analysis, B12's ψ and B11's ψ_p, 1e-4·max for coefficients and the
Hankel-fused synthesis, 2e-5·max
for the updated density away from the real constraint's thresholds (a
rounding difference can flip a point there), 1e-4 relative for every sum.
"""
from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from xframe_tpu.ops.hankel import (SphericalHankelTransform as JaxHankel,
                                   generate_weights)
from xframe_tpu.ops.pallas_mtip import FusedIteration as JaxFusedIteration
from xframe_tpu.ops.pallas_sht import FusedSHT as JaxFusedSHT
from xframe_tpu.ops.sht import SphericalHarmonicTransform as JaxSHT
from xframe_tpu.projects.fxs.projections import \
    RealConstraint as JaxRealConstraint

from xframe_tpu_torch.ops import fused_mtip
from xframe_tpu_torch.ops.fused_sht import FusedSHT, METHODS as SHT_METHODS
from xframe_tpu_torch.ops.hankel import SphericalHankelTransform
from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
from xframe_tpu_torch.projects.fxs.projections import RealConstraint

L, N_THETA, N_PHI, B, N_Q = 6, 16, 32, 2, 4
GRID = (B, N_Q, N_THETA, N_PHI)
COEF = (B, N_Q, 2 * L + 1, L + 1)
_FUSED = ("E_re", "E_im", "I_re", "I_im", "PW", "P_t")


@pytest.fixture(scope="module")
def pair():
    """(JAX SHT, JAX FusedSHT, port FusedSHT on the JAX tables, rng)."""
    jsht = JaxSHT(L, n_theta=N_THETA, n_phi=N_PHI)
    jfused = JaxFusedSHT(jsht, q_block=4, m_splits=1)
    sht = SphericalHarmonicTransform(L, N_THETA, N_PHI, device="cpu")
    sht.set_tables(np.asarray(jsht._P), np.asarray(jsht._PW))
    fused = FusedSHT(sht)
    fused.set_tables(*(np.asarray(getattr(jfused, "_" + n))[:sht.n_m]
                       for n in _FUSED))
    return jsht, jfused, fused, np.random.default_rng(7)


def _cx(rng, shape, mask=None):
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return (x if mask is None else x * mask).astype(np.complex64)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _rel(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * np.abs(want))


def test_forward_real_abs2_matches_jax(pair):
    _, jfused, fused, rng = pair
    psi = _cx(rng, (8, N_THETA, N_PHI))
    ref = np.asarray(jax.jit(jfused.forward_real_abs2)(jnp.asarray(psi)))
    got = fused.forward_real_abs2(torch.as_tensor(psi))
    _close(got.numpy(), ref, 1e-5)
    assert fused.launches == dict.fromkeys(SHT_METHODS, 0)


@pytest.mark.parametrize("mode", ["midpoint", "trapz"])
def test_hankel_synthesize_matches_jax(pair, mode):
    """Leading batch of 2 over n_q = 8 shells, for the all-samples and the
    skip-r=0 weight layouts (tests/test_transforms.py:470-496)."""
    jsht, jfused, fused, rng = pair
    n_q = 8
    jht = JaxHankel(generate_weights(L, n_q, np.pi, 3, mode), r_max=1.0)
    jfi = JaxFusedIteration(jfused, q_block=4, hankel=jht)
    assert jfi._hsyn_qb
    ht = SphericalHankelTransform.from_tables(jht._wf, jht._wi, mode,
                                              device="cpu")
    fi = fused_mtip.FusedIteration(fused, hankel=ht)
    c = _cx(rng, (2, n_q, 2 * L + 1, L + 1), jsht.lm_mask)
    psi_ref, cf_ref = jax.jit(jfi.hankel_synthesize)(jnp.asarray(c))
    psi, cf = fi.hankel_synthesize(torch.as_tensor(c))
    _close(cf.numpy(), cf_ref, 1e-4)
    _close(psi.numpy(), psi_ref, 1e-4)
    assert fi.launches == dict.fromkeys(fused_mtip.METHODS, 0)


@pytest.mark.parametrize("mode", ["midpoint", "trapz"])
def test_inverse_row0_matches_jax(mode):
    rng = np.random.default_rng(11)
    n_q = 8
    jht = JaxHankel(generate_weights(L, n_q, np.pi, 3, mode), r_max=1.0)
    ht = SphericalHankelTransform.from_tables(jht._wf, jht._wi, mode,
                                              device="cpu")
    f = _cx(rng, (2, n_q, 2 * L + 1, L + 1))
    ref = np.asarray(jax.jit(jht.inverse_row0)(jnp.asarray(f)))
    _close(ht.inverse_row0(torch.as_tensor(f)).numpy(), ref, 1e-5)
    _close(ht.inverse_row0(torch.as_tensor(f)).numpy(),
           ht.inverse(torch.as_tensor(f))[:, 0].numpy(), 1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_inverse_real_project_fwd_matches_jax(pair, weighted):
    """Unweighted and w_rec-weighted reciprocal sums, per restart
    (tests/test_transforms.py:386-409,435-468)."""
    jsht, jfused, fused, rng = pair
    w_rec = (rng.random((N_Q, N_THETA)) + 0.1).astype(np.float32) \
        if weighted else None
    jfi = JaxFusedIteration(jfused, q_block=4, w_rec=w_rec)
    fi = fused_mtip.FusedIteration(fused, w_rec=w_rec)
    c = _cx(rng, COEF, jsht.lm_mask)
    psi = _cx(rng, GRID)
    c_ref, num_ref, den_ref = jax.jit(jax.vmap(jfi.inverse_real_project_fwd))(
        jnp.asarray(c), jnp.asarray(psi))
    c_out, num, den = fi.inverse_real_project_fwd(torch.as_tensor(c),
                                                  torch.as_tensor(psi))
    _close(c_out.numpy(), c_ref, 1e-4)
    assert num.shape == den.shape == (B,)
    _rel(num.numpy(), num_ref, 1e-4)
    _rel(den.numpy(), den_ref, 1e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_inverse_real_project_matches_jax(pair, weighted):
    """B11: ψ_p and the per-restart sums (tests/test_transforms.py:411)."""
    jsht, jfused, fused, rng = pair
    w_rec = (rng.random((N_Q, N_THETA)) + 0.1).astype(np.float32) \
        if weighted else None
    jfi = JaxFusedIteration(jfused, q_block=4, w_rec=w_rec)
    fi = fused_mtip.FusedIteration(fused, w_rec=w_rec)
    c = _cx(rng, COEF, jsht.lm_mask)
    psi = _cx(rng, GRID)
    pp_ref, num_ref, den_ref = jax.jit(jax.vmap(jfi.inverse_real_project))(
        jnp.asarray(c), jnp.asarray(psi))
    pp, num, den = fi.inverse_real_project(torch.as_tensor(c),
                                           torch.as_tensor(psi))
    _close(pp.numpy(), pp_ref, 1e-5)
    assert num.shape == den.shape == (B,)
    _rel(num.numpy(), num_ref, 1e-4)
    _rel(den.numpy(), den_ref, 1e-4)
    assert fi.launches == dict.fromkeys(fused_mtip.METHODS, 0)


def test_synthesize_abs2_matches_jax(pair):
    """B12: ψ and the analysis of |ψ|², m < 0 rows mirrored
    (tests/test_transforms.py:370)."""
    jsht, jfused, fused, rng = pair
    jfi = JaxFusedIteration(jfused, q_block=4)
    fi = fused_mtip.FusedIteration(fused)
    cf = _cx(rng, COEF, jsht.lm_mask)
    psi_ref, ilm_ref = jax.jit(jax.vmap(jfi.synthesize_abs2))(jnp.asarray(cf))
    psi, ilm = fi.synthesize_abs2(torch.as_tensor(cf))
    _close(psi.numpy(), psi_ref, 1e-5)
    _close(ilm.numpy(), ilm_ref, 1e-4)
    assert fi.launches == dict.fromkeys(fused_mtip.METHODS, 0)


@pytest.fixture(scope="module")
def update_inputs(pair):
    jsht, _, _, _ = pair
    rng = np.random.default_rng(5)
    return dict(
        d=_cx(rng, COEF, jsht.lm_mask), rho_in=_cx(rng, GRID),
        support=rng.uniform(size=GRID) > 0.4,
        w_plane=rng.uniform(0.1, 1.0, (N_Q, N_THETA)).astype(np.float32),
        w_grid=rng.uniform(0.1, 1.0, GRID).astype(np.float32),
        c_phase=np.exp(1j * np.array([0.7, -2.1])).astype(np.complex64))


GATES = {"none": None, "0": [0.0, 0.0], "1": [1.0, 1.0],
         "mixed": [0.0, 1.0]}
# (method, ft_stab, gate): the gate scales the ft-stab add, so it varies
# under ft-stab only; the ungated cases keep their ids
UPDATE_CASES = [pytest.param(m, fs, "none", id=f"{m}-{fs}")
                for m, fs in (("HIO", True), ("ER", True), ("RAAR", False),
                              ("HIO", False))] \
    + [pytest.param(m, True, g, id=f"{m}-True-gate_{g}")
       for m in ("HIO", "ER") for g in ("0", "1", "mixed")]


@pytest.mark.parametrize("weights", ["plane", "grid", "shared_grid"])
@pytest.mark.parametrize("method,ft_stab,gate", UPDATE_CASES)
def test_synthesize_update_matches_jax(pair, update_inputs, method, ft_stab,
                                       gate, weights):
    """The weight forms (the plane, a grid per restart, the grid the
    restarts share, which the kernel takes) and the linked ft-stab gate per
    restart (none, 0, 1 and mixed, JAX's ft_gate); the JAX kernel runs per
    restart under vmap, so its row 0 is each restart's q = 0
    (tests/test_transforms.py:498-563)."""
    _, jfused, fused, _ = pair
    x = update_inputs
    w = {"plane": x["w_plane"], "grid": x["w_grid"],
         "shared_grid": x["w_grid"][0]}[weights]
    g = GATES[gate]
    beta = 0.6
    jrc = JaxRealConstraint(threshold_low=0.05, limit_imag=0.3)
    rc = RealConstraint(threshold_low=0.05, limit_imag=0.3)
    jfi = JaxFusedIteration(jfused, q_block=4)
    fi = fused_mtip.FusedIteration(fused)
    fn = partial(jfi.synthesize_update, method=method, ft_stab=ft_stab,
                 real_constraint=jrc)
    w_axis = 0 if weights == "grid" else None
    ref = jax.jit(jax.vmap(
        lambda d, r, s, w_, c, g_: fn(d, r, s, w_, beta, c, ft_gate=g_),
        in_axes=(0, 0, 0, w_axis, 0, None if g is None else 0)))(
        jnp.asarray(x["d"]), jnp.asarray(x["rho_in"]),
        jnp.asarray(x["support"], dtype=np.float32), jnp.asarray(w),
        jnp.asarray(x["c_phase"]),
        None if g is None else jnp.asarray(g, dtype=jnp.float32))
    args = [torch.as_tensor(x[k]) for k in ("d", "rho_in", "support")]
    t_gate = None if g is None else torch.tensor(g)
    got = fi.synthesize_update(*args, torch.as_tensor(w), beta,
                               torch.as_tensor(x["c_phase"]), method=method,
                               ft_stab=ft_stab, real_constraint=rc,
                               ft_gate=t_gate)
    rp, _ = fi.pre_constraint_plain(args[0], args[1],
                                    torch.as_tensor(x["c_phase"]),
                                    ft_stab=ft_stab, ft_gate=t_gate)
    keep = fused_mtip.away_from_thresholds(rp, rc,
                                           1e-4 * float(rp.abs().max()))
    left_out = int((~keep).sum())
    assert left_out < 0.01 * keep.numel()
    new, new_ref = got[0].numpy(), np.asarray(ref[0])
    assert new.shape == GRID
    assert np.abs(new - new_ref)[keep.numpy()].max() \
        <= 2e-5 * np.abs(new_ref).max()
    for g, r in zip(got[1:3], ref[1:3]):
        _rel(g.numpy(), r, 1e-4)
    for g, r in zip(got[3:], ref[3:]):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == (B,)
        assert np.all(np.abs(g - r) <= 1e-4 * (np.abs(r) + 1e-6))
    assert fi.launches == dict.fromkeys(fused_mtip.METHODS, 0)


def test_q0_rows_are_per_restart(pair, update_inputs):
    """Under ft-stab the ρ_in add skips q = 0 of every restart: two restarts
    in one call give what each gives alone."""
    _, _, fused, _ = pair
    x = update_inputs
    fi = fused_mtip.FusedIteration(fused)
    rc = RealConstraint(threshold_low=0.05, limit_imag=0.3)
    t = {k: torch.as_tensor(x[k]) for k in ("d", "rho_in", "support",
                                            "w_plane", "c_phase")}
    both = fi.synthesize_update(t["d"], t["rho_in"], t["support"],
                                t["w_plane"], 0.6, t["c_phase"],
                                method="HIO", ft_stab=True,
                                real_constraint=rc)
    for b in range(B):
        one = fi.synthesize_update(t["d"][b], t["rho_in"][b],
                                   t["support"][b], t["w_plane"], 0.6,
                                   t["c_phase"][b], method="HIO",
                                   ft_stab=True, real_constraint=rc)
        assert torch.equal(one[0], both[0][b])
        for g, r in zip(one[1:], both[1:]):
            assert torch.allclose(g, r[b], rtol=1e-6, atol=0)


def test_unknown_update_method_raises(pair):
    fi = fused_mtip.FusedIteration(pair[2])
    z = torch.zeros(GRID, dtype=torch.complex64)
    with pytest.raises(ValueError):
        fi.synthesize_update(torch.zeros(COEF, dtype=torch.complex64), z,
                             z.real > 0, torch.ones(N_Q, N_THETA), 0.5, 1.0,
                             method="OSS", ft_stab=False,
                             real_constraint=RealConstraint())
    with pytest.raises(ValueError):
        fi.hankel_synthesize(torch.zeros(COEF, dtype=torch.complex64))
