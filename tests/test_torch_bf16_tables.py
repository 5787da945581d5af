"""fourier_transform.fused_bf16_tables in the port, against the JAX package
(CPU).

The port's contract under bf16 tables: the Legendre tables hold bf16
values, each Legendre product rounds its data operand to bf16 (the Fourier
columns of an analysis; the coefficients of a synthesis, after the
Hermitian fold of a real output) and sums in float32; the φ-transforms stay
float32. Its plain version is the plain SHT under mxu_dtype bf16.

  * the plain SHT under mxu_dtype against the JAX SphericalHarmonicTransform
    under mxu_dtype=bfloat16, the five methods: at odd n_θ (L = 8, 17×34)
    the same rounded operands, so within 1e-5 of max (float32 sums in
    another order); at even n_θ (18×34) the JAX transform folds θ
    about the equator before it rounds, so within the bf16 regime, 1e-2 of
    max. A non-Hermitian c through inverse_real: the fold comes first, so
    the result is bitwise that of its Hermitian part;
  * FusedSHT(table_dtype=bf16) and the five FusedIteration methods on the
    CPU against the JAX package's Pallas kernels with bf16 tables in
    interpret mode (L = 6, 16×32, 2 restarts × 4 shells): the JAX kernels
    also round their φ-DFT operands, so within 1e-2 of max (5e-2 for ψ_p
    away from I_new = 0, 1e-2 relative for the sums), and each more than
    1e-5 of max from the float32 form;
  * the round trip at L = 127, 320×640 against a float64 host transform:
    within JAX's window 1e-4 < err < 1e-2 and no worse than JAX's bf16
    FusedSHT (tests/test_transforms.py:851-876);
  * the dtypes through SphericalFourierTransform and make_demo_problem to
    FusedSHT and FusedIteration, a 2-iteration run finite
    (tests/test_transforms.py:289,704); convert.mtip_arrays and
    mtip_from_numpy carry them from a JAX problem;
  * the reconstruct worker: its first iteration against the JAX worker
    (fused_sht true, interpret mode) with the key, 1e-2 relative (0.4 %
    measured: the JAX kernels' rounded DFT), more than 1e-5 from its
    float32 run; under float64, in 2D and under fused_sht false the key
    changes nothing, bit for bit.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import xframe_tpu as xf
from xframe_tpu.ops.hankel import (SphericalHankelTransform as JaxHankel,
                                   generate_weights)
from xframe_tpu.ops.pallas_mtip import FusedIteration as JaxFusedIteration
from xframe_tpu.ops.pallas_sht import FusedSHT as JaxFusedSHT
from xframe_tpu.ops.sht import SphericalHarmonicTransform as JaxSHT
from xframe_tpu.projects.fxs.demo import make_demo_problem as jax_demo
from xframe_tpu.projects.fxs.phasing import Segment as JaxSegment
from xframe_tpu.projects.fxs.projections import \
    RealConstraint as JaxRealConstraint
from xframe_tpu.projects.fxs.reconstruct import ProjectWorker as JaxWorker

from xframe_tpu_torch.convert import (mtip_arrays, mtip_from_numpy,
                                      save_invariants)
from xframe_tpu_torch.main import select_worker
from xframe_tpu_torch.ops import fused_mtip
from xframe_tpu_torch.ops.fused_sht import (BF16_METHODS, METHODS,
                                            FusedSHT)
from xframe_tpu_torch.ops.hankel import SphericalHankelTransform
from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
from xframe_tpu_torch.projects.fxs.phasing import Segment
from xframe_tpu_torch.projects.fxs.projections import RealConstraint
from xframe_tpu_torch.settings import deep_update

BF16 = torch.bfloat16
ODD_TOL = 1e-5      # the same rounded operands, float32 sums in another order
BF16_TOL = 1e-2     # the bf16 regime: 2^-8 relative per rounded operand


def _cx(rng, shape, mask=None):
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return (x if mask is None else x * mask).astype(np.complex64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------- the plain mxu_dtype SHT
L_P, NP_P, ROWS_P = 8, 34, 5


@pytest.fixture(scope="module", params=[17, 18], ids=["odd", "even"])
def plain(request):
    """(n_θ, JAX SHT at mxu bf16, port SHT at mxu bf16, inputs)."""
    nt = request.param
    rng = np.random.default_rng(0)
    f = _cx(rng, (ROWS_P, nt, NP_P))
    fr = np.abs(f).astype(np.float32)
    j32 = JaxSHT(L_P, n_theta=nt, n_phi=NP_P)
    inputs = {"forward": f,
              "inverse": np.asarray(jax.jit(j32.forward)(jnp.asarray(f))),
              "forward_real": fr,
              # Hermitian coefficients: the fold onto m ≥ 0 is exact
              "inverse_real": np.asarray(jax.jit(j32.forward_real)(
                  jnp.asarray(fr))),
              "forward_real_abs2": f}
    return (nt, JaxSHT(L_P, n_theta=nt, n_phi=NP_P, mxu_dtype=jnp.bfloat16),
            SphericalHarmonicTransform(L_P, nt, NP_P, mxu_dtype=BF16,
                                       device="cpu"), inputs)


@pytest.mark.parametrize("method", METHODS)
def test_plain_mxu_sht_matches_jax(plain, method):
    nt, jsht, sht, inputs = plain
    fn = getattr(jsht, method, None)
    if fn is None:      # the JAX SHT has no fused |ψ|² analysis
        fn = lambda psi: jsht.forward_real((psi * psi.conj()).real)  # noqa
    x = inputs[method]
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    got = getattr(sht, method)(torch.as_tensor(x)).numpy()
    assert _rel(got, want) < (ODD_TOL if nt % 2 else BF16_TOL)
    # and it is the bf16 form: far from the float32 transform
    f32 = SphericalHarmonicTransform(L_P, nt, NP_P, device="cpu")
    assert _rel(got, getattr(f32, method)(torch.as_tensor(x)).numpy()) \
        > ODD_TOL


def test_plain_inverse_real_folds_before_rounding(plain):
    """inverse_real rounds the folded coefficients c_h[m] = (c_m + (−1)^m
    conj c_{−m})/2 (float32), as the kernels do: a non-Hermitian c gives
    bitwise what its Hermitian part gives."""
    _, _, sht, inputs = plain
    c = torch.as_tensor(inputs["inverse"])
    L = L_P
    h = c.clone()
    signs = torch.tensor((-1.0) ** np.arange(1, L + 1), dtype=torch.float32)
    pos, neg = c[..., L + 1:, :], c[..., :L, :].flip(-2)
    fold = 0.5 * (pos + signs[:, None] * torch.conj(neg))
    h[..., L + 1:, :] = fold
    h[..., :L, :] = (signs[:, None] * torch.conj(fold)).flip(-2)
    h[..., L, :] = torch.complex(c[..., L, :].real,
                                 torch.zeros_like(c[..., L, :].real))
    assert torch.equal(sht.inverse_real(c), sht.inverse_real(h))


def test_mxu_tables_hold_bf16_values():
    sht = SphericalHarmonicTransform(L_P, 17, NP_P, mxu_dtype=BF16,
                                     device="cpu")
    for t in (sht._P, sht._PW):
        assert t.dtype == torch.float32
        assert torch.equal(t, t.to(BF16).to(torch.float32))
    f32 = SphericalHarmonicTransform(L_P, 17, NP_P, device="cpu")
    assert f32.with_mxu_dtype(None) is f32
    assert torch.equal(f32.with_mxu_dtype(BF16)._P, sht._P)


# ------------------------------------- FusedSHT and FusedIteration, bf16
L, N_THETA, N_PHI, B, N_Q = 6, 16, 32, 2, 4
GRID = (B, N_Q, N_THETA, N_PHI)
COEF = (B, N_Q, 2 * L + 1, L + 1)


@pytest.fixture(scope="module")
def pair():
    """(JAX SHT, JAX FusedSHT with bf16 tables, port FusedSHT with bf16
    tables on the JAX SHT's tables, the port's float32 FusedSHT, rng)."""
    jsht = JaxSHT(L, n_theta=N_THETA, n_phi=N_PHI)
    jfused = JaxFusedSHT(jsht, q_block=4, m_splits=1,
                         table_dtype=ml_dtypes.bfloat16)
    sht = SphericalHarmonicTransform(L, N_THETA, N_PHI, device="cpu")
    sht.set_tables(np.asarray(jsht._P), np.asarray(jsht._PW))
    return (jsht, jfused, FusedSHT(sht, table_dtype=BF16), FusedSHT(sht),
            np.random.default_rng(7))


def test_fused_sht_bf16_tables(pair):
    """P_t and PW on the device in bf16 (half the bytes), those of the JAX
    FusedSHT bitwise; E and I float32; the plain version at mxu bf16; no
    launch on the CPU."""
    _, jfused, fused, f32, _ = pair
    n_m = 2 * L + 1
    for name in ("PW", "P_t"):
        t = getattr(fused, "_" + name)
        assert t.dtype == BF16
        assert t.element_size() * 2 == getattr(f32, "_" + name).element_size()
        assert np.array_equal(t.float().numpy(), np.asarray(
            getattr(jfused, "_" + name))[:n_m].astype(np.float32))
    for name in ("E_re", "E_im", "I_re", "I_im"):
        assert torch.equal(getattr(fused, "_" + name), getattr(f32, "_" + name))
    assert fused.table_dtype == BF16 and fused.plain.mxu_dtype == BF16
    assert f32.plain is f32.sht and fused.sht is f32.sht
    assert set(fused.launches) == set(BF16_METHODS)
    with pytest.raises(ValueError, match="table_dtype"):
        FusedSHT(f32.sht, table_dtype=torch.float16)


@pytest.mark.parametrize("method", METHODS)
def test_fused_sht_bf16_matches_jax_pallas(pair, method):
    jsht, jfused, fused, f32, rng = pair
    rows = 8
    x = {"forward": _cx(rng, (rows, N_THETA, N_PHI)),
         "forward_real_abs2": _cx(rng, (rows, N_THETA, N_PHI)),
         "forward_real": rng.normal(size=(rows, N_THETA, N_PHI)).astype(
             np.float32),
         "inverse": _cx(rng, (rows, 2 * L + 1, L + 1), jsht.lm_mask),
         "inverse_real": _cx(rng, (rows, 2 * L + 1, L + 1), jsht.lm_mask),
         }[method]
    want = np.asarray(jax.jit(getattr(jfused, method))(jnp.asarray(x)))
    got = getattr(fused, method)(torch.as_tensor(x))
    assert torch.equal(got, getattr(fused.plain, method)(torch.as_tensor(x)))
    got = got.numpy()
    assert _rel(got, want) < BF16_TOL
    assert _rel(got, getattr(f32, method)(torch.as_tensor(x)).numpy()) \
        > ODD_TOL
    assert fused.launches == dict.fromkeys(BF16_METHODS, 0)


def _fi_pair(pair, hankel=False, w_rec=None):
    """(JAX FusedIteration, the port's on bf16 tables, on float32 ones);
    hankel: with a midpoint Hankel transform on 8 shells (the JAX kernel's
    q-block of 8)."""
    jsht, jfused, fused, f32, _ = pair
    kw, jkw = {}, {}
    if hankel:
        jht = JaxHankel(generate_weights(L, 8, np.pi, 3, "midpoint"),
                        r_max=1.0)
        jkw["hankel"] = jht
        kw["hankel"] = SphericalHankelTransform.from_tables(
            jht._wf, jht._wi, "midpoint", device="cpu")
    jfi = JaxFusedIteration(jfused, q_block=4, w_rec=w_rec, **jkw)
    return (jfi, fused_mtip.FusedIteration(fused, w_rec=w_rec, **kw),
            fused_mtip.FusedIteration(f32, w_rec=w_rec, **kw))


def _held(got, want, f32, tol=BF16_TOL, keep=None):
    """got within tol·max of the JAX kernel's, more than 1e-5·max from
    the float32 form's."""
    got, want, f32 = (np.asarray(a) for a in (got, want, f32))
    k = np.ones(got.shape, bool) if keep is None else keep
    scale = np.abs(want).max()
    assert np.abs(got - want)[k].max() <= tol * scale
    assert np.abs(got - f32)[k].max() > ODD_TOL * scale


def _sums_held(got, want):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == (B,)
        assert np.all(np.abs(g - w) <= BF16_TOL * np.abs(w))


def test_hankel_synthesize_bf16_matches_jax(pair):
    jfi, fi, fi32 = _fi_pair(pair, hankel=True)
    assert jfi._hsyn_qb
    c = _cx(pair[4], (B, 8) + COEF[2:], pair[0].lm_mask)
    psi_ref, cf_ref = jax.jit(jfi.hankel_synthesize)(jnp.asarray(c))
    psi, cf = fi.hankel_synthesize(torch.as_tensor(c))
    psi32, cf32 = fi32.hankel_synthesize(torch.as_tensor(c))
    # the Hankel GEMM stays float32: cf is the float32 form's
    assert torch.equal(cf, cf32)
    np.testing.assert_allclose(cf.numpy(), np.asarray(cf_ref), rtol=0,
                               atol=1e-4 * np.abs(cf_ref).max())
    _held(psi, psi_ref, psi32)
    assert set(fi.launches) == set(fused_mtip.BF16_METHODS)
    assert fi.launches == dict.fromkeys(fused_mtip.BF16_METHODS, 0)


@pytest.mark.parametrize("weighted", [False, True])
def test_inverse_real_project_fwd_bf16_matches_jax(pair, weighted):
    rng = pair[4]
    w = (rng.random((N_Q, N_THETA)) + 0.1).astype(np.float32) \
        if weighted else None
    jfi, fi, fi32 = _fi_pair(pair, w_rec=w)
    c = _cx(rng, COEF, pair[0].lm_mask)
    psi = _cx(rng, GRID)
    ref = jax.jit(jax.vmap(jfi.inverse_real_project_fwd))(
        jnp.asarray(c), jnp.asarray(psi))
    got = fi.inverse_real_project_fwd(torch.as_tensor(c),
                                      torch.as_tensor(psi))
    f32 = fi32.inverse_real_project_fwd(torch.as_tensor(c),
                                        torch.as_tensor(psi))
    _held(got[0], ref[0], f32[0])
    _sums_held(got[1:], ref[1:])


def test_inverse_real_project_bf16_matches_jax(pair):
    """B11: ψ_p away from I_new = 0, where √ turns the bf16 difference δ of
    I_new into one of √δ (points with |I_new| < 5e-2·max left out)."""
    rng = pair[4]
    jfi, fi, fi32 = _fi_pair(pair)
    c = _cx(rng, COEF, pair[0].lm_mask)
    psi = _cx(rng, GRID)
    ref = jax.jit(jax.vmap(jfi.inverse_real_project))(jnp.asarray(c),
                                                      jnp.asarray(psi))
    got = fi.inverse_real_project(torch.as_tensor(c), torch.as_tensor(psi))
    f32 = fi32.inverse_real_project(torch.as_tensor(c), torch.as_tensor(psi))
    i_new = fi.f.plain.inverse_real(torch.as_tensor(c)).abs().numpy()
    keep = i_new > 5e-2 * i_new.max()
    assert keep.mean() > 0.8
    _held(got[0], ref[0], f32[0], tol=5 * BF16_TOL, keep=keep)
    _sums_held(got[1:], ref[1:])


def test_synthesize_abs2_bf16_matches_jax(pair):
    jfi, fi, fi32 = _fi_pair(pair)
    cf = _cx(pair[4], COEF, pair[0].lm_mask)
    ref = jax.jit(jax.vmap(jfi.synthesize_abs2))(jnp.asarray(cf))
    got = fi.synthesize_abs2(torch.as_tensor(cf))
    f32 = fi32.synthesize_abs2(torch.as_tensor(cf))
    for g, r, f in zip(got, ref, f32):
        _held(g, r, f)


@pytest.mark.parametrize("method,ft_stab", [("HIO", True), ("ER", True),
                                            ("RAAR", False)])
def test_synthesize_update_bf16_matches_jax(pair, method, ft_stab):
    """The updated density away from the real constraint's thresholds by
    1e-2 of max (a bf16 difference flips a point nearer), the sums 1e-2
    relative."""
    jsht, _, _, _, rng = pair
    d = _cx(rng, COEF, jsht.lm_mask)
    rho_in = _cx(rng, GRID)
    support = rng.uniform(size=GRID) > 0.4
    w = rng.uniform(0.1, 1.0, (N_Q, N_THETA)).astype(np.float32)
    c_phase = np.exp(1j * np.array([0.7, -2.1])).astype(np.complex64)
    jfi, fi, fi32 = _fi_pair(pair)
    jrc = JaxRealConstraint(threshold_low=0.05, limit_imag=0.3)
    rc = RealConstraint(threshold_low=0.05, limit_imag=0.3)
    ref = jax.jit(jax.vmap(
        lambda d_, r, s, c: jfi.synthesize_update(
            d_, r, s, jnp.asarray(w), 0.6, c, method=method,
            ft_stab=ft_stab, real_constraint=jrc)))(
        jnp.asarray(d), jnp.asarray(rho_in),
        jnp.asarray(support, dtype=np.float32), jnp.asarray(c_phase))
    args = (torch.as_tensor(d), torch.as_tensor(rho_in),
            torch.as_tensor(support), torch.as_tensor(w), 0.6,
            torch.as_tensor(c_phase))
    kw = dict(method=method, ft_stab=ft_stab, real_constraint=rc)
    got = fi.synthesize_update(*args, **kw)
    f32 = fi32.synthesize_update(*args, **kw)
    rp, _ = fi.pre_constraint_plain(args[0], args[1], args[5],
                                    ft_stab=ft_stab)
    keep = fused_mtip.away_from_thresholds(
        rp, rc, BF16_TOL * float(rp.abs().max())).numpy()
    assert keep.mean() > 0.8
    _held(got[0], ref[0], f32[0], keep=keep)
    _sums_held(got[1:3], ref[1:3])
    # Σwρ² and Σwρ cancel: held to the sums of the terms' magnitudes
    new = np.abs(np.asarray(ref[0]))
    w3 = w[None, :, :, None]
    for g, r, s in zip(got[3:], ref[3:], ((w3 * new * new).sum((1, 2, 3)),
                                          (w3 * new).sum((1, 2, 3)))):
        assert np.all(np.abs(g.numpy() - np.asarray(r)) <= BF16_TOL * s)


# ------------------------------------------------------------ round trip
def test_round_trip_at_production_order():
    """L = 127, 320×640 (tests/test_transforms.py:851-876): the port's bf16
    round trip within JAX's window and no worse than JAX's bf16 FusedSHT,
    which also rounds its φ-DFT."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from sht_accuracy import HostSHT64, rel

    Lp, nt, nph = 127, 320, 640
    ref = HostSHT64(Lp, nt, nph)
    rng = np.random.default_rng(2)
    shape = (2, 2 * Lp + 1, Lp + 1)
    c0 = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
        * ref.mask
    c32 = c0.astype(np.complex64)
    jsht = JaxSHT(Lp, n_theta=nt, n_phi=nph)
    jfused = JaxFusedSHT(jsht, table_dtype=ml_dtypes.bfloat16)
    jrt = np.asarray(jax.jit(lambda x: jfused.forward(jfused.inverse(x)))(
        c32)) * ref.mask
    fused = FusedSHT(SphericalHarmonicTransform(Lp, nt, nph, device="cpu"),
                     table_dtype=BF16)
    c = torch.as_tensor(c32)
    rt = fused.forward(fused.inverse(c)).numpy() * ref.mask
    err, err_jax = rel(rt, c0), rel(jrt, c0)
    assert 1e-4 < err < 1e-2
    assert err <= err_jax, (err, err_jax)


# --------------------------------------------------------- the plumbing
def test_table_dtype_plumbs_through_ft_and_demo():
    """make_demo_problem(fused_table_dtype=) reaches FusedSHT and
    FusedIteration; a 2-iteration run on the CPU is finite and launches
    nothing; mxu_dtype reaches the plain SHT."""
    p = make_demo_problem(12, 6, fused_sht=True, fused_table_dtype=BF16,
                          device="cpu")
    assert p.ft.harmonic.table_dtype == BF16
    assert p.ft.harmonic._PW.dtype == p.ft.harmonic._P_t.dtype == BF16
    assert p.ft.harmonic._E_re.dtype == torch.float32
    assert p.mtip._fi is not None and p.mtip._fi.f is p.ft.harmonic
    sched = [Segment("HIO", 2, betas=np.full(2, 0.5), ft_stab=True)]
    _, errs = p.mtip.run_batch(p.initial_density_batch(0, 1), sched)
    assert torch.isfinite(errs).all()
    assert not any(p.ft.harmonic.launches.values())
    assert not any(p.mtip._fi.launches.values())
    q = make_demo_problem(12, 6, fused_sht=False, mxu_dtype=BF16,
                          device="cpu")
    assert q.ft.harmonic is q.ft.sht and q.ft.sht.mxu_dtype == BF16
    # float64 builds no FusedSHT: the table dtype is ignored
    r = make_demo_problem(12, 6, real_dtype=torch.float64,
                          fused_table_dtype=BF16, device="cpu")
    assert r.ft.harmonic is r.ft.sht and r.mtip._fi is None


def test_convert_carries_bf16_tables():
    """A JAX problem with bf16 FusedSHT tables through mtip_arrays and
    mtip_from_numpy: the port's FusedSHT gets bf16 tables equal to JAX's
    and its own float32 DFT tables; the first iteration of both within the
    bf16 regime (1e-2 relative), the float32 pair's within 1e-4."""
    jp = jax_demo(12, 6, fused_sht=True, fused_table_dtype=ml_dtypes.bfloat16)
    arrays, config = mtip_arrays(jp.mtip)
    assert config["table_dtype"] == "bfloat16"
    assert arrays["fused_PW"].dtype == np.float32
    mtip = mtip_from_numpy(arrays, config, "cpu")
    h = mtip.ft.harmonic
    assert h.table_dtype == BF16 and mtip._fi is not None
    assert np.array_equal(h._PW.float().numpy(), arrays["fused_PW"])
    own = FusedSHT(h.sht)
    assert torch.equal(h._E_re, own._E_re) and torch.equal(h._I_im,
                                                           own._I_im)
    rho0 = np.asarray(jp.initial_density_batch(0, 2))
    sched_j = [JaxSegment("HIO", 1, betas=np.full(1, 0.5), ft_stab=True)]
    sched_t = [Segment("HIO", 1, betas=np.full(1, 0.5), ft_stab=True)]
    _, e_j = jax.jit(lambda r: jp.mtip.run_batch(r, sched_j))(rho0)
    _, e_t = mtip.run_batch(torch.as_tensor(rho0), sched_t)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=BF16_TOL)
    a32, c32 = mtip_arrays(jax_demo(12, 6, fused_sht=True).mtip)
    assert c32["table_dtype"] == "float32"
    assert mtip_from_numpy(a32, c32, "cpu").ft.harmonic.table_dtype \
        == torch.float32


# ------------------------------------------------------------ the worker
L_SIM, N_SIM, L_REC, N_REC = 14, 48, 10, 24
BF16_KEY = {"fourier_transform": {"fused_bf16_tables": True}}


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The JAX chain simulate_ccd → extract at the pipeline test's sizes
    (tests/test_torch_options.py) in a temporary XFRAME_TPU_HOME."""
    home = str(tmp_path_factory.mktemp("xf_bf16_home"))
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = home
    xf.select_project("fxs", "simulate_ccd", overrides={
        "structure_name": "bf16", "dimensions": 3,
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
        "structure_name": "bf16", "dimensions": 3, "max_order": L_SIM})
    inv = xf.run()
    path = os.path.join(home, "bf16_invariants.npz")
    save_invariants(inv, path)
    yield inv, path, home
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


def _overrides(extra, inv_path=None):
    ov = {"structure_name": "bf16", "dimensions": 3, "particle_radius": 50,
          "grid": {"n_radial_points": N_REC, "max_order": L_REC},
          "multi_start": {"n_reconstructions": 2, "batch_size": 2,
                          "seed": 7},
          "main_loop": {"sub_loops": {
              "order": ["main"],
              "main": {"iterations": 1, "order": ["HIO", "SW", "ER"],
                       "methods": {"HIO": {"iterations": 3},
                                   "SW": {"iterations": 1},
                                   "ER": {"iterations": 2}}}}}}
    if inv_path is not None:
        ov["input"] = {"invariants_path": inv_path}
    return deep_update(ov, extra)


def _port_mtip(path, extra):
    w = select_worker("fxs", "reconstruct",
                      overrides=_overrides(extra, path), device="cpu")
    m, ft, aux = w.setup_mtip(w._load_invariants())
    return m, aux, w._build_schedule(ft)


def test_worker_first_iteration_matches_jax(chain):
    """Both workers with fused_sht true and fused_bf16_tables: the JAX
    fused iteration in interpret mode, the port's on the plain bf16 path;
    the first iteration's errors within 1e-2 relative, and the port's more
    than 1e-5 from its float32 run."""
    inv, path, _ = chain
    extra = deep_update({"fourier_transform": {"fused_sht": True}},
                        BF16_KEY)
    xf.select_project("fxs", "reconstruct", overrides=_overrides(extra))
    jw = JaxWorker()
    jm, jft, jaux = jw.setup_mtip(inv)
    assert jft._fused.table_dtype == ml_dtypes.bfloat16
    assert jm._fi is not None
    js = jw._build_schedule(jft)
    tm, taux, ts = _port_mtip(path, extra)
    assert tm.ft.harmonic.table_dtype == BF16 and tm._fi is not None
    rho0 = np.array(jaux["initial_density_batch"](7, 2))
    _, e_j = jax.jit(lambda r: jm.run_batch(r, js[:1]))(rho0)
    _, e_t = tm.run_batch(torch.as_tensor(rho0), ts[:1])
    e_j, e_t = np.asarray(e_j), e_t.numpy()
    assert e_t.shape == e_j.shape and np.isfinite(e_t).all()
    np.testing.assert_allclose(e_t[:, 0], e_j[:, 0], rtol=BF16_TOL)
    t32, _, s32 = _port_mtip(path, {"fourier_transform": {"fused_sht": True}})
    _, e32 = t32.run_batch(torch.as_tensor(rho0), s32[:1])
    e32 = e32.numpy()
    assert np.abs(e_t[:, 0] - e32[:, 0]).max() \
        > ODD_TOL * np.abs(e32[:, 0]).max()


@pytest.mark.parametrize("extra", [{"precision": "float64"},
                                   {"precision": "float64", "dimensions": 2},
                                   {"fourier_transform": {"fused_sht": False}}],
                         ids=["float64", "two_dimensions", "fused_sht_false"])
def test_worker_ignores_the_key_without_fused_sht(chain, extra):
    """Where no FusedSHT is built the key changes nothing: the worker's
    results with and without it are equal bit for bit."""
    _, path, _ = chain
    results = []
    for key in ({}, BF16_KEY):
        ov = _overrides(deep_update(dict(extra), key), path)
        ov["main_loop"]["sub_loops"]["main"]["methods"]["HIO"] = \
            {"iterations": 2}
        w = select_worker("fxs", "reconstruct", overrides=ov, device="cpu")
        results.append(w.run()["reconstruction_results"])
    a, b = results
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k]["real_density"], b[k]["real_density"])
        assert np.array_equal(a[k]["error_dict"]["main"],
                              b[k]["error_dict"]["main"])
