"""The port's 2D (polar) transforms and projections against the JAX
package's (CPU).

Same numpy inputs through both:
  * the polar Hankel weights, every quadrature mode, raw and assembled:
    within 1e-10 of max in float64;
  * PolarHankelTransform, CircularHarmonicTransform, PolarFourierTransform
    (forward, inverse, forward_and_roundtrip), RealCircularHarmonics: within
    1e-5 of max in float32 (FFTs and matmuls summed in another order);
  * PolarIntegrator's weights exactly (float32 of the same float64 table),
    its integral and L2 norm within 1e-6 relative;
  * ReciprocalConstraintPolar with and without the SO(2) pin, the port on a
    batch against the JAX package per restart: phases and projected
    coefficients within 1e-5 of max, the pinned phase exactly 1;
  * shrink-wrap on a polar grid (threshold and fixed-volume): the supports
    equal away from the threshold.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from xframe_tpu.ops import fourier as jfourier
from xframe_tpu.ops import hankel as jhankel
from xframe_tpu.ops import integrate as jintegrate
from xframe_tpu.ops import sht as jsht
from xframe_tpu.projects.fxs import projections as jp

from xframe_tpu_torch.ops import fourier as tfourier
from xframe_tpu_torch.ops import hankel as thankel
from xframe_tpu_torch.ops import integrate as tintegrate
from xframe_tpu_torch.ops import sht as tsht
from xframe_tpu_torch.projects.fxs import projections as tp

MODES = ["midpoint", "trapz", "gauss", "Zernike"]
TOL64, TOL = 1e-10, 1e-5
N, M, N_PHI, Q_MAX, RC = 24, 8, 32, 0.4, 2.0


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


@pytest.mark.parametrize("mode", MODES)
def test_polar_weights(mode):
    want = jhankel.generate_weights(M, N, RC, 2, mode)
    got = thankel.generate_weights(M, N, RC, 2, mode)
    assert got["dimension"] == 2
    assert _rel(got["weights"], want["weights"]) <= TOL64
    r_max = jhankel.radial_grids(mode, Q_MAX, N, RC)[2]
    aw = jhankel.assemble_weights(want["weights"], r_max, RC, 2, mode)
    at = thankel.assemble_weights(got["weights"], r_max, RC, 2, mode)
    assert at["forward"].shape[-1] == 2 * M + 1
    for k in ("forward", "inverse"):
        assert _rel(at[k], aw[k]) <= TOL64


@pytest.mark.parametrize("mode", MODES)
def test_polar_hankel_transform(mode):
    wd = jhankel.generate_weights(M, N, RC, 2, mode)
    r_max = jhankel.radial_grids(mode, Q_MAX, N, RC)[2]
    jh = jhankel.PolarHankelTransform(wd, r_max, RC)
    th = thankel.PolarHankelTransform(wd, r_max, RC, device="cpu")
    f = _cplx(np.random.default_rng(1), (3, N, 2 * M + 1))
    for name in ("forward", "inverse"):
        want = np.asarray(getattr(jh, name)(jnp.asarray(f)))
        got = getattr(th, name)(torch.as_tensor(f)).numpy()
        assert _rel(got, want) < TOL, name


def test_circular_harmonic_transform():
    jc, tc = jsht.CircularHarmonicTransform(N_PHI), \
        tsht.CircularHarmonicTransform(N_PHI)
    rng = np.random.default_rng(2)
    f = _cplx(rng, (2, N, N_PHI))
    r = rng.normal(size=(2, N, N_PHI)).astype(np.float32)
    for x in (f, r):
        assert _rel(tc.forward(torch.as_tensor(x)).numpy(),
                    jc.forward(jnp.asarray(x))) < TOL
    assert _rel(tc.inverse(torch.as_tensor(f)).numpy(),
                jc.inverse(jnp.asarray(f))) < TOL


@pytest.mark.parametrize("mode", MODES)
def test_polar_fourier_transform(mode):
    jft = jfourier.PolarFourierTransform(N, M, N_PHI, Q_MAX, mode=mode,
                                         reciprocity_coefficient=RC)
    tft = tfourier.PolarFourierTransform(N, M, N_PHI, Q_MAX, mode=mode,
                                         reciprocity_coefficient=RC,
                                         device="cpu")
    np.testing.assert_array_equal(tft.rs, jft.rs)
    np.testing.assert_array_equal(tft.qs, jft.qs)
    assert tft.grid_shape == (N, N_PHI)
    f = _cplx(np.random.default_rng(3), (2, N, N_PHI))
    for name in ("forward", "inverse"):
        assert _rel(getattr(tft, name)(torch.as_tensor(f)).numpy(),
                    getattr(jft, name)(jnp.asarray(f))) < TOL, name
    got = tft.forward_and_roundtrip(torch.as_tensor(f))
    want = jft.forward_and_roundtrip(jnp.asarray(f))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < TOL
    # from_parts on the JAX tables computes the same transform
    h = thankel.PolarHankelTransform.from_tables(
        np.asarray(jft.hankel._wf), np.asarray(jft.hankel._wi), mode,
        device="cpu")
    part = tfourier.PolarFourierTransform.from_parts(
        jft.rs, jft.qs, jft.r_max, jft.q_max, N_PHI, h)
    assert part.m_max == M
    assert _rel(part.forward(torch.as_tensor(f)).numpy(),
                jft.forward(jnp.asarray(f))) < TOL


def test_polar_integrator():
    rs = np.linspace(0.5, 30.0, N)
    ji = jintegrate.PolarIntegrator(rs, N_PHI)
    ti = tintegrate.PolarIntegrator(rs, N_PHI, device="cpu")
    np.testing.assert_array_equal(ti._w.numpy(), ji._w)
    assert ti.norm == ji.norm and ti.max_r == ji.max_r
    v = _cplx(np.random.default_rng(4), (3, N, N_PHI))
    for name in ("integrate", "l2_norm"):
        assert _rel(getattr(ti, name)(torch.as_tensor(v)).numpy(),
                    getattr(ji, name)(jnp.asarray(v))) < 1e-6, name


def test_real_circular_harmonics():
    jc, tc = jp.RealCircularHarmonics(N_PHI, M), \
        tp.RealCircularHarmonics(N_PHI, M)
    i = np.random.default_rng(5).random((2, N, N_PHI)).astype(np.float32)
    want = np.asarray(jc.forward(jnp.asarray(i)))
    got = tc.forward(torch.as_tensor(i)).numpy()
    assert got.shape == (2, N, M + 1) and _rel(got, want) < TOL
    assert _rel(tc.inverse(torch.as_tensor(want)).numpy(),
                jc.inverse(jnp.asarray(want))) < TOL


def _polar_constraints(pin, seed=6):
    rng = np.random.default_rng(seed)
    qs = np.linspace(0.05, 0.4, N)
    vecs = [_cplx(rng, (N,)) for _ in range(M + 1)]
    avg = rng.random(N)
    mask = rng.random((M + 1, N)) > 0.2
    kw = dict(used_order_ids=np.arange(0, M + 1, 2),
              use_averaged_intensity=True, average_intensity=avg,
              radial_mask=mask, n_particles=3.0, so_pin_order=pin)
    return (jp.ReciprocalConstraintPolar.build(vecs, qs, M, **kw),
            tp.ReciprocalConstraintPolar.build(vecs, qs, M, device="cpu",
                                               **kw))


@pytest.mark.parametrize("pin", [None, 2], ids=["free", "so2_pin"])
def test_reciprocal_constraint_polar(pin):
    jrc, trc = _polar_constraints(pin)
    for name in ("V", "VD", "use_order", "radial_mask"):
        np.testing.assert_array_equal(getattr(trc, name).numpy(),
                                      np.asarray(getattr(jrc, name)))
    Im = _cplx(np.random.default_rng(7), (3, N, M + 1))
    phases = trc.approximate_unknowns(torch.as_tensor(Im)).numpy()
    out = trc(torch.as_tensor(Im)).numpy()
    for b in range(3):
        want_ph = np.asarray(jrc.approximate_unknowns(jnp.asarray(Im[b])))
        assert _rel(phases[b], want_ph) < TOL
        assert _rel(out[b], jrc(jnp.asarray(Im[b]))) < TOL
    assert np.allclose(np.abs(phases), 1.0, atol=1e-5)
    if pin is not None:
        assert (phases[:, pin] == 1.0).all()


@pytest.mark.parametrize("mode", ["threshold", "fixed_volume"])
def test_shrink_wrap_polar(mode):
    rng = np.random.default_rng(8)
    qs = np.linspace(0.05, 0.4, N)
    w = jintegrate.PolarIntegrator(np.linspace(0.5, 30, N), N_PHI)._w
    sup = np.zeros((N, N_PHI), bool)
    sup[: N // 2] = True
    kw = dict(mode=mode, volume_fraction=0.4, integration_weights=w,
              initial_support=sup)
    jsw = jp.ShrinkWrap.build(qs, grid_rank=2, **kw)
    tsw = tp.ShrinkWrap.build(qs, grid_rank=2, device="cpu", **kw)
    assert tuple(tsw.q_radii.shape) == (N, 1)
    conv = rng.random((2, N, N_PHI)).astype(np.float32)
    cur = rng.random((2, N, N_PHI)) > 0.3
    got = tsw.new_support(torch.as_tensor(conv), 0.3,
                          current_support=torch.as_tensor(cur)).numpy()
    for b in range(2):
        want = np.asarray(jsw.new_support(jnp.asarray(conv[b]), 0.3,
                                          current_support=jnp.asarray(
                                              cur[b])))
        np.testing.assert_array_equal(got[b], want)
    s = 0.7
    assert _rel(tsw.gaussian_values(s).numpy(), jsw.gaussian_values(s)) \
        < TOL
