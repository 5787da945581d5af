"""The port's transforms against the JAX package's, on the CPU.

Plain torch SHT vs the JAX SphericalHarmonicTransform and vs the JAX
FusedSHT Pallas kernels in interpret mode (the case and tolerance of
tests/test_transforms.py:264-287: L=10, 24×48, 6 rows, 1e-5·max), plus the
Hankel, Fourier and integrator layers.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from xframe_tpu.ops.sht import SphericalHarmonicTransform as JSHT
from xframe_tpu.ops.pallas_sht import FusedSHT as JFused
from xframe_tpu.ops.fourier import SphericalFourierTransform as JFT
from xframe_tpu.ops.integrate import SphericalIntegrator as JInteg

from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
from xframe_tpu_torch.ops.fused_sht import FusedSHT, METHODS
from xframe_tpu_torch.ops.fourier import SphericalFourierTransform
from xframe_tpu_torch.ops.integrate import SphericalIntegrator

L, NT, NP, ROWS = 10, 24, 48, 6


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    f = (rng.normal(size=(ROWS, NT, NP))
         + 1j * rng.normal(size=(ROWS, NT, NP))).astype(np.complex64)
    jsht = JSHT(L, n_theta=NT, n_phi=NP)
    c = np.array(jax.jit(jsht.forward)(jnp.asarray(f)))
    inputs = {"forward": f, "inverse": c,
              "forward_real": np.abs(f).astype(np.float32),
              "inverse_real": c, "forward_real_abs2": f}
    return dict(inputs=inputs, jsht=jsht,
                jfused=JFused(jsht, q_block=4, m_splits=2),
                sht=SphericalHarmonicTransform(L, NT, NP, device="cpu"))


@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("method", METHODS)
def test_plain_matches_jax(case, method, reference):
    x = case["inputs"][method]
    ref = case["jsht"] if reference == "jnp" else case["jfused"]
    fn = getattr(ref, method, None)
    if fn is None:      # the JAX SHT has no fused |ψ|² analysis
        fn = lambda psi: ref.forward_real((psi * psi.conj()).real)  # noqa: E731
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    got = getattr(case["sht"], method)(torch.as_tensor(x)).numpy()
    assert _rel(got, want) < 1e-5, (method, reference)


@pytest.mark.parametrize("method", METHODS)
def test_fused_on_cpu_takes_plain_path(case, method):
    fused = FusedSHT(case["sht"])
    x = torch.as_tensor(case["inputs"][method])
    got = getattr(fused, method)(x)
    want = getattr(case["sht"], method)(x)
    assert torch.equal(got, want)
    assert fused.launches == dict.fromkeys(METHODS, 0)


def test_fused_tables_match_jax(case):
    fused = FusedSHT(case["sht"])
    jf, n_m = case["jfused"], 2 * L + 1
    for name in ("E_re", "E_im", "I_re", "I_im", "PW", "P_t"):
        want = np.asarray(getattr(jf, "_" + name))[:n_m]
        got = getattr(fused, "_" + name).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), name


def test_fused_rejects_other_devices(case):
    fused = FusedSHT(case["sht"])
    with pytest.raises(RuntimeError):
        fused.forward(torch.zeros((2, NT, NP), dtype=torch.complex64,
                                  device="meta"))
    assert fused.launches == dict.fromkeys(METHODS, 0)


@pytest.fixture(scope="module")
def fts():
    kw = dict(q_max=0.4, mode="midpoint", reciprocity_coefficient=2.0)
    return JFT(16, 8, **kw), SphericalFourierTransform(16, 8, device="cpu",
                                                       **kw)


def test_fourier_and_hankel_match_jax(fts):
    jft, tft = fts
    assert np.allclose(tft.rs, jft.rs) and np.allclose(tft.qs, jft.qs)
    for w in ("_wf", "_wi"):
        want = np.asarray(getattr(jft.hankel, w))
        got = getattr(tft.hankel, w).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    rng = np.random.default_rng(1)
    rho = (rng.normal(size=jft.grid_shape)
           + 0.3j * rng.normal(size=jft.grid_shape)).astype(np.complex64)
    c = np.array(jft.sht.forward(jnp.asarray(rho)))
    assert _rel(tft.hankel.forward(torch.as_tensor(c)).numpy(),
                jft.hankel.forward(c)) < 1e-5
    assert _rel(tft.hankel.inverse(torch.as_tensor(c)).numpy(),
                jft.hankel.inverse(c)) < 1e-5
    r = torch.as_tensor(rho)
    assert _rel(tft.forward(r).numpy(), jft.forward(jnp.asarray(rho))) < 1e-5
    assert _rel(tft.inverse(r).numpy(), jft.inverse(jnp.asarray(rho))) < 1e-5
    psi_t, rt_t = tft.forward_and_roundtrip(r)
    psi_j, rt_j = jft.forward_and_roundtrip(jnp.asarray(rho))
    assert _rel(psi_t.numpy(), psi_j) < 1e-5
    assert _rel(rt_t.numpy(), rt_j) < 1e-5
    # restarts as a leading axis give the per-restart transforms
    both = tft.forward(torch.stack([r, 2 * r]))
    assert torch.allclose(both[1], 2 * both[0], rtol=1e-5, atol=1e-6)


def test_integrator_matches_jax(fts):
    jft, tft = fts
    ji = JInteg(jft.qs, 16, 32)
    ti = SphericalIntegrator(tft.qs, 16, 32, device="cpu")
    assert np.abs(ti.w_broadcast.numpy() - ji.w_broadcast).max() \
        <= 1e-7 * ji.w_broadcast.max()
    assert ti._w.shape == (16, 16, 32)
