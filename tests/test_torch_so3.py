"""The port's SO(3) tools (xframe_tpu_torch/ops/so3.py) against the JAX
package's (CPU).

The Wigner tables are numpy copies (tests/test_torch_host_tables.py holds
them equal); here the torch rotation and correlation are held to
xframe_tpu.ops.so3 on the same coefficients: the correlation within 1e-4 of
max|C| (float32 sums in another order), single and batched; the rotation
preserves each order's norm, its inverse restores the coefficients, and the
correlation's maximum recovers a rotation applied on the SO(3) grid, as
tests/test_so3.py requires of the JAX package.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from xframe_tpu.ops import so3 as jso3

from xframe_tpu_torch.ops import so3 as tso3


def _coeff(L, lead, seed, decay=False):
    rng = np.random.default_rng(seed)
    coeff = np.zeros(lead + (2 * L + 1, L + 1), dtype=np.complex64)
    for l in range(L + 1):
        s = slice(L - l, L + l + 1)
        c = rng.normal(size=lead + (2 * l + 1,)) \
            + 1j * rng.normal(size=lead + (2 * l + 1,))
        coeff[..., s, l] = c / (1 + l) if decay else c
    return coeff


@pytest.mark.parametrize("L,n_r,weighted,bandwidth",
                         [(6, 3, False, None), (8, 4, True, None),
                          (5, 2, True, 8)])
def test_correlate_matches_jax(L, n_r, weighted, bandwidth):
    f, g = _coeff(L, (n_r,), 0), _coeff(L, (n_r,), 1)
    w = np.linspace(0.2, 1.0, n_r) if weighted else None
    want = np.asarray(jso3.SO3Correlator(L, bandwidth=bandwidth).correlate(
        jnp.asarray(f), jnp.asarray(g), radial_weights=w))
    corr = tso3.SO3Correlator(L, bandwidth=bandwidth, device="cpu")
    got = corr.correlate(torch.as_tensor(f), torch.as_tensor(g),
                         radial_weights=w).numpy()
    assert got.shape == want.shape == (corr.n_ab,) * 3
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # a batch of candidates against one reference: one call, same values
    gs = np.stack([g, _coeff(L, (n_r,), 2)])
    batch = corr.correlate(torch.as_tensor(f), torch.as_tensor(gs),
                           radial_weights=w).numpy()
    assert np.abs(batch[0] - got).max() <= 1e-5 * np.abs(got).max()
    want1 = np.asarray(jso3.SO3Correlator(L, bandwidth=bandwidth).correlate(
        jnp.asarray(f), jnp.asarray(gs[1]), radial_weights=w))
    assert np.abs(batch[1] - want1).max() <= 1e-4 * np.abs(want1).max()


def test_rotate_coeff_roundtrip_and_unitarity():
    L = 6
    coeff = torch.as_tensor(_coeff(L, (3,), 0))
    a, b, g = 0.7, 1.1, -0.4
    rot = tso3.rotate_coeff(coeff, tso3.wigner_D_single(L, a, b, g))
    want = np.asarray(jso3.rotate_coeff(jnp.asarray(coeff.numpy()),
                                        jso3.wigner_D_single(L, a, b, g)))
    assert np.abs(rot.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    for l in range(L + 1):
        np.testing.assert_allclose(torch.linalg.norm(rot[..., l]),
                                   torch.linalg.norm(coeff[..., l]),
                                   rtol=1e-5)
    back = tso3.rotate_coeff(rot, tso3.wigner_D_single(L, -g, -b, -a))
    assert np.abs((back - coeff).numpy()).max() <= 1e-5


def test_correlation_recovers_rotation():
    L = 8
    coeff = _coeff(L, (2,), 2, decay=True)
    corr = tso3.SO3Correlator(L, device="cpu")
    a0, b0, g0 = corr.alphas[5], corr.betas[7], corr.gammas[11]
    g_rot = tso3.rotate_coeff(torch.as_tensor(coeff),
                              tso3.wigner_D_single(L, a0, b0, g0))
    C = corr.correlate(g_rot, torch.as_tensor(coeff))
    angles = corr.argmax_euler(C)
    aligned = tso3.rotate_coeff(torch.as_tensor(coeff),
                                tso3.wigner_D_single(L, *angles))
    rel = float(torch.linalg.norm(aligned - g_rot) / torch.linalg.norm(g_rot))
    assert rel < 0.05, (rel, (a0, b0, g0), angles)
    np.testing.assert_allclose(angles, (a0, b0, g0), atol=1e-12)
