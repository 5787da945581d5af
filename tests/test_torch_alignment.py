"""The port's 3D Aligner (xframe_tpu_torch/projects/fxs/alignment.py)
against the JAX package's (CPU), at N_q = 16, L = 8.

Both start from the same candidates: the demo's true density rotated by a
known rotation off the SO(3) grid, one of them point-inverted (two balls are
their own point inverse up to a rotation, so either answer may win), with
noise.
center and coefficients agree within 1e-4 of max; align and align_batch
give the JAX angles and inversion wherever the correlation's maximum is
clear (its top two values ≥ 1e-3 of the maximum apart; otherwise a float32
rounding may pick the neighbour) and aligned densities within 1e-4 of max;
align_batch equals the serial align.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from xframe_tpu.ops.fourier import SphericalFourierTransform as JFT
from xframe_tpu.projects.fxs.alignment import Aligner as JAligner

from xframe_tpu_torch.ops.so3 import rotate_coeff, wigner_D_single
from xframe_tpu_torch.projects.fxs.alignment import Aligner
from xframe_tpu_torch.projects.fxs.demo import make_demo_problem

N_Q, L = 16, 8
ROTATIONS = [(0.4, 1.3, 2.2, False), (2.9, 0.7, 5.1, True)]


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def aligners():
    p = make_demo_problem(N_Q, L, device="cpu")
    jft = JFT(N_Q, L, q_max=0.4 * N_Q / 32, mode="midpoint",
              reciprocity_coefficient=2.0)
    np.testing.assert_allclose(jft.rs, p.ft.rs)
    np.testing.assert_allclose(jft.qs, p.ft.qs)
    w = p.integrator.w_broadcast.numpy()
    port = Aligner(p.ft, w)
    truth = torch.as_tensor(p.rho_true.astype(np.complex64))
    coeff = port.coefficients(truth)
    rng = np.random.default_rng(4)
    cands = []
    for a, b, g, inv in ROTATIONS:
        c = rotate_coeff(coeff, wigner_D_single(L, a, b, g))
        if inv:
            c = port.invert_parity(c)
        rho = port.sht.inverse(c)
        noise = rng.normal(size=rho.shape) * 0.02 * float(rho.abs().max())
        cands.append(rho + torch.as_tensor(noise.astype(np.float32)))
    return p, port, JAligner(jft, w), truth, torch.stack(cands)


def test_center_and_coefficients(aligners):
    p, port, jal, truth, cands = aligners
    for rho in (truth, cands[0], cands[1]):
        got, com = port.center(rho)
        want, wcom = jal.center(jnp.asarray(rho.numpy()))
        assert _max_rel(got.numpy(), want) < 1e-4
        np.testing.assert_allclose(com.numpy(), np.asarray(wcom), atol=1e-5)
        assert _max_rel(port.coefficients(got).numpy(),
                        jal.coefficients(jnp.asarray(got.numpy()))) < 1e-4
    got, _, coms = port.center_batch(cands)
    for i in range(len(cands)):
        want, wcom = jal.center(jnp.asarray(cands[i].numpy()))
        assert _max_rel(got[i].numpy(), want) < 1e-4
        np.testing.assert_allclose(coms[i].numpy(), np.asarray(wcom),
                                   atol=1e-5)


def _clear(port, ref_coeff, rho, inverted):
    """The correlation's top two values are ≥ 1e-3 of its maximum apart."""
    c = port.coefficients(rho)
    if inverted:
        c = port.invert_parity(c)
    C = port.corr.correlate(port._truncate(ref_coeff), port._truncate(c),
                            radial_weights=port._w_r).numpy().ravel()
    top = np.sort(C)[-2:]
    return top[1] - top[0] >= 1e-3 * abs(top[1])


@pytest.mark.parametrize("k", range(len(ROTATIONS)))
def test_align_matches_jax(aligners, k):
    p, port, jal, truth, cands = aligners
    ref_c = port.center(truth)[0]
    rho_c = port.center(cands[k])[0]
    ref_coeff = port.coefficients(ref_c)
    got, _, info = port.align(rho_c, ref_coeff)
    want, _, winfo = jal.align(jnp.asarray(rho_c.numpy()),
                               jnp.asarray(ref_coeff.numpy()))
    assert info["inverted"] == winfo["inverted"]
    if _clear(port, ref_coeff, rho_c, info["inverted"]):
        np.testing.assert_allclose(info["angles"], winfo["angles"],
                                   atol=1e-12)
        np.testing.assert_allclose(info["score"], winfo["score"], rtol=1e-4)
    assert _max_rel(got.numpy(), want) < 1e-4


def test_align_batch_matches_serial_and_jax(aligners):
    p, port, jal, truth, cands = aligners
    ref_c = port.center(truth)[0]
    ref_coeff = port.coefficients(ref_c)
    rhos = port.center_batch(cands)[0]
    psis = p.ft.forward(rhos)
    rot, psi_rot, l2, infos = port.align_batch(rhos, ref_coeff, ref_rho=ref_c,
                                               psis=psis)
    jrot, jpsi, jl2, jinfos = jal.align_batch(
        jnp.asarray(rhos.numpy()), jnp.asarray(ref_coeff.numpy()),
        ref_rho=jnp.asarray(ref_c.numpy()), psis=jnp.asarray(psis.numpy()))
    for i in range(len(cands)):
        serial, _, info = port.align(rhos[i], ref_coeff)
        assert infos[i]["inverted"] == info["inverted"] \
            == jinfos[i]["inverted"]
        np.testing.assert_allclose(infos[i]["angles"], info["angles"],
                                   atol=1e-12)
        assert _max_rel(rot[i].numpy(), serial.numpy()) < 1e-5
        if _clear(port, ref_coeff, rhos[i], info["inverted"]):
            np.testing.assert_allclose(infos[i]["angles"],
                                       jinfos[i]["angles"], atol=1e-12)
        assert _max_rel(rot[i].numpy(), np.asarray(jrot[i])) < 1e-4
        assert _max_rel(psi_rot[i].numpy(), np.asarray(jpsi[i])) < 1e-4
        np.testing.assert_allclose(l2[i], port.l2_distance(rot[i], ref_c),
                                   rtol=1e-5)
    np.testing.assert_allclose(l2, np.asarray(jl2), rtol=1e-3)
