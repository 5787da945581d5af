"""Ground-truth fidelity of the port's phasing (plain path, CPU).

The port's make_demo_problem(32, 16) runs the 100-iteration schedule of
tests/test_phasing.py:74-80; the port's own align_to_ground_truth centers
its best density and the analytic truth of the demo's shape settings and
SO(3)-aligns the one to the other, and the real-space correlation must
exceed 0.9 (as tests/test_phasing.py:125 requires of the JAX path). The same
best density through the JAX package's align_to_ground_truth gives the same
truth, the same correlation within 1e-4 and an aligned density within 1e-4
of max.
"""
import numpy as np
import pytest
import torch

from xframe_tpu.ops.fourier import SphericalFourierTransform as JFT
from xframe_tpu.projects.fxs import fidelity as jfid

from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
from xframe_tpu_torch.projects.fxs.fidelity import (
    align_batch_to_ground_truth, align_to_ground_truth)
from xframe_tpu_torch.projects.fxs.phasing import Segment


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: on tensors this small, parallel test processes
    that each start a thread per core oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    p = make_demo_problem(32, 16, device="cpu")
    sigma = p.mtip.sw.default_sigma
    schedule = [
        Segment('HIO', 40, betas=np.full(40, 0.5), ft_stab=True),
        Segment('SW', sigma=sigma * 2, threshold=0.09),
        Segment('ER', 20, betas=np.zeros(20), ft_stab=True),
        Segment('SW', sigma=sigma, threshold=0.09),
        Segment('ER', 40, betas=np.zeros(40), ft_stab=True),
    ]
    rho0 = p.initial_density_batch(torch.Generator().manual_seed(7), 1)
    state, errors = p.mtip.run_batch(rho0, schedule)
    return p, state, errors[0].numpy()


def test_port_reaches_ground_truth(run):
    p, state, errors = run
    assert errors.shape == (100, 2) and np.isfinite(errors).all()
    assert errors[-1, 0] < 0.1 * errors[:5, 0].mean()
    assert errors[-1, 0] < 5e-2
    corr, aligned, truth, info = align_to_ground_truth(
        state.best_rho[0], p.shapes, p.ft, p.integrator.w_broadcast)
    assert aligned.shape == truth.shape == p.rho_true.shape
    assert corr > 0.9, f"real-space correlation {corr} ({info})"


def test_ground_truth_alignment_matches_jax(run):
    p, state, _ = run
    jft = JFT(32, 16, q_max=0.4, mode="midpoint", reciprocity_coefficient=2.0)
    assert np.allclose(jft.rs, p.ft.rs)
    w = p.integrator.w_broadcast.numpy()
    best = state.best_rho[0].numpy()
    corr, aligned, truth, info = align_to_ground_truth(best, p.shapes, p.ft, w)
    jcorr, jaligned, jtruth = jfid.align_to_ground_truth(best, p.shapes, jft,
                                                         w)
    assert np.abs(truth - jtruth).max() <= 1e-4 * np.abs(jtruth).max()
    assert abs(corr - jcorr) <= 1e-4, (corr, jcorr)
    assert np.abs(aligned - jaligned).max() <= 1e-4 * np.abs(jaligned).max()
    assert np.isclose(jfid.density_correlation(aligned, truth, w), corr,
                      rtol=1e-12)


def test_batch_alignment_equals_single(run):
    """A batch of densities aligns as each does alone."""
    p, state, _ = run
    w = p.integrator.w_broadcast
    best = state.best_rho[0]
    stack = torch.stack([best, best.conj() * 0.5, p.initial_density_batch(
        torch.Generator().manual_seed(3), 1)[0]])
    corrs, aligned, truth, infos = align_batch_to_ground_truth(
        stack, p.shapes, p.ft, w)
    assert len(corrs) == len(infos) == 3 and aligned.shape[0] == 3
    for i in range(3):
        corr, one, truth1, info = align_to_ground_truth(stack[i], p.shapes,
                                                        p.ft, w)
        assert np.array_equal(truth1, truth)
        assert info["inverted"] == infos[i]["inverted"]
        assert abs(corr - corrs[i]) <= 1e-5
        assert np.abs(one - aligned[i]).max() <= 1e-5 * np.abs(one).max()
    assert corrs[0] > 0.9
