"""The port's polar (B7) and fused-projection (B8) modules against the JAX
package's Pallas kernels in interpret mode (CPU).

`ops.fused_projection.polar_unitary` and `fused_projection_bucket` take
their plain versions here, on the same numpy inputs as
`xframe_tpu.ops.pallas_kernels.polar_unitary_pallas` and
`fused_projection_bucket`. Inputs are well-conditioned full-rank matrices
(W is not comparable in float32 where a block is rank deficient, ROADMAP
§C). Tolerances are the JAX tests' own: 5e-4 for the polar kernel against
the jnp polar (tests/test_polar_schedule.py:125), 5e-3·max for the fused
projection (tests/test_phasing.py:389-390), and 1e-5·max in float64, where
both packages run the same iteration.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from xframe_tpu.ops.pallas_kernels import (
    fused_projection_bucket as jax_bucket, polar_unitary_pallas)
from xframe_tpu.ops.polar_schedule import DEFAULT_SCHEDULE
from xframe_tpu.projects.fxs import projections as jp

from xframe_tpu_torch.ops import fused_projection as fp

SCHEDULES = pytest.mark.parametrize("schedule", [None, DEFAULT_SCHEDULE],
                                    ids=["fixed", "minimax"])


def _cx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


@SCHEDULES
def test_polar_unitary_matches_jax_kernel(schedule):
    """Two 30×30 matrices, zero-padded to a 128-lane tile on the JAX side
    only (the port does not pad)."""
    rng = np.random.default_rng(9)
    n, p = 30, 128
    m = _cx(rng, (2, n, n))
    re = np.zeros((2, p, p), np.float32)
    im = np.zeros((2, p, p), np.float32)
    re[:, :n, :n], im[:, :n, :n] = m.real, m.imag
    wr, wi = polar_unitary_pallas(jnp.asarray(re), jnp.asarray(im), 16,
                                  schedule=schedule, interpret=True)
    want = np.asarray(wr)[:, :n, :n] + 1j * np.asarray(wi)[:, :n, :n]
    got = fp.polar_unitary(torch.as_tensor(m), 16, schedule=schedule).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    assert np.abs(got - want).max() < 5e-4
    assert np.abs(got.conj().transpose(0, 2, 1) @ got - np.eye(n)).max() \
        < 1e-3
    assert fp.launches == dict.fromkeys(fp.METHODS, 0)


@SCHEDULES
def test_polar_unitary_float64_matches_jax(schedule):
    """In float64 the plain version runs the JAX package's iteration."""
    m = _cx(np.random.default_rng(3), (3, 17, 17))
    with jax.enable_x64(True):
        want = np.asarray(jp.polar_unitary_newton_schulz(
            jnp.asarray(m, dtype=jnp.complex128), 16, schedule=schedule))
    got = fp.polar_unitary(torch.as_tensor(m, dtype=torch.complex128), 16,
                           schedule=schedule).numpy()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_schedule_rows():
    rows = fp.schedule_rows(16, None)
    assert len(rows) == 20 and rows[0] == (3.4445, -4.7750, 2.0315)
    assert rows[-1] == (1.5, -0.5, 0.0)
    rows = fp.schedule_rows(16, DEFAULT_SCHEDULE)
    assert len(rows) == len(DEFAULT_SCHEDULE)
    assert rows[0][0] == float(np.float32(DEFAULT_SCHEDULE[0][0]))


@SCHEDULES
@pytest.mark.parametrize("l_lo,h", [(0, 5), (6, 7)])
def test_fused_projection_bucket_matches_jax_kernel(schedule, l_lo, h):
    """One bucket, two restarts (the JAX kernel runs each alone), a radial
    mask in `take`, n_q ≥ c so that every block has full rank."""
    rng = np.random.default_rng(21 + h)
    c, n_q = 2 * h + 1, 2 * h + 4
    g = h - l_lo + 1
    pd, v = _cx(rng, (g, c, n_q)), _cx(rng, (g, n_q, c))
    it = _cx(rng, (2, g, n_q, c))
    take = (rng.random((g, n_q)) > 0.3).astype(np.float32)
    kw = dict(l_lo=l_lo, h=h, iterations=16, schedule=schedule)
    tb = np.broadcast_to(take[:, :, None], (g, n_q, c)).astype(np.float32)
    want = []
    for r in range(2):
        o_re, o_im = jax_bucket(
            pd.real, pd.imag, it[r].real, it[r].imag, v.real, v.imag, tb,
            c=c, n_q=n_q, interpret=True, **kw)
        want.append(np.asarray(o_re) + 1j * np.asarray(o_im))
    want = np.stack(want)
    got = fp.fused_projection_bucket(*map(torch.as_tensor, (pd, it, v, take)),
                                     **kw).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 5e-3 * np.abs(want).max()
    # rows outside `take` keep the input exactly
    keep = np.broadcast_to(take[None, :, :, None] == 0, got.shape)
    assert np.array_equal(got[keep], it[keep])
    assert fp.launches == dict.fromkeys(fp.METHODS, 0)


def test_kernel_inputs_hold_their_values():
    """A lazily conjugated view can already be contiguous (x.conj(), or the
    .mH of a column-major Q from torch.linalg.qr); what a kernel receives
    holds the view's values in its memory, not the unconjugated ones."""
    from xframe_tpu_torch.ops import _build
    rng = np.random.default_rng(5)
    q = torch.linalg.qr(torch.as_tensor(_cx(rng, (2, 9, 7))))[0]
    for view in (q.mH, q.contiguous().conj()):
        assert view.is_contiguous() and view.is_conj()
        got = _build.kernel_input(view, torch.complex64)
        assert got.is_contiguous() and not got.is_conj()
        # view_as_real reads the memory behind data_ptr()
        assert torch.equal(torch.view_as_real(got),
                           torch.stack([view.real, view.imag], -1))
    neg = q.conj().imag                   # a pending negation
    assert neg.is_neg()
    got = _build.kernel_input(neg, torch.float32)
    assert not got.is_neg() and torch.equal(got, -q.imag)
