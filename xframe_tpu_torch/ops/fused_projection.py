"""The Newton–Schulz polar factor and the fused data projection through
hand-written CUDA.

Port of `xframe_tpu.ops.pallas_kernels` (polar_unitary_pallas,
fused_projection_bucket). Each wrapper dispatches on the input's device, as
`FusedSHT` does:

  * a CPU tensor takes the plain PyTorch version beside it;
  * a CUDA tensor launches the kernel of `csrc/projection.cu`, or raises;
  * any other device raises.

Each kernel launch adds one to `launches[<wrapper>]`; nothing else does.

The TPU kernels take float32 re/im planes zero-padded to 128-lane tiles;
here complex64 tensors go in as they are, with no padding: a zero pad changes
no result (the Newton–Schulz norm is a max of row and column sums, and the
odd polynomials keep zero singular values at zero), and the kernels tile by
their own bounds. The schedule's (a, b, c) rows reach the kernel as a device
table built once per schedule and device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from xframe_tpu_torch.ops import _build

METHODS = ("polar_unitary", "fused_projection_bucket")
launches = dict.fromkeys(METHODS, 0)

_QUINTIC = (3.4445, -4.7750, 2.0315)
_CUBIC = (1.5, -0.5, 0.0)
_SLOTS = 4   # c×c scratch matrices per kernel block (csrc/projection.cu)


def reset_launches():
    for k in launches:
        launches[k] = 0


def _f32(x):
    """A Python float rounded to float32, as the JAX package's coefficient
    arrays are."""
    return float(np.float32(x))


def polar_unitary_newton_schulz(M, iterations=18, eps=1e-12, schedule=None):
    """Unitary polar factor of a (batched) matrix by Newton–Schulz
    iterations: fixed quintic steps (3.4445, −4.7750, 2.0315) plus four cubic
    polishing steps, or the per-step minimax `schedule` of (a, b, c). The
    plain version of `polar_unitary`."""
    a = M.abs()
    norm = torch.sqrt(a.sum(-1).amax(-1) * a.sum(-2).amax(-1))[..., None, None]
    X = M / (norm + eps)

    def gram(X):
        return X.conj().transpose(-1, -2) @ X

    def cubic(X):
        return 1.5 * X - 0.5 * (X @ gram(X))

    if schedule is not None:
        for ca, cb, cc in schedule:
            A = gram(X)
            X = _f32(ca) * X + X @ (_f32(cb) * A + _f32(cc) * (A @ A))
        return X
    for _ in range(iterations):
        A = gram(X)
        X = _QUINTIC[0] * X + X @ (_QUINTIC[1] * A + _QUINTIC[2] * (A @ A))
    for _ in range(4):
        X = cubic(X)
    return X


def schedule_rows(iterations, schedule):
    """The (a, b, c) of every step the kernels run: the minimax schedule, or
    `iterations` fixed quintic steps and four cubic ones (c = 0, which the
    kernel runs without A²)."""
    if schedule is not None:
        return tuple(tuple(_f32(v) for v in row) for row in schedule)
    return (_QUINTIC,) * int(iterations) + (_CUBIC,) * 4


@functools.lru_cache(maxsize=None)
def _table(rows, device):
    return torch.tensor(np.asarray(rows, np.float32).reshape(-1, 3),
                        device=device)


def _on_card(x, name):
    """False for a CPU tensor (plain path), True for a CUDA one; raises
    otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} takes CPU or CUDA tensors, got {x.device}")
    return True


def _launch(method, entry, device, *args):
    _build.launch(entry, *args, torch.cuda.current_stream(device).cuda_stream)
    launches[method] += 1


def _complex64(x, name):
    if x.dtype != torch.complex64:
        raise TypeError(f"{name}: the kernel takes complex64, got {x.dtype}")
    return _build.kernel_input(x, torch.complex64)


# -------------------------------------------------------------------- B7
def polar_unitary(m, iterations=16, schedule=None):
    """Polar factors of a batch of complex matrices (..., c, c), by the
    Newton–Schulz iteration of `polar_unitary_newton_schulz` (fixed
    `iterations` + 4 cubic steps, or the minimax `schedule`)."""
    if not _on_card(m, "polar_unitary"):
        return polar_unitary_newton_schulz(m, iterations, schedule=schedule)
    c = m.shape[-1]
    if m.dim() < 2 or m.shape[-2] != c:
        raise ValueError(f"polar_unitary: square matrices expected, got "
                         f"{tuple(m.shape)}")
    x = _complex64(m, "polar_unitary").reshape(-1, c, c)
    w = torch.empty_like(x)
    scratch = torch.empty((x.shape[0], _SLOTS, c, c), dtype=torch.complex64,
                          device=x.device)
    rows = schedule_rows(iterations, schedule)
    table = _table(rows, x.device)
    _launch("polar_unitary", "xf_polar_unitary", x.device, x.data_ptr(),
            w.data_ptr(), scratch.data_ptr(), table.data_ptr(), len(rows),
            x.shape[0], c)
    return w.reshape(m.shape)


# -------------------------------------------------------------------- B8
def fused_projection_bucket(pd, it, v, take, *, l_lo, h, iterations=16,
                            schedule=None):
    """The data projection of one bucket of orders l = l_lo + g on their
    centered crop of half-width h (c = 2h+1 columns):

        B = PD_l·I_l, M = B + rms·eyeᶜ, W = polar(M),
        out = take·(V_l·W) + (1 − take)·I_l,

    rms = √(Σ|B|²/(2l+1)) + 1e-20, eyeᶜ the identity on the crop's diagonal
    outside [h − l, h + l]. pd (G, c, n_q), v (G, n_q, c) complex; take
    (G, n_q) float 0/1, broadcast over m; it (..., G, n_q, c) with the
    restarts leading → (..., G, n_q, c)."""
    if not _on_card(it, "fused_projection_bucket"):
        return fused_projection_bucket_plain(pd, it, v, take, l_lo=l_lo, h=h,
                                             iterations=iterations,
                                             schedule=schedule)
    n_g, c, n_q = pd.shape
    if c != 2 * h + 1 or tuple(v.shape) != (n_g, n_q, c) \
            or tuple(take.shape) != (n_g, n_q) \
            or tuple(it.shape[-3:]) != (n_g, n_q, c):
        raise ValueError(f"fused_projection_bucket: PD {tuple(pd.shape)}, "
                         f"I {tuple(it.shape)}, V {tuple(v.shape)}, take "
                         f"{tuple(take.shape)} do not fit h = {h}")
    x = _complex64(it, "fused_projection_bucket").reshape(-1, n_g, n_q, c)
    pd = _complex64(pd, "fused_projection_bucket")
    v = _complex64(v, "fused_projection_bucket")
    take = _build.kernel_input(take, torch.float32)
    out = torch.empty_like(x)
    scratch = torch.empty((x.shape[0] * n_g, _SLOTS, c, c),
                          dtype=torch.complex64, device=x.device)
    rows = schedule_rows(iterations, schedule)
    table = _table(rows, x.device)
    _launch("fused_projection_bucket", "xf_fused_projection", x.device,
            pd.data_ptr(), x.data_ptr(), v.data_ptr(), take.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), table.data_ptr(), len(rows),
            x.shape[0], n_g, c, n_q, l_lo, h)
    return out.reshape(it.shape)


def fused_projection_bucket_plain(pd, it, v, take, *, l_lo, h, iterations=16,
                                  schedule=None):
    n_g, c = pd.shape[0], pd.shape[1]
    B = pd @ it
    ls = torch.arange(l_lo, l_lo + n_g, device=B.device)
    rms = torch.sqrt((B.abs() ** 2).sum((-2, -1))
                     / (2 * ls + 1).to(B.real.dtype))[..., None]
    idx = torch.arange(c, device=B.device)
    outside = (idx < h - ls[:, None]) | (idx > h + ls[:, None])
    M = B + torch.diag_embed(outside * (rms + 1e-20)).to(B.dtype)
    W = polar_unitary_newton_schulz(M, iterations, schedule=schedule)
    t = take[..., None].to(B.real.dtype)
    return t * (v @ W) + (1 - t) * it
