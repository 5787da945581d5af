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

B7 and B8 run each (restart, order) matrix on a thread-block cluster whose
blocks hold one or two product groups of 256 threads, each group a worker
that forms output tiles on its own; the two kernels share the normalisation
and the Newton–Schulz steps. Their launch plan is host code, so that the
CPU tests reach it: `launch_shape` picks the cluster size and the groups
per block for each call (B7) or bucket (B8) from the matrix count, c and
the card's resident clusters of that kernel (`max_active_clusters`), and
`hermitian_tiles` lists the 64×64 tiles on and above the diagonal that the
Hermitian products X†X and A² form (the kernel mirrors the rest).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from xframe_tpu_torch.ops import _build

METHODS = ("polar_unitary", "fused_projection_bucket")
launches = dict.fromkeys(METHODS, 0)

_QUINTIC = (3.4445, -4.7750, 2.0315)
_CUBIC = (1.5, -0.5, 0.0)
_SLOTS = 4   # c×c scratch matrices per matrix (csrc/projection.cu kSlots)
_TILE = 64   # output tile of a product (kGM, kGN)
_CLUSTERS = (1, 2, 4, 8, 16)   # cluster sizes B7 and B8 may launch (kMaxCluster)
_GROUPS = (1, 2)   # product groups per block (polar_kernel<G>, project_kernel<G>)
# the kernel codes of xf_max_active_clusters
_CLUSTER_KERNELS = {"fused_projection_bucket": 0, "polar_unitary": 1}
# Two of B8's workers on one SM form 1.4× the tiles one alone does in the
# same time (chip_smoke.py's bucket sweep at N_q = 256, L = 127 on an H100).
_PAIR_GAIN = 1.4


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
    _build.launch(entry, device, *args)
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
    shape = launch_shape(x.shape[0], c,
                         max_active_clusters(x.device, "polar_unitary"),
                         _sm_count(x.device))
    launch_polar(x, w, schedule_rows(iterations, schedule), shape)
    return w.reshape(m.shape)


def launch_polar(x, w, rows, shape):
    """One launch of B7 on checked complex64 matrices x and w (n_mat, c, c),
    in clusters of shape = (S blocks, G groups each); polar_unitary chooses
    the shape, chip_smoke.py also times the others."""
    n_mat, c = x.shape[0], x.shape[-1]
    scratch = torch.empty((n_mat, _SLOTS, c, c), dtype=torch.complex64,
                          device=x.device)
    table = _table(rows, x.device)
    herm = _herm_table(c, x.device)
    _launch("polar_unitary", "xf_polar_unitary", x.device, x.data_ptr(),
            w.data_ptr(), scratch.data_ptr(), table.data_ptr(),
            herm.data_ptr(), herm.shape[0], *shape, len(rows), n_mat, c)


# -------------------------------------------------------------------- B8
def hermitian_tiles(c):
    """(row, column) tile indices of a c×c Hermitian product on and above
    the diagonal, row-major: the tiles B8 forms of X†X and A²; rank r of a
    cluster of S takes entries r, r + S, …. → int32 (n, 2)."""
    nt = -(-c // _TILE)
    return np.array([(i, j) for i in range(nt) for j in range(i, nt)],
                    dtype=np.int32).reshape(-1, 2)


def launch_shape(n_mat, c, resident, n_sm):
    """(blocks per cluster S, product groups per block G) of B7 or B8 for a
    call of `n_mat` c×c matrices on a card of `n_sm` SMs that holds
    resident[(S, G)] such clusters of the kernel at once
    (`max_active_clusters`). A cluster has S·G
    workers. Each candidate (no more workers than output tiles, at least
    one resident cluster) is costed wave by wave: the tiles one worker forms
    per quintic step (its share of the two Hermitian products and of the
    full one) times the workers an SM runs in that wave, over their joint
    rate (_PAIR_GAIN for two); the cheapest wins, on a tie the one with
    fewer workers, then fewer groups."""
    nt = -(-c // _TILE)
    full, herm = nt * nt, nt * (nt + 1) // 2
    best = None
    for s in _CLUSTERS:
        for g in _GROUPS:
            workers = s * g
            if workers > full or resident.get((s, g), 0) < 1:
                continue
            tiles = 2 * -(-herm // workers) + -(-full // workers)
            cost, left = 0.0, n_mat
            while left > 0:
                wave = min(left, resident[(s, g)])
                left -= wave
                per_sm = g * -(-wave * s // n_sm)
                cost += tiles * per_sm / (1 + (_PAIR_GAIN - 1) * (per_sm - 1))
            key = (cost, workers, g)
            if best is None or key < best[0]:
                best = (key, (s, g))
    if best is None:
        raise RuntimeError(f"no cluster of {n_mat} c = {c} matrices fits "
                           f"the card (resident clusters {resident})")
    return best[1]


@functools.lru_cache(maxsize=None)
def max_active_clusters(device, kernel):
    """{(S, G): clusters of S blocks of G product groups of `kernel`'s
    kernel ("polar_unitary": B7, "fused_projection_bucket": B8) the card
    holds at once}, from cudaOccupancyMaxActiveClusters; 0 where a shape
    does not launch."""
    out = {}
    with torch.cuda.device(device):     # the query reads the current device
        stream = torch.cuda.current_stream(device).cuda_stream
        for s in _CLUSTERS:
            for g in _GROUPS:
                n = ctypes.c_int(0)
                err = _build.library().xf_max_active_clusters(
                    ctypes.addressof(n), _CLUSTER_KERNELS[kernel], s, g,
                    stream)
                out[(s, g)] = n.value if err == 0 else 0
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _herm_table(c, device):
    return torch.as_tensor(hermitian_tiles(c), device=device)


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
    n_mat = x.shape[0] * n_g
    shape = launch_shape(n_mat, c,
                         max_active_clusters(x.device,
                                             "fused_projection_bucket"),
                         _sm_count(x.device))
    launch_bucket(pd, x, v, take, out, l_lo, h,
                  schedule_rows(iterations, schedule), shape)
    return out.reshape(it.shape)


def launch_bucket(pd, it, v, take, out, l_lo, h, rows, shape):
    """One launch of B8 on checked complex64 inputs, it and out (batch,
    n_g, n_q, c), in clusters of shape = (S blocks, G groups each);
    fused_projection_bucket chooses the shape, chip_smoke.py also times the
    others."""
    n_g, c = pd.shape[0], pd.shape[1]
    scratch = torch.empty((it.shape[0] * n_g, _SLOTS, c, c),
                          dtype=torch.complex64, device=it.device)
    table = _table(rows, it.device)
    herm = _herm_table(c, it.device)
    _launch("fused_projection_bucket", "xf_fused_projection", it.device,
            pd.data_ptr(), it.data_ptr(), v.data_ptr(), take.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), table.data_ptr(),
            herm.data_ptr(), herm.shape[0], *shape, len(rows), it.shape[0],
            n_g, c, pd.shape[2], l_lo, h)


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
