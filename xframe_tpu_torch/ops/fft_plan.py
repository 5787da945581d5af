"""The host plan of the shared-memory Stockham FFTs of `csrc/fft.cuh`.

Every FFT route of the port's kernels runs on this plan: the analyses B1,
B9 and B3 and the syntheses B2 and B10 (`ops/fused_sht.py`), B4's
projection and the syntheses of B5, B6, B11 and B12, B12's with its |ψ|²
analysis (`ops/fused_mtip.py`). A FusedSHT
builds it once for its n_φ and its FusedIteration shares it. The route
exists where n_φ = 2^a·3^b·5^c; any other n_φ has no plan and keeps the
dense DFTs against the E/I tables.

The line rule (`fft_block_lines`) is host code too: how many θ lines one
FFT block holds follows from n_φ and the card's shared memory, the wrapper
sizes its per-tile partial sums by it and passes it, and the launch
(`csrc/sht.cuh` fft_block_lines, the same rule) refuses any other count.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

_RADICES = (4, 2, 3, 5)   # the FFT's passes, in this order
_MAX_PASSES = 10          # kMaxPasses: radices packed 3 bits each
# (most, least) θ lines per block of each FFT kernel, halving from the
# first: the analysis (B1, B9, B3) and the synthesis (B2, B10, B5, B6,
# B11, B12) 4, 2 or 1 (B9's, B3's, B10's and B11's FFT lines each carry two
# real θ lines, and B12's |ψ|² FFTs two per line in the same buffers);
# B4's projection 8, 4 or 2, its lines running in pairs
FFT_KERNELS = {"analysis": (4, 1), "synthesis": (4, 1), "projection": (8, 2)}
_STATIC_RESERVE = 1024    # kStaticReserve: a kernel's static shared memory


def fft_radices(n):
    """The radices of the Stockham FFT of length n, 4s first, then 2, 3
    and 5; None where n has another prime factor (the dense route)."""
    out = []
    for r in _RADICES:
        while n % r == 0:
            out.append(r)
            n //= r
    return out if n == 1 and 0 < len(out) <= _MAX_PASSES else None


def fft_twiddles(n):
    """tw[t] = e^{−2πi·t/n}, t = 0..n−1, complex64 (the forward FFT's
    twiddles; the inverse conjugates them)."""
    return np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)


def fft_bins(l_max, n):
    """The FFT bin of column j = m + L of the Fourier columns, m = −L..L:
    (j − L) mod n, torch.fft.fft's ordering."""
    return (np.arange(-l_max, l_max + 1) % n).astype(np.int32)


@dataclass(frozen=True)
class FftPlan:
    """An FFT route on the card: the radices packed 3 bits each (first
    pass lowest), the twiddle table and the bin map."""
    code: int
    twiddles: torch.Tensor
    bins: torch.Tensor


def fft_plan(l_max, n_phi, device):
    """The FFT plan for n_φ, or None for the dense route."""
    radices = fft_radices(n_phi)
    if radices is None:
        return None
    return FftPlan(sum(r << (3 * k) for k, r in enumerate(radices)),
                   torch.as_tensor(fft_twiddles(n_phi), device=device),
                   torch.as_tensor(fft_bins(l_max, n_phi), device=device))


def fft_block_lines(kernel, n_phi, l_max, smem_optin):
    """θ lines per block of the FFT route's `kernel` ("analysis",
    "synthesis" or "projection", FFT_KERNELS) at n_φ on a card whose blocks
    may opt in to `smem_optin` bytes of shared memory: the largest count
    whose two line buffers and twiddle table (and, for B4, the tile's L+1
    Legendre sums per line) fit beside the static reserve; 0 where none
    does. csrc/sht.cuh fft_block_lines is the same rule."""
    most, least = FFT_KERNELS[kernel]
    stride = n_phi + (n_phi + 15) // 16                # fft_line_stride
    per_line = 8 * (l_max + 1) if kernel == "projection" else 0
    lines = most
    while lines >= least:
        if (2 * lines * stride + n_phi) * 8 + lines * per_line \
                + _STATIC_RESERVE <= smem_optin:
            return lines
        lines //= 2
    return 0


@functools.lru_cache(maxsize=None)
def smem_optin(device):
    """The shared memory a block may opt in to on a CUDA device, in bytes
    (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232,448 on the H100)."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin
