"""Spherical harmonic transforms through the hand-written CUDA kernels.

Port of `xframe_tpu.ops.pallas_sht.FusedSHT` (forward, inverse,
forward_real, inverse_real, forward_real_abs2). Each method dispatches on the
input's device:

  * a CPU tensor takes the plain PyTorch version (`ops/sht.py`);
  * a CUDA tensor launches the kernel of `csrc/sht.cu`, or raises;
  * any other device raises.

There is no fallback: a failed build or a non-zero cudaError_t raises. Each
kernel launch adds one to `self.launches[<method>]`; nothing else does.

`table_dtype=torch.bfloat16` (the worker's fourier_transform.
fused_bf16_tables, the JAX package's `FusedSHT(table_dtype=bfloat16)`)
holds the Legendre tables P_t and PW on the card in bf16, at half the
bytes, and launches the kernels' bf16 forms (the entry points named with
`_bf16` at the end, counted under `<method>_bf16`): at every Legendre
product the data operand is rounded to bf16 by round-to-nearest-even (the
Fourier columns of an analysis; the coefficients of a synthesis, after the
Hermitian fold of a real output, which stays float32) and every sum
accumulates in float32; the FFT route's per-order GEMMs run on the BF16
tensor cores. The φ-transforms stay float32, the FFTs and the dense
route's E and I alike, so the result does not depend on the route. That is
one rounding fewer than the JAX package's bf16 FusedSHT, which also rounds
its φ-DFT; it is the JAX plain transform under `mxu_dtype=bfloat16` wherever
n_θ is odd (at even n_θ the JAX transform folds θ about the equator before
the rounding, which the port does not). CPU tensors take `self.plain`, the
plain transform at `mxu_dtype` bf16 (ops/sht.py), the plain version of
every bf16 form; a CUDA tensor never takes it or the float32 kernels.

The tables follow `pallas_sht.py:312-342` without the TPU's padding of m to
a multiple of 8: the analysis DFT E[j, φ] = e^{−imφ}·2π/n_φ, the synthesis
DFT I[j, φ] = e^{+imφ}, the quadrature table PW[j, θ, l] and the transposed
synthesis table P_t[j, l, θ], j = m + L. The real-input analyses read rows
L..2L of E and PW (the JAX package's separate Ep/PWp tables). The tables are
also those of the fused MTIP kernels (`ops/fused_mtip.py`).

Every method has two routes, chosen from n_φ before the launch
(`analysis_route`, `synthesis_route`): where n_φ = 2^a·3^b·5^c, the FFT plan
of `ops/fft_plan.py` (built here once, shared with the FusedIteration) runs
the φ-transforms as Stockham FFTs. The analyses forward (B1), forward_real
(B9) and forward_real_abs2 (B3) run the FFTs into a scratch of Fourier
columns, (rows, 2L+1, n_θ) for B1 and (rows, L+1, n_θ) for the real fields
B9 and B3 (two θ lines per FFT), and a per-order GEMM runs the quadrature;
the syntheses inverse (B2) and inverse_real (B10) run the Legendre stage as
a per-order GEMM into a scratch of Fourier columns, (rows, 2L+1, n_θ) for B2
and (rows, L+1, n_θ) for B10 (folded onto m ≥ 0, two θ lines per FFT), then
the inverse FFTs. Any other n_φ keeps the dense DFT against E or I. One
entry point per method runs either route and counts one launch. How many θ
lines an FFT block holds follows from n_φ and the card (`fft_lines`, the
line rule of `ops/fft_plan.py`); past the rule's limit the wrapper raises
before the launch.
"""
from __future__ import annotations

import numpy as np
import torch

from xframe_tpu_torch.ops import _build, fft_plan

METHODS = ("forward", "inverse", "forward_real", "inverse_real",
           "forward_real_abs2")
BF16_METHODS = tuple(m + _build.BF16_SUFFIX for m in METHODS)


def table_suffix(table_dtype):
    """"" for float32 tables, "_bf16" for bf16 ones: the suffix of the
    entry points and launch counters of that form; raises for any other
    dtype."""
    if table_dtype == torch.float32:
        return ""
    if table_dtype == torch.bfloat16:
        return _build.BF16_SUFFIX
    raise ValueError(f"table_dtype {table_dtype}: the kernels hold their "
                     f"Legendre tables in float32 or bfloat16")


class FusedSHT:
    """Kernel-backed forward/inverse/forward_real/inverse_real/
    forward_real_abs2 for a SphericalHarmonicTransform; same shapes and
    layouts as its methods. table_dtype: torch.float32 or torch.bfloat16,
    the dtype of the Legendre tables on the card (the module's
    docstring)."""

    def __init__(self, sht, table_dtype=torch.float32):
        self.sht = sht
        self.table_dtype = table_dtype
        self._tag = table_suffix(table_dtype)
        self._plain = None
        self.device = sht.device
        self.l_max, self.n_theta, self.n_phi = sht.l_max, sht.n_theta, sht.n_phi
        self.n_m = sht.n_m
        self.launches = dict.fromkeys((m + self._tag for m in METHODS), 0)
        self.fft = fft_plan.fft_plan(self.l_max, self.n_phi, self.device)
        L, n_phi = self.l_max, self.n_phi
        phi = 2 * np.pi * np.arange(n_phi) / n_phi
        ms = np.arange(-L, L + 1)
        E = np.exp(-1j * np.outer(ms, phi)) * (2 * np.pi / n_phi)
        I = np.exp(1j * np.outer(ms, phi))
        self.set_tables(E.real, E.imag, I.real, I.imag,
                        sht._PW.cpu().numpy(),
                        np.swapaxes(sht._P.cpu().numpy(), 1, 2))

    def set_tables(self, E_re, E_im, I_re, I_im, PW, P_t):
        """Install the kernel tables from host arrays: the DFT tables E and
        I in float32 (None keeps the ones installed), the Legendre tables
        PW and P_t at table_dtype (rounded to it from float32 values)."""
        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                                   device=self.device).to(dtype)
        if E_re is not None:
            self._E_re, self._E_im = dev(E_re), dev(E_im)
            self._I_re, self._I_im = dev(I_re), dev(I_im)
        self._PW, self._P_t = dev(PW, self.table_dtype), \
            dev(P_t, self.table_dtype)

    @property
    def plain(self):
        """The plain version of this form, made at first use: the
        SphericalHarmonicTransform without rounding (sht itself, for
        float32 tables) or at mxu_dtype bf16 (bf16 tables)."""
        if self._plain is None:
            self._plain = self.sht.with_mxu_dtype(
                None if self.table_dtype == torch.float32
                else self.table_dtype)
        return self._plain

    def reset_launches(self):
        for k in self.launches:
            self.launches[k] = 0

    # ------------------------------------------------------------ dispatch
    def _rows(self, x, tail, dtype):
        """(..., *tail) → contiguous (rows, *tail) of `dtype` on the card;
        None for a CPU tensor (plain path)."""
        if x.device.type == "cpu":
            return None
        if x.device.type != "cuda":
            raise RuntimeError(f"FusedSHT takes CPU or CUDA tensors, got "
                               f"{x.device}")
        if x.device != self._PW.device:
            raise RuntimeError(f"input on {x.device}, tables on "
                               f"{self._PW.device}")
        if tuple(x.shape[-len(tail):]) != tail:
            raise ValueError(f"expected trailing shape {tail}, got "
                             f"{tuple(x.shape)}")
        return _build.kernel_input(x.reshape((-1,) + tail), dtype)

    def _launch(self, method, entry, x, tensors, ints=()):
        """entry(x, *tensors (None: a null pointer), rows, n_θ, n_φ, L,
        *ints, stream) of this table dtype's form, counted as one launch of
        `method` in that form."""
        _build.launch(entry + self._tag, x.device, x.data_ptr(),
                      *map(_build.ptr, tensors),
                      x.shape[0], self.n_theta, self.n_phi, self.l_max, *ints)
        self.launches[method + self._tag] += 1

    @property
    def analysis_route(self):
        """"fft" or "dense": how forward, forward_real and
        forward_real_abs2 run their φ-transforms at this n_φ
        (analysis_fft_kernel and quadrature_gemm_kernel, or analysis_kernel,
        of csrc/sht.cuh)."""
        return "dense" if self.fft is None else "fft"

    @property
    def synthesis_route(self):
        """"fft" or "dense": how inverse and inverse_real run their
        φ-synthesis at this n_φ (legendre_gemm_kernel and
        synthesis_fft_kernel, or synthesis_kernel, of csrc/sht.cuh)."""
        return "dense" if self.fft is None else "fft"

    def fft_lines(self, kernel):
        """θ lines per block of the FFT route's `kernel` ("analysis": B1,
        B9 and B3, "synthesis": B2, B10, B5, B6, B11 and B12,
        "projection": B4) at
        this n_φ on the tables' card, by the line rule of ops/fft_plan.py;
        raises where not even the kernel's fewest lines fit a block."""
        optin = fft_plan.smem_optin(self._PW.device)
        lines = fft_plan.fft_block_lines(kernel, self.n_phi, self.l_max,
                                         optin)
        if lines == 0:
            least = fft_plan.FFT_KERNELS[kernel][1]
            raise RuntimeError(
                f"the {kernel} FFT kernel refuses n_φ = {self.n_phi}: "
                f"{least} θ line(s) of it take more than the {optin} bytes "
                f"of shared memory a block may have")
        return lines

    def fft_operands(self, rows, n_cols, kernel):
        """The FFT route's launch operands for `rows` rows of `kernel`:
        ((twiddle table, scratch of Fourier columns (rows, n_cols, n_θ)
        complex64), (radix code, θ lines per block)); ((None, None), (0, 0))
        on the dense route."""
        if self.fft is None:
            return (None, None), (0, 0)
        lines = self.fft_lines(kernel)
        scratch = torch.empty((rows, n_cols, self.n_theta),
                              dtype=torch.complex64, device=self.device)
        return (self.fft.twiddles, scratch), (self.fft.code, lines)

    def _analyse(self, method, entry, x, n_cols):
        """B1, B9 or B3 on the route of this n_φ: → coefficients (rows,
        2L+1, L+1). n_cols: the Fourier columns the FFT route keeps (2L+1,
        or L+1 for a real field)."""
        out = torch.empty((x.shape[0], self.n_m, self.l_max + 1),
                          dtype=torch.complex64, device=x.device)
        (tw, g), ints = self.fft_operands(x.shape[0], n_cols, "analysis")
        self._launch(method, entry, x,
                     (self._E_re, self._E_im, self._PW, tw, g, out), ints)
        return out

    # ---------------------------------------------------------- transforms
    def forward(self, f):
        """f(..., θ, φ) complex → coefficients (..., 2L+1, L+1)."""
        grid = (self.n_theta, self.n_phi)
        x = self._rows(f, grid, torch.complex64)
        if x is None:
            return self.plain.forward(f)
        out = self._analyse("forward", "xf_sht_forward", x, self.n_m)
        return out.reshape(f.shape[:-2] + out.shape[1:])

    def forward_real(self, f):
        """Real f(..., θ, φ) → coefficients (..., 2L+1, L+1); the kernel
        fills the m < 0 rows from c_{l,−m} = (−1)^m conj(c_{l,m})."""
        grid = (self.n_theta, self.n_phi)
        x = self._rows(f, grid, torch.float32)
        if x is None:
            return self.plain.forward_real(f)
        out = self._analyse("forward_real", "xf_sht_forward_real", x,
                            self.l_max + 1)
        return out.reshape(f.shape[:-2] + out.shape[1:])

    def forward_real_abs2(self, psi):
        """Complex ψ(..., θ, φ) → analysis of |ψ|², (..., 2L+1, L+1); the
        kernel squares ψ in registers, so the intensity grid never exists."""
        grid = (self.n_theta, self.n_phi)
        x = self._rows(psi, grid, torch.complex64)
        if x is None:
            return self.plain.forward_real_abs2(psi)
        out = self._analyse("forward_real_abs2", "xf_sht_forward_real_abs2",
                            x, self.l_max + 1)
        return out.reshape(psi.shape[:-2] + out.shape[1:])

    def _synthesize(self, method, entry, x, n_cols, dtype):
        """B2 or B10 on the route of this n_φ: → grid (rows, n_θ, n_φ) of
        `dtype`. n_cols: the Fourier columns the FFT route keeps (2L+1, or
        L+1 for the real synthesis)."""
        out = torch.empty((x.shape[0], self.n_theta, self.n_phi),
                          dtype=dtype, device=x.device)
        (tw, fm), ints = self.fft_operands(x.shape[0], n_cols, "synthesis")
        self._launch(method, entry, x,
                     (self._P_t, self._I_re, self._I_im, tw, fm, out), ints)
        return out

    def inverse(self, c):
        """Coefficients (..., 2L+1, L+1) → complex f(..., θ, φ)."""
        coef = (self.n_m, self.l_max + 1)
        x = self._rows(c, coef, torch.complex64)
        if x is None:
            return self.plain.inverse(c)
        out = self._synthesize("inverse", "xf_sht_inverse", x, self.n_m,
                               torch.complex64)
        return out.reshape(c.shape[:-2] + out.shape[1:])

    def inverse_real(self, c):
        """Coefficients (..., 2L+1, L+1) → Re(inverse(c)), float32, for any
        c (Hermitian or not)."""
        coef = (self.n_m, self.l_max + 1)
        x = self._rows(c, coef, torch.complex64)
        if x is None:
            return self.plain.inverse_real(c)
        out = self._synthesize("inverse_real", "xf_sht_inverse_real", x,
                               self.l_max + 1, torch.float32)
        return out.reshape(c.shape[:-2] + out.shape[1:])
