"""Spherical and circular harmonic transforms in plain PyTorch.

Port of `xframe_tpu.ops.sht.SphericalHarmonicTransform` and
`CircularHarmonicTransform` (the 2D transform: an FFT over φ, see its
class). The spherical transform:

  forward:  FFT over φ → per-m associated-Legendre contraction over θ
  inverse:  per-m Legendre synthesis → inverse FFT over φ

Coefficient layout is dense and padded: (..., 2L+1, L+1) indexed [j, l] with
centered m (m = j - L) and entries l < |m| zero. Orthonormal Y_lm with the
Condon-Shortley phase; Gauss-Legendre nodes in cos θ (θ ascending), uniform
φ in [0, 2π). `forward` carries the 2π/n_φ normalization and the quadrature
weights; the synthesis has none.

These five functions are also the plain versions of the CUDA kernels in
`csrc/sht.cu` (see `ops/fused_sht.py`), in float32. With
`real_dtype=torch.float64` the tables are float64 and the transforms
complex128: the transforms of `precision: float64`, which no kernel runs.

With `mxu_dtype=torch.bfloat16` (the JAX package's `mxu_dtype`) the
Legendre tables hold bf16 values and each Legendre contraction rounds its
data operand to bf16 by round-to-nearest-even and sums in float32: the
Fourier columns of an analysis, the coefficients of a synthesis. The FFTs
stay float32. These are also the plain versions of the kernels' bf16-table
forms (`FusedSHT(table_dtype=torch.bfloat16)`), so `inverse_real` rounds
the coefficients after their Hermitian fold onto m ≥ 0, which stays
float32, as the kernels do; for Hermitian coefficients that fold is exact
and the result is the JAX package's. Unlike the JAX package the port does
not fold θ about the equator at even n_θ before the rounding (the JAX
transform adds f(θ) and f(π−θ) first and rounds the sum): at odd n_θ the
two agree up to the order of the float32 sums, at even n_θ within the
bf16 rounding.

A θ shard of the spherical transform (`theta_shard`) holds the rows
[a, b) of the θ axis: its analyses contract those rows and sum the
partial coefficients over the θ ranks (the entries l ≥ |m| only: the
tables, hence the partial sums, are exactly zero below), its syntheses
give those rows.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from xframe_tpu_torch.library.legendre import (gauss_legendre,
                                               sph_legendre_table_full_m)


def complex_dtype_of(real_dtype):
    """complex64 for float32, complex128 for float64."""
    return torch.complex64 if real_dtype == torch.float32 \
        else torch.complex128


def angular_grid_size(l_max: int, anti_aliasing_degree: int = 2):
    """n_phi = 2^(⌊log2((N+1)·L)⌋+1), n_theta = n_phi/2."""
    n = anti_aliasing_degree
    n_phi = 2 ** (int(np.log2((n + 1) * max(l_max, 1))) + 1)
    n_phi = max(n_phi, 2 * (l_max + 1))
    return n_phi // 2, n_phi


class SphericalHarmonicTransform:
    """forward(f): (..., n_theta, n_phi) → (..., 2L+1, L+1) coefficients;
    inverse(c): (..., 2L+1, L+1) → (..., n_theta, n_phi). Tables live on
    `device` at `real_dtype` (float32 or float64); the transforms compute
    at the matching complex dtype. On a θ shard n_theta is the shard's
    rows and `shard` sums partial coefficients over the θ ranks.
    mxu_dtype: None, or torch.bfloat16 for bf16 Legendre products (the
    module's docstring)."""

    shard = None              # a θ shard (ThetaShard); None: whole grid

    def __init__(self, l_max: int, n_theta: int | None = None,
                 n_phi: int | None = None, anti_aliasing_degree: int = 2, *,
                 real_dtype=torch.float32, mxu_dtype=None, device):
        self.l_max = int(l_max)
        nt_d, np_d = angular_grid_size(self.l_max, anti_aliasing_degree)
        self.n_theta = int(n_theta) if n_theta else nt_d
        self.n_phi = int(n_phi) if n_phi else np_d
        if self.n_phi < 2 * self.l_max + 1:
            raise ValueError(
                f"n_phi={self.n_phi} cannot resolve m up to ±{self.l_max}")
        if self.n_theta < self.l_max + 1:
            raise ValueError(
                f"n_theta={self.n_theta} cannot resolve l up to {self.l_max}")
        self.n_m = 2 * self.l_max + 1
        self.device = torch.device(device)
        self.real_dtype = real_dtype
        self.complex_dtype = complex_dtype_of(real_dtype)
        self.mxu_dtype = mxu_dtype
        x, w = gauss_legendre(self.n_theta)
        x, w = x[::-1].copy(), w[::-1].copy()
        self.cos_theta = x
        self.theta = np.arccos(x)
        self.phi = 2 * np.pi * np.arange(self.n_phi) / self.n_phi
        self.gl_weights = w
        ms = np.arange(-self.l_max, self.l_max + 1)
        self.lm_mask = np.arange(self.l_max + 1)[None, :] >= np.abs(ms)[:, None]
        P = sph_legendre_table_full_m(self.l_max, x)        # (n_m, θ, L+1)
        np_real = np.float32 if real_dtype == torch.float32 else np.float64
        self.set_tables(P.astype(np_real),
                        (P * w[None, :, None]).astype(np_real))

    def set_tables(self, P, PW):
        """Synthesis table P[m, θ, l] and analysis table PW[m, θ, l] (GL
        weights folded in), from host arrays, at the transform's dtype
        (rounded to mxu_dtype first where one is set)."""
        def dev(a):
            t = torch.as_tensor(np.asarray(a), device=self.device)
            if self.mxu_dtype is not None:
                t = t.to(self.mxu_dtype)
            return t.to(self.real_dtype)
        self._P, self._PW = dev(P), dev(PW)

    def with_mxu_dtype(self, mxu_dtype):
        """This transform with Legendre products at `mxu_dtype` (None: at
        the real dtype, on the tables as they are): itself where it has
        it, else a copy, whose tables are rounded to a new mxu_dtype."""
        if mxu_dtype == self.mxu_dtype:
            return self
        new = copy.copy(self)
        new.mxu_dtype = mxu_dtype
        if mxu_dtype is not None:
            new._P = self._P.to(mxu_dtype).to(self.real_dtype)
            new._PW = self._PW.to(mxu_dtype).to(self.real_dtype)
        return new

    def theta_shard(self, shard):
        """This transform on a rank's θ rows (`shard`, a
        projections.ThetaShard: `shard.rows`, a slice of the grid's): those
        rows of the tables and of the θ nodes; `shard.all_reduce` sums the
        partial coefficients of the analyses over the θ ranks, the one
        exchange of an analysis. The syntheses exchange nothing. → a new
        transform sharing the rest."""
        rows = shard.rows
        new = copy.copy(self)
        new.n_theta = len(range(self.n_theta)[rows])
        new.cos_theta, new.theta = self.cos_theta[rows], self.theta[rows]
        new.gl_weights = self.gl_weights[rows]
        new._P = self._P[:, rows].contiguous()
        new._PW = self._PW[:, rows].contiguous()
        new.shard = shard
        new._lm = torch.as_tensor(self.lm_mask, device=self.device)
        return new

    def _summed(self, c, rows=slice(None)):
        """Partial coefficients (m rows `rows`) of a θ shard summed over
        its θ ranks: the entries l ≥ |m| travel, the zeros below stay."""
        if self.shard is None:
            return c
        lm = self._lm[rows]
        out = torch.zeros_like(c)
        out[..., lm], = self.shard.all_reduce((c[..., lm],),
                                              name="sht_analysis")
        return out

    # ---------------------------------------------------------------- cores
    def _cx_einsum(self, spec, x, table):
        """complex × real-table einsum as two real contractions; under
        mxu_dtype the data operand is rounded to it (the table already
        holds its values) and the products, exact in the real dtype, are
        summed there."""
        re, im = x.real, x.imag
        if self.mxu_dtype is not None:
            re = re.to(self.mxu_dtype).to(self.real_dtype)
            im = im.to(self.mxu_dtype).to(self.real_dtype)
        return torch.complex(torch.einsum(spec, re, table),
                             torch.einsum(spec, im, table))

    def _analysis(self, fm, rows=slice(None)):
        """(..., θ, m-subset) Fourier columns → (..., m-subset, L+1)."""
        return self._cx_einsum("...tm,mtl->...ml", fm, self._PW[rows])

    def _synthesis(self, c):
        """(..., 2L+1, L+1) → (..., θ, 2L+1) Fourier columns."""
        return self._cx_einsum("...ml,mtl->...tm",
                               c.to(self.complex_dtype), self._P)

    # ------------------------------------------------------------ transforms
    def forward(self, f):
        """f(..., θ, φ) → f_lm (..., 2L+1, L+1)."""
        fm = torch.fft.fft(f.to(self.complex_dtype), dim=-1)
        L = self.l_max
        fm = torch.cat([fm[..., fm.shape[-1] - L:], fm[..., : L + 1]], dim=-1)
        return self._summed(self._analysis(fm * (2 * np.pi / self.n_phi)))

    def forward_real(self, f):
        """Analysis of a REAL field: rfft, m = 0..L contraction, then
        c_{l,-m} = (-1)^m conj(c_{l,m}) fills the negative rows."""
        L = self.l_max
        fm = torch.fft.rfft(f.to(self.real_dtype), dim=-1)[..., : L + 1] \
            * (2 * np.pi / self.n_phi)
        c_pos = self._summed(self._analysis(fm, slice(L, None)),
                             slice(L, None))
        signs = torch.as_tensor(((-1.0) ** np.arange(1, L + 1))[::-1].copy(),
                                dtype=self.real_dtype, device=c_pos.device)
        c_neg = signs[:, None] * torch.conj(c_pos[..., 1:, :]).flip(-2)
        return torch.cat([c_neg, c_pos], dim=-2)

    def forward_real_abs2(self, psi):
        """Analysis of the intensity |ψ|² of a complex field ψ(..., θ, φ)."""
        return self.forward_real((psi * psi.conj()).real)

    def inverse(self, c):
        """f_lm (..., 2L+1, L+1) → f(..., θ, φ)."""
        fm = self._synthesis(c)
        L = self.l_max
        zeros = fm.new_zeros(fm.shape[:-1] + (self.n_phi - self.n_m,))
        full = torch.cat([fm[..., L:], zeros, fm[..., :L]], dim=-1)
        return torch.fft.ifft(full, dim=-1) * self.n_phi

    def inverse_real(self, c):
        """Re(inverse(c)) through a hermitian fold and irfft. Under
        mxu_dtype the coefficients are folded onto m ≥ 0 before their
        Legendre synthesis, c_h[0] = Re c_0, c_h[m] = (c_m + (−1)^m
        conj c_{−m})/2, as the kernels fold them."""
        L = self.l_max
        if self.mxu_dtype is not None:
            half = self._folded_synthesis(c)
        else:
            fm = self._synthesis(c)
            pos = fm[..., L:]
            neg = fm[..., :L].flip(-1)
            dc = pos[..., :1].real
            half = torch.cat([torch.complex(dc, torch.zeros_like(dc)),
                              0.5 * (pos[..., 1:] + torch.conj(neg))],
                             dim=-1)
        zeros = half.new_zeros(half.shape[:-1] + (self.n_phi // 2 + 1 - (L + 1),))
        spec = torch.cat([half, zeros], dim=-1)
        return torch.fft.irfft(spec * self.n_phi, self.n_phi, dim=-1)


    def _folded_synthesis(self, c):
        """(..., 2L+1, L+1) → the m ≥ 0 Fourier columns (..., θ, L+1) of
        Re(inverse(c)) from the folded coefficients c_h (float32 fold)."""
        L = self.l_max
        c = c.to(self.complex_dtype)
        pos, neg = c[..., L:, :], c[..., :L, :].flip(-2)
        signs = torch.as_tensor((-1.0) ** np.arange(1, L + 1),
                                dtype=self.real_dtype, device=c.device)
        h = torch.cat([torch.complex(pos[..., :1, :].real,
                                     torch.zeros_like(pos[..., :1, :].real)),
                       0.5 * (pos[..., 1:, :]
                              + signs[:, None] * torch.conj(neg))], dim=-2)
        return self._cx_einsum("...ml,mtl->...tm", h, self._P[L:])


class CircularHarmonicTransform:
    """2D circular harmonic transform on complex64 (complex128 under
    real_dtype float64): forward f(..., φ) → f_m = FFT(f)/n_φ in full FFT
    order (n_m = n_φ), inverse f_m → IFFT(f_m·n_φ). (The MTIP's real
    intensity takes projections.RealCircularHarmonics.)"""

    def __init__(self, n_phi: int, real_dtype=torch.float32):
        self.n_phi = int(n_phi)
        self.complex_dtype = complex_dtype_of(real_dtype)

    def forward(self, f):
        return torch.fft.fft(f.to(self.complex_dtype), dim=-1) / self.n_phi

    def inverse(self, c):
        return torch.fft.ifft(c.to(self.complex_dtype) * self.n_phi, dim=-1)
