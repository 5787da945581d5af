"""Spherical and polar Fourier transforms on (r,θ,φ) and (r,φ) grids.

Port of `xframe_tpu.ops.fourier.SphericalFourierTransform` and
`PolarFourierTransform`: FT = synthesis ∘ Hankel ∘ analysis. The settings
choose the spherical analysis and synthesis, as the JAX package's
`fused_sht` does: with `fused_sht` (the default) at float32 they go through
`ops/fused_sht.FusedSHT` (the CUDA kernels on CUDA tensors, the plain
transforms of `ops/sht.py` on CPU tensors); with `fused_sht=False`, or at
`real_dtype` float64, which no kernel computes, they are the plain
`SphericalHarmonicTransform` on the FT's device, CUDA included. Nothing
swaps one for the other at run time. `fused_table_dtype` (torch.bfloat16:
the worker's fourier_transform.fused_bf16_tables) gives the FusedSHT bf16
Legendre tables, and is ignored where there is no FusedSHT, as the JAX
package ignores it; `mxu_dtype` gives the plain transform bf16 Legendre
products (ops/sht.py), as the JAX package's does. `theta_shard` gives the
FT on a θ shard of the plain transforms (the Hankel transform acts on
coefficients, whole on every θ rank). The polar FT is torch.fft around the
per-m Hankel matmul, as the JAX package computes it with jnp.fft and an
einsum outside any kernel.
"""
from __future__ import annotations

import copy

import numpy as np

from xframe_tpu_torch.ops.fused_sht import FusedSHT
import torch

from xframe_tpu_torch.ops.sht import (CircularHarmonicTransform,
                                      SphericalHarmonicTransform)
from xframe_tpu_torch.ops.hankel import (PolarHankelTransform,
                                         SphericalHankelTransform,
                                         generate_weights, radial_grids)


class SphericalFourierTransform:
    """3D FT between real (r,θ,φ) and reciprocal (q,θ,φ) spherical grids."""

    def __init__(self, n_radial_points: int, l_max: int, q_max: float = None,
                 mode: str = 'midpoint', reciprocity_coefficient: float = np.pi,
                 n_theta: int = None, n_phi: int = None,
                 weights_dict: dict = None, *, real_dtype=torch.float32,
                 fused_sht: bool = True, mxu_dtype=None,
                 fused_table_dtype=None, device="cuda"):
        if q_max is None:
            q_max = float(np.pi * n_radial_points / 250.0)
        self.mode = mode
        self.reciprocity_coefficient = reciprocity_coefficient
        self.rs, self.qs, self.r_max = radial_grids(mode, q_max,
                                                    n_radial_points,
                                                    reciprocity_coefficient)
        self.q_max = q_max
        self.n_radial_points = n_radial_points
        self.sht = SphericalHarmonicTransform(l_max, n_theta=n_theta,
                                              n_phi=n_phi,
                                              real_dtype=real_dtype,
                                              mxu_dtype=mxu_dtype,
                                              device=device)
        # the kernels compute in float32 planes: float64 takes the plain
        # transforms, as the JAX package takes its jnp SHT
        self.harmonic = FusedSHT(
            self.sht, table_dtype=fused_table_dtype or torch.float32) \
            if fused_sht and real_dtype == torch.float32 else self.sht
        if weights_dict is None:
            weights_dict = generate_weights(l_max, n_radial_points,
                                            reciprocity_coefficient, 3, mode)
        self.hankel = SphericalHankelTransform(weights_dict, self.r_max,
                                               reciprocity_coefficient,
                                               real_dtype=real_dtype,
                                               device=device)

    @classmethod
    def from_parts(cls, rs, qs, r_max, q_max, harmonic, hankel):
        """An FT from its radial grids, a FusedSHT or a plain
        SphericalHarmonicTransform, and a Hankel transform."""
        obj = cls.__new__(cls)
        obj.mode = hankel.mode
        obj.rs, obj.qs = np.asarray(rs), np.asarray(qs)
        obj.r_max, obj.q_max = float(r_max), float(q_max)
        obj.n_radial_points = len(obj.rs)
        obj.sht = harmonic.sht if isinstance(harmonic, FusedSHT) \
            else harmonic
        obj.harmonic, obj.hankel = harmonic, hankel
        return obj

    def theta_shard(self, shard):
        """This FT on a rank's θ rows of its grid (`shard`, a
        projections.ThetaShard), through the plain transform's θ shard
        (SphericalHarmonicTransform.theta_shard); grid_shape then holds
        the shard's rows. → a new FT."""
        if self.harmonic is not self.sht:
            raise ValueError("a θ shard needs the plain transforms "
                             "(fused_sht false or float64)")
        new = copy.copy(self)
        new.sht = new.harmonic = self.sht.theta_shard(shard)
        return new

    @property
    def real_dtype(self):
        return self.sht.real_dtype

    @property
    def complex_dtype(self):
        return self.sht.complex_dtype

    @property
    def grid_shape(self):
        return (self.n_radial_points, self.sht.n_theta, self.sht.n_phi)

    @property
    def _analysis(self):
        return self.harmonic.forward

    @property
    def _synthesis(self):
        return self.harmonic.inverse

    def forward(self, density):
        """ρ(r,θ,φ) → ψ(q,θ,φ)."""
        return self._synthesis(self.hankel.forward(self._analysis(density)))

    def inverse(self, amplitude):
        """ψ(q,θ,φ) → ρ(r,θ,φ)."""
        return self._synthesis(self.hankel.inverse(self._analysis(amplitude)))

    def forward_and_roundtrip(self, density):
        """(FT(ρ), iFT(FT(ρ))) sharing one analysis (ft-stabilization)."""
        cf = self.hankel.forward(self._analysis(density))
        psi = self._synthesis(cf)
        rt = self._synthesis(self.hankel.inverse(cf))
        return psi, rt


class PolarFourierTransform:
    """2D FT between (r,φ) and (q,φ) polar grids: the circular harmonics
    m = 0..M and -M..-1 (FFT order, taken by slices), the polar Hankel
    transform, zero padding back to n_φ, the inverse FFT."""

    def __init__(self, n_radial_points: int, m_max: int, n_phi: int,
                 q_max: float, mode: str = 'midpoint',
                 reciprocity_coefficient: float = np.pi,
                 weights_dict: dict = None, *, real_dtype=torch.float32,
                 device="cuda"):
        self.mode = mode
        self.reciprocity_coefficient = reciprocity_coefficient
        self.rs, self.qs, self.r_max = radial_grids(mode, q_max,
                                                    n_radial_points,
                                                    reciprocity_coefficient)
        self.q_max = q_max
        self.m_max = int(m_max)
        self.n_phi = int(n_phi)
        self.n_radial_points = n_radial_points
        self.cht = CircularHarmonicTransform(n_phi, real_dtype=real_dtype)
        if weights_dict is None:
            weights_dict = generate_weights(m_max, n_radial_points,
                                            reciprocity_coefficient, 2, mode)
        self.hankel = PolarHankelTransform(weights_dict, self.r_max,
                                           reciprocity_coefficient,
                                           real_dtype=real_dtype,
                                           device=device)

    @classmethod
    def from_parts(cls, rs, qs, r_max, q_max, n_phi, hankel):
        """A polar FT from its radial grids, n_φ and a Hankel transform."""
        obj = cls.__new__(cls)
        obj.mode = hankel.mode
        obj.rs, obj.qs = np.asarray(rs), np.asarray(qs)
        obj.r_max, obj.q_max = float(r_max), float(q_max)
        obj.n_radial_points = len(obj.rs)
        obj.m_max = (hankel.n_m - 1) // 2
        obj.n_phi = int(n_phi)
        obj.cht = CircularHarmonicTransform(
            n_phi, real_dtype=torch.float32
            if hankel.complex_dtype == torch.complex64 else torch.float64)
        obj.hankel = hankel
        return obj

    @property
    def complex_dtype(self):
        return self.cht.complex_dtype

    @property
    def real_dtype(self):
        return torch.float32 if self.complex_dtype == torch.complex64 \
            else torch.float64

    @property
    def grid_shape(self):
        return (self.n_radial_points, self.n_phi)

    def _select(self, f):
        """The used circular harmonics of f, [0..M, -M..-1]."""
        M = self.m_max
        c = self.cht.forward(f)
        return torch.cat([c[..., : M + 1], c[..., c.shape[-1] - M:]], dim=-1) \
            if M > 0 else c[..., :1]

    def _expand(self, g):
        """(..., 2M+1) harmonics → the field, zeros in the unused bins."""
        M = self.m_max
        zeros = g.new_zeros(g.shape[:-1] + (self.n_phi - (2 * M + 1),))
        return self.cht.inverse(torch.cat([g[..., : M + 1], zeros,
                                           g[..., M + 1:]], dim=-1))

    def forward(self, density):
        """ρ(r,φ) → ψ(q,φ)."""
        return self._expand(self.hankel.forward(self._select(density)))

    def inverse(self, amplitude):
        """ψ(q,φ) → ρ(r,φ)."""
        return self._expand(self.hankel.inverse(self._select(amplitude)))

    def forward_and_roundtrip(self, density):
        """(FT(ρ), iFT(FT(ρ))) sharing one circular-harmonic analysis."""
        cf = self.hankel.forward(self._select(density))
        return self._expand(cf), self._expand(self.hankel.inverse(cf))
