"""Quadrature on spherical and polar grids.

Port of `xframe_tpu.ops.integrate.SphericalIntegrator` (Gauss-Legendre
weights in θ, uniform φ (π/n_θ per sample), trapezoid in r with r²) and
`PolarIntegrator` (trapezoid r·dr·dφ).
"""
from __future__ import annotations

import numpy as np
import torch

from xframe_tpu_torch.library.legendre import gauss_legendre


def _trapz_weights(x):
    x = np.asarray(x, dtype=np.float64)
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += dx / 2
    w[1:] += dx / 2
    return w


class SphericalIntegrator:
    """∫ f(r,θ,φ) r² dr dΩ over an (n_r, n_θ, n_φ) grid.

    `w_broadcast` is the separable (n_r, n_θ, 1) weight on `device`, at
    `real_dtype` (float32 or float64); `_w` is its expanded (n_r, n_θ, n_φ)
    view."""

    def __init__(self, rs: np.ndarray, n_theta: int, n_phi: int, *,
                 real_dtype=torch.float32, device):
        rs = np.asarray(rs, dtype=np.float64)
        _, w_theta = gauss_legendre(n_theta)
        r_w = _trapz_weights(rs) * rs ** 2
        w = r_w[:, None, None] * w_theta[None, :, None] * (np.pi / n_theta)
        self.w_broadcast = torch.as_tensor(w, device=torch.device(device)
                                           ).to(real_dtype)
        self._w = self.w_broadcast.expand(len(rs), n_theta, n_phi)


class PolarIntegrator:
    """∫ f(r,φ) r dr dφ over an (n_r, n_φ) grid: trapezoid weights in r
    (times r) and over the n_φ points of [0, 2π) (the last point's half
    interval not closed), `_w` (n_r, n_φ) at `real_dtype` (float32 or
    float64) on `device`."""

    def __init__(self, rs: np.ndarray, n_phi: int, *,
                 real_dtype=torch.float32, device):
        rs = np.asarray(rs, dtype=np.float64)
        phis = 2 * np.pi * np.arange(n_phi) / n_phi
        w = (_trapz_weights(rs) * rs)[:, None] * _trapz_weights(phis)[None, :]
        self._w = torch.as_tensor(w, device=torch.device(device)).to(
            real_dtype)
        self.max_r = float(rs.max())
        self.norm = np.pi * self.max_r ** 2

    def integrate(self, values):
        return torch.sum(self._w * values, dim=(-2, -1))

    def l2_norm(self, values):
        return self.integrate((values * values.conj()).real)
