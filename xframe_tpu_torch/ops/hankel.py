"""Spherical and polar Hankel transforms as batched per-order complex
matmuls.

The weight builders are numpy copies of `xframe_tpu.ops.hankel`
(`spherical_jn_all`, `radial_grids`, `generate_weights` and
`assemble_weights` for every quadrature mode, 3D and 2D): the original
module imports jax. Forward 3D: F_l(q_p) = (-i)^l √(2/π) Σ_k w_{kp}^l
f_l(r_k), with w including r² and the quadrature weight; the inverse uses
(+i)^l and the q-grid constants. 2D uses (∓i)^m without √(2/π), w with r,
and extends the weights to negative m by w_{-m} = (-1)^m w_m. The apply
step is `torch.matmul` over the order axis, as the JAX package leaves it to
an XLA einsum outside any kernel.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import eval_jacobi, jv

from xframe_tpu_torch.library.legendre import gauss_legendre
from xframe_tpu_torch.ops.sht import complex_dtype_of

HT_MODES = ('trapz', 'Zernike', 'midpoint', 'gauss')


def spherical_jn_all(l_max: int, z: np.ndarray) -> np.ndarray:
    """j_l(z) for every l = 0..l_max, vectorized over z (float64): upward
    recurrence where stable (z > l_max + 12), Miller's downward recurrence
    normalized against j_0 (or j_1 near a zero of j_0) elsewhere.
    → shape (l_max+1,) + z.shape."""
    z = np.asarray(z, dtype=np.float64)
    zf = z.ravel()
    out = np.empty((l_max + 1, zf.size), dtype=np.float64)
    up = zf > l_max + 12
    dn = ~up

    zu = zf[up]
    if zu.size:
        jm1 = np.sin(zu) / zu
        out[0, up] = jm1
        if l_max >= 1:
            jl = jm1 / zu - np.cos(zu) / zu
            out[1, up] = jl
            for l in range(1, l_max):
                jm1, jl = jl, (2 * l + 1) / zu * jl - jm1
                out[l + 1, up] = jl

    zd = zf[dn]
    if zd.size:
        zero = zd == 0.0
        zs = np.where(zero, 1.0, zd)
        l_start = l_max + 16 + int(np.ceil(np.sqrt(40.0 * (l_max + 1))))
        sub = np.zeros((l_max + 1, zd.size))
        jp1 = np.zeros(zd.size)
        jl = np.full(zd.size, 1e-30)
        for l in range(l_start, 0, -1):
            if l <= l_max:
                sub[l] = jl
            jp1, jl = jl, (2 * l + 1) / zs * jl - jp1
            big = np.abs(jl) > 1e250
            if big.any():
                jl[big] *= 1e-250
                jp1[big] *= 1e-250
                sub[:, big] *= 1e-250
        sub[0] = jl
        j0 = np.where(zero, 1.0, np.sin(zs) / zs)
        if l_max >= 1:
            j1 = j0 / zs - np.cos(zs) / zs
            pick1 = np.abs(sub[1]) > np.abs(sub[0])
            denom = np.where(pick1, sub[1], sub[0])
            numer = np.where(pick1, j1, j0)
        else:
            denom, numer = sub[0], j0
        sub *= numer / np.where(denom == 0.0, 1.0, denom)
        if zero.any():
            sub[:, zero] = 0.0
            sub[0, zero] = 1.0
        out[:, dn] = sub

    return out.reshape((l_max + 1,) + z.shape)


def _zernike_radial(l: int, s_values: np.ndarray, x: np.ndarray,
                    dimension: int) -> np.ndarray:
    """Radial part R^l_s(x) of D-dimensional Zernike polynomials
    → (len(s_values), len(x))."""
    k = ((np.asarray(s_values) - l) // 2).astype(int)
    sign = (-1.0) ** k
    return sign[:, None] * x[None, :] ** l \
        * eval_jacobi(k[:, None], l + dimension / 2 - 1, 0,
                      1 - 2 * x[None, :] ** 2)


def reciprocity_relation(cutoff: float, n_points: int,
                         reciprocity_coefficient: float = np.pi):
    """Q·R = c·N."""
    return reciprocity_coefficient * n_points / cutoff


def radial_grids(mode: str, q_max: float, n_points: int,
                 reciprocity_coefficient: float):
    """Real/reciprocal radial sampling points for a quadrature mode."""
    N = n_points
    r_max = reciprocity_relation(q_max, N, reciprocity_coefficient)
    if mode in ('trapz', 'Zernike'):
        rs = np.arange(N) * r_max / N
        qs = np.arange(N) * q_max / N
    elif mode == 'midpoint':
        dr, dq = r_max / N, q_max / N
        rs = np.linspace(dr / 2, r_max - dr / 2, N)
        qs = np.linspace(dq / 2, q_max - dq / 2, N)
    elif mode == 'gauss':
        x, _ = gauss_legendre(N)
        rs = r_max / 2 * x + r_max / 2
        qs = q_max / 2 * x + q_max / 2
    else:
        raise ValueError(f"unknown Hankel mode {mode!r}; known: {HT_MODES}")
    return rs, qs, r_max


def _zernike_weights(max_order, N, rc, dimensions=3):
    """Zernike-expansion quadrature weights (trapz variant, r=0 input
    sample dropped): w_l[p,k] = c[p,k] Σ_s (-1)^((s-l)/2)(2s+D) R^l_s(p/N)
    B_{s+1}(k·rc), B the spherical j (3D, c = p²/k) or J (2D, c = p/k)."""
    expansion_limit = max(2 * (2 * N - 1), max_order)
    ps = np.arange(1, N)
    ks = np.arange(N)
    out = np.zeros((max_order + 1, N - 1, N))
    j_all = spherical_jn_all(expansion_limit + 1, ks[1:] * rc) \
        if dimensions == 3 else None
    for l in range(max_order + 1):
        s = np.arange(l, expansion_limit + 1, 2)
        if dimensions == 3:
            pref = (-1.0) ** ((s - l) / 2) * (2 * s + 3)
            B = j_all[s + 1]
        else:
            pref = (-1.0) ** ((s - l) / 2) * (2 * s + 2)
            B = jv((s + 1)[:, None], ks[1:][None, :] * rc)
        Z = _zernike_radial(l, s, ps / N, dimensions)
        w = np.zeros((N - 1, N))
        w[:, 1:] = np.einsum("s,sp,sk->pk", pref, Z, B)
        if l == 0:
            w[:, 0] = rc
        out[l] = w
    c = np.zeros((N - 1, N))
    power = 2 if dimensions == 3 else 1
    c[:, 1:] = (ps ** power)[:, None] / ks[None, 1:]
    c[:, 0] = ps ** power
    return out * c[None]


def _spherical_weights(mode, l_max, N, rc):
    if mode == 'midpoint':
        ps = np.arange(N) + 0.5
        arg = ps[None, :] * ps[:, None] * rc / N
        return ps[None, :, None] ** 2 * spherical_jn_all(l_max, arg)
    if mode == 'trapz':
        ps = np.arange(1, N)
        ks = np.arange(N)
        arg = ks[None, :] * ps[:, None] * rc / N
        return ps[None, :, None] ** 2 * spherical_jn_all(l_max, arg)
    if mode == 'Zernike':
        return _zernike_weights(l_max, N, rc)
    if mode == 'gauss':
        x, wg = gauss_legendre(N)
        ps = x + 1
        arg = ps[None, :] * ps[:, None] * rc * N / 4
        j = spherical_jn_all(l_max, arg)
        return ps[None, :, None] ** 2 * j * wg[None, :, None]
    raise ValueError(f"unknown Hankel mode {mode!r}; known: {HT_MODES}")


def _polar_weights(mode, m_max, N, rc):
    ms = np.arange(m_max + 1)
    if mode == 'midpoint':
        ps = np.arange(N) + 0.5
        arg = ps[None, :] * ps[:, None] * rc / N
        return ps[None, :, None] * jv(ms[:, None, None], arg[None])
    if mode == 'trapz':
        ps = np.arange(1, N)
        ks = np.arange(N)
        arg = ks[None, :] * ps[:, None] * rc / N
        return ps[None, :, None] * jv(ms[:, None, None], arg[None])
    if mode == 'Zernike':
        return _zernike_weights(m_max, N, rc, dimensions=2)
    if mode == 'gauss':
        x, wg = gauss_legendre(N)
        ps = x + 1
        arg = ps[None, :] * ps[:, None] * rc * N / 4
        J = jv(ms[:, None, None], arg[None])
        return ps[None, :, None] * J * wg[None, :, None]
    raise ValueError(f"unknown Hankel mode {mode!r}; known: {HT_MODES}")


def generate_weights(max_order: int, n_radial_points: int,
                     reciprocity_coefficient: float = np.pi,
                     dimensions: int = 3, mode: str = 'midpoint'):
    """Raw quadrature weight tables (order, p_sum, k_out), float64."""
    if dimensions == 3:
        w = _spherical_weights(mode, max_order, n_radial_points,
                               reciprocity_coefficient)
    elif dimensions == 2:
        w = _polar_weights(mode, max_order, n_radial_points,
                           reciprocity_coefficient)
    else:
        raise ValueError(f"dimensions must be 2 or 3, got {dimensions}")
    return {'weights': w, 'posHarmOrders': np.arange(max_order + 1),
            'mode': mode, 'dimension': dimensions}


def assemble_weights(weights: np.ndarray, r_max: float,
                     reciprocity_coefficient: float, dimensions: int,
                     mode: str, dtype=np.complex128):
    """Apply the forward/inverse prefactors; reorder to (k_sum, p_out,
    order). 3D: (∓i)^l·c³·√(2/π); 2D: the orders in FFT layout [0..M,
    -M..-1] with w_{-m} = (-1)^m w_m and (∓i)^m·c². Zernike weights take
    an extra 1/π."""
    rdtype = np.float32 if np.dtype(dtype) == np.complex64 else np.float64
    weights = np.asarray(weights, dtype=rdtype)
    n_radial_points = weights.shape[-1]
    q_max = reciprocity_relation(r_max, n_radial_points,
                                 reciprocity_coefficient)
    if mode == 'gauss':
        c_fwd, c_inv = (r_max / 2), (q_max / 2)
    else:
        c_fwd, c_inv = (r_max / n_radial_points), (q_max / n_radial_points)
    extra = 1 / np.pi if mode == 'Zernike' else 1.0
    if dimensions == 3:
        orders = np.arange(weights.shape[0])
        fwd_pref = (-1j) ** orders * c_fwd ** 3 * np.sqrt(2 / np.pi) * extra
        inv_pref = (1j) ** orders * c_inv ** 3 * np.sqrt(2 / np.pi) * extra
    else:
        pos = np.arange(weights.shape[0])
        all_orders = np.concatenate((pos, -pos[:0:-1]))
        fwd_pref = (-1j) ** all_orders * c_fwd ** 2 * extra
        inv_pref = (1j) ** all_orders * c_inv ** 2 * extra
        weights = np.concatenate(
            (weights, (-1.0) ** pos[:0:-1, None, None] * weights[:0:-1]),
            axis=0)
    w = np.moveaxis(weights, 0, 2)
    return {'forward': w * fwd_pref[None, None, :].astype(dtype),
            'inverse': w * inv_pref[None, None, :].astype(dtype),
            'mode': mode}


def _np_complex(real_dtype):
    return np.complex64 if real_dtype == torch.float32 else np.complex128


class SphericalHankelTransform:
    """forward(f): (..., n_r, n_m, L+1) coefficients in r → (..., n_q, n_m,
    L+1) in q; inverse analogous. Trapz/Zernike modes drop the r=0 input
    sample from the sum."""

    def __init__(self, weights_dict: dict, r_max: float,
                 reciprocity_coefficient: float = np.pi, *,
                 real_dtype=torch.float32, device):
        mode = weights_dict['mode']
        w = assemble_weights(np.asarray(weights_dict['weights']), r_max,
                             reciprocity_coefficient, 3, mode,
                             dtype=_np_complex(real_dtype))
        self.mode = mode
        self.skip_zero = mode in ('trapz', 'Zernike')
        self.device = torch.device(device)
        self.complex_dtype = complex_dtype_of(real_dtype)
        self.set_tables(w['forward'], w['inverse'])

    @classmethod
    def from_tables(cls, wf, wi, mode, *, real_dtype=torch.float32, device):
        """A transform on given (k_sum, p_out, L+1) weight tables."""
        obj = cls.__new__(cls)
        obj.mode = mode
        obj.skip_zero = mode in ('trapz', 'Zernike')
        obj.device = torch.device(device)
        obj.complex_dtype = complex_dtype_of(real_dtype)
        obj.set_tables(wf, wi)
        return obj

    def set_tables(self, wf, wi):
        """Weights (k_sum, p_out, L+1) complex64 (complex128 under
        real_dtype float64), from host arrays. The device copies are stored
        per order, (L+1, p_out, k_sum), the left operand of the batched
        matmul."""
        self._wf = torch.as_tensor(np.asarray(wf), device=self.device).to(
            self.complex_dtype)
        self._wi = torch.as_tensor(np.asarray(wi), device=self.device).to(
            self.complex_dtype)
        self._wf_l = self._wf.permute(2, 1, 0).contiguous()
        self._wi_l = self._wi.permute(2, 1, 0).contiguous()
        self.n_radial_points = self._wf.shape[1]

    def _apply(self, w_l, f):
        """out[..., p, m, l] = Σ_k w[k, p, l] f[..., k, m, l]."""
        if self.skip_zero:
            f = f[..., 1:, :, :]
        lead = f.shape[:-3]
        k, n_m, n_l = f.shape[-3:]
        x = f.reshape((-1, k, n_m, n_l)).permute(3, 1, 0, 2)
        y = torch.matmul(w_l, x.reshape(n_l, k, -1))      # (l, p, b·m)
        y = y.reshape(n_l, -1, x.shape[2], n_m).permute(2, 1, 3, 0)
        return y.reshape(lead + y.shape[1:])

    def forward(self, f):
        return self._apply(self._wf_l, f)

    def inverse(self, f):
        return self._apply(self._wi_l, f)

    def inverse_row0(self, f):
        """Radial row p = 0 of inverse(f): (..., k, m, l) → (..., m, l), one
        weight-row contraction instead of a whole inverse (the fused
        ft-stab combine restores d[0] with it)."""
        if self.skip_zero:
            f = f[..., 1:, :, :]
        return torch.einsum("kl,...kml->...ml", self._wi[:, 0, :], f)


class PolarHankelTransform:
    """2D transform on the FFT m layout [0..M, -M..-1]: forward(f) maps
    (..., n_r, n_m) coefficients in r to (..., n_q, n_m) in q, inverse
    analogous; out[..., p, m] = Σ_k w[k, p, m] f[..., k, m] as one batched
    matmul over m. Trapz/Zernike modes drop the r=0 input sample."""

    def __init__(self, weights_dict: dict, r_max: float,
                 reciprocity_coefficient: float = np.pi, *,
                 real_dtype=torch.float32, device):
        mode = weights_dict['mode']
        w = assemble_weights(np.asarray(weights_dict['weights']), r_max,
                             reciprocity_coefficient, 2, mode,
                             dtype=_np_complex(real_dtype))
        self.mode = mode
        self.skip_zero = mode in ('trapz', 'Zernike')
        self.device = torch.device(device)
        self.complex_dtype = complex_dtype_of(real_dtype)
        self.set_tables(w['forward'], w['inverse'])

    @classmethod
    def from_tables(cls, wf, wi, mode, *, real_dtype=torch.float32, device):
        """A transform on given (k_sum, p_out, n_m) weight tables."""
        obj = cls.__new__(cls)
        obj.mode = mode
        obj.skip_zero = mode in ('trapz', 'Zernike')
        obj.device = torch.device(device)
        obj.complex_dtype = complex_dtype_of(real_dtype)
        obj.set_tables(wf, wi)
        return obj

    def set_tables(self, wf, wi):
        """Weights (k_sum, p_out, n_m) complex64 (complex128 under
        real_dtype float64) from host arrays, stored per order, (n_m,
        p_out, k_sum), the left operand of the matmul."""
        self._wf = torch.as_tensor(np.asarray(wf), device=self.device).to(
            self.complex_dtype)
        self._wi = torch.as_tensor(np.asarray(wi), device=self.device).to(
            self.complex_dtype)
        self._wf_m = self._wf.permute(2, 1, 0).contiguous()
        self._wi_m = self._wi.permute(2, 1, 0).contiguous()
        self.n_m = self._wf.shape[-1]

    def _apply(self, w_m, f):
        if self.skip_zero:
            f = f[..., 1:, :]
        lead = f.shape[:-2]
        k, n_m = f.shape[-2:]
        x = f.reshape((-1, k, n_m)).permute(2, 1, 0)       # (m, k, batch)
        y = torch.matmul(w_m, x)                            # (m, p, batch)
        return y.permute(2, 1, 0).reshape(lead + (y.shape[1], n_m))

    def forward(self, f):
        return self._apply(self._wf_m, f)

    def inverse(self, f):
        return self._apply(self._wi_m, f)
