"""Grids and transforms of the reference: the midpoint radial grids, the
angular grid rule, Gauss–Legendre nodes, orthonormal associated Legendre
tables, the spherical harmonic transform, the spherical Hankel transform
and the 3D Fourier transform they make, on (restarts, r, θ, φ) grids.

Conventions, as the reconstruct worker states them: coefficients (..., 2L+1,
L+1) with centred m (index j ↔ m = j − L) and l < |m| zero; orthonormal
Y_lm with the Condon–Shortley phase; θ ascending (cos θ on Gauss–Legendre
nodes, descending); φ uniform on [0, 2π); the analysis carries 2π/n_φ and
the Gauss–Legendre weights. The Hankel transform of order l on the
midpoint grids is F(q_p) = (∓i)^l c³ √(2/π) Σ_k k² j_l(k p c_r / N) f(r_k)
with k, p the half-integer grid indices, c = r_max/N forward and q_max/N
inverse.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class Precision:
    """How the reference computes: "float64", or "tf32" (float32 data,
    every matrix product's operands rounded to TF32 by round-to-nearest-
    even, products summed in float32, as TF32 tensor cores do)."""

    def __init__(self, name="float64"):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name
        self.real = torch.float64 if name == "float64" else torch.float32
        self.complex = torch.complex128 if name == "float64" \
            else torch.complex64

    def round(self, x):
        """x with its mantissa cut to TF32's 10 bits (tf32 only)."""
        if self.name != "tf32":
            return x
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)

    def rmm(self, a, b):
        """Real matrix product."""
        return torch.matmul(self.round(a), self.round(b))

    def cmm(self, a, b):
        """Complex matrix product (tf32: four real products)."""
        if self.name == "float64":
            return torch.matmul(a, b)
        ar, ai, br, bi = a.real, a.imag, b.real, b.imag
        return torch.complex(self.rmm(ar, br) - self.rmm(ai, bi),
                             self.rmm(ar, bi) + self.rmm(ai, br))

    def cmm_real(self, a, t):
        """Complex a times real t."""
        return torch.complex(self.rmm(a.real, t), self.rmm(a.imag, t))


def radial_grids(q_max, n_points, reciprocity_coefficient):
    """Midpoint grids: r_max = c·N/q_max; → (rs, qs, r_max)."""
    r_max = reciprocity_coefficient * n_points / q_max
    half = np.arange(n_points) + 0.5
    return half * r_max / n_points, half * q_max / n_points, r_max


def angular_grid_size(l_max, anti_aliasing_degree=2):
    """The settings' rule for a grid left at n_theta = n_phi = 0: n_φ the
    power of two 2^(⌊log2((a+1)·L)⌋+1), at least 2(L+1); n_θ = n_φ/2."""
    n_phi = 2 ** (int(math.log2((anti_aliasing_degree + 1)
                                * max(l_max, 1))) + 1)
    n_phi = max(n_phi, 2 * (l_max + 1))
    return n_phi // 2, n_phi


def gauss_legendre(n):
    """Nodes (ascending) and weights on [-1, 1]."""
    return np.polynomial.legendre.leggauss(n)


def legendre_table(l_max, x):
    """Orthonormal (over the sphere) associated Legendre values with the
    Condon–Shortley phase, all m: (2L+1, len(x), L+1) indexed [m + L, x,
    l], P̄_l^{-m} = (-1)^m P̄_l^m, zero where l < |m|."""
    x = np.asarray(x, dtype=np.float64)
    L = l_max
    pos = np.zeros((L + 1, x.size, L + 1))
    s = np.sqrt(np.maximum(0.0, 1.0 - x * x))
    pmm = np.full(x.size, 1.0 / np.sqrt(4.0 * np.pi))
    for m in range(L + 1):
        if m > 0:
            pmm = -np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * s * pmm
        pos[m, :, m] = pmm
        if m + 1 <= L:
            pos[m, :, m + 1] = np.sqrt(2.0 * m + 3.0) * x * pmm
        for l in range(m + 2, L + 1):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m)
                        / (4.0 * (l - 1.0) ** 2 - 1.0))
            pos[m, :, l] = a * (x * pos[m, :, l - 1] - b * pos[m, :, l - 2])
    out = np.zeros((2 * L + 1, x.size, L + 1))
    out[L:] = pos
    for m in range(1, L + 1):
        out[L - m] = (-1.0) ** m * pos[m]
    return out


def spherical_bessel(l_max, z):
    """j_l(z) for l = 0..l_max: (l_max+1,) + z.shape, float64. Upward
    recurrence where z > l_max + 12, where it is stable; elsewhere Miller's
    downward recurrence from far above l_max, rescaled against overflow
    and normalised to j_0 (to j_1 where j_0 is the smaller)."""
    z = np.asarray(z, dtype=np.float64)
    flat = z.ravel()
    out = np.empty((l_max + 1, flat.size))
    up = flat > l_max + 12
    zu = flat[up]
    if zu.size:
        prev, cur = np.sin(zu) / zu, np.sin(zu) / zu ** 2 - np.cos(zu) / zu
        out[0, up] = prev
        if l_max >= 1:
            out[1, up] = cur
        for l in range(1, l_max):
            prev, cur = cur, (2 * l + 1) / zu * cur - prev
            out[l + 1, up] = cur
    zd = flat[~up]
    if zd.size:
        zs = np.where(zd == 0.0, 1.0, zd)
        sub = np.zeros((l_max + 1, zd.size))
        above, cur = np.zeros(zd.size), np.full(zd.size, 1e-30)
        for l in range(l_max + 16 + int(np.ceil(np.sqrt(40.0 * (l_max + 1)))),
                       0, -1):
            if l <= l_max:
                sub[l] = cur
            above, cur = cur, (2 * l + 1) / zs * cur - above
            big = np.abs(cur) > 1e250
            if big.any():
                cur[big] *= 1e-250
                above[big] *= 1e-250
                sub[:, big] *= 1e-250
        sub[0] = cur
        j0 = np.sin(zs) / zs
        j1 = j0 / zs - np.cos(zs) / zs
        one = np.abs(sub[1]) > np.abs(sub[0]) if l_max >= 1 \
            else np.zeros(zd.size, bool)
        norm = np.where(one, j1, j0) / np.where(one, sub[min(1, l_max)],
                                                sub[0])
        sub *= norm
        sub[:, zd == 0.0] = 0.0
        sub[0, zd == 0.0] = 1.0
        out[:, ~up] = sub
    return out.reshape((l_max + 1,) + z.shape)


def hankel_weights(l_max, n_points, reciprocity_coefficient):
    """w[l, p, k] = k² j_l(k·p·c/N) over half-integer k, p: (L+1, N, N),
    float64, the sum running over k."""
    half = np.arange(n_points) + 0.5
    arg = half[:, None] * half[None, :] * reciprocity_coefficient / n_points
    return spherical_bessel(l_max, arg) * half[None, None, :] ** 2


class Transforms:
    """The 3D Fourier transform FT = synthesis ∘ Hankel ∘ analysis between
    the real (r, θ, φ) and reciprocal (q, θ, φ) grids; hankel=False: the
    harmonic transforms alone."""

    def __init__(self, n_radial, l_max, q_max, reciprocity_coefficient,
                 precision, device, n_theta=None, n_phi=None, hankel=True):
        self.p = precision
        self.device = torch.device(device)
        self.N, self.L = int(n_radial), int(l_max)
        self.rs, self.qs, self.r_max = radial_grids(
            q_max, self.N, reciprocity_coefficient)
        self.q_max = float(q_max)
        nt, nph = angular_grid_size(self.L)
        self.n_theta, self.n_phi = int(n_theta or nt), int(n_phi or nph)
        x, w = gauss_legendre(self.n_theta)
        x, w = x[::-1].copy(), w[::-1].copy()   # θ ascending
        self.cos_theta, self.gl_weights = x, w
        self.theta = np.arccos(x)
        self.phi = 2 * np.pi * np.arange(self.n_phi) / self.n_phi
        P = legendre_table(self.L, x)                       # (n_m, θ, L+1)
        dt = self.p.real
        self._P = torch.as_tensor(P, device=self.device).to(dt)
        self._PW = torch.as_tensor(P * w[None, :, None],
                                   device=self.device).to(dt)
        self._P_t = self._P.transpose(1, 2).contiguous()    # (n_m, L+1, θ)
        if not hankel:
            return
        hw = hankel_weights(self.L, self.N, reciprocity_coefficient)
        ls = np.arange(self.L + 1)
        root = np.sqrt(2 / np.pi)
        fwd = (-1j) ** ls * (self.r_max / self.N) ** 3 * root
        inv = (1j) ** ls * (self.q_max / self.N) ** 3 * root
        # per order the (p_out, k_sum) matrix
        self._Hf = torch.as_tensor(hw * fwd[:, None, None],
                                   device=self.device).to(self.p.complex)
        self._Hi = torch.as_tensor(hw * inv[:, None, None],
                                   device=self.device).to(self.p.complex)

    @property
    def grid_shape(self):
        return (self.N, self.n_theta, self.n_phi)

    # ----------------------------------------------------------- harmonics
    def sht_forward(self, f):
        """f (..., θ, φ) → (..., 2L+1, L+1)."""
        L, lead = self.L, f.shape[:-2]
        fm = torch.fft.fft(f.to(self.p.complex), dim=-1) \
            * (2 * np.pi / self.n_phi)
        fm = torch.cat([fm[..., self.n_phi - L:], fm[..., :L + 1]], dim=-1)
        x = fm.reshape(-1, self.n_theta, 2 * L + 1).permute(2, 0, 1)
        c = self.p.cmm_real(x, self._PW)                   # (n_m, B, L+1)
        return c.permute(1, 0, 2).reshape(lead + (2 * L + 1, L + 1))

    def sht_inverse(self, c):
        """(..., 2L+1, L+1) → f (..., θ, φ)."""
        L, lead = self.L, c.shape[:-2]
        x = c.to(self.p.complex).reshape(-1, 2 * L + 1, L + 1) \
            .permute(1, 0, 2)                               # (n_m, B, L+1)
        fm = self.p.cmm_real(x, self._P_t)                  # (n_m, B, θ)
        fm = fm.permute(1, 2, 0)                            # (B, θ, n_m)
        full = fm.new_zeros(fm.shape[:-1] + (self.n_phi,))
        full[..., :L + 1] = fm[..., L:]
        full[..., self.n_phi - L:] = fm[..., :L]
        out = torch.fft.ifft(full, dim=-1) * self.n_phi
        return out.reshape(lead + (self.n_theta, self.n_phi))

    # ------------------------------------------------------------- Hankel
    def _hankel(self, H, f):
        """f (B, N, n_m, L+1) → Σ_k H[l, p, k] f[b, k, m, l]."""
        b, n, n_m, n_l = f.shape
        x = f.permute(3, 1, 0, 2).reshape(n_l, n, b * n_m)
        y = self.p.cmm(H, x)                                # (l, p, b·m)
        return y.reshape(n_l, n, b, n_m).permute(2, 1, 3, 0)

    # ----------------------------------------------------------------- FT
    def forward(self, rho):
        """ρ (B, r, θ, φ) → ψ (B, q, θ, φ)."""
        return self.sht_inverse(self._hankel(self._Hf,
                                             self.sht_forward(rho)))

    def inverse(self, psi):
        return self.sht_inverse(self._hankel(self._Hi,
                                             self.sht_forward(psi)))

    def forward_and_roundtrip(self, rho):
        """(FT(ρ), iFT(FT(ρ))) from one analysis."""
        cf = self._hankel(self._Hf, self.sht_forward(rho))
        return self.sht_inverse(cf), self.sht_inverse(
            self._hankel(self._Hi, cf))

    def integration_weights(self, radii):
        """(n, θ, 1) weights of ∫ f x² dx dΩ on a radial grid `radii`:
        trapezoid in x times x², Gauss–Legendre in θ, π/n_θ in φ."""
        radii = np.asarray(radii, dtype=np.float64)
        tw = np.zeros_like(radii)
        d = np.diff(radii)
        tw[:-1] += d / 2
        tw[1:] += d / 2
        w = (tw * radii ** 2)[:, None, None] \
            * self.gl_weights[None, :, None] * (np.pi / self.n_theta)
        return torch.as_tensor(w, device=self.device).to(self.p.real)
