"""MTIP projection operators in PyTorch.

Port of `xframe_tpu.projects.fxs.projections`: the 3D reciprocal (data)
projection as batched per-order matmuls plus a Newton–Schulz or SVD polar
factor (under `newton_schulz_pallas` through the polar and fused-projection
kernels of `ops/fused_projection.py`); the 2D one (`ReciprocalConstraintPolar`
on the circular harmonics of `RealCircularHarmonics`: rank-1 vectors v_m and
a phase unknown per order); the amplitude projection, the real-space
constraint, shrink-wrap on (r,θ,φ) or (r,φ) grids and the HIO/ER/RAAR
updates. Every operator takes an optional leading restart axis; reductions
run over everything but that axis, through `grid_reduce`: on a θ shard
(an operator's `shard`, a ThetaShard) they are then summed (max, min)
over the θ ranks. The constraints hold their tensors at
`real_dtype` (float32, or float64 for `precision: float64`) and its
complex dtype; the kernels B7 and B8 compute in complex64.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from xframe_tpu_torch.ops.fused_projection import (
    fused_projection_bucket, polar_unitary, polar_unitary_newton_schulz,
)

_REDUCE = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}


class ThetaShard:
    """A rank's θ rows of the whole grid and the exchanges over its θ
    group, the one object that the operators on a θ shard hold (the
    transform, the MTIP, the reciprocal constraint, the shrink-wrap: their
    `shard`; None on the whole grid). `mesh` is the rank's mesh
    (parallel/mesh.py), `grid_shape` the whole grid's (..., n_θ, n_φ):
    `n_theta` and `grid_points` (per restart) are the whole grid's, `rows`
    the rank's θ rows."""

    def __init__(self, mesh, grid_shape):
        self.mesh = mesh
        self.n_theta = int(grid_shape[-2])
        self.grid_points = int(np.prod(grid_shape))
        self.rows = mesh.theta_rows(self.n_theta)

    def all_reduce(self, parts, op="sum", name=None):
        """Partial reductions over the rank's θ rows (tensors of one dtype)
        → the whole grid's, all in one exchange over the θ group (summed,
        or their largest or smallest entries), the same bits on every θ
        rank. → a tuple."""
        parts = tuple(parts)
        flat = torch.cat([p.reshape(-1) for p in parts]) \
            if len(parts) > 1 else parts[0].reshape(-1)
        flat = self.mesh.all_reduce(flat, op, name=name or "grid_" + op)
        return tuple(f.reshape(p.shape) for f, p in
                     zip(torch.split(flat, [p.numel() for p in parts]),
                         parts))

    def gather(self, x, name="sw_gather"):
        """The rank's θ rows (axis -2) of a real or bool tensor → the whole
        grid's, joined over the θ group."""
        return self.mesh.all_gather_theta(x, self.n_theta, name=name)


def grid_reduce(xs, dims, op="sum", shard=None, keepdim=False):
    """Each tensor of xs summed ("sum"), or its largest or smallest entries
    ("max", "min"), over the grid axes `dims`; on a θ shard then over the
    θ ranks, in one exchange (ThetaShard.all_reduce). → a tuple."""
    parts = tuple(_REDUCE[op](x, dim=dims, keepdim=keepdim) for x in xs)
    return parts if shard is None else shard.all_reduce(parts, op)


def _np_dtypes(real_dtype):
    """(numpy real, numpy complex) dtypes of a torch real dtype."""
    return (np.float32, np.complex64) if real_dtype == torch.float32 \
        else (np.float64, np.complex128)


def crop_buckets(l_max):
    """[(l_lo, l_hi, h)]: the Newton–Schulz crop buckets, bucket k holding
    orders 64(k−1)..min(64k−1, L−1) on the centered window of half-width
    h = min(64k−1, L−1), then the full-width order (L, L, L)."""
    L, buckets, k = l_max, [], 1
    while 64 * (k - 1) <= L - 1:
        buckets.append((64 * (k - 1), min(64 * k - 1, L - 1),
                        min(64 * k - 1, L - 1)))
        k += 1
    return buckets + [(L, L, L)]


# ------------------------------------------------------------ reciprocal side
@dataclass
class ReciprocalConstraint:
    """Device tensors of the reciprocal (data) projection."""
    V_pad: Any          # (L+1, n_q, n_m) complex64 or complex128, centered
    PD: Any             # (L+1, n_m, n_q) = V_pad† D²
    eye_diag: Any       # (L+1, n_m) real: 1 outside the l-window
    use_order: Any      # (L+1,) bool
    radial_mask: Any    # (L+1, n_q) bool
    n_particles: float
    l_max: int
    # 'svd' | 'newton_schulz' | 'newton_schulz_pallas' (the JAX package's
    # name for its kernels; here the CUDA kernels B7 and B8)
    procrustes_method: str = "svd"
    ns_iterations: int = 16
    ns_schedule: Any = None
    # the in-loop particle-number estimate (None: off): the scan's scales
    # s_N = 1/√N − 1 (descending in N), its candidates N (ascending), the
    # gradient's abscissa (√N under pn_project, else N), all (K,); and the
    # isotropic intensity a(q) per shell (n_q,); real tensors
    pn_s: Any = None
    pn_Ns: Any = None
    pn_x: Any = None
    pn_a: Any = None
    pn_project: bool = False

    shard = None              # a θ shard (ThetaShard); None: whole grid

    def __post_init__(self):
        if self.procrustes_method not in ("svd", "newton_schulz",
                                          "newton_schulz_pallas"):
            raise ValueError(f"unknown procrustes_method "
                             f"{self.procrustes_method!r}")
        self._k5 = self._k5_planes() if self.k5_active else None

    @classmethod
    def build(cls, projection_matrices, radial_points, l_max,
              used_order_ids=None, odd_orders_to_0=True,
              use_averaged_intensity=True, average_intensity=None,
              radial_mask=None, n_particles=1.0, schmidt_scaling=True,
              procrustes_method="svd", ns_iterations=16, ns_schedule=None,
              pn_scan_space=None, pn_project=False, *,
              real_dtype=torch.float32, device="cuda"):
        """Host assembly from the per-order projection matrices V_l
        ((n_q, min(2l+1, n_q)) complex each). pn_scan_space (lo, hi, K):
        the particle-number estimate's √N-linear scan of K candidates."""
        n_q = len(radial_points)
        L = l_max
        n_m = 2 * L + 1
        V = np.zeros((L + 1, n_q, n_m), dtype=complex)
        for l in range(min(L + 1, len(projection_matrices))):
            vl = np.asarray(projection_matrices[l])
            if vl.ndim == 1:
                vl = vl[:, None]
            ncols = min(vl.shape[1], 2 * l + 1, n_q)
            V[l, :, L - l: L - l + ncols] = vl[:, :ncols]
        if odd_orders_to_0:
            V[1::2] = 0
        if use_averaged_intensity and average_intensity is not None:
            V[0] = 0
            V[0, :, L] = np.asarray(average_intensity).real * 2 * np.sqrt(np.pi)
        if schmidt_scaling:
            V *= 2
        D2 = np.asarray(radial_points, dtype=float) ** 2
        PD = np.conj(np.swapaxes(V, 1, 2)) * D2[None, None, :]
        eye_diag = np.ones((L + 1, n_m))
        for l in range(L + 1):
            eye_diag[l, L - l: L + l + 1] = 0.0
        use_order = np.zeros(L + 1, dtype=bool)
        if used_order_ids is None:
            used_order_ids = np.arange(L + 1)
        use_order[np.asarray(used_order_ids, dtype=int)] = True
        if radial_mask is None:
            radial_mask = np.ones((L + 1, n_q), dtype=bool)
        pn = {}
        if pn_scan_space is not None:
            lo, hi, k = pn_scan_space
            sq = np.linspace(np.sqrt(lo), np.sqrt(hi), int(k))
            # a(q) = I00(q)·Y00: with the averaged-intensity column
            # I00 = avg·2√π this is avg itself
            pn = dict(pn_s=1.0 / sq - 1.0, pn_Ns=sq ** 2,
                      pn_x=sq if pn_project else sq ** 2,
                      pn_a=np.abs(V[0, :, L].real) / (2 * np.sqrt(np.pi)))
            # the JAX package rounds each table to the real dtype on the
            # host
            pn = {k: np.asarray(v, _np_dtypes(real_dtype)[0])
                  for k, v in pn.items()}
        return cls.from_numpy(V, PD, eye_diag, use_order, radial_mask,
                              n_particles=n_particles, l_max=L,
                              procrustes_method=procrustes_method,
                              ns_iterations=ns_iterations,
                              ns_schedule=ns_schedule, pn_project=pn_project,
                              real_dtype=real_dtype, device=device, **pn)

    @classmethod
    def from_numpy(cls, V_pad, PD, eye_diag, use_order, radial_mask, *,
                   n_particles, l_max, procrustes_method="svd",
                   ns_iterations=16, ns_schedule=None, pn_s=None, pn_Ns=None,
                   pn_x=None, pn_a=None, pn_project=False,
                   real_dtype=torch.float32, device="cuda"):
        rdt, cdt = _np_dtypes(real_dtype)

        def dev(a, dtype):
            return None if a is None else torch.as_tensor(
                np.asarray(a, dtype=dtype), device=device)
        return cls(V_pad=dev(V_pad, cdt), PD=dev(PD, cdt),
                   eye_diag=dev(eye_diag, rdt),
                   use_order=dev(use_order, bool),
                   radial_mask=dev(radial_mask, bool),
                   n_particles=float(n_particles), l_max=int(l_max),
                   procrustes_method=procrustes_method,
                   ns_iterations=int(ns_iterations),
                   ns_schedule=None if ns_schedule is None
                   else tuple(map(tuple, ns_schedule)),
                   pn_s=dev(pn_s, rdt), pn_Ns=dev(pn_Ns, rdt),
                   pn_x=dev(pn_x, rdt), pn_a=dev(pn_a, rdt),
                   pn_project=bool(pn_project))

    def _eye_mat(self):
        """(L+1, n_m, n_m) identity on the complement of each l-window."""
        return torch.diag_embed(self.eye_diag).to(self.V_pad.dtype)

    def _polar(self, M):
        return polar_unitary_newton_schulz(M, self.ns_iterations,
                                           schedule=self.ns_schedule)

    @property
    def k5_active(self):
        """True when __call__ runs the fused projection (B8): the kernels'
        method at a scale with more than one crop bucket, complex64."""
        return (self.procrustes_method == "newton_schulz_pallas"
                and 2 * self.l_max + 1 > 128
                and self.V_pad.dtype == torch.complex64)

    def _k5_planes(self):
        """Per bucket (l_lo, h, PD crop (G, c, n_q), V crop (G, n_q, c), take
        (G, n_q) float 0/1), device tensors built once with the constraint,
        unpadded (the counterpart of the JAX package's k5_planes_host)."""
        L = self.l_max
        take = (self.use_order[:, None] & self.radial_mask).to(torch.float32)
        planes = []
        for (l_lo, l_hi, h) in crop_buckets(self.l_max):
            sl = slice(L - h, L + h + 1)
            orders = slice(l_lo, l_hi + 1)
            planes.append((l_lo, h, self.PD[orders, sl, :].contiguous(),
                           self.V_pad[orders, :, sl].contiguous(),
                           take[orders].contiguous()))
        return planes

    def approximate_unknowns(self, Ilm):
        """Per-order Procrustes unitaries from intensity coefficients:
        Ilm (..., n_q, n_m, L+1) → W (..., L+1, n_m, n_m)."""
        Ilt = Ilm.movedim(-1, -3)                          # (..., L+1, n_q, n_m)
        B = self.PD @ Ilt                                  # (..., L+1, n_m, n_m)
        if self.procrustes_method == "svd":
            u, _, vh = torch.linalg.svd(B + self._eye_mat(),
                                        full_matrices=False)
            return u @ vh
        # eye-pad the complement at the block's RMS singular-value scale:
        # polar(blockdiag(A, s·I)) = blockdiag(polar(A), I) for any s > 0
        L, n_m = self.l_max, 2 * self.l_max + 1
        sizes = 2 * torch.arange(L + 1, dtype=self.eye_diag.dtype,
                                 device=B.device) + 1
        rms = torch.sqrt((B.abs() ** 2).sum((-2, -1)) / sizes)[..., None, None]
        M = B + self._eye_mat() * (rms + 1e-20)
        if not (n_m > 128 and L >= 1):
            return self._polar(M)
        # crop path: each bucket of orders runs on its centered window only
        # (exact by the block-diagonal identity above), l = L at full width;
        # under newton_schulz_pallas each through the polar kernel (B7) on
        # a complex64 crop at any dtype, W cast back, as the JAX package's
        # _unknowns_pallas does; else through the plain iteration
        kernel = self.procrustes_method == "newton_schulz_pallas"
        idx = torch.arange(n_m, device=B.device)
        parts = []
        for (l_lo, l_hi, h) in crop_buckets(self.l_max):
            sl = slice(L - h, L + h + 1)
            Mb = M[..., l_lo:l_hi + 1, sl, sl]
            Wb = polar_unitary(Mb.to(torch.complex64), self.ns_iterations,
                               schedule=self.ns_schedule).to(M.dtype) \
                if kernel else self._polar(Mb)
            if h == L:
                parts.append(Wb)
                continue
            outside = ((idx < L - h) | (idx > L + h)).to(M.dtype)
            W_full = torch.diag_embed(outside).expand(Wb.shape[:-2]
                                                      + (n_m, n_m)).clone()
            W_full[..., sl, sl] = Wb
            parts.append(W_full)
        return torch.cat(parts, dim=-3)

    def _project_fused(self, Ilm):
        """The whole data projection, one fused_projection_bucket launch
        (B8) per bucket; then the l = 0 row in torch: the data column where
        taken, and the 1/√N particle scaling of the whole row. Entries of a
        bucket's orders outside its crop are zero, as in the JAX package."""
        L = self.l_max
        Ilt = Ilm.movedim(-1, -3)                          # (..., L+1, n_q, n_m)
        out = torch.zeros_like(Ilt)
        for l_lo, h, pd, v, take in self._k5:
            orders = slice(l_lo, l_lo + pd.shape[0])
            sl = slice(L - h, L + h + 1)
            out[..., orders, :, sl] = fused_projection_bucket(
                pd, Ilt[..., orders, :, sl], v, take, l_lo=l_lo, h=h,
                iterations=self.ns_iterations, schedule=self.ns_schedule)
        take0 = (self.use_order[0] & self.radial_mask[0])[:, None]
        out[..., 0, :, :] = torch.where(take0, self.V_pad[0],
                                        Ilt[..., 0, :, :]) \
            / float(np.sqrt(self.n_particles))
        return out.movedim(-3, -1)

    def project_coefficients(self, Ilm, W):
        """Replace I_l by V_l·W_l on used orders and unmasked shells; the
        l = 0 row takes the data column and the 1/√N particle scaling."""
        Ilt = Ilm.movedim(-1, -3)                          # (..., L+1, n_q, n_m)
        proj = self.V_pad @ W
        proj[..., 0, :, :] = self.V_pad[0]
        take = (self.use_order[:, None] & self.radial_mask)[:, :, None]
        out = torch.where(take, proj, Ilt)
        out[..., 0, :, :] *= 1.0 / float(np.sqrt(self.n_particles))
        return out.movedim(-3, -1)

    def __call__(self, Ilm):
        if self.k5_active and Ilm.dtype == torch.complex64:
            return self._project_fused(Ilm)
        return self.project_coefficients(Ilm, self.approximate_unknowns(Ilm))

    @property
    def pn_enabled(self):
        return self.pn_s is not None

    def particle_number_estimate(self, I):
        """The particle-number estimate of each restart from the projected
        intensity I (..., n_q, θ, φ), and I projected to its scaling under
        pn_project. A point turns negative under the scale s exactly when
        s < r = −I/a, so one histogram of r over the scan's scales gives
        every candidate's negative share; N̂ is the candidate after the
        steepest rise of that share (the first, as jnp.argmax). The
        restarts' buckets are offset into one bincount.
        → (N̂ (...), I)."""
        lead = I.shape[:-3]
        idx = torch.argmax(self.particle_number_scan(I), dim=-1)
        if self.pn_project:
            s = self.pn_s[idx].reshape(lead + (1, 1, 1))
            I = torch.clamp(I + s * self.pn_a.reshape(-1, 1, 1), min=0.0)
        return self.pn_Ns[idx], I

    def particle_number_scan(self, I):
        """The estimate's objective per restart: the rise of the negative
        share between neighbouring candidates over their abscissa, (...,
        K−1) at the tables' dtype; N̂ follows its first maximum."""
        lead = I.shape[:-3]
        a = self.pn_a.reshape(-1, 1, 1)
        pos = a > 0
        r = torch.where(pos, -I / torch.where(pos, a, 1.0), -torch.inf)
        r = r.reshape(-1, I.shape[-3:].numel())
        k = self.pn_s.shape[0]
        bucket = torch.searchsorted(self.pn_s.flip(0).contiguous(), r,
                                    right=True)
        bucket += (k + 1) * torch.arange(r.shape[0],
                                         device=r.device)[:, None]
        counts = torch.bincount(bucket.reshape(-1),
                                minlength=r.shape[0] * (k + 1))
        # a θ shard's integer counts summed over the θ ranks: exact
        if self.shard is not None:
            counts, = self.shard.all_reduce((counts,))
        n = r.shape[1] if self.shard is None else self.shard.grid_points
        cum = counts.reshape(r.shape[0], k + 1).cumsum(-1)
        neg = ((n - cum[:, :-1]).to(self.pn_s.dtype) / n).flip(-1)
        x = self.pn_x
        grad = (neg[:, 1:] - neg[:, :-1]) / (x[1:] - x[:-1])
        return grad.reshape(lead + grad.shape[-1:])


class RealCircularHarmonics:
    """Intensity ↔ circular-harmonic coefficients for the 2D MTIP: forward
    is an rfft over φ truncated to m = 0..M, divided by n_φ; inverse the
    irfft of the zero-padded half spectrum times n_φ."""

    def __init__(self, n_phi: int, m_max: int):
        self.n_phi = int(n_phi)
        self.m_max = int(m_max)

    def forward(self, intensity):
        return torch.fft.rfft(intensity, dim=-1)[..., : self.m_max + 1] \
            / self.n_phi

    def inverse(self, coeff):
        pad = self.n_phi // 2 + 1 - coeff.shape[-1]
        if pad > 0:
            coeff = torch.cat([coeff, coeff.new_zeros(coeff.shape[:-1]
                                                      + (pad,))], dim=-1)
        return torch.fft.irfft(coeff * self.n_phi, self.n_phi, dim=-1)


@dataclass
class ReciprocalConstraintPolar:
    """Device tensors of the 2D data projection on rfft-layout
    coefficients (..., n_q, M+1): the unit phase of each order from
    u_m = Σ_q conj(v_m)·q·I_m (weighted by q, not q² as in 3D), then
    I_m ← v_m·phase_m on used orders and unmasked shells; row 0 takes
    v_0/√N. so_pin_order fixes that order's phase to exactly 1 (the SO(2)
    gauge)."""
    V: Any               # (M+1, n_q) complex64 or complex128 data vectors
    VD: Any              # (M+1, n_q) = conj(v_m)·q
    use_order: Any       # (M+1,) bool
    radial_mask: Any     # (M+1, n_q) bool
    n_particles: float
    m_max: int
    so_pin_order: Any = None

    @classmethod
    def build(cls, projection_vectors, radial_points, m_max,
              used_order_ids=None, odd_orders_to_0=True,
              use_averaged_intensity=True, average_intensity=None,
              radial_mask=None, n_particles=1.0, so_pin_order=None, *,
              real_dtype=torch.float32, device="cuda"):
        """Host assembly from the per-order vectors v_m (n_q,) or (n_q, 1)."""
        n_q = len(radial_points)
        V = np.zeros((m_max + 1, n_q), dtype=complex)
        for m in range(min(m_max + 1, len(projection_vectors))):
            v = np.asarray(projection_vectors[m]).reshape(-1)
            V[m, : len(v)] = v[:n_q]
        if odd_orders_to_0:
            V[1::2] = 0
        if use_averaged_intensity and average_intensity is not None:
            V[0] = np.asarray(average_intensity).real
        D1 = np.asarray(radial_points, dtype=float)
        use_order = np.zeros(m_max + 1, dtype=bool)
        if used_order_ids is None:
            used_order_ids = np.arange(m_max + 1)
        use_order[np.asarray(used_order_ids, dtype=int)] = True
        if radial_mask is None:
            radial_mask = np.ones((m_max + 1, n_q), dtype=bool)
        cdt = _np_dtypes(real_dtype)[1]
        return cls.from_numpy(V.astype(cdt), (V.conj() * D1[None, :]).astype(
            cdt), use_order, radial_mask, n_particles=n_particles,
            m_max=m_max, so_pin_order=so_pin_order, real_dtype=real_dtype,
            device=device)

    @classmethod
    def from_numpy(cls, V, VD, use_order, radial_mask, *, n_particles, m_max,
                   so_pin_order=None, real_dtype=torch.float32,
                   device="cuda"):
        cdt = _np_dtypes(real_dtype)[1]

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)
        return cls(V=dev(V, cdt), VD=dev(VD, cdt),
                   use_order=dev(use_order, bool),
                   radial_mask=dev(radial_mask, bool),
                   n_particles=float(n_particles), m_max=int(m_max),
                   so_pin_order=None if so_pin_order is None
                   else int(so_pin_order))

    def approximate_unknowns(self, Im):
        """Im (..., n_q, M+1) → unit phases (..., M+1)."""
        u = torch.einsum("mq,...qm->...m", self.VD, Im)
        mag = u.abs()
        one = torch.ones((), dtype=u.dtype, device=u.device)
        phases = torch.where(mag > 0, u / torch.where(mag > 0, mag, 1.0), one)
        if self.so_pin_order is not None:
            pin = torch.arange(self.m_max + 1, device=u.device) \
                == self.so_pin_order
            phases = torch.where(pin, one, phases)
        return phases

    def project_coefficients(self, Im, phases):
        proj = self.V * phases[..., :, None]               # (..., M+1, n_q)
        row0 = (self.V[0] / float(np.sqrt(self.n_particles))).expand(
            proj.shape[:-2] + (1, proj.shape[-1]))
        proj = torch.cat([row0, proj[..., 1:, :]], dim=-2)
        take = self.use_order[:, None] & self.radial_mask
        return torch.where(take, proj, Im.transpose(-1, -2)).transpose(-1,
                                                                       -2)

    def __call__(self, Im):
        return self.project_coefficients(Im, self.approximate_unknowns(Im))


def project_to_modified_intensity(psi, intensity, new_intensity, eps=0.0):
    """ψ ← ψ·√(I_new/I) where both intensities are valid, else 0."""
    valid = (intensity > eps) & (new_intensity >= 0)
    ratio = torch.where(valid, new_intensity
                        / torch.where(valid, intensity, 1.0), 0.0)
    return psi * torch.sqrt(ratio)


# ----------------------------------------------------------------- real side
@dataclass
class RealConstraint:
    """Support + value-threshold + limit-imag projection. → (projected
    density, invalid mask); `considered_projections` picks which violation
    masks form the HIO/RAAR feedback region."""
    apply_support: bool = True
    apply_value_threshold: bool = True
    threshold_low: float | None = 0.0
    threshold_high: float | None = None
    apply_limit_imag: bool = True
    limit_imag: float = 2.0
    apply_assert_real: bool = False
    considered_projections: tuple = ("all",)

    def _considered(self, name):
        return "all" in self.considered_projections \
            or name in self.considered_projections

    def __call__(self, rho, support):
        invalid = torch.zeros(rho.shape, dtype=torch.bool, device=rho.device)
        out = rho
        zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
        if self.apply_support:
            m = ~support
            out = torch.where(m, zero, out)
            if self._considered("support"):
                invalid = invalid | m
        if self.apply_value_threshold and self.threshold_low is not None:
            m = out.real < self.threshold_low
            lo = torch.complex(torch.full_like(out.real, self.threshold_low),
                               out.imag)
            out = torch.where(m, lo, out)
            if self._considered("value_threshold"):
                invalid = invalid | m
        if self.apply_value_threshold and self.threshold_high is not None:
            m = out.real > self.threshold_high
            hi = torch.complex(torch.full_like(out.real, self.threshold_high),
                               out.imag)
            out = torch.where(m, hi, out)
            if self._considered("value_threshold"):
                invalid = invalid | m
        if self.apply_limit_imag:
            m = out.imag.abs() >= self.limit_imag
            out = torch.where(m, torch.complex(out.real,
                                               torch.zeros_like(out.real)), out)
            if self._considered("limit_imag"):
                invalid = invalid | m
        if self.apply_assert_real:
            out = torch.complex(out.real, torch.zeros_like(out.real))
        return out, invalid


# ---------------------------------------------------------------- shrink wrap
def fixed_volume_keep_bucketed(c, w, target, n_bins=512, n_levels=3):
    """Keep-mask (B, M) whose weighted volume first reaches `target` (B, 1)
    per row, taking points of c (B, M) in descending order, without a sort:
    three rounds of a 512-way weighted histogram refine the boundary bin;
    bins above it are kept, and the boundary bin is filled in flat-index
    order. Membership follows the bin index the histogram counted, never
    recomputed edges. The histograms, the kept weight and the boundary's
    cumulative sum are float64: the card's scatter-adds run in no fixed
    order, and in float64 that order moves a bin's sum some 1e-9 of a
    float32 weight, so reruns take the same boundary bin unless the target
    lies that close to a bin's edge. w (M,) is shared by the rows."""
    b = c.shape[0]
    rows = torch.arange(b, device=c.device)[:, None] * n_bins
    wd = w.to(torch.float64)
    target = target.to(torch.float64)
    lo = c.amin(-1, keepdim=True)
    width = ((c.amax(-1, keepdim=True) - lo) * (1.0 + 1e-6) + 1e-30) / n_bins
    alive = torch.ones(c.shape, dtype=torch.bool, device=c.device)
    kept = torch.zeros_like(alive)
    w_kept = torch.zeros((b, 1), dtype=torch.float64, device=c.device)
    zero = torch.zeros((), dtype=torch.float64, device=c.device)
    for _ in range(n_levels):
        idx = torch.clamp(((c - lo) / width).to(torch.int32), 0, n_bins - 1)
        histw = torch.zeros(b * n_bins, dtype=torch.float64,
                            device=c.device).index_add_(
            0, (idx + rows).reshape(-1),
            torch.where(alive, wd, zero).reshape(-1)).reshape(b, n_bins)
        suffix = histw.flip(-1).cumsum(-1).flip(-1)    # Σ_{j ≥ k} histw
        ok = (w_kept + suffix) >= target               # a prefix of True
        bin_ = torch.clamp(ok.sum(-1, keepdim=True) - 1, min=0)
        promote = alive & (idx > bin_)
        kept |= promote
        w_kept = w_kept + torch.where(promote, wd, zero).sum(-1, keepdim=True)
        alive &= idx == bin_
        lo = lo + bin_ * width
        width = width / n_bins
    cw = torch.where(alive, wd, zero).cumsum(-1)
    # kept while the weight before the point is below the residual (the
    # crossing point included, as searchsorted on the sort path)
    return kept | (alive & (cw - wd < target - w_kept))


@dataclass
class ShrinkWrap:
    """Gaussian-blur support update: multiply ψ = FT(|ρ|) by the FT of a
    Gaussian, inverse-FT, then threshold between min and max of the
    clipped blur (mode='threshold') or keep the highest-blur points whose
    integrated volume reaches a target (mode='fixed_volume': an exact sort,
    or under fixed_volume_method 'bucketed' fixed_volume_keep_bucketed).
    The grid's rank (3: (q,θ,φ), 2: (q,φ)) is that of q_radii."""
    q_radii: Any              # (n_q, 1, 1) or (n_q, 1) real tensor
    default_sigma: float
    mode: str = "threshold"
    volume_fraction: float = 0.5
    vol_weights: Any = None   # grid tensor, zero outside the initial support
    initial_support: Any = None
    fixed_volume_method: str = "sort"
    max_volume_change: Any = 0.2
    # a θ shard (ThetaShard): the threshold's max and min over the θ
    # ranks, a fixed volume on the whole grid (vol_weights and
    # initial_support stay whole); None: the whole grid
    shard = None

    @classmethod
    def build(cls, qs, mode="threshold", volume_fraction=0.5,
              integration_weights=None, initial_support=None,
              fixed_volume_method="sort", max_volume_change=0.2, *,
              grid_rank=3, real_dtype=torch.float32, device="cuda"):
        rdt = _np_dtypes(real_dtype)[0]
        q = torch.as_tensor(np.asarray(qs, rdt).reshape(
            (-1,) + (1,) * (grid_rank - 1)), device=device)
        w = sup = None
        if mode == "fixed_volume":
            if integration_weights is None or initial_support is None:
                raise ValueError("fixed_volume shrink-wrap needs "
                                 "integration_weights and initial_support")
            sup = torch.as_tensor(np.asarray(initial_support), device=device)
            w = torch.as_tensor(np.asarray(integration_weights, rdt),
                                device=device) * sup
        mvc = None if max_volume_change in (None, False) \
            else float(max_volume_change)
        return cls(q_radii=q, default_sigma=float(np.pi / np.max(qs)),
                   mode=str(mode), volume_fraction=float(volume_fraction),
                   vol_weights=w, initial_support=sup,
                   fixed_volume_method=str(fixed_volume_method),
                   max_volume_change=mvc)

    def gaussian_values(self, sigma):
        a = torch.tensor(1.0 / (2.0 * float(sigma) ** 2),
                         dtype=self.q_radii.dtype, device=self.q_radii.device)
        return torch.sqrt(np.pi / a) * torch.exp(-np.pi ** 2
                                                 * self.q_radii ** 2 / a)

    @property
    def _grid(self):
        return tuple(range(-self.q_radii.dim(), 0))

    def new_support(self, conv, threshold, current_support=None):
        """conv (..., n_q, n_θ, n_φ) or (..., n_q, n_φ) → bool support,
        per leading index."""
        if self.mode == "fixed_volume":
            return self.new_support_fixed_volume(conv, current_support)
        c = torch.clamp(conv.real, min=0.0)
        cmax, = grid_reduce((c,), self._grid, "max", self.shard, True)
        cmin, = grid_reduce((c,), self._grid, "min", self.shard, True)
        return c >= cmin + threshold * (cmax - cmin)

    def new_support_fixed_volume(self, conv, current_support=None):
        """Exact quantile by a descending sort and weighted cumsum ('sort')
        or the bucketed histograms ('bucketed'); with max_volume_change and
        the current support, the target is clipped to within that fraction
        of the current volume. On a θ shard the blurred field and the
        current support are gathered along θ (once a shrink-wrap), every θ
        rank computes the whole mask alike and keeps its rows: exact, as
        on one card."""
        if self.shard is not None:
            gather = self.shard.gather
            whole = copy.copy(self)
            whole.shard = None
            whole = whole.new_support_fixed_volume(
                gather(conv.real), None if current_support is None
                else gather(current_support))
            return whole[..., self.shard.rows, :]
        rank = self.q_radii.dim()
        grid = conv.shape[-rank:]
        lead = conv.shape[:-rank]
        c = conv.real.reshape(lead + (-1,))
        w = self.vol_weights.reshape(-1)
        target = self.volume_fraction * w.sum()
        target = target.expand(lead + (1,)).clone()
        if self.max_volume_change is not None and current_support is not None:
            old = (w * current_support.reshape(lead + (-1,))).sum(-1,
                                                                  keepdim=True)
            target = torch.minimum(torch.maximum(
                target, (1.0 - self.max_volume_change) * old),
                (1.0 + self.max_volume_change) * old)
        if self.fixed_volume_method == "bucketed":
            keep = fixed_volume_keep_bucketed(c.reshape(-1, c.shape[-1]), w,
                                              target.reshape(-1, 1))
            return keep.reshape(lead + grid) & self.initial_support
        order = torch.argsort(-c, dim=-1, stable=True)
        cum = torch.cumsum(w[order], dim=-1)
        pos = torch.clamp(torch.searchsorted(cum.contiguous(),
                                             target.contiguous()),
                          0, c.shape[-1] - 1)
        ranks = torch.arange(c.shape[-1], device=c.device)
        keep = torch.zeros_like(c, dtype=torch.bool)
        keep.scatter_(-1, order, ranks <= pos)
        return keep.reshape(lead + grid) & self.initial_support


# -------------------------------------------------------------------- updates
def hio_update(rho_in, rho_p, rho_proj, invalid, beta):
    """Fienup hybrid input-output."""
    return torch.where(invalid, rho_in - beta * (rho_p - rho_proj), rho_proj)


def er_update(rho_proj):
    """Error reduction."""
    return rho_proj


def raar_update(rho_in, rho_p, rho_proj, invalid, beta):
    """Relaxed averaged alternating reflections (Luke 2005)."""
    return torch.where(invalid, beta * rho_in + (1 - 2 * beta) * rho_p,
                       rho_proj)
