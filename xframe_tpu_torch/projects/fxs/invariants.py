"""The FXS invariant engine: B_l ↔ cross-correlation ↔ projection
matrices (3D), B_m ↔ cross-correlation ↔ projection vectors (2D).

Port of `xframe_tpu.projects.fxs.invariants`. The JAX
package computes them in host float64 numpy; here they run in torch float64
(complex128) on the device of their tensor inputs, the worker's device.
One-dimensional tables (Ewald angles, Legendre values, quadrature nodes,
q-limit lines) are built on the host in numpy, as in the JAX package, and
moved to that device. Conventions:

  * I_lm: orthonormal spherical harmonics, padded layout (n_q, 2L+1, L+1);
  * B_l(q1,q2) = Σ_m I_lm(q1) I*_lm(q2);
  * C_n(q1,q2) = Σ_l B_l · P̄_l^n(cosθ_1) P̄_l^n(cosθ_2)/(2l+1), θ_i the
    Ewald-sphere polar angles; CC(q1,q2,Δ) = irfft(C_n) over n_φ points.

`harmonic_coeff_to_deg2_invariants_3d` and
`projection_matrices_to_deg2_invariant_3d` stay host numpy: the workers'
diagnostics call them on host arrays. The SHT-constraint prephasing
(`enforce_sht_constraint`) and the particle-number estimate
(`estimate_number_of_particles`) run their transforms through a FusedSHT:
the kernels B2 and B9 on the card, the plain versions on the CPU. The 2D
functions (`*_2d`) take and give tensors, float64/complex128 on the device
of their input: B_m = I_m(q1) I*_m(q2) of circular harmonics, CC = irfft
over the B_m axis, B_m = rfft of the CC, v_m the rank-1 factor of B_m.
"""
from __future__ import annotations

import numpy as np
import torch

from xframe_tpu_torch.library.legendre import (legendre_poly_table,
                                               sph_legendre_table)
from xframe_tpu_torch.library.physics import ewald_sphere_theta_pi

F64, C128 = torch.float64, torch.complex128


def _tensor(x, dtype, device):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


# ------------------------------------------------------------------ PP matrices
def ewald_legendre_tables(thetas, l_max: int, device="cpu"):
    """P̄_l^m(cosθ_q) tables (n_q, m, l), zeros for l < m, float64."""
    return _tensor(sph_legendre_table(l_max, np.cos(np.asarray(thetas))),
                   F64, device)


def pp_matrix_single_l(tables, l: int):
    """PP_l[q1,q2,n] = P̄_l^n(θ1)·P̄_l^n(θ2)/(2l+1) for n = 0..l."""
    col = tables[:, : l + 1, l]
    return col[None, :, :] * col[:, None, :] / (2 * l + 1)


def pp_matrices(tables):
    """PP[q1,q2,n,l] = P̄_l^n(θ1)P̄_l^n(θ2)/(2l+1)."""
    l_max = tables.shape[-1] - 1
    orders = torch.arange(l_max + 1, dtype=F64, device=tables.device)
    return tables[None, :] * tables[:, None] \
        / (2 * orders + 1)[None, None, None, :]


# ---------------------------------------------------------- invariants (host)
def harmonic_coeff_to_deg2_invariants_3d(coeff: np.ndarray) -> np.ndarray:
    """B_l = I_l I_l† from padded coefficients (n_q, n_m, L+1) → (L+1, n_q, n_q)."""
    return np.einsum("qml,pml->lqp", coeff, coeff.conj())


def projection_matrices_to_deg2_invariant_3d(proj_matrices) -> np.ndarray:
    """B_l = V_l V_l† from the per-order list → (L+1, n_q, n_q)."""
    n_q = proj_matrices[0].shape[0]
    out = np.zeros((len(proj_matrices), n_q, n_q), dtype=complex)
    for l, v in enumerate(proj_matrices):
        out[l] = v @ v.conj().T
    return out


# ------------------------------------------------------------------- B_l → CC
def deg2_invariant_to_cc_3d(bl, xray_wavelength: float, qs, n_phi=None):
    """CC(q1,q2,Δ) from B_l (L+1, n_q, n_q) through the PP relation and an
    irfft, C_n accumulated order by order. → float64 (n_q, n_q, n_φ)."""
    dev = bl.device
    l_max = bl.shape[0] - 1
    tables = ewald_legendre_tables(
        ewald_sphere_theta_pi(xray_wavelength, np.asarray(qs)), l_max, dev)
    n_q = len(qs)
    cns = torch.zeros((n_q, n_q, l_max + 1), dtype=C128, device=dev)
    for l in range(l_max + 1):
        if not bool((bl[l] != 0).any()):
            continue
        cns[..., : l + 1] += bl[l][..., None] * pp_matrix_single_l(tables, l)
    if n_phi is None:
        n_phi = 2 * (cns.shape[-1] - 1)
    return torch.fft.irfft(cns * n_phi, n_phi, dim=-1)


# ------------------------------------------------------------------- CC → B_l
def cc_to_deg2_invariant_3d(cc, xray_wavelength: float, qs, l_max: int,
                            assume_zero_odd_orders: bool = True,
                            mode: str = "back_substitution"):
    """B_l(q1,q2) (L+1, n_q, n_q) complex128 from a float64 CC on its device.
    Modes: back_substitution (and its memory_hungry twin, the same solve),
    back_substitution_qqsym, back_substitution_psd, legendre, lstsq."""
    if mode in ("back_substitution", "back_substitution_memory_hungry"):
        return _cc_to_bl_back_substitution(cc, xray_wavelength, qs, l_max,
                                           assume_zero_odd_orders)
    if mode == "back_substitution_qqsym":
        return _cc_to_bl_back_substitution(cc, xray_wavelength, qs, l_max,
                                           assume_zero_odd_orders,
                                           symmetrize=True)
    if mode == "back_substitution_psd":
        return _cc_to_bl_back_substitution_psd(cc, xray_wavelength, qs,
                                               l_max, assume_zero_odd_orders)
    if mode == "lstsq":
        return _cc_to_bl_lstsq(cc, xray_wavelength, qs, l_max,
                               assume_zero_odd_orders)
    if mode == "legendre":
        return _cc_to_bl_legendre(cc, l_max, assume_zero_odd_orders)
    raise ValueError(f"unknown B_l extraction mode {mode!r}")


def _cc_to_bl_back_substitution(cc, xray_wavelength, qs, l_max,
                                assume_zero_odd_orders, symmetrize=False):
    """Triangular solve against the PP matrices from l = L downward;
    symmetrize=True (q1,q2)-symmetrizes the C_n and the PP columns first."""
    dev = cc.device
    tables = ewald_legendre_tables(
        ewald_sphere_theta_pi(xray_wavelength, np.asarray(qs)), l_max, dev)
    n_phi = cc.shape[-1]
    stride = 2 if assume_zero_odd_orders else 1
    ccn = torch.fft.rfft(cc.to(F64), dim=-1)[..., : l_max + 1: stride] / n_phi
    if symmetrize:
        ccn = (ccn + ccn.transpose(0, 1).conj()) / 2
    bl = torch.zeros((l_max + 1,) + tuple(cc.shape[:2]), dtype=C128,
                     device=dev)
    for l in range(0, l_max + 1, stride)[::-1]:
        col = pp_matrix_single_l(tables, l)[..., ::stride]
        if symmetrize:
            col = (col + col.transpose(0, 1)) / 2
        bl[l] = ccn[..., -1] / col[..., -1]
        ccn = ccn[..., :-1] - bl[l][..., None] * col[..., :-1]
    return bl


def _cc_to_bl_back_substitution_psd(cc, xray_wavelength, qs, l_max,
                                    assume_zero_odd_orders):
    """The back substitution at stride 1 with the C_n projected to the
    nearest PSD matrix first and every B_l projected before its
    contribution is subtracted; odd orders zeroed afterwards on request."""
    dev = cc.device
    tables = ewald_legendre_tables(
        ewald_sphere_theta_pi(xray_wavelength, np.asarray(qs)), l_max, dev)
    n_phi = cc.shape[-1]
    ccn = torch.fft.rfft(cc.to(F64), dim=-1)[..., : l_max + 1] / n_phi
    ccn = nearest_positive_semidefinite_matrix(
        ccn.movedim(-1, 0)).movedim(0, -1).to(C128)
    bl = torch.zeros((l_max + 1,) + tuple(cc.shape[:2]), dtype=C128,
                     device=dev)
    for l in range(l_max, -1, -1):
        col = pp_matrix_single_l(tables, l)
        bl[l] = nearest_positive_semidefinite_matrix(ccn[..., -1]
                                                     / col[..., -1])
        ccn = ccn[..., :-1] - bl[l][..., None] * col[..., :-1]
    if assume_zero_odd_orders:
        bl[1::2] = 0
    return bl


def _cc_to_bl_legendre(cc, l_max, assume_zero_odd_orders):
    """Flat-Ewald extraction: B_l = 4π × the Legendre coefficients of the
    π-periodized CC in x = cosΔ, exact by Gauss–Legendre quadrature of its
    cosine series at K = n_φ/2 + L + 1 nodes."""
    dev = cc.device
    cc = enforce_pi_periodicity(cc.to(F64))
    n_phi = cc.shape[-1]
    r = torch.fft.rfft(cc, dim=-1).real / n_phi
    g = torch.cat([r[..., :1], 2 * r[..., 1:-1], r[..., -1:]], dim=-1)
    K = n_phi // 2 + l_max + 1
    x, w = np.polynomial.legendre.leggauss(K)
    E = np.cos(np.outer(np.arccos(x), np.arange(g.shape[-1])))
    f = g @ _tensor(E.T, F64, dev)
    stride = 2 if assume_zero_odd_orders else 1
    orders = np.arange(0, l_max + 1, stride)
    P = _tensor(legendre_poly_table(l_max, x)[:, orders], F64, dev)
    a = torch.einsum("abk,kl->lab", f * _tensor(w, F64, dev), P) \
        * _tensor((2 * orders + 1) / 2, F64, dev)[:, None, None]
    bl = torch.zeros((l_max + 1,) + tuple(cc.shape[:2]), dtype=C128,
                     device=dev)
    bl[torch.as_tensor(orders, device=dev)] = (4 * np.pi * a).to(C128)
    return bl


def _legendre_poly(l_max, x):
    """P_l(x) for l = 0..l_max on a tensor: x.shape + (l_max+1,), the
    recurrence of library/legendre.legendre_poly_table."""
    out = torch.empty((l_max + 1,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    out[0] = 1.0
    if l_max >= 1:
        out[1] = x
    for l in range(2, l_max + 1):
        out[l] = x * out[l - 1] * ((2 * l - 1) / l) \
            - (l - 1) / l * out[l - 2]
    return out.movedim(0, -1)


def _cc_to_bl_lstsq(cc, xray_wavelength, qs, l_max, assume_zero_odd_orders,
                    row_chunk=None):
    """Per-(q1,q2) least squares against F_l(q1,q2,Δ) = P_l(cosθ1 cosθ2 +
    sinθ1 sinθ2 cosΔ)/(4π) through the normal equations, batched over
    q1-row chunks; a pseudo-inverse for a singular chunk."""
    dev = cc.device
    cc = cc.to(F64)
    thetas = ewald_sphere_theta_pi(xray_wavelength, np.asarray(qs))
    n_q, n_phi = len(qs), cc.shape[-1]
    phis = 2 * np.pi * np.arange(n_phi) / n_phi
    stride = 2 if assume_zero_odd_orders else 1
    orders = torch.arange(0, l_max + 1, stride, device=dev)
    ct, st = _tensor(np.cos(thetas), F64, dev), _tensor(np.sin(thetas), F64,
                                                          dev)
    cosphi = _tensor(np.cos(phis), F64, dev)
    bl = torch.zeros((l_max + 1, n_q, n_q), dtype=C128, device=dev)
    if row_chunk is None:
        row_chunk = max(1, int(1e9 / (n_q * n_phi * (l_max + 1) * 8)))
    for a0 in range(0, n_q, row_chunk):
        a1 = min(a0 + row_chunk, n_q)
        arg = (ct[a0:a1, None, None] * ct[None, :, None]
               + st[a0:a1, None, None] * st[None, :, None]
               * cosphi[None, None, :])
        F = _legendre_poly(l_max, arg)[..., orders] / (4 * np.pi)
        Ft = F.transpose(-1, -2).contiguous()
        G = Ft @ F
        rhs = (Ft @ cc[a0:a1, ..., None])[..., 0]
        try:
            sol = torch.linalg.solve(G, rhs[..., None])[..., 0]
        except torch.linalg.LinAlgError:
            sol = (torch.linalg.pinv(G) @ rhs[..., None])[..., 0]
        bl[orders, a0:a1] = sol.movedim(-1, 0).to(C128)
    return bl


# ---------------------------------------------------------------- PSD / eigen
def _lexicographic_min(ev):
    """numpy's min of a complex array: the least real part, ties broken by
    the imaginary part."""
    ev = ev.reshape(-1)
    cand = ev[ev.real == ev.real.min()]
    return cand[torch.argmin(cand.imag)]


def nearest_positive_semidefinite_matrix(A,
                                         low_positive_eigenvalues_to_zero=False):
    """Higham's nearest-PSD projection of (..., n, n) matrices."""
    B = (A + A.transpose(-1, -2).conj()) / 2
    lam, v = torch.linalg.eigh(B)
    limit = 0.0
    if low_positive_eigenvalues_to_zero:
        limit = float(_lexicographic_min(torch.linalg.eigvals(A)).abs())
    lam = torch.where(lam < limit, torch.zeros_like(lam), lam)
    return (v * lam[..., None, :]) @ v.transpose(-1, -2).conj()


def _eig_sort_metric(lam, vec, sort_mode):
    """Eigen-pair ranking: by eigenvalue (0), or by the median of |√λ·v|
    signed by the eigenvalue (1, 'median_of_scaled_eigenvector')."""
    if sort_mode == 1:
        scaled = (torch.sqrt(lam.abs())[None, :] * vec).abs()
        return torch.quantile(scaled, 0.5, dim=0) * torch.sign(lam)
    return lam


def deg2_invariant_to_projection_matrices(bl, q_id_limits=None,
                                          rank_cap=True, sort_mode=0):
    """Per-order eigendecomposition B_l ≈ V_l V_l† (torch.linalg.eigh on
    bl's device, float64): V_l (n_q, min(n_q, 2l+1)) complex128 with
    eigen-pairs ranked descending by the sort_mode metric, negatives
    clipped, each order's [lo, hi) q-limits. V_l is fixed up to a phase per
    column. → (list of V_l, list of eigenvalues)."""
    bl = torch.as_tensor(bl)
    n_orders, n_q, _ = bl.shape
    dev = bl.device
    proj, eigs = [], []
    for l in range(n_orders):
        if q_id_limits is not None:
            lo, hi = int(q_id_limits[l][0]), int(q_id_limits[l][1])
        else:
            lo, hi = 0, n_q
        sub = bl[l, lo:hi, lo:hi].to(C128)
        sub = (sub + sub.conj().T) / 2
        cap = 2 * l + 1 if rank_cap else n_q
        NN = min(n_q, cap)
        if bool((sub.abs() <= 1e-8).all()):
            proj.append(torch.zeros((n_q, NN), dtype=C128, device=dev))
            eigs.append(torch.zeros(NN, dtype=F64, device=dev))
            continue
        lam, vec = torch.linalg.eigh(sub)
        order = torch.argsort(_eig_sort_metric(lam, vec, sort_mode),
                              stable=True).flip(0)
        N = min(hi - lo, cap)
        lam, vec = lam[order][:N].clone(), vec[:, order][:, :N].clone()
        neg = lam < 0
        lam[neg] = 0
        vec[:, neg] = 0
        full_vec = torch.zeros((n_q, NN), dtype=C128, device=dev)
        full_lam = torch.zeros(NN, dtype=F64, device=dev)
        full_vec[lo:hi, :N] = vec
        full_lam[:N] = lam
        proj.append(full_vec * torch.sqrt(full_lam)[None, :])
        eigs.append(full_lam)
    return proj, eigs


# ---------------------------------------------------------------------- 2D
def harmonic_coeff_to_deg2_invariants_2d(coeff):
    """B_m = I_m(q1) I*_m(q2) from circular-harmonic coefficients (n_q,
    n_m) → (n_m, n_q, n_q) complex128 on coeff's device."""
    c = torch.as_tensor(coeff).to(C128)
    return torch.einsum("qm,pm->mqp", c, c.conj())


def deg2_invariant_to_cc_2d(bm, n_phi=None):
    """CC(q1,q2,Δ) = irfft(B_m·n_φ) over the order axis, float64."""
    bm = torch.as_tensor(bm).to(C128).movedim(0, -1)
    if n_phi is None:
        n_phi = 2 * (bm.shape[-1] - 1)
    return torch.fft.irfft(bm * n_phi, n_phi, dim=-1)


def cc_to_deg2_invariant_2d(cc, m_max: int):
    """B_m (M+1, n_q, n_q) complex128: the circular harmonics
    rfft(CC)/n_φ of the CC over Δ, m = 0..M."""
    cc = torch.as_tensor(cc).to(F64)
    bm = torch.fft.rfft(cc, dim=-1)[..., : m_max + 1] / cc.shape[-1]
    return bm.movedim(-1, 0).contiguous()


def deg2_invariant_to_projection_vectors_2d(bm, sort_mode=0):
    """The rank-1 factor v_m of each B_m (one batched torch.linalg.eigh
    over the orders, float64 on bm's device): the eigen-pair with the
    largest sort_mode metric, v_m = √λ·u (zero where λ ≤ 0). v_m is fixed
    up to a phase: compare v_m v_m†. → ((n_m, n_q) complex128 vectors,
    (n_m,) eigenvalues)."""
    bm = torch.as_tensor(bm).to(C128)
    sub = (bm + bm.transpose(-1, -2).conj()) / 2
    lam, vec = torch.linalg.eigh(sub)
    if sort_mode == 1:
        scaled = (torch.sqrt(lam.abs())[:, None, :] * vec).abs()
        metric = torch.quantile(scaled, 0.5, dim=-2) * torch.sign(lam)
    else:
        metric = lam
    i = torch.argmax(metric, dim=-1)
    val = torch.clamp(lam.gather(-1, i[:, None])[:, 0], min=0.0)
    v = vec.gather(-1, i[:, None, None].expand(-1, vec.shape[1], 1))[..., 0]
    return v * torch.sqrt(val)[:, None], val


# ----------------------------------------------------- procrustes / padding
def solve_procrustes_problem(V1, V2):
    """Unitary U minimizing ||V1 − V2·U|| via svd(V2†V1)."""
    u, _, vh = torch.linalg.svd(V2.conj().T @ V1, full_matrices=False)
    return u @ vh


def pad_projection_matrices(proj, l_max: int, n_q: int):
    """Per-order (n_q, ≤2l+1) V_l → the padded layout (n_q, 2L+1, L+1) with
    the centered-m window."""
    dev = proj[0].device
    out = torch.zeros((n_q, 2 * l_max + 1, l_max + 1), dtype=C128,
                      device=dev)
    for l in range(min(l_max + 1, len(proj))):
        v = torch.atleast_2d(proj[l])
        if v.shape[0] != n_q:
            v = v.T
        ncols = min(v.shape[1], 2 * l + 1)
        out[:, l_max - l: l_max - l + ncols, l] = v[:, :ncols]
    return out


def unpad_projection_matrices(padded, rank_cap=True) -> list:
    """Inverse of pad_projection_matrices."""
    n_q, n_m, n_l = padded.shape
    L = n_l - 1
    out = []
    for l in range(n_l):
        ncols = min(2 * l + 1, n_q) if rank_cap else 2 * l + 1
        out.append(padded[:, L - l: L - l + ncols, l].clone())
    return out



def _procrustes_orders(V, P):
    """Every order's Procrustes back onto the data: P_l·U_l with U_l =
    svd(P_l† V_l) → u·vh, P_l and V_l the order's rank-capped window of
    the padded (n_q, 2L+1, L+1) arrays; orders of one width (those capped
    at n_q) in one batched SVD. → the padded P_l·U_l, complex128."""
    n_q, _, n_l = P.shape
    L = n_l - 1
    by_width = {}
    for l in range(n_l):
        by_width.setdefault(min(2 * l + 1, n_q), []).append(l)
    out = torch.zeros_like(P)
    for k, ls in by_width.items():
        p = torch.stack([P[:, L - l: L - l + k, l] for l in ls])
        v = torch.stack([V[:, L - l: L - l + k, l] for l in ls]).to(C128)
        u, _, vh = torch.linalg.svd(p.conj().transpose(1, 2) @ v,
                                    full_matrices=False)
        rotated = p @ (u @ vh)
        for i, l in enumerate(ls):
            out[:, L - l: L - l + k, l] = rotated[i]
    return out


def enforce_sht_constraint(proj, sht, iterations=100, rel_err_limit=1e-6):
    """Prephasing of the projection matrices: alternate (a) the positivity
    of the intensity they synthesize — the SHT round trip inverse (B2) →
    real part clipped at 0 → forward_real (B9) — and (b) each order's
    Procrustes rotation back onto the data matrices in float64 (orders of
    one width in one batched SVD). Every 10th iteration tests convergence
    (the relative change of Σ|V_new − V|/Σ|V| below rel_err_limit), one
    host read.
    sht: a FusedSHT of order L on proj's device; the transforms take
    complex64/float32 planes as the JAX package's do. → (the prephased
    per-order V_l, complex128, rank-capped widths; converged; iterations
    run)."""
    L = sht.l_max
    n_q = torch.atleast_2d(proj[0]).shape[0]
    P = pad_projection_matrices(proj, L, n_q)
    V = P
    err_old = None
    converged = False
    n_iter = 0
    for i in range(iterations):
        I = sht.inverse(V.to(torch.complex64)).real
        Vnew = sht.forward_real(torch.clamp(I, min=0.0))
        del I
        V = _procrustes_orders(Vnew, P)
        n_iter = i + 1
        if i % 10 == 9:
            err = float((Vnew.to(C128) - V).abs().sum()
                        / torch.clamp(V.abs().sum(), min=1e-30))
            if err_old is not None and abs(err_old - err) \
                    / max(err_old, 1e-30) < rel_err_limit:
                converged = True
                break
            err_old = err
    return unpad_projection_matrices(V), converged, n_iter


def estimate_number_of_particles(proj_matrices, sht, search_space=(1.0, 10.0,
                                                                   64),
                                 average_intensity=None, method="onset",
                                 onset_threshold=1e-4):
    """Number of particles from the projection matrices: scale the
    isotropic part I_00 by 1/s and follow the share of grid points with a
    negative intensity, which leaves ~0 near s ≈ √n. One inverse SHT (B2
    on the card) of the padded V (its l = 0 column replaced by the average
    intensity's, when given), the scan over the search_space scales on the
    device, then on the host: method 'onset' takes the first scale whose
    share exceeds onset_threshold, 'gradient' the largest |d share/ds|.
    → (n_particles, gradient, negative shares, scales)."""
    L = sht.l_max
    n_q = torch.atleast_2d(proj_matrices[0]).shape[0]
    V = pad_projection_matrices(proj_matrices, L, n_q)
    if average_intensity is not None:
        V[:, :, 0] = 0
        V[:, L, 0] = torch.as_tensor(
            np.abs(np.asarray(average_intensity)) * 2 * np.sqrt(np.pi),
            device=V.device)
    i00 = V[:, L, 0].abs().to(torch.float32)
    scales = np.linspace(*search_space)
    I = sht.inverse(V.to(torch.complex64)).real
    base = (i00 / (2 * np.sqrt(np.pi)))[:, None, None]
    neg = torch.stack([((I + (1.0 / s - 1.0) * base) < 0).sum()
                       for s in np.asarray(scales, dtype=np.float32)])
    neg = neg.cpu().numpy() / I.numel()
    grad = np.gradient(neg, scales[1] - scales[0])
    if method == "gradient":
        s_star = scales[np.argmax(np.abs(grad))]
    else:
        above = np.nonzero(neg > onset_threshold)[0]
        s_star = scales[above[0]] if len(above) else scales[-1]
    return float(s_star ** 2), grad, neg, scales

def projection_matrix_error_estimate(bl, proj):
    """Per-order |B_l − V_l V_l†| / |B_l| on the nonzero entries of B_l,
    −1 elsewhere (float64, bl's device)."""
    errors = torch.full(tuple(bl.shape), -1.0, dtype=F64, device=bl.device)
    for l in range(min(bl.shape[0], len(proj))):
        b = bl[l]
        pr = torch.atleast_2d(proj[l])
        if pr.shape[0] != b.shape[0]:
            pr = pr.T
        nz = b != 0
        rec = pr @ pr.conj().T
        errors[l][nz] = (b - rec).abs()[nz] / b[nz].abs()
    return errors


def calc_unknown_unitary_transform(proj_1, eig_1, proj_2, eig_2, b_21,
                                   radial_points, q_id_limits=None,
                                   method="procrustes"):
    """Unitary W_l relating the unknowns of two datasets from the mixed
    invariant B_21 = V2 W V1† ('procrustes' on q-weighted B_21, or
    'direct'). → (list of W_l, relative errors (orders, n_q, n_q))."""
    dev = b_21.device
    n_orders, n_q = len(proj_1), b_21.shape[-1]
    if q_id_limits is None:
        q_id_limits = np.zeros((n_orders, 2, 2), dtype=int)
        q_id_limits[..., 1] = n_q
    qs = _tensor(radial_points, F64, dev)
    W = []
    errors = torch.full(tuple(b_21.shape), -1.0, dtype=F64, device=dev)
    for o in range(n_orders):
        lim = np.asarray(q_id_limits[o])
        s2, s1 = slice(*lim[0]), slice(*lim[1])
        b = b_21[o][s2, s1]
        N1 = min(lim[1, 1] - lim[1, 0], 2 * o + 1)
        N2 = min(lim[0, 1] - lim[0, 0], 2 * o + 1)
        v1 = proj_1[o][s1, :N1]
        v2 = proj_2[o][s2, :N2]
        v1d = _scaled_by_inverse(v1, eig_1[o][:N1])
        if method == "direct":
            w = _scaled_by_inverse(v2, eig_2[o][:N2]).conj().T @ b @ v1d
        else:
            w = solve_procrustes_problem((qs[s2, None] * b) @ v1d, v2)
        W.append(w)
        nz = b != 0
        err = torch.full(tuple(b.shape), -1.0, dtype=F64, device=dev)
        err[nz] = (b - v2 @ w @ v1.conj().T).abs()[nz] / b[nz].abs()
        errors[o][s2, s1] = err
    return W, errors


def _scaled_by_inverse(v, e):
    """Columns of v divided by their positive eigenvalues, 0 elsewhere."""
    pos = e > 0
    out = torch.zeros_like(v)
    out[:, pos] = v[:, pos] / e[pos]
    return out


# -------------------------------------------------------------------- CC masks
def cc_mask(qs, phis, mask_type="none", xray_wavelength=None, pixel_size=None,
            mask_at_pi=True, threshold=0.01, custom=None,
            n_masked_pixels_phi=0.0, n_masked_pixels_q=0.0, device="cpu"):
    """Cross-correlation validity mask (n_q, n_q, n_φ), bool on `device`:
    none, direct (the given array), pixel_custom (fractions of the Δ axis
    around 0 and π, for q-pairs within a band), donatelli (|q1 ± q2|²
    threshold), pixel_arc (Ewald-sphere arc length below the reciprocal
    pixel size 2π/pixel_size) or pixel_flat (flat-detector variant)."""
    qs = np.asarray(qs, dtype=float)
    phis = np.asarray(phis, dtype=float)
    n_q, n_phi = len(qs), len(phis)
    if mask_type == "none":
        return torch.ones((n_q, n_q, n_phi), dtype=torch.bool, device=device)
    if mask_type == "direct":
        return torch.as_tensor(np.asarray(custom, dtype=bool), device=device)

    def t(x):
        return _tensor(x, F64, device)

    if mask_type == "pixel_custom":
        n = int(n_phi * float(n_masked_pixels_phi))
        nq = int(n_q * float(n_masked_pixels_q))
        pi_index = n_phi // 2
        ids = list(range(n)) + list(range(n_phi - n, n_phi))
        if mask_at_pi and n > 0:
            # the reference's window: 2n-2 ids around π, none for n = 1
            ids += list(range(pi_index - (n - 1), pi_index + (n - 1)))
        mask = torch.ones((n_q, n_q, n_phi), dtype=torch.bool, device=device)
        if ids:
            mask[..., torch.as_tensor(np.asarray(ids) % n_phi,
                                      device=device)] = False
        far = np.abs(np.arange(n_q)[:, None] - np.arange(n_q)[None, :]) > nq
        mask[torch.as_tensor(far, device=device)] = True
        return mask

    if mask_type == "donatelli":
        thetas = ewald_sphere_theta_pi(xray_wavelength, qs)
        q, ct, st = t(qs), t(np.cos(thetas)), t(np.sin(thetas))
        a = (q ** 2)[:, None, None] + (q ** 2)[None, :, None]
        b = 2 * q[:, None, None] * q[None, :, None] * (
            ct[:, None, None] * ct[None, :, None]
            + st[:, None, None] * st[None, :, None]
            * t(np.cos(phis))[None, None, :])
        return ~((a + b < threshold) | (a - b < threshold))

    r_pix = 2 * np.pi / float(pixel_size)
    if mask_type == "pixel_arc":
        thetas = ewald_sphere_theta_pi(xray_wavelength, qs)
        ewald_r = 2 * np.pi / xray_wavelength
        z = np.broadcast_to((qs * np.cos(thetas) - ewald_r)[:, None],
                            (n_q, n_phi))
        cart = np.stack([
            qs[:, None] * np.sin(thetas)[:, None] * np.cos(phis)[None, :],
            qs[:, None] * np.sin(thetas)[:, None] * np.sin(phis)[None, :],
            z,
        ], axis=-1)
        sph_theta = np.arccos(np.clip(cart[..., 2]
                                      / np.linalg.norm(cart, axis=-1),
                                      -1, 1))[:, 0]
        ct, st = t(np.cos(sph_theta)), t(np.sin(sph_theta))

        def arc(phi_vals):
            cosarc = ct[:, None, None] * ct[None, :, None] \
                + st[:, None, None] * st[None, :, None] \
                * t(np.cos(phi_vals))[None, None, :]
            return (ewald_r * torch.arccos(torch.clamp(cosarc, -1, 1))).abs()

        mask = arc(phis) > r_pix
        if mask_at_pi:
            mask &= arc(phis - np.pi) > r_pix
        return mask
    if mask_type == "pixel_flat":
        with np.errstate(divide="ignore"):
            phi_min = np.where(qs > 0, r_pix / np.where(qs > 0, qs, 1.0),
                               np.inf)
        phi_mask = (phis[None, :] > phi_min[:, None]) \
            & (phis[None, :] < 2 * np.pi - phi_min[:, None])
        if mask_at_pi:
            phi_mask &= (phis[None, :] > np.pi + phi_min[:, None]) \
                | (phis[None, :] < np.pi - phi_min[:, None])
        pm = torch.as_tensor(phi_mask, device=device)
        radial = torch.as_tensor(np.abs(qs[None, :] - qs[:, None]) > r_pix,
                                 device=device)
        return radial[:, :, None] | (pm[None, :, :] & pm[:, None, :])
    raise ValueError(f"unknown cc mask type {mask_type!r}")


# ---------------------------------------------------------- CC modifications
def interpolate_masked_cc(cc, mask, row_chunk=65536):
    """Fill the masked Δ entries of each (q1,q2) row by periodic linear
    interpolation between the nearest unmasked neighbours (rows without
    one become 0); vectorized over row chunks. → a new float64 tensor."""
    cc = cc.to(F64).clone()
    mask = mask.to(torch.bool)
    n_phi = cc.shape[-1]
    flat_c = cc.reshape(-1, n_phi)
    flat_m = mask.reshape(-1, n_phi)
    rows = torch.nonzero(~flat_m.all(dim=-1)).flatten()
    if len(rows) == 0:
        return cc
    dev = cc.device
    idx3 = torch.arange(3 * n_phi, device=dev)
    x_mid = idx3[n_phi: 2 * n_phi].to(F64)
    for c0 in range(0, len(rows), row_chunk):
        r = rows[c0: c0 + row_chunk]
        m, c = flat_m[r], flat_c[r]
        none_good = ~m.any(dim=-1)
        m3 = torch.cat([m, m, m], dim=-1)
        c3 = torch.cat([c, c, c], dim=-1)
        left = torch.cummax(torch.where(m3, idx3, -1), dim=-1).values[
            :, n_phi: 2 * n_phi]
        right = torch.cummin(torch.where(m3, idx3, 3 * n_phi).flip(-1),
                             dim=-1).values.flip(-1)[:, n_phi: 2 * n_phi]
        left_c = torch.clamp(left, 0, 3 * n_phi - 1)
        right_c = torch.clamp(right, 0, 3 * n_phi - 1)
        fL = torch.gather(c3, 1, left_c)
        fR = torch.gather(c3, 1, right_c)
        den = torch.clamp(right_c - left_c, min=1).to(F64)
        vals = fL + (x_mid[None, :] - left_c.to(F64)) / den * (fR - fL)
        filled = torch.where(m, c, vals)
        filled[none_good] = 0.0
        flat_c[r] = filled
    return cc


def enforce_pi_periodicity(cc, mask=None):
    """CC(Δ) = CC(Δ+π): the mean of the two Δ-halves, or with a mask their
    mask-weighted mean. → cc, or (cc, mask | mask shifted by π)."""
    n2 = cc.shape[-1] // 2
    rolled = torch.roll(cc, n2, dims=-1)
    if mask is None:
        return 0.5 * (cc + rolled)
    rm = torch.roll(mask, n2, dims=-1)
    w = mask.to(F64) + rm.to(F64)
    out = torch.where(w > 0, (cc * mask + rolled * rm)
                      / torch.clamp(w, min=1), torch.zeros_like(w))
    return out.to(cc.dtype), mask | rm


def symmetrize_cc_q1q2(cc, mask):
    """cc(q1,q2,Δ) = cc(q2,q1,−Δ): the mask-weighted mean of the CC and its
    Δ-reversed transpose; the masks' union. → (cc, mask)."""
    sw = cc.clone()
    sw[..., 1:] = cc[..., 1:].flip(-1)
    swm = mask.clone()
    swm[..., 1:] = mask[..., 1:].flip(-1)
    sw, swm = sw.transpose(0, 1), swm.transpose(0, 1)
    w = mask.to(F64) + swm.to(F64)
    out = torch.where(w > 0, (cc * mask + sw * swm) / torch.clamp(w, min=1),
                      torch.zeros_like(w))
    return out.to(cc.dtype), mask | swm


def zero_cc_harmonics(cc, max_order=None, zero_odd=False):
    """Zero the circular harmonics of the CC above max_order, and the odd
    ones on request."""
    f = torch.fft.rfft(cc.to(F64), dim=-1)
    if max_order is not None:
        f[..., int(max_order) + 1:] = 0
    if zero_odd:
        f[..., 1::2] = 0
    return torch.fft.irfft(f, cc.shape[-1], dim=-1)


def _sosfilt(sos, x):
    """scipy.signal.sosfilt along dim 0 (direct form II transposed, zero
    initial state), one step per sample."""
    for b0, b1, b2, _, a1, a2 in np.asarray(sos, dtype=float):
        z0 = torch.zeros_like(x[0])
        z1 = torch.zeros_like(x[0])
        y = torch.empty_like(x)
        for n in range(x.shape[0]):
            xn = x[n]
            yn = b0 * xn + z0
            z0 = b1 * xn - a1 * yn + z1
            z1 = b2 * xn - a2 * yn
            y[n] = yn
        x = y
    return x


def low_pass_cc_in_q(cc, cutoff):
    """First-order Butterworth low-pass along the q1 and q2 axes."""
    from scipy.signal import butter
    sos = butter(1, float(cutoff), "lp", fs=len(cc), output="sos")
    cc = _sosfilt(sos, cc.to(F64))
    return _sosfilt(sos, cc.transpose(0, 1)).transpose(0, 1)


def binned_mean_cc(cc, mask, max_order, phis):
    """Re-bin the Δ axis to 2·max_order bins of width π/max_order by masked
    averaging. → (cc, mask, phis) on the new grid (phis host numpy)."""
    phis = np.asarray(phis, dtype=float)
    step = np.pi / int(max_order)
    n_bins = 2 * int(max_order)
    ids = ((phis + step / 2) // step).astype(int)
    n_roll = int(np.sum(ids == n_bins))
    ids[ids == n_bins] = 0
    ccr = torch.roll(cc.to(F64), n_roll, dims=-1)
    mr = torch.roll(mask.to(torch.bool), n_roll, dims=-1)
    idr = np.roll(ids, n_roll)
    ccr = torch.where(mr, ccr, torch.zeros_like(ccr))
    # the segments np.add.reduceat sums: from each change of bin id on
    split = np.where(np.roll(idr, 1) != idr)[0]
    seg = np.full(len(idr), -1)
    for i, s in enumerate(split):
        seg[s:] = i
    keep = torch.as_tensor(np.nonzero(seg >= 0)[0], device=cc.device)
    segs = torch.as_tensor(seg[seg >= 0], device=cc.device)
    shape = tuple(cc.shape[:-1]) + (len(split),)
    new_cc = torch.zeros(shape, dtype=F64, device=cc.device).index_add_(
        -1, segs, ccr[..., keep])
    counts = torch.zeros(shape, dtype=torch.int64,
                         device=cc.device).index_add_(
        -1, segs, mr[..., keep].to(torch.int64))
    new_mask = counts != 0
    new_cc = torch.where(new_mask, new_cc / torch.clamp(counts, min=1),
                         new_cc)
    return new_cc, new_mask, np.arange(n_bins) * 2 * np.pi / n_bins


# ------------------------------------------------------- per-order q-id limits
def _distance_from_line(p1, p2, orders, qs):
    """Signed distance of every (order, q) point from the line p1 → p2."""
    p1, p2 = np.asarray(p1, dtype=float), np.asarray(p2, dtype=float)
    d = p2 - p1
    normal = np.array([d[1], -d[0]])
    return ((orders[:, None] - p1[0]) * normal[0]
            + (qs[None, :] - p1[1]) * normal[1])


def line_q_id_limits(qs, l_max, min_line=None, max_line=None, q_mask=None,
                     device="cpu"):
    """Per-order q limits from lines [(l, q), (l, q)] in (order, q) space
    bounding each order's usable q range from below (min_line) and above
    (max_line), clamped to the q_mask extent. The rows are host numpy (one
    value per order and q); → (mask (L+1, n_q, n_q) bool on `device`, the
    outer product of each order's row; q_id_limits (L+1, 2) int [lo, hi))."""
    qs = np.asarray(qs, dtype=float)
    n_q = len(qs)
    orders = np.arange(l_max + 1, dtype=float)
    limits = np.zeros((l_max + 1, 2), dtype=int)
    limits[:, 1] = n_q
    row_masks = np.ones((l_max + 1, n_q), dtype=bool)
    if min_line is not None:
        m = -_distance_from_line(min_line[0], min_line[1], orders, qs) >= 0
        # an order without a valid q gets [n_q-1, n_q); its all-False row
        # excludes it
        limits[:, 0] = np.where(m.any(axis=1), np.argmax(m, axis=1), n_q - 1)
        row_masks &= m
    if max_line is not None:
        m = _distance_from_line(max_line[0], max_line[1], orders, qs) > 0
        limits[:, 1] = np.where(m.all(axis=1), n_q, np.argmin(m, axis=1))
        row_masks &= m
    if q_mask is not None:
        q_mask = np.asarray(q_mask, dtype=bool)
        q_lo = int(np.argmax(q_mask))
        q_hi = n_q - int(np.argmax(q_mask[::-1]))
        limits[:, 0] = np.maximum(limits[:, 0], q_lo)
        limits[:, 1] = np.minimum(limits[:, 1], q_hi)
        row_masks &= q_mask[None, :]
    limits[:, 1] = np.maximum(limits[:, 1], limits[:, 0])
    rows = torch.as_tensor(row_masks, device=device)
    return rows[:, :, None] & rows[:, None, :], limits


def apply_psd_on_q_limits(bl, q_id_limits):
    """Nearest-PSD projection of each order's [lo, hi) sub-block only."""
    out = bl.clone()
    for l in range(len(bl)):
        lo, hi = int(q_id_limits[l][0]), int(q_id_limits[l][1])
        if hi - lo < 1:
            continue
        out[l, lo:hi, lo:hi] = nearest_positive_semidefinite_matrix(
            bl[l, lo:hi, lo:hi])
    return out
