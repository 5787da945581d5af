"""Degree-2 invariants B_l ↔ projection matrices V_l (host numpy).

Numpy copies of `harmonic_coeff_to_deg2_invariants_3d`,
`projection_matrices_to_deg2_invariant_3d` and
`deg2_invariant_to_projection_matrices` from
`xframe_tpu.projects.fxs.invariants` (importing that module pulls in the
JAX package's settings and PyYAML).
"""
from __future__ import annotations

import numpy as np


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


def _eig_sort_metric(lam, vec, sort_mode):
    """Eigen-pair ranking: by eigenvalue (0), or by the median of |√λ·v|
    signed by the eigenvalue (1)."""
    if sort_mode == 1:
        return np.median(np.abs(np.sqrt(np.abs(lam[None, :])) * vec),
                         axis=0) * np.sign(lam)
    return lam


def deg2_invariant_to_projection_matrices(bl: np.ndarray, q_id_limits=None,
                                          rank_cap=True, sort_mode=0):
    """Per-l eigendecomposition B_l ≈ V_l V_l†, V_l of shape
    (n_q, min(n_q, 2l+1)), eigenvalues sorted descending, negatives clipped.
    → (list of V_l, list of eigenvalues)."""
    n_orders, n_q, _ = bl.shape
    proj, eigs = [], []
    for l in range(n_orders):
        if q_id_limits is not None:
            lo, hi = int(q_id_limits[l][0]), int(q_id_limits[l][1])
        else:
            lo, hi = 0, n_q
        sub = bl[l, lo:hi, lo:hi]
        sub = (sub + sub.conj().T) / 2
        cap = 2 * l + 1 if rank_cap else n_q
        NN = min(n_q, cap)
        if np.allclose(sub, 0):
            proj.append(np.zeros((n_q, NN), dtype=complex))
            eigs.append(np.zeros(NN))
            continue
        lam, vec = np.linalg.eigh(sub)
        order = np.argsort(_eig_sort_metric(lam.real, vec, sort_mode))[::-1]
        lam, vec = lam[order].real, vec[:, order]
        N = min(hi - lo, cap)
        lam, vec = lam[:N].copy(), vec[:, :N]
        neg = lam < 0
        lam[neg] = 0
        vec = vec.copy()
        vec[:, neg] = 0
        full_vec = np.zeros((n_q, NN), dtype=complex)
        full_lam = np.zeros(NN)
        full_vec[lo:hi, :N] = vec
        full_lam[:N] = lam
        proj.append(full_vec @ np.diag(np.sqrt(full_lam)))
        eigs.append(full_lam)
    return proj, eigs
