"""Host-side special-function tables (float64, numpy/scipy).

Numpy copy of `xframe_tpu.library.legendre` (the functions the phasing
slice and the invariant engine use): importing the JAX package pulls in its
settings and PyYAML, which the machine with the card lacks.
`tests/test_torch_host_tables.py` holds these copies equal to the
originals.
"""
from __future__ import annotations

import numpy as np
from scipy.special import roots_legendre


def gauss_legendre(n, start=-1.0, stop=1.0):
    """Gauss-Legendre nodes/weights on [start, stop]."""
    xi, w = roots_legendre(n)
    xi = (stop - start) / 2 * xi + (start + stop) / 2
    w = (stop - start) / 2 * w
    return xi, w


def sph_legendre_table(l_max: int, x: np.ndarray) -> np.ndarray:
    """Orthonormalized (4π) associated Legendre values P̄_l^m(x), 0<=m<=l<=l_max,
    with the Condon-Shortley phase. → (len(x), l_max+1, l_max+1) indexed
    [x, m, l]; entries with l < m are zero."""
    x = np.asarray(x, dtype=np.float64)
    nx = x.shape[0]
    L = l_max
    out = np.zeros((nx, L + 1, L + 1), dtype=np.float64)
    sx = np.sqrt(np.maximum(0.0, 1.0 - x * x))

    pmm = np.full(nx, np.sqrt(1.0 / (4.0 * np.pi)))
    out[:, 0, 0] = pmm
    for m in range(1, L + 1):
        pmm = -np.sqrt((2 * m + 1) / (2.0 * m)) * sx * pmm
        out[:, m, m] = pmm
    for m in range(0, L + 1):
        if m + 1 <= L:
            out[:, m, m + 1] = x * np.sqrt(2 * m + 3.0) * out[:, m, m]
        for l in range(m + 2, L + 1):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            out[:, m, l] = a * (x * out[:, m, l - 1] - b * out[:, m, l - 2])
    return out


def sph_legendre_table_full_m(l_max: int, x: np.ndarray) -> np.ndarray:
    """P̄_l^m for all m in CENTERED ordering (index j ↔ m = j - L).
    → (2L+1, len(x), L+1) indexed [j, x, l]; P̄_l^{-m} = (-1)^m P̄_l^m."""
    t = sph_legendre_table(l_max, x)
    L = l_max
    pos = np.moveaxis(t, 0, 1)
    out = np.zeros((2 * L + 1, x.shape[0], L + 1), dtype=np.float64)
    out[L:] = pos
    signs = (-1.0) ** np.arange(1, L + 1)
    out[:L] = (signs[::-1, None, None]) * pos[1:][::-1]
    return out


def legendre_poly_table(l_max: int, x: np.ndarray) -> np.ndarray:
    """Plain Legendre polynomials P_l(x), shape x.shape + (l_max+1,). The
    recurrence runs with l as the leading axis (contiguous updates), then
    one transposing copy."""
    x = np.asarray(x, dtype=np.float64)
    tmp = np.empty((l_max + 1,) + x.shape, dtype=np.float64)
    tmp[0] = 1.0
    if l_max >= 1:
        tmp[1] = x
    for l in range(2, l_max + 1):
        np.multiply(x, tmp[l - 1], out=tmp[l])
        tmp[l] *= (2 * l - 1) / l
        tmp[l] -= (l - 1) / l * tmp[l - 2]
    return np.ascontiguousarray(np.moveaxis(tmp, 0, -1))
