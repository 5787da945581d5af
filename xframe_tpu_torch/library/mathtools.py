"""Host-side numerical helpers (float64 numpy).

Numpy copy of `xframe_tpu.library.mathtools.ring_symmetry_score` (see
`library/legendre.py` for why the port keeps copies), the figure of merit
of the correlate worker's beam-center search;
`tests/test_torch_host_tables.py` holds it equal to the original.
"""
from __future__ import annotations

import numpy as np


def ring_symmetry_score(r, weights, n_bins=64, r_max=None):
    """Azimuthal-symmetry figure of merit of a pattern around a candidate
    center: mean over radial rings of var(I)/mean(I)². r/weights are flat
    per-pixel radius and intensity; pixels with r >= r_max are ignored.
    Degenerate candidates — no pixels inside r_max, zero intensity
    everywhere, or rings mostly empty (an origin at the detector edge) —
    score +inf, so a grid search never prefers them over a real minimum."""
    r = np.asarray(r, dtype=np.float64).ravel()
    w = np.asarray(weights, dtype=np.float64).ravel()
    if r_max is None:
        r_max = float(r.max()) if r.size else 0.0
    if r_max <= 0:
        return np.inf
    inside = r < r_max
    if not inside.any():
        return np.inf
    idx = np.floor(r[inside] / r_max * n_bins).clip(0, n_bins - 1).astype(int)
    wi = w[inside]
    if not np.any(wi):
        return np.inf
    raw_counts = np.bincount(idx, minlength=n_bins)
    if (raw_counts > 0).sum() < n_bins // 2:
        return np.inf
    sums = np.bincount(idx, weights=wi, minlength=n_bins)
    sq = np.bincount(idx, weights=wi ** 2, minlength=n_bins)
    counts = np.maximum(raw_counts, 1)
    ring_mean = sums / counts
    ring_var = sq / counts - ring_mean ** 2
    return float(np.mean(ring_var / (np.abs(ring_mean) + 1e-30) ** 2))
