"""SPB experiment utilities: SAXS profiles, ROIs, beam-center refinement
and the frame filters of the experiment worker.

A numpy copy of `xframe_tpu.experiments.SPB.exp_library`
(tests/test_torch_spb.py holds the two equal): host helpers on multi-panel
frames with lab-frame pixel geometry.
"""
from __future__ import annotations

import numpy as np


def radial_bins(pixel_grid_reciprocal, n_q=128, q_range=None):
    """Per-pixel radial bin index + bin centers from (…, 3) (q,θ,φ) pixels."""
    q = np.asarray(pixel_grid_reciprocal)[..., 0]
    flat = q.ravel()
    if q_range is None:
        q_range = (float(flat[flat > 0].min()), float(flat.max()))
    idx = np.floor((flat - q_range[0]) / (q_range[1] - q_range[0]) * n_q)
    idx = np.clip(idx, -1, n_q).astype(np.int64)
    idx[(idx < 0) | (idx >= n_q)] = n_q  # trash bin
    centers = np.linspace(q_range[0], q_range[1], n_q + 1)[:-1] \
        + (q_range[1] - q_range[0]) / (2 * n_q)
    return idx.reshape(q.shape), centers


def saxs_profile(frames, pixel_grid_reciprocal, n_q=128, q_range=None,
                 pixel_mask=None):
    """Azimuthally averaged intensity profile I(q) over a frame stack
    """
    idx, centers = radial_bins(pixel_grid_reciprocal, n_q, q_range)
    flat_idx = idx.ravel()
    frames = np.asarray(frames, dtype=np.float64)
    total = frames.sum(axis=0).ravel()
    if pixel_mask is not None:
        m = np.asarray(pixel_mask, dtype=bool).ravel()
        flat_idx = np.where(m, flat_idx, n_q)
    sums = np.bincount(flat_idx, weights=total, minlength=n_q + 1)[:n_q]
    counts = np.bincount(flat_idx, minlength=n_q + 1)[:n_q] * len(frames)
    return np.where(counts > 0, sums / np.maximum(counts, 1), 0.0), centers


def annulus_roi(pixel_grid_reciprocal, q_min, q_max):
    """Boolean pixel mask selecting q ∈ [q_min, q_max]."""
    q = np.asarray(pixel_grid_reciprocal)[..., 0]
    return (q >= q_min) & (q <= q_max)


def azimuthal_roi(pixel_grid_reciprocal, phi_min, phi_max):
    phi = np.mod(np.asarray(pixel_grid_reciprocal)[..., 2], 2 * np.pi)
    phi_min, phi_max = np.mod(phi_min, 2 * np.pi), np.mod(phi_max, 2 * np.pi)
    if phi_min <= phi_max:
        return (phi >= phi_min) & (phi <= phi_max)
    return (phi >= phi_min) | (phi <= phi_max)


def refine_beam_center(mean_frame, pixel_centers, search_radius=2.0e-3,
                       steps=9):
    """Grid-search the transverse beam offset that maximizes the azimuthal
    symmetry of the averaged pattern: minimizes the variance of I within
    radial rings. → (dx, dy) in meters."""
    from xframe_tpu_torch.library.mathtools import ring_symmetry_score
    mean_frame = np.asarray(mean_frame, dtype=np.float64).ravel()
    pos = np.asarray(pixel_centers)[..., :2].reshape(-1, 2)
    offsets = np.linspace(-search_radius, search_radius, steps)
    best = (np.inf, (0.0, 0.0))
    for dx in offsets:
        for dy in offsets:
            r = np.linalg.norm(pos - np.array([dx, dy]), axis=1)
            score = ring_symmetry_score(r, mean_frame, n_bins=64)
            if score < best[0]:
                best = (score, (float(dx), float(dy)))
    return best[1]


# ------------------------------------------------------------ filter pipeline
# Filters compose over chunk dicts
# {'data': (B, …), 'mask': (B, …) pixel validity, 'good': (B,) frame
# validity}; each filter may mask pixels, drop frames, or rescale data.
# They are vectorized numpy over the whole chunk.

class FilterSequence:
    """Apply a list of filters in order."""

    def __init__(self, filters):
        self.filters = list(filters)

    def __call__(self, chunk):
        for f in self.filters:
            chunk = f(chunk)
        return chunk


def _masked_frame_mean(data, mask):
    n = len(data)
    d = data.reshape(n, -1)
    m = mask.reshape(n, -1)
    counts = np.maximum(m.sum(axis=1), 1)
    return (d * m).sum(axis=1) / counts


class ADUFilter:
    """Mask pixels outside [low, high] ADU.

    A bound applies when it is a real number (python OR numpy scalar); None
    and False disable it — the framework-wide no-limit convention."""

    def __init__(self, limits):
        self.low, self.high = limits

    @staticmethod
    def _bound(x):
        return None if x is None or isinstance(x, bool) \
            or not isinstance(x, (int, float, np.integer, np.floating)) \
            else float(x)

    def __call__(self, chunk):
        data, mask = chunk["data"], chunk["mask"]
        ok = np.ones_like(mask)
        low, high = self._bound(self.low), self._bound(self.high)
        if low is not None:
            ok &= data >= low
        if high is not None:
            ok &= data <= high
        chunk["mask"] = mask & ok
        return chunk


class NormalizationFilter:
    """Divide each frame by its masked (ROI-)mean intensity; not counted as
    a frame modification."""

    def __init__(self, roi_mask=None):
        self.roi_mask = roi_mask

    def __call__(self, chunk):
        data, mask = chunk["data"], chunk["mask"]
        m = mask if self.roi_mask is None \
            else mask & np.asarray(self.roi_mask, dtype=bool)[None]
        scale = _masked_frame_mean(data, m)
        scale = np.where((scale == 0) | ~np.isfinite(scale), 1.0, scale)
        chunk["data"] = data / scale.reshape((-1,) + (1,) * (data.ndim - 1))
        return chunk


class MetricFilter:
    """Drop frames whose masked metric falls outside [low, high]. metric:
    'mean' | 'median' | 'std' | 'sum' or a callable taking the masked
    per-frame values."""

    _metrics = {"mean": np.mean, "median": np.median, "std": np.std,
                "sum": np.sum}

    def __init__(self, metric, limits):
        self.metric = self._metrics[metric] if isinstance(metric, str) \
            else metric
        self.low, self.high = limits

    def __call__(self, chunk):
        data, mask = chunk["data"], chunk["mask"]
        vals = np.zeros(len(data))
        for i in range(len(data)):
            v = data[i][mask[i]]
            vals[i] = self.metric(v) if v.size else 0.0
        ok = np.ones(len(data), dtype=bool)
        if self.low is not None:
            ok &= vals >= self.low
        if self.high is not None:
            ok &= vals <= self.high
        chunk["good"] = chunk["good"] & ok
        return chunk


class LitPixelsFilter(MetricFilter):
    """Drop frames by lit-pixel fraction."""

    def __init__(self, lit_threshold, limits):
        thr = float(lit_threshold)
        super().__init__(lambda v: (v > thr).mean(), limits)


class BraggFilter:
    """Per-radial-bin outlier masking: pixels beyond mean + max_sigma·std of
    their q-ring are masked ('mask' mode, zeroed with fill_value) or their
    frames dropped ('discard') / kept exclusively ('select'), vectorized
    over the chunk via bincount ring stats."""

    def __init__(self, radial_bin_index, n_bins, max_sigma=5.0, mode="mask",
                 fill_value=0.0):
        self.bins = np.asarray(radial_bin_index)      # (…pixels), n_bins=trash
        self.n_bins = int(n_bins)
        self.max_sigma = float(max_sigma)
        self.mode = str(mode)
        self.fill_value = float(fill_value)

    def __call__(self, chunk):
        data, mask = chunk["data"], chunk["mask"]
        n = len(data)
        flat_bins = self.bins.ravel()
        d = data.reshape(n, -1)
        m = mask.reshape(n, -1)
        nb = self.n_bins + 1
        bragg = np.zeros_like(d, dtype=bool)
        for i in range(n):
            w = np.where(m[i], d[i], 0.0)
            counts = np.maximum(np.bincount(flat_bins, weights=m[i].astype(float),
                                            minlength=nb)[: self.n_bins], 1)
            s1 = np.bincount(flat_bins, weights=w, minlength=nb)[: self.n_bins]
            s2 = np.bincount(flat_bins, weights=w * w,
                             minlength=nb)[: self.n_bins]
            mean = s1 / counts
            std = np.sqrt(np.maximum(s2 / counts - mean ** 2, 0.0))
            thr = (mean + self.max_sigma * std)[
                np.clip(flat_bins, 0, self.n_bins - 1)]
            valid_bin = flat_bins < self.n_bins
            bragg[i] = m[i] & valid_bin & (np.abs(d[i]) > thr)
        bragg = bragg.reshape(data.shape)
        has_bragg = bragg.reshape(n, -1).any(axis=1)
        if self.mode == "mask":
            chunk["data"] = np.where(bragg, self.fill_value, data)
            chunk["mask"] = mask & ~bragg
        elif self.mode == "discard":
            chunk["good"] = chunk["good"] & ~has_bragg
        elif self.mode == "select":
            chunk["good"] = chunk["good"] & has_bragg
        else:
            raise ValueError(f"unknown BraggFilter mode {self.mode!r}")
        return chunk
