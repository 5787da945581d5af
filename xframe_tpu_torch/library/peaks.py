"""Persistence-based peak detection (persistent homology of super-level
sets).

A numpy copy of `xframe_tpu.library.peaks` (tests/test_torch_peaks.py holds
the two to the same peaks): local maxima of a 1D sequence or a 2D image are
ranked by persistence, the height between a peak's summit and the saddle
where its component merges into an older, taller one; the global maximum
never dies (persistence inf). An array-based union-find with path halving
and the elder rule (on a merge the component with the taller summit
absorbs the younger one), over one descending argsort of the samples. A
sequential host algorithm for detector diagnostics, not a device op.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class _UnionFind:
    """Array-based disjoint sets over integers 0..n-1 with path halving.

    ``root_birth[r]`` tracks, for each current root r, the processing rank of
    the component's summit (smaller rank = taller summit = elder component).
    """

    __slots__ = ("parent", "birth_rank")

    def __init__(self, n: int):
        self.parent = np.full(n, -1, dtype=np.int64)  # -1 = not yet added
        self.birth_rank = np.full(n, -1, dtype=np.int64)

    def add(self, i: int, rank: int) -> None:
        self.parent[i] = i
        self.birth_rank[i] = rank

    def __contains__(self, i: int) -> bool:
        return self.parent[i] >= 0

    def find(self, i: int) -> int:
        p = self.parent
        while p[i] != i:
            p[i] = p[p[i]]  # path halving
            i = p[i]
        return int(i)

    def union_elder(self, a: int, b: int) -> int:
        """Merge the components of roots a, b; the elder root wins. Returns
        the root of the component that DIED (the younger), or -1 if a == b."""
        if a == b:
            return -1
        if self.birth_rank[a] <= self.birth_rank[b]:
            self.parent[b] = a
            return b
        self.parent[a] = b
        return a


@dataclass
class Peak1D:
    """One persistence pair of a 1D sequence.

    born/died are sample indices (died is None for the immortal global max);
    left/right delimit the peak's region when it died (inclusive)."""
    born: int
    left: int
    right: int
    died: int | None = None

    def persistence(self, seq) -> float:
        if self.died is None:
            return float("inf")
        return float(seq[self.born] - seq[self.died])


def find_peaks_1d(seq) -> list[Peak1D]:
    """All local maxima of ``seq`` ranked by persistence (descending).

    Sweep values high→low, grow intervals, and on an interval merge kill
    the younger (lower-summit) peak at the current sample.
    """
    seq = np.asarray(seq)
    n = seq.shape[0]
    if n == 0:
        return []
    order = np.argsort(seq, kind="stable")[::-1]
    peaks: list[Peak1D] = []
    owner = np.full(n, -1, dtype=np.int64)  # sample index -> peak id

    for idx in order:
        idx = int(idx)
        li = owner[idx - 1] if idx > 0 else -1
        ri = owner[idx + 1] if idx < n - 1 else -1
        if li < 0 and ri < 0:  # isolated: a new peak is born
            owner[idx] = len(peaks)
            peaks.append(Peak1D(born=idx, left=idx, right=idx))
        elif li >= 0 and ri < 0:  # extend the left peak rightwards
            peaks[li].right = idx
            owner[idx] = li
        elif li < 0 and ri >= 0:  # extend the right peak leftwards
            peaks[ri].left = idx
            owner[idx] = ri
        else:  # saddle: the younger of the two peaks dies here
            elder, younger = (li, ri) if seq[peaks[li].born] >= seq[peaks[ri].born] \
                else (ri, li)
            peaks[younger].died = idx
            peaks[elder].left = min(peaks[elder].left, peaks[younger].left)
            peaks[elder].right = max(peaks[elder].right, peaks[younger].right)
            owner[peaks[elder].left] = owner[peaks[elder].right] = elder
            owner[idx] = elder

    peaks.sort(key=lambda p: p.persistence(seq), reverse=True)
    return peaks


@dataclass
class Peak2D:
    """One persistence pair of a 2D image: born at pixel ``born`` with value
    ``birth_value``; merged into an elder component at saddle pixel ``saddle``
    (None for the immortal global max)."""
    born: tuple[int, int]
    birth_value: float
    persistence: float
    saddle: tuple[int, int] | None = None


def _neighbor_offsets_2d(shape, periodic: bool):
    """Flat-index 4-neighborhoods for every pixel: (n_pix, 4) int array with
    -1 marking out-of-bounds neighbors (non-periodic edges)."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    y = yy.ravel()
    x = xx.ravel()
    nbrs = np.empty((h * w, 4), dtype=np.int64)
    for k, (dy, dx) in enumerate(((-1, 0), (1, 0), (0, -1), (0, 1))):
        ny, nx = y + dy, x + dx
        if periodic:
            ny %= h
            nx %= w
            valid = np.ones(h * w, dtype=bool)
        else:
            valid = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        flat = np.where(valid, ny * w + nx, -1)
        nbrs[:, k] = flat
    return nbrs


def find_peaks_2d(image, periodic: bool = False) -> list[Peak2D]:
    """All local maxima of a 2D image ranked by persistence (descending).

    Sweep pixels high→low over the 4-neighborhood (optionally periodic in
    both axes), union-find the super-level components, and record a
    (birth, saddle) pair whenever a younger component merges into an elder
    one. Returned persistence is
    birth_value − saddle_value; the global max has persistence inf.
    """
    im = np.asarray(image)
    h, w = im.shape
    flat = im.ravel()
    order = np.argsort(flat, kind="stable")[::-1]
    nbrs = _neighbor_offsets_2d((h, w), periodic)
    uf = _UnionFind(h * w)

    # under the elder rule a component's root is always its summit pixel,
    # so peaks can be addressed by flat summit index
    peak_at: dict[int, Peak2D] = {}
    for rank, p in enumerate(order):
        p = int(p)
        v = float(flat[p])
        # roots of already-processed neighbor components
        roots = {uf.find(int(q)) for q in nbrs[p] if q >= 0 and q in uf}
        uf.add(p, rank)
        if not roots:
            # a fresh local maximum is born at p
            peak_at[p] = Peak2D(born=(p // w, p % w), birth_value=v,
                                persistence=np.inf)
            continue
        # attach p to the eldest neighboring component, then merge the rest;
        # every younger component that merges here dies at saddle p
        by_age = sorted(roots, key=lambda r: uf.birth_rank[r])
        uf.union_elder(by_age[0], p)
        for r in by_age[1:]:
            peak = peak_at[r]
            peak.persistence = peak.birth_value - v
            peak.saddle = (p // w, p % w)
            uf.union_elder(by_age[0], r)

    results = sorted(peak_at.values(), key=lambda g: g.persistence,
                     reverse=True)
    return results


class PeakDetector:
    """Peak detection by dimension: find_peaks(1 or 2, data)."""

    @staticmethod
    def find_peaks(dim: int, data, periodic: bool = False):
        if dim == 1:
            return find_peaks_1d(data)
        if dim == 2:
            return find_peaks_2d(data, periodic=periodic)
        raise ValueError(f"peak detection supports dim 1 or 2, got {dim}")
