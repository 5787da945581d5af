"""The correlate worker: detector frames → angular cross-correlation
C(q1,q2,Δ).

Port of `xframe_tpu.projects.fxs.correlate`. Frames stream from raw files
through the C++ reader (`xframe_tpu_torch/native/`, into pinned host
buffers on the card, the next batch read while the current one
correlates) and through one batch function on the worker's device:
validity (finite values, the static mask, thresholds on raw values) →
background subtraction → the polar regrid of the frames and of their
validity → the radial pixel filter → rejection of fully masked frames →
ROI normalization and the mean-bounds filter → the corrections → the rfft
of polar·good and of pmask·good over φ → Σ_frames f̂(q1)* f̂(q2), one
batched complex GEMM over the harmonics for the CCF and one for the mask
CCF, accumulated in place in complex64 with the WAXS sums and counts.
After the last batch, on the device: the mask-CCF normalization (ccm >
0.5), the optional symmetrization and the fc_n_max low-pass, all in
float32 as the JAX worker computes them under numpy 2; then one read back.

The regrid is an explicit gather in pixel coordinates: the host builds,
once, the flat pixel indices and float32 weights of every polar sample
(`regrid_table`), with JAX's map_coordinates arithmetic — order 1 floors
and weights (1 − t, t) per axis, order 0 rounds half away from zero, and
a neighbour outside the frame reads a zero sentinel (cval 0). The median
of the `median_mad` filter averages the two middle values of an even
count, as jnp.nanmedian does (torch.nanmedian returns the lower one).

`PanelCorrelator` bins a multi-panel detector's pixels (e.g. the AGIPD
geometry of `experiments/SPB/detectors/agipd.py`) onto the polar grid by a
padded gather table and a deterministic sum. With `input.source:
experiment` the worker streams the calibrated frames of an SPB run folder
(`experiments/SPB/experiment.py`, settings block `experiment`) through it.
The run folder, and `.h5` background and mask files, are HDF5: where h5py
is not installed they stop with an error that names it before any frame
is read.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from xframe_tpu_torch.library.physics import \
    scattering_angle_to_reciprocal_radii
from xframe_tpu_torch.settings import home_dir

GATHER_BYTES = 1 << 30   # PanelCorrelator: gathered pixels per sub-batch


def _low_pass_cc(cc, fc_n_max):
    """Zero the CC harmonics (last axis) above fc_n_max."""
    if not fc_n_max or fc_n_max >= cc.shape[-1] // 2:
        return cc
    f = torch.fft.rfft(cc, dim=-1)
    f[..., int(fc_n_max) + 1:] = 0
    return torch.fft.irfft(f, cc.shape[-1], dim=-1)


def symmetrize_cc(cc, phis):
    """Flat-Ewald CC symmetrization: the noisy Δ∈[0,π/2) and Δ∈(3π/2,2π]
    ranges are replaced by the values shifted by π from the interior."""
    phis = np.asarray(phis)
    pos_pi2 = int(np.abs(phis - np.pi / 2).argmin())
    pos_pi = int(np.abs(phis - np.pi).argmin())
    pos_3pi2 = int(np.abs(phis - 3 * np.pi / 2).argmin())
    n = cc.shape[-1]
    out = cc.clone()
    out[..., :pos_pi2] = cc[..., pos_pi:pos_pi + pos_pi2]
    out[..., pos_3pi2 + 1:] = cc[..., pos_3pi2 + 1 - pos_pi:n - pos_pi]
    return out


def refine_detector_origin(mean_frame, origin0, search_radius_pix=3.0,
                           steps=7, n_bins=64):
    """Grid-search the beam center that maximizes the azimuthal symmetry of
    the averaged pattern (host numpy). Degenerate candidates score +inf; an
    all-degenerate search returns origin0. → refined (oy, ox) pixels."""
    from xframe_tpu_torch.library.mathtools import ring_symmetry_score
    frame = np.asarray(mean_frame, dtype=np.float64)
    ny, nx = frame.shape
    yy, xx = np.mgrid[0:ny, 0:nx]
    offsets = np.linspace(-search_radius_pix, search_radius_pix, int(steps))
    weights = frame.ravel()
    best = (np.inf, tuple(float(v) for v in origin0))
    for dy in offsets:
        for dx in offsets:
            oy, ox = origin0[0] + dy, origin0[1] + dx
            r = np.hypot(yy - oy, xx - ox)
            r_max = min(oy, ox, ny - 1 - oy, nx - 1 - ox)
            score = ring_symmetry_score(r, weights, n_bins, r_max=r_max)
            if score < best[0]:
                best = (score, (float(oy), float(ox)))
    return best[1]


def _split_batch_item(item):
    """(batch, good) from a frame-stream item: plain batches get an all-good
    mask; (batch, ok) pairs (the reader's flags) pass their mask through."""
    if isinstance(item, tuple):
        batch, good = item
        return (np.asarray(batch, dtype=np.float32),
                np.asarray(good, dtype=np.float32))
    batch = np.asarray(item, dtype=np.float32)
    return batch, np.ones(len(batch), dtype=np.float32)


def _round_half_away(x):
    """Round to the nearest integer, halves away from zero (lax.round)."""
    r = np.trunc(x)
    return r + np.sign(x) * (np.abs(x - r) >= 0.5)


def regrid_table(coords, image_shape, order):
    """Gather table of map_coordinates(frame, coords, order, cval=0) on a
    (ny, nx) frame flattened with one zero appended: → (indices (K, n)
    int64, weights (K, n) float32), K = 4 neighbours for order 1 in the
    order (y_lo, x_lo), (y_lo, x_hi), (y_hi, x_lo), (y_hi, x_hi), K = 1
    for order 0; a neighbour outside the frame points at the zero at
    ny·nx. coords: float32 (2, ...) pixel coordinates."""
    ny, nx = image_shape
    cy, cx = (np.asarray(c, dtype=np.float32).ravel() for c in coords)
    if order == 0:
        axes = [[(_round_half_away(c).astype(np.int64), np.float32(1))]
                for c in (cy, cx)]
    elif order == 1:
        axes = []
        for c in (cy, cx):
            lower = np.floor(c)
            upper_w = c - lower
            lo = lower.astype(np.int64)
            axes.append([(lo, np.float32(1) - upper_w), (lo + 1, upper_w)])
    else:
        raise ValueError(f"interpolation_order {order}: 0 or 1")
    idx, wts = [], []
    for (iy, wy) in axes[0]:
        for (ix, wx) in axes[1]:
            inside = (iy >= 0) & (iy < ny) & (ix >= 0) & (ix < nx)
            idx.append(np.where(inside, iy * nx + ix, ny * nx))
            wts.append(np.broadcast_to(np.float32(wy * wx), cy.shape))
    return np.stack(idx), np.stack(wts)


def _nanmedian(x, keep):
    """Median over the last axis of x where `keep`, averaging the two
    middle values of an even count (jnp.nanmedian); NaN where none."""
    a = torch.where(keep, x, torch.full_like(x, float("nan")))
    a = torch.sort(a, dim=-1).values
    counts = keep.sum(dim=-1, keepdim=True).to(x.dtype)
    q = 0.5 * (counts - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    top = counts - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top))
    lo_v = torch.gather(a, -1, low.long())
    hi_v = torch.gather(a, -1, high.long())
    return lo_v * low_w + hi_v * high_w


class _Accumulator:
    """In-place sums across batches on the device: the CCF and mask CCF per
    harmonic (n_h, n1, n2) complex64, the WAXS sum and count (n_q, n_φ),
    the good-frame count."""

    def __init__(self, shape_cc, shape_polar, with_ccf, device):
        self.cc_f = self.cc_m = None
        if with_ccf:
            self.cc_f = torch.zeros(shape_cc, dtype=torch.complex64,
                                    device=device)
            self.cc_m = torch.zeros_like(self.cc_f)
        self.waxs = torch.zeros(shape_polar, dtype=torch.float32,
                                device=device)
        self.count = torch.zeros_like(self.waxs)
        self.n_good = torch.zeros((), dtype=torch.float32, device=device)

    @staticmethod
    def outer(acc, f1, f2):
        """acc[n] += f1[:, :, n]† f2[:, :, n]: Σ_b f̂1(q1)* f̂2(q2) per
        harmonic n as one batched GEMM."""
        acc.baddbmm_(f1.permute(2, 1, 0).conj(), f2.permute(2, 0, 1))

    def add(self, polar, pmask, good, q1_pos=None, q2_pos=None):
        """One batch: polar (B, n_q, n_φ) corrected and masked, pmask the
        same 0/1 as float32, good (B,) 0/1."""
        g = good[:, None, None]
        if self.cc_f is not None:
            f = torch.fft.rfft(polar * g, dim=-1)
            m = torch.fft.rfft(pmask * g, dim=-1)
            if q1_pos is None:
                self.outer(self.cc_f, f, f)
                self.outer(self.cc_m, m, m)
            else:
                self.outer(self.cc_f, f[:, q1_pos], f[:, q2_pos])
                self.outer(self.cc_m, m[:, q1_pos], m[:, q2_pos])
        self.waxs += (polar * g).sum(dim=0)
        self.count += (pmask * g).sum(dim=0)
        self.n_good += good.sum()

    def finish(self, n_phi, symmetrize_phis=None, fc_n_max=None):
        """→ (CC (n1, n2, n_φ) float32 on the device or None, WAXS sum,
        count, good count): the mask-CCF normalization, the optional
        symmetrization and low-pass."""
        cc = None
        if self.cc_f is not None:
            ccf = torch.fft.irfft(self.cc_f.permute(1, 2, 0), n_phi, dim=-1)
            ccm = torch.fft.irfft(self.cc_m.permute(1, 2, 0), n_phi, dim=-1)
            self.cc_f = self.cc_m = None
            ok = ccm > 0.5
            cc = torch.where(ok, ccf / torch.where(ok, ccm, 1.0), 0.0)
            del ccf, ccm, ok
            if symmetrize_phis is not None:
                cc = symmetrize_cc(cc, symmetrize_phis)
            cc = _low_pass_cc(cc, fc_n_max)
        return cc, self.waxs, self.count, self.n_good


def _stream(frame_iter, is_good, device, process):
    """Feed every batch of frame_iter through `process(frames, good)` on
    `device`. Host frames go up with non_blocking copies (async from pinned
    buffers); before the next batch is asked for, the copy is waited for,
    so the reader may reuse its buffer. → timing: frames seen, seconds
    waiting for the reader and in the host's good-frame filter, and on the
    card the device seconds of the batches (CUDA events around each)."""
    cuda = device.type == "cuda"
    n_frames, read_s, filter_s, events = 0, 0.0, 0.0, []
    it = iter(frame_iter)
    while True:
        t0 = time.perf_counter()
        item = next(it, None)
        read_s += time.perf_counter() - t0
        if item is None:
            break
        t0 = time.perf_counter()
        batch, good = _split_batch_item(item)
        if is_good is not None:
            good = good * np.asarray(is_good(batch), dtype=np.float32)
        filter_s += time.perf_counter() - t0
        n_frames += len(batch)
        if not len(batch):
            continue
        frames = torch.from_numpy(batch).to(device, non_blocking=True)
        if cuda:
            copied = torch.cuda.Event()
            copied.record()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        process(frames, torch.from_numpy(good).to(device, non_blocking=True))
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events.append((start, end))
            copied.synchronize()
    if n_frames == 0:
        raise ValueError("correlate: the frame stream is empty")
    timing = dict(frames=n_frames, read_wait_s=read_s,
                  host_filter_s=filter_s)
    if cuda:
        torch.cuda.synchronize(device)
        timing["device_batches_s"] = sum(a.elapsed_time(b)
                                         for a, b in events) / 1e3
    return timing


def _results(cc, waxs, count, n_good):
    """Host results: the CC, the average intensity per ring (numpy float32,
    the JAX worker's arithmetic), the good-frame count."""
    waxs, count = waxs.cpu().numpy(), count.cpu().numpy()
    avg = np.where(count > 0, waxs / np.maximum(count, 1), 0.0)
    return {"cross_correlation": None if cc is None else cc.cpu().numpy(),
            "average_intensity": avg.mean(axis=-1),
            "num_images_good": int(n_good.item())}


class Correlator:
    """Batch correlator closed over a single-panel detector geometry; its
    tables live on `device`.

    The options are the JAX Correlator's: qrange=(q_min, q_max, q_step)
    [Å⁻¹] or a uniform pixel-radius grid of n_q rings; qrange_xcca=((q1_min,
    q1_max, idx_step), (q2_min, q2_max, idx_step)) restricts the CCF to
    ring subsets; phi_range=(φ_min, φ_max) and phi_sampling_mode
    'max'|'min' (cap or floor n_phi at the 1-pixel circumference sampling
    at q_max); roi_q_range, roi_normalize, roi_mean_bounds;
    radial_pixel_filter=('average_sigma'|'median_mad', n_sigma);
    symmetrize; background and static_mask per-pixel frames; fc_n_max;
    with_ccf=False (WAXS and good counts only); polarization (True/'v',
    'h') and solid_angle corrections; interpolation_order 0 or 1."""

    def __init__(self, image_shape, detector_origin, pixel_size_um,
                 sample_distance_mm, wavelength, n_phi=1024, n_q=None,
                 interpolation_order=1, mask_below=None, mask_above=None,
                 polarization=False, solid_angle=False, background=None,
                 fc_n_max=None, with_ccf=True, qrange=None, qrange_xcca=None,
                 phi_range=None, phi_sampling_mode=None, roi_q_range=None,
                 roi_normalize=False, roi_mean_bounds=None,
                 radial_pixel_filter=None, symmetrize=False,
                 static_mask=None, device="cuda"):
        from xframe_tpu_torch.projects.fxs.reconstruct import device_of
        self.device = dev = device_of(device)
        ny, nx = self.image_shape = tuple(int(n) for n in image_shape)
        oy, ox = float(detector_origin[0]), float(detector_origin[1])
        r_max_pix = min(oy, ox, ny - 1 - oy, nx - 1 - ox)
        dist_pix = sample_distance_mm * 1000.0 / pixel_size_um
        self.wavelength = wavelength

        if qrange is not None:
            # q rings map to pixel radii via r = tan(2θ)·D
            q_min, q_max, q_step = [float(v) for v in qrange]
            self.n_q = int((q_max - q_min) / q_step + 1)
            self.qs = np.arange(self.n_q) * q_step + q_min
            angles = 2.0 * np.arcsin(self.qs * wavelength / (4 * np.pi))
            r_pix = np.tan(angles) * dist_pix
        else:
            if n_q is None or n_q <= 0:
                n_q = int(r_max_pix)
            self.n_q = int(n_q)
            r_pix = (np.arange(self.n_q) + 0.5) * r_max_pix / self.n_q
            angles = np.arctan(r_pix / dist_pix)
            self.qs = scattering_angle_to_reciprocal_radii(angles, wavelength)
        self.order = int(interpolation_order)

        phi_min, phi_max = (0.0, 2 * np.pi) if phi_range is None \
            else (float(phi_range[0]), float(phi_range[1]))
        n_phi = int(n_phi)
        if phi_sampling_mode in ("max", "min"):
            maxpix = int(round(2 * np.pi * float(r_pix[-1])))
            maxpix += maxpix % 2
            n_phi = min(maxpix, n_phi) if phi_sampling_mode == "max" \
                else max(maxpix, n_phi)
        self.n_phi = n_phi
        self.phis = phis = phi_min + (phi_max - phi_min) \
            * np.arange(n_phi) / n_phi

        yy = oy + r_pix[:, None] * np.sin(phis)[None, :]
        xx = ox + r_pix[:, None] * np.cos(phis)[None, :]
        self._coords = np.stack([yy, xx]).astype(np.float32)

        corr = np.ones((self.n_q, self.n_phi))
        if solid_angle:
            corr *= 1.0 / np.cos(angles)[:, None] ** 3
        if polarization:
            # 1/(cos²2θ + sin²2θ·trig²φ): sin for vertical, cos for
            # horizontal polarization
            trig = np.cos if str(polarization) == "h" else np.sin
            corr /= np.maximum(
                np.cos(angles)[:, None] ** 2
                + (np.sin(angles)[:, None] * trig(phis)[None, :]) ** 2, 1e-3)
        self._corrections = corr.astype(np.float32)
        self.mask_below = mask_below
        self.mask_above = mask_above
        self._background = None if background is None else \
            np.asarray(background, dtype=np.float32)
        self._static_mask = None if static_mask is None else \
            np.asarray(static_mask) > 0.5
        self.fc_n_max = None if not fc_n_max else int(fc_n_max)
        self.with_ccf = bool(with_ccf)
        self.symmetrize = bool(symmetrize)

        if qrange_xcca is not None:
            (a_lo, a_hi, a_st), (b_lo, b_hi, b_st) = qrange_xcca
            p1 = int(np.abs(self.qs - float(a_lo)).argmin())
            p2 = int(np.abs(self.qs - float(a_hi)).argmin())
            self.q1_pos = np.arange(p1, p2 + 1, int(a_st))
            p1 = int(np.abs(self.qs - float(b_lo)).argmin())
            p2 = int(np.abs(self.qs - float(b_hi)).argmin())
            self.q2_pos = np.arange(p1, p2 + 1, int(b_st))
        else:
            self.q1_pos = self.q2_pos = np.arange(self.n_q)

        self._roi = None
        if roi_q_range is not None:
            lo = int(np.abs(self.qs - float(roi_q_range[0])).argmin())
            hi = int(np.abs(self.qs - float(roi_q_range[1])).argmin())
            self._roi = (lo, max(hi, lo + 1))
        self.roi_normalize = bool(roi_normalize)
        self.roi_mean_bounds = None if roi_mean_bounds is None else \
            (float(roi_mean_bounds[0]), float(roi_mean_bounds[1]))
        self.radial_pixel_filter = None if radial_pixel_filter is None else \
            (str(radial_pixel_filter[0]), float(radial_pixel_filter[1]))

        idx, wts = regrid_table(self._coords, (ny, nx), self.order)
        self._idx = torch.as_tensor(idx.ravel(), device=dev)
        self._w = torch.as_tensor(wts.reshape(len(wts), self.n_q, n_phi),
                                  device=dev)
        self._corr_t = torch.as_tensor(self._corrections, device=dev)
        self._bg_t = None if self._background is None else \
            torch.as_tensor(self._background, device=dev)
        self._static_t = None if self._static_mask is None else \
            torch.as_tensor(self._static_mask, device=dev)
        full = len(self.q1_pos) == len(self.q2_pos) == self.n_q
        self._pos = None if full else (
            torch.as_tensor(self.q1_pos, device=dev),
            torch.as_tensor(self.q2_pos, device=dev))

    # -------------------------------------------------------------- device
    def _regrid(self, frames):
        """(B, ny, nx) → (B, n_q, n_φ) by the gather table: Σ_k w_k·v_k in
        the neighbours' order."""
        B = frames.shape[0]
        flat = torch.cat([frames.reshape(B, -1),
                          frames.new_zeros((B, 1))], dim=1)
        got = flat[:, self._idx].reshape((B,) + tuple(self._w.shape))
        out = got[:, 0] * self._w[0]
        for k in range(1, self._w.shape[0]):
            out = out + got[:, k] * self._w[k]
        return out

    def polar_batch(self, frames, good):
        """frames (B, ny, nx) float32, good (B,) float32 0/1, on the device
        → (polar (B, n_q, n_φ) corrected and masked, pmask 0/1 float32,
        good): the JAX worker's per-frame steps in its order."""
        valid = torch.isfinite(frames)
        if self._static_t is not None:
            valid &= self._static_t[None]
        if self.mask_below is not None:
            valid &= frames > self.mask_below
        if self.mask_above is not None:
            valid &= frames < self.mask_above
        if self._bg_t is not None:
            frames = frames - self._bg_t
        frames = torch.where(valid, frames, 0.0)

        polar = self._regrid(frames)
        pmask = self._regrid(valid.to(torch.float32)) > 0.99
        polar = polar * pmask

        if self.radial_pixel_filter is not None:
            mode, n_sig = self.radial_pixel_filter
            mf = pmask.to(polar.dtype)
            if mode == "median_mad":
                center = _nanmedian(polar, pmask)
                spread = _nanmedian((polar - center).abs(), pmask)
            else:  # 'average_sigma'
                cnt = torch.clamp(mf.sum(dim=-1, keepdim=True), min=1.0)
                center = (polar * mf).sum(dim=-1, keepdim=True) / cnt
                var = (((polar - center) * mf) ** 2).sum(
                    dim=-1, keepdim=True) / cnt
                spread = torch.sqrt(var)
            keep = (polar - center).abs() <= n_sig * spread
            pmask &= torch.where(center.isnan() | spread.isnan(), True, keep)
            polar = polar * pmask

        good = good * (pmask.sum(dim=(1, 2)) > 0)

        if self._roi is not None:
            lo, hi = self._roi
            rm = pmask[:, lo:hi, :].to(polar.dtype)
            roi_cnt = rm.sum(dim=(1, 2))
            roi_mean = (polar[:, lo:hi, :] * rm).sum(dim=(1, 2)) \
                / torch.clamp(roi_cnt, min=1.0)
            if self.roi_mean_bounds is not None:
                lo_v, hi_v = self.roi_mean_bounds
                good = good * ((roi_mean >= lo_v) & (roi_mean <= hi_v))
            if self.roi_normalize:
                # the actual (possibly negative) ROI mean; a frame whose
                # ROI is empty or has a zero mean is flagged bad instead
                ok = (roi_cnt > 0) & (roi_mean != 0)
                good = good * ok
                polar = polar / torch.where(ok, roi_mean, 1.0)[:, None, None]

        polar = polar * self._corr_t * pmask
        return polar, pmask.to(torch.float32), good

    # ------------------------------------------------------------ streaming
    def pinned_buffers(self, batch_size):
        """Two pinned host batches for the reader on the card (numpy views;
        each keeps its tensor alive), or None on the CPU."""
        if self.device.type != "cuda":
            return None
        return [torch.empty((int(batch_size),) + self.image_shape,
                            dtype=torch.float32, pin_memory=True).numpy()
                for _ in range(2)]

    def correlate_frames(self, frame_iter, batch_size=64, is_good=None):
        """Accumulate the mask-corrected CC over a stream of frames.

        frame_iter yields (B, ny, nx) float32 numpy batches, or (batch, ok)
        pairs (the reader's flags); is_good(batch) filters compose on top
        on the host. → {"cross_correlation" (n1, n2, n_φ) float32 or None,
        "average_intensity" (n_q,) float32, "num_images_good", "timing"}."""
        dev = self.device
        n_h = self.n_phi // 2 + 1
        acc = _Accumulator((n_h, len(self.q1_pos), len(self.q2_pos)),
                           (self.n_q, self.n_phi), self.with_ccf, dev)
        pos = (None, None) if self._pos is None else self._pos

        def process(frames, good):
            acc.add(*self.polar_batch(frames, good), *pos)

        t0 = time.perf_counter()
        timing = _stream(frame_iter, is_good, dev, process)
        timing["loop_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = acc.finish(self.n_phi, self.phis if self.symmetrize else None,
                         self.fc_n_max)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timing["normalize_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = _results(*out)
        timing["readback_s"] = time.perf_counter() - t0
        res["timing"] = timing
        return res


class PanelCorrelator:
    """Multi-panel (lab-frame geometry) correlator: detector pixels are
    binned onto a polar (q, φ) grid by their Ewald scattering coordinates,
    then the mask-corrected FFT cross-correlation runs on the binned
    intensities. The binning is a gather through a padded table (per bin,
    its pixel indices; the padding points at a zero appended to each
    frame), built on the host once, then a sum over each bin's slots —
    deterministic, unlike a scatter with float atomics. A batch is gathered
    in sub-batches of at most GATHER_BYTES."""

    def __init__(self, pixel_grid_reciprocal, n_q=128, n_phi=512,
                 q_range=None, pixel_mask=None, fc_n_max=None,
                 device="cuda"):
        from xframe_tpu_torch.projects.fxs.reconstruct import device_of
        self.device = dev = device_of(device)
        qgrid = np.asarray(pixel_grid_reciprocal)  # (..., 3): (q, θ, φ)
        q = qgrid[..., 0].ravel()
        phi = np.mod(qgrid[..., 2].ravel(), 2 * np.pi)
        if q_range is None:
            q_range = (float(q[q > 0].min()), float(q.max()))
        self.n_q, self.n_phi = int(n_q), int(n_phi)
        self.qs = np.linspace(q_range[0], q_range[1], self.n_q + 1)[:-1] \
            + (q_range[1] - q_range[0]) / (2 * self.n_q)
        self.phis = 2 * np.pi * np.arange(self.n_phi) / self.n_phi

        qi = np.floor((q - q_range[0]) / (q_range[1] - q_range[0])
                      * self.n_q).astype(np.int32)
        pi = np.floor(phi / (2 * np.pi) * self.n_phi).astype(np.int32) \
            % self.n_phi
        valid = (qi >= 0) & (qi < self.n_q)
        if pixel_mask is not None:
            valid &= np.asarray(pixel_mask, dtype=bool).ravel()
        n_bins = self.n_q * self.n_phi
        # invalid pixels go to a trash bin n_q·n_φ
        flat = np.where(valid, qi * self.n_phi + pi, n_bins)
        self._flat_idx = flat.astype(np.int32)
        self._n_bins = n_bins + 1
        counts = np.bincount(flat, minlength=self._n_bins)[:-1]
        self._bin_counts = counts.reshape(self.n_q, self.n_phi)
        self._gather_idx = gather_table(flat, n_bins)
        self._max_count = self._gather_idx.shape[1]
        self.n_pixels = flat.size
        self.fc_n_max = None if not fc_n_max else int(fc_n_max)

        self._gather_t = torch.as_tensor(self._gather_idx.astype(np.int64),
                                         device=dev)
        self._counts_t = torch.as_tensor(
            np.maximum(self._bin_counts, 1).astype(np.float32), device=dev)
        self._pmask_t = torch.as_tensor(
            (self._bin_counts > 0).astype(np.float32), device=dev)

    def gather_bytes(self, batch):
        """Bytes of the gathered tensor of `batch` frames (float32)."""
        return int(batch) * self._gather_idx.size * 4

    def _bin_frames(self, frames):
        """(B, ...) → polar sums (B, n_q, n_φ)."""
        B = frames.shape[0]
        flat = torch.cat([frames.reshape(B, -1),
                          frames.new_zeros((B, 1))], dim=1)
        step = max(1, GATHER_BYTES // max(self.gather_bytes(1), 1))
        sums = [flat[i: i + step][:, self._gather_t].sum(dim=-1)
                for i in range(0, B, step)]
        return torch.cat(sums).reshape(B, self.n_q, self.n_phi)

    def polar_batch(self, frames, good):
        """→ (polar (B, n_q, n_φ) bin means, pmask broadcast, good)."""
        polar = self._bin_frames(frames) / self._counts_t * self._pmask_t
        return polar, self._pmask_t.expand(polar.shape), good

    def correlate_frames(self, frame_iter, is_good=None):
        """As Correlator.correlate_frames, on the binned intensities."""
        dev = self.device
        n_h = self.n_phi // 2 + 1
        acc = _Accumulator((n_h, self.n_q, self.n_q),
                           (self.n_q, self.n_phi), True, dev)

        def process(frames, good):
            acc.add(*self.polar_batch(frames, good))

        t0 = time.perf_counter()
        timing = _stream(frame_iter, is_good, dev, process)
        timing["loop_s"] = time.perf_counter() - t0
        res = _results(*acc.finish(self.n_phi, None, self.fc_n_max))
        res["timing"] = timing
        return res


def gather_table(flat, n_bins):
    """Per polar bin b < n_bins, the indices of the pixels with flat[p] ==
    b in ascending order, padded with len(flat) (the zero slot). → int32
    (n_bins, max count)."""
    order = np.argsort(flat, kind="stable")
    sorted_bins = flat[order]
    starts = np.searchsorted(sorted_bins, np.arange(n_bins + 1))
    ends = np.searchsorted(sorted_bins, np.arange(n_bins + 1) + 1)
    max_count = int(np.max(ends[:-1] - starts[:-1])) if n_bins else 1
    n_px = flat.size
    table = np.full((n_bins, max_count), n_px, dtype=np.int32)
    inside = sorted_bins < n_bins
    rank = np.arange(n_px) - starts[sorted_bins]
    table[sorted_bins[inside], rank[inside]] = order[inside]
    return table


class ProjectWorker:
    """correlate: raw detector frames (a list file in an input folder), or
    an SPB run folder under input.source: experiment, → a ccd archive.
    After `run` the worker keeps the archive's (path, run) (`saved`)."""

    def __init__(self, settings: dict, device="cuda"):
        from xframe_tpu_torch.projects.fxs.reconstruct import device_of
        from xframe_tpu_torch.projects.fxs.store import ProjectStore
        self.settings = settings
        self.device = device_of(device)
        self.store = ProjectStore(settings.get("structure_name", "default"),
                                  settings)

    def run(self):
        """Correlate and archive. → the ccd dict (the JAX worker's keys)
        with its "timing" (setup, the loop and its parts, normalization,
        save seconds; frames), which the archive does not hold."""
        if str(self.settings.get("input", {}).get("source", "files")) \
                == "experiment":
            return self._run_experiment()
        return self._run_files()

    def _run_experiment(self):
        """The facility path: calibrated AGIPD frames of the SPB run folder
        experiment.run_folder, binned by the geometry (nominal, or
        experiment.geometry_file at experiment.detector_distance) through
        PanelCorrelator on the worker's device."""
        from xframe_tpu_torch.experiments.SPB.experiment import (
            DataSelection, ExperimentWorker, Filters)
        opt = self.settings
        eopt = opt.get("experiment", {})
        t_setup = time.perf_counter()
        exp = ExperimentWorker(
            str(eopt["run_folder"]),
            geometry_file=eopt.get("geometry_file") or None,
            detector_distance=float(eopt.get("detector_distance", 0.217)),
            wavelength=float(opt["wavelength"]),
            filters=Filters(lit_pixel_fraction_min=float(
                opt.get("filters", {}).get("lit_pixel_fraction_min", 0)
                or 0)))
        mods = tuple(sorted(exp._module_files))  # the run's modules
        grid = opt["polar_grid"]
        corr = PanelCorrelator(
            exp.get_pixel_grid_reciprocal()[list(mods)],
            n_q=int(grid.get("n_q", 0) or 128), n_phi=int(grid["n_phi"]),
            fc_n_max=int(opt.get("fc_n_max", 0) or 0) or None,
            device=self.device)
        n_max = opt.get("max_n_patterns", "all")
        stop = None if (isinstance(n_max, str) and n_max == "all") \
            else int(n_max)
        sel = DataSelection(frame_range=(0, stop), modules=mods,
                            batch_size=int(opt.get("batch_size", 32)))
        setup_s = time.perf_counter() - t_setup
        out = corr.correlate_frames(
            (c["data"], c["good"]) for c in exp.get_data(sel))
        data = {
            "dimensions": 3,
            "radial_points": corr.qs,
            "angular_points": corr.phis,
            "xray_wavelength": float(opt["wavelength"]),
            "average_intensity": out["average_intensity"],
            "cross_correlation": {"I1I1": out["cross_correlation"]},
            "num_images_processed": exp.n_frames() if stop is None
            else stop,
            "num_images_good": out["num_images_good"],
        }
        t0 = time.perf_counter()
        self.saved = self.store.save("ccd", data)
        data["timing"] = dict(out["timing"], setup_s=setup_s,
                              save_s=time.perf_counter() - t0)
        print(f"correlate(experiment): saved to {self.saved[0]}")
        return data

    def _run_files(self):
        from xframe_tpu_torch.native import PrefetchingFrameLoader
        opt = self.settings
        t_setup = time.perf_counter()
        ny, nx = [int(v) for v in opt["image_dimensions"]]
        fopt = opt.get("filters", {})
        compute = [str(c) for c in opt.get("compute",
                                           ["is_good", "waxs_aver",
                                            "ccf_q1q2"])]
        with_ccf = any(c.startswith("ccf") for c in compute)
        background = self._load_background(fopt.get("background_file"),
                                           (ny, nx))
        static_mask = self._load_background(fopt.get("mask_file"), (ny, nx))
        paths = self._frame_paths()
        n_max = opt.get("max_n_patterns", "all")
        if not (isinstance(n_max, str) and n_max == "all"):
            paths = paths[: int(n_max)]
        dtype = np.dtype(str(opt.get("input", {}).get("dtype", "float32")))
        batch_size = int(opt.get("batch_size", 64))

        origin = [float(v) for v in opt["detector_origin"]]
        refine = opt.get("refine_beam_center", False)
        if refine:
            origin = self._refine_origin(paths, (ny, nx), dtype, origin,
                                         refine, batch_size)

        def _pair(v):
            return None if (v is None or v is False) else \
                tuple(float(x) for x in v)

        def _off(v):
            return None if v is False else v

        roi = fopt.get("roi", {}) or {}
        rpf = fopt.get("radial_pixel_filter", False)
        corr_opt = opt.get("corrections", {})
        grid = opt["polar_grid"]
        corr = Correlator(
            (ny, nx), origin, float(opt["pixel_size"]),
            float(opt["sample_distance"]), float(opt["wavelength"]),
            n_phi=int(grid["n_phi"]), n_q=int(grid.get("n_q", 0)),
            interpolation_order=int(opt.get("interpolation_order", 1)),
            mask_below=_off(fopt.get("mask_below")),
            mask_above=_off(fopt.get("mask_above")),
            polarization=corr_opt.get("polarization", False),
            solid_angle=bool(corr_opt.get("solid_angle", False)),
            background=background,
            fc_n_max=int(opt.get("fc_n_max", 0) or 0) or None,
            with_ccf=with_ccf,
            qrange=_pair(opt.get("qrange", False)),
            qrange_xcca=None if not opt.get("qrange_xcca", False)
            else tuple(tuple(float(x) for x in row)
                       for row in opt["qrange_xcca"]),
            phi_range=_pair(opt.get("phi_range", False)),
            phi_sampling_mode=grid.get("phi_sampling_mode") or None,
            roi_q_range=_pair(roi.get("q_range", False)),
            roi_normalize=bool(roi.get("normalize", False)),
            roi_mean_bounds=_pair(roi.get("mean_bounds", False)),
            radial_pixel_filter=None if not rpf
            else (str(rpf[0]), float(rpf[1])),
            symmetrize=bool(opt.get("ccf_2p_symmetrize", False)),
            static_mask=static_mask, device=self.device)
        loader = PrefetchingFrameLoader(
            paths, (ny, nx), dtype=dtype, batch_size=batch_size,
            buffers=corr.pinned_buffers(batch_size))
        lit_min = float(fopt.get("lit_pixel_fraction_min", 0.0) or 0.0)

        def is_good(batch):
            if lit_min <= 0:
                return np.ones(len(batch))
            frac = (batch > 0).mean(axis=(1, 2))
            return (frac >= lit_min).astype(np.float32)

        setup_s = time.perf_counter() - t_setup
        out = corr.correlate_frames(loader, batch_size=batch_size,
                                    is_good=is_good)
        data = {
            "dimensions": 3,
            "radial_points": corr.qs,
            "angular_points": corr.phis,
            "xray_wavelength": corr.wavelength,
            "average_intensity": out["average_intensity"],
            "cross_correlation": {"I1I1": out["cross_correlation"]}
            if out["cross_correlation"] is not None else {},
            "num_images_processed": len(paths),
            "num_images_good": out["num_images_good"],
        }
        if len(corr.q1_pos) != corr.n_q or len(corr.q2_pos) != corr.n_q:
            # a qrange_xcca-restricted CCF: radial_points stays the full
            # ring grid; the ring subsets make the file self-describing
            data["qrange_xcca_q1_ids"] = corr.q1_pos
            data["qrange_xcca_q2_ids"] = corr.q2_pos
            data["qrange_xcca_q1_points"] = corr.qs[corr.q1_pos]
            data["qrange_xcca_q2_points"] = corr.qs[corr.q2_pos]
        t0 = time.perf_counter()
        self.saved = self.store.save("ccd", data)
        timing = dict(out["timing"], setup_s=setup_s,
                      save_s=time.perf_counter() - t0)
        data["timing"] = timing
        print(f"correlate: {len(paths)} frames ({out['num_images_good']} "
              f"good); saved to {self.saved[0]}")
        return data

    def _refine_origin(self, paths, shape, dtype, origin, refine,
                       batch_size):
        """refine_beam_center: grid-search the detector origin on the mean
        of the first batch's good frames before the polar grid is built."""
        from xframe_tpu_torch.native import read_frame_batch
        frames, ok = read_frame_batch(paths[: max(int(batch_size), 8)],
                                      shape, dtype=dtype)
        good = frames[ok]
        if not len(good):
            return origin
        mean_frame = np.where(np.isfinite(good), good, 0.0).mean(axis=0)
        ropt = refine if isinstance(refine, dict) else {}
        refined = refine_detector_origin(
            mean_frame, origin,
            search_radius_pix=float(ropt.get("search_radius_pix", 3.0)),
            steps=int(ropt.get("steps", 7)))
        print(f"correlate: beam center refined {tuple(origin)} -> {refined}")
        return list(refined)

    @staticmethod
    def _load_background(spec, shape):
        """filters.background_file / mask_file: a per-pixel frame (.npy,
        .h5 or .hdf5: the dataset 'background', else the first one, or raw
        float32 of the image size). → float32 array or None."""
        if not spec:
            return None
        path = str(spec)
        if path.endswith(".npy"):
            bg = np.load(path)
        elif path.endswith((".h5", ".hdf5")):
            from xframe_tpu_torch.io import hdf5
            d = hdf5.load(path)
            bg = d["background"] if "background" in d \
                else next(iter(d.values()))
        else:
            bg = np.fromfile(path, dtype=np.float32)
        return np.asarray(bg, dtype=np.float32).reshape(shape)

    def _frame_paths(self):
        inp = self.settings.get("input", {})
        folder = str(inp.get("input_folder", "")) or os.path.join(
            home_dir(), "data", "fxs", "input_files")
        list_path = os.path.join(folder, str(inp.get("file_list",
                                                     "patterns_list.txt")))
        with open(list_path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        return [ln if os.path.isabs(ln) else os.path.join(folder, ln)
                for ln in lines]
