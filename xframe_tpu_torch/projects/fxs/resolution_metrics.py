"""Resolution metrics: PRTF, FSC/FRC (+ half-bit criterion), FQC (host
numpy).

A copy of `xframe_tpu.projects.fxs.resolution_metrics` (importing that
module pulls in the JAX package's settings and PyYAML):
  PRTF(q)  = |⟨ψ_i(q,Ω)⟩_i| / ⟨|ψ_i(q,Ω)|⟩_i, angularly averaged (Chapman
             definition; the fxs variant uses the projected amplitudes)
  FSC(q)   = ⟨ψ1 ψ2*⟩_Ω / √(⟨|ψ1|²⟩⟨|ψ2|²⟩)
  half-bit = (0.2071 + 1.9102/√n) / (1.2071 + 0.9102/√n), n = shell samples
  FQC(q1,q2,n) = normalized CC harmonic coherence
"""
from __future__ import annotations

import numpy as np


def _angular_mean(x, theta_weights=None, axes=None):
    """Mean over the angular axes: (..., n_q, n_theta, n_phi) by default,
    (..., n_q, n_phi) with axes=(-1,) for polar data."""
    if axes is None:
        axes = (-2, -1)
    if theta_weights is None or axes == (-1,):
        return x.mean(axis=axes)
    w = np.asarray(theta_weights)
    return (x * w[:, None]).sum(axis=(-2, -1)) / (w.sum() * x.shape[-1])


def prtf(psis, theta_weights=None, axes=None):
    """PRTF(q) from a stack of aligned reciprocal amplitudes
    (n_signals, n_q, n_theta, n_phi), or (n_signals, n_q, n_phi) with
    axes=(-1,)."""
    psis = np.asarray(psis)
    num = np.abs(psis.mean(axis=0))
    den = np.abs(psis).mean(axis=0)
    ratio = np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
    return _angular_mean(ratio, theta_weights, axes=axes)


def prtf_resolution(prtf_values, qs, criterion=1 / np.e):
    """First q where the PRTF falls below the criterion (∞-resolution if never)."""
    below = np.nonzero(np.asarray(prtf_values) < criterion)[0]
    if len(below) == 0:
        return float(qs[-1]), None
    q_c = float(qs[below[0]])
    return q_c, (2 * np.pi / q_c if q_c > 0 else None)


def prtf_fxs(avg_amplitude, avg_intensity, avg_proj_amplitude=None,
             avg_proj_intensity=None, axes=None):
    """Data-relative PRTF (reference PRTF_fxs + PRTF,
    resolution_metrics.py:63-101): pointwise

        prtf_nd = sqrt( a1·a2* / (b1·b2*) )

    with a1 the averaged scattering amplitude and b1 = sqrt(averaged
    intensity) — i.e. the amplitude retained by averaging relative to the
    measured/projected power. With the projected pair (a2, b2) given this is
    the cross variant comparing the density-average against the averaged
    PROJECTED amplitudes; without it a2=a1, b2=b1 (the reference's
    PRTF_from_density / PRTF_from_ft_density forms).

    → (prtf (n_q,) complex, prtf_std (n_q,)) — angular mean/std, matching
    the reference's unweighted np.average over the angular axes."""
    a1 = np.asarray(avg_amplitude)
    if avg_proj_amplitude is not None:
        a2 = np.asarray(avg_proj_amplitude)
        b1 = np.sqrt(np.asarray(avg_intensity))
        b2 = np.sqrt(np.asarray(avg_proj_intensity))
    else:
        a2 = a1
        b1 = b2 = np.sqrt(np.asarray(avg_intensity))
    if axes is None:
        axes = tuple(range(1, a1.ndim))
    prtf_nd = np.ones(a1.shape, dtype=complex)
    nz = (b1 != 0) & (b2 != 0)
    prtf_nd[nz] = (a1[nz] * a2[nz].conj()) / (b1[nz] * b2[nz].conj())
    prtf_nd[~nz & (a1 != 0) & (a2 != 0)] = 0
    prtf_nd = np.sqrt(prtf_nd)
    return np.average(prtf_nd, axis=axes), np.std(prtf_nd, axis=axes)


def fsc(psi1, psi2, theta_weights=None, axes=None):
    """Fourier shell/ring correlation over angular shells."""
    psi1, psi2 = np.asarray(psi1), np.asarray(psi2)
    num = _angular_mean(psi1 * np.conj(psi2), theta_weights, axes=axes)
    d1 = _angular_mean(np.abs(psi1) ** 2, theta_weights, axes=axes)
    d2 = _angular_mean(np.abs(psi2) ** 2, theta_weights, axes=axes)
    den = np.sqrt(d1 * d2)
    return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)


def half_bit_threshold(n_shell_samples):
    """½-bit information criterion curve (van Heel & Schatz 2005)."""
    n = np.sqrt(np.maximum(np.asarray(n_shell_samples, dtype=float), 1.0))
    return (0.2071 + 1.9102 / n) / (1.2071 + 0.9102 / n)


def fqc(cc1, cc2, skip_odd_orders=False, max_order=None):
    """Fourier quadrant correlation of two cross-correlation datasets
    (Kurta et al. PRL 119:158102 eq. S17; reference resolution_metrics.py:
    103-144, which drops the 0th harmonic from the sums):

      FQC(q1,q2) = Σ_n c1_n c2_n* / √(Σ|c1_n|² Σ|c2_n|²),  n ≥ 1

    symmetrized in (q1,q2); the per-q curve is the lower-triangle mean.
    → (fqc_q (n_q,), fqc_2d (n_q,n_q))."""
    c1 = np.fft.rfft(np.asarray(cc1), axis=-1)
    c2 = np.fft.rfft(np.asarray(cc2), axis=-1)
    start, step = (2, 2) if skip_odd_orders else (1, 1)
    stop = None if max_order is None else int(max_order) + 1
    c1 = ((c1 + np.swapaxes(c1, 0, 1)) / 2)[..., start:stop:step]
    c2 = ((c2 + np.swapaxes(c2, 0, 1)) / 2)[..., start:stop:step]
    num = np.sum(c1 * np.conj(c2), axis=-1).real
    den = np.sqrt(np.sum(np.abs(c1) ** 2, axis=-1)
                  * np.sum(np.abs(c2) ** 2, axis=-1))
    cc = np.where(den > 0, num / np.where(den > 0, den, 1.0), 1.0)
    tril = np.tril(np.ones(cc.shape, dtype=bool))
    fqc_q = np.array([cc[i, tril[i]].mean() for i in range(cc.shape[0])])
    return fqc_q, cc


def fqcb(b1, b2, skip_odd_orders=False, include_zero_order=False):
    """FQC over deg-2 invariants: correlate two B_l/B_m stacks (n_orders,
    n_q, n_q) summed over the order axis (reference FQCB_2D,
    resolution_metrics.py:146-186; the reference's FQCB_3D is an unfinished
    NotImplementedError — the same contraction applies, so both dims share
    this implementation). → (fqcb_q, std_q, fqcb_2d)."""
    b1, b2 = np.asarray(b1), np.asarray(b2)
    start = 0 if include_zero_order else (2 if skip_odd_orders else 1)
    step = 2 if skip_odd_orders else 1
    stop = min(len(b1), len(b2))
    s1 = ((b1 + np.swapaxes(b1, -1, -2)) / 2)[start:stop:step]
    s2 = ((b2 + np.swapaxes(b2, -1, -2)) / 2)[start:stop:step]
    num = np.sum(s1 * np.conj(s2), axis=0).real
    den = np.sqrt(np.sum(np.abs(s1) ** 2, axis=0)
                  * np.sum(np.abs(s2) ** 2, axis=0))
    bb = np.abs(np.where(den > 0, num / np.where(den > 0, den, 1.0), 1.0))
    tril = np.tril(np.ones(bb.shape, dtype=bool))
    fqcb_q = np.array([bb[i, tril[i]].mean() for i in range(bb.shape[0])])
    std_q = np.array([bb[i, tril[i]].std() for i in range(bb.shape[0])])
    return fqcb_q, std_q, bb
