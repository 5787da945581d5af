"""Ground-truth fidelity: does a reconstructed density match the known
truth?

Port of `xframe_tpu.projects.fxs.fidelity`: the analytic density of the
simulate_ccd shape settings on the reconstruction's grid, the
reconstruction aligned to it (SO(3) rotation and point inversion in 3D,
the circular search in 2D; both centered first) on the FT's device, and
the real-space correlation

    corr = Σ w·ρ_a·ρ_t / sqrt(Σ w·ρ_a² · Σ w·ρ_t²),   ρ = |real part|

with w the integration weights. 1.0 = perfect, 0 = noise.
`align_batch_to_ground_truth` aligns a stack of densities in one batch.
"""
from __future__ import annotations

import numpy as np
import torch

from xframe_tpu_torch.library.shapes import polar_grid, spherical_grid
from xframe_tpu_torch.projects.fxs.alignment import Aligner, Aligner2D
from xframe_tpu_torch.projects.fxs.simulate_ccd import \
    build_density_from_shapes


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def density_correlation(a, b, weights):
    """Normalized weighted real-space correlation of two densities (host)."""
    a = np.abs(np.real(_host(a))).astype(np.float64)
    b = np.abs(np.real(_host(b))).astype(np.float64)
    w = np.broadcast_to(_host(weights).astype(np.float64), a.shape)
    num = float((w * a * b).sum())
    den = float(np.sqrt((w * a * a).sum() * (w * b * b).sum()))
    return num / max(den, 1e-300)


def ground_truth_density(shapes_opt, ft, dim=3):
    """The simulate_ccd shape settings evaluated on ft's real grid."""
    if dim == 3:
        grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
    else:
        grid = polar_grid(ft.rs, 2 * np.pi * np.arange(ft.n_phi) / ft.n_phi)
    return np.asarray(build_density_from_shapes(grid, shapes_opt),
                      dtype=np.float64)


def align_batch_to_ground_truth(densities, shapes_opt, ft,
                                integration_weights, dim=3, l_max_align=None,
                                center=True):
    """Align each of `densities` (N, n_r, n_θ, n_φ) or in 2D (N, n_r, n_φ)
    (a tensor or host arrays on ft's real grid) to the analytic truth of
    `shapes_opt`, in one
    batch on ft's device: the truth is built and the aligner set up once.
    → (correlations (N,), aligned densities (N, ...), truth density, infos:
    the rotation's angles, its score and whether the density was
    inverted); the densities are host arrays."""
    truth = ground_truth_density(shapes_opt, ft, dim=dim)
    aligner = Aligner(ft, integration_weights, l_max_align=l_max_align) \
        if dim == 3 else Aligner2D(ft, integration_weights)
    truth_d = torch.as_tensor(truth.astype(np.complex64),
                              device=aligner.device)
    if not isinstance(densities, torch.Tensor):
        densities = np.stack([_host(d) for d in densities])
    cand_d = torch.as_tensor(densities, device=aligner.device).to(
        torch.complex64)
    if center:
        truth_d = aligner.center(truth_d)[0]
        cand_d = aligner.center(cand_d)[0]
    rot, _, _, infos = aligner.align_batch(
        cand_d, aligner.coefficients(truth_d), ref_rho=truth_d,
        check_point_inversion=True)
    aligned, truth_h = rot.cpu().numpy(), truth_d.cpu().numpy()
    corrs = [density_correlation(a, truth_h, integration_weights)
             for a in aligned]
    return corrs, aligned, truth_h, infos


def align_to_ground_truth(density, shapes_opt, ft, integration_weights,
                          dim=3, l_max_align=None, center=True):
    """Align `density` (a tensor or host array on ft's real grid) to the
    analytic truth of `shapes_opt`, on ft's device.
    → (correlation, aligned density, truth density, info: the rotation's
    angles, its score and whether the density was inverted); the densities
    are host arrays."""
    corrs, aligned, truth_h, infos = align_batch_to_ground_truth(
        torch.as_tensor(density)[None], shapes_opt, ft, integration_weights,
        dim=dim, l_max_align=l_max_align, center=center)
    return corrs[0], aligned[0], truth_h, infos[0]
