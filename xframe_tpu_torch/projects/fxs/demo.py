"""Self-contained synthetic MTIP problems (3D and 2D).

Port of `xframe_tpu.projects.fxs.demo.make_demo_problem` and
`make_demo_problem_2d`: a known two-ball (two-disk) density → its B_l (B_m)
invariants → projection matrices (vectors) → the MTIP program, plus random
initial densities. The data side runs through the port's own transforms
(the kernels on a GPU in 3D).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from xframe_tpu_torch.library.shapes import (ball_density,
                                             get_test_function, polar_grid,
                                             spherical_grid)
from xframe_tpu_torch.ops.fourier import (PolarFourierTransform,
                                          SphericalFourierTransform)
from xframe_tpu_torch.ops.integrate import PolarIntegrator, SphericalIntegrator
from xframe_tpu_torch.projects.fxs import invariants as itools
from xframe_tpu_torch.projects.fxs.projections import (
    RealCircularHarmonics, ReciprocalConstraint, ReciprocalConstraintPolar,
    RealConstraint, ShrinkWrap,
)
from xframe_tpu_torch.projects.fxs.phasing import MTIP, bump_density_guess


def _device(device, caller):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device={str(device)!r}): CUDA is not "
                           "available")
    return device


def make_demo_problem(n_radial: int = 32, l_max: int = 16, *,
                      q_max: float = None, n_theta: int = None,
                      n_phi: int = None, mode: str = "midpoint",
                      reciprocity_coefficient: float = 2.0,
                      procrustes_method: str = "svd",
                      ns_iterations: int = 16, ns_schedule=None,
                      fused_sht: bool = True, real_dtype=torch.float32,
                      fused_table_dtype=None, mxu_dtype=None,
                      host=None, device="cuda") -> SimpleNamespace:
    """Two-ball density → invariants → MTIP on `device`. Asking for a CUDA
    device where none exists raises; nothing falls back to the CPU.

    With `fused_sht` (the default) at float32 the spherical harmonic
    transforms run through FusedSHT (the CUDA kernels on a GPU, the plain
    transforms on the CPU) and the MTIP runs the fused iteration, as the
    JAX package's does with its fused SHT. `fused_sht=False`, or
    `real_dtype=torch.float64`, builds the FT on the plain transforms and
    runs the stepwise iteration, on either device.

    `fused_table_dtype=torch.bfloat16` gives the FusedSHT bf16 Legendre
    tables and the kernels' bf16 forms (ignored without a FusedSHT);
    `mxu_dtype=torch.bfloat16` the plain transform bf16 Legendre products
    (ops/sht.py), as the JAX package's arguments of the same names.

    `shapes` describes `rho_true` as simulate_ccd shape settings.
    `initial_density_batch(seed_or_generator, n_restarts)` draws random
    bump guesses (torch.Generator on `device`, or an int seed for one) and
    smooths them with an FT round trip.

    `host`: a problem made earlier on the same grid, e.g. the float32 one
    of a float64 problem, whose host-built `grid` and `rho_true` (numpy
    float64, most of the set-up's host time on a large grid) are taken
    over."""
    device = _device(device, "make_demo_problem")
    if q_max is None:
        q_max = 0.4 * n_radial / 32.0
    ft = SphericalFourierTransform(n_radial, l_max, q_max=q_max, mode=mode,
                                   reciprocity_coefficient=reciprocity_coefficient,
                                   n_theta=n_theta, n_phi=n_phi,
                                   real_dtype=real_dtype,
                                   fused_sht=fused_sht, mxu_dtype=mxu_dtype,
                                   fused_table_dtype=fused_table_dtype,
                                   device=device)
    np_real = np.float32 if real_dtype == torch.float32 else np.float64
    radius = ft.r_max / 2.2
    # the true density as simulate_ccd shape settings, for
    # fidelity.align_to_ground_truth
    shapes = dict(types=["sphere", "sphere"],
                  centers=[(radius / 2, 1.2, 0.7), (radius / 2.2, 2.1, 3.9)],
                  sizes=[radius / 2.5, radius / 3.0], densities=[1.0, 0.7])
    if host is not None:
        if host.shapes != shapes or host.grid.shape[:3] != (
                n_radial, ft.sht.n_theta, ft.sht.n_phi):
            raise ValueError("make_demo_problem: `host` was made on another "
                             "grid")
        grid, rho_true = host.grid, host.rho_true
    else:
        grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
        rho_true = sum(ball_density(grid, size, center=c, amplitude=a)
                       for size, c, a in zip(shapes["sizes"],
                                             shapes["centers"],
                                             shapes["densities"]))

    # data side: B_l of the true density → projection matrices V_l
    rho_t = torch.as_tensor(rho_true.astype(np_real), device=device)
    psi = ft.forward(rho_t.to(ft.complex_dtype))
    coeff = ft.harmonic.forward_real((psi * psi.conj()).real).cpu().numpy()
    del rho_t, psi
    bl = itools.harmonic_coeff_to_deg2_invariants_3d(coeff).real.astype(complex)
    bl[1::2] = 0  # Friedel symmetry
    proj, eigs = itools.deg2_invariant_to_projection_matrices(
        torch.as_tensor(bl))
    proj, eigs = [v.numpy() for v in proj], [e.numpy() for e in eigs]
    avg_intensity = np.sqrt(np.maximum(np.diag(bl[0]).real, 0.0) / (4 * np.pi))
    total_intensity = float(np.trapezoid(avg_intensity * ft.qs ** 2, ft.qs)
                            * 2 * np.sqrt(np.pi))

    integ = SphericalIntegrator(ft.rs, ft.sht.n_theta, ft.sht.n_phi,
                                real_dtype=real_dtype, device=device)
    initial_support = grid[..., 0] < radius * 1.2
    rc = ReciprocalConstraint.build(proj, ft.qs, l_max,
                                    use_averaged_intensity=True,
                                    average_intensity=avg_intensity,
                                    odd_orders_to_0=True, schmidt_scaling=False,
                                    procrustes_method=procrustes_method,
                                    ns_iterations=ns_iterations,
                                    ns_schedule=ns_schedule,
                                    real_dtype=real_dtype, device=device)
    real = RealConstraint(limit_imag=2.0)
    sw = ShrinkWrap.build(ft.qs, real_dtype=real_dtype, device=device)
    mtip = MTIP(ft, rc, real, sw, integ.w_broadcast.cpu().numpy(),
                initial_support, enforce_initial_support_limit=6e-3,
                fused_pipeline=None if fused_sht else False,
                real_dtype=real_dtype, device=device)

    bump = get_test_function(support=[-radius, radius], slope=0.3)(ft.rs)
    shape = (n_radial, ft.sht.n_theta, ft.sht.n_phi)

    def initial_density_batch(seed_or_generator, n_restarts):
        """(n_restarts, n_r, n_θ, n_φ) smoothed random bump guesses."""
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(gen))
        rho0 = bump_density_guess(gen, bump, shape, snr=2.0,
                                  total_intensity=total_intensity,
                                  integration_weights=integ.w_broadcast,
                                  n_restarts=n_restarts,
                                  real_dtype=real_dtype)
        return ft.inverse(ft.forward(rho0))

    return SimpleNamespace(
        ft=ft, mtip=mtip, grid=grid, rho_true=rho_true, shapes=shapes, bl=bl,
        projection_matrices=proj, eigenvalues=eigs,
        average_intensity=avg_intensity, total_intensity=total_intensity,
        radius=radius, integrator=integ, initial_support=initial_support,
        initial_density_batch=initial_density_batch,
    )


def make_demo_problem_2d(n_radial: int = 32, m_max: int = 16, n_phi: int = 64,
                         *, q_max: float = None, mode: str = "midpoint",
                         reciprocity_coefficient: float = 2.0,
                         real_dtype=torch.float32,
                         device="cuda") -> SimpleNamespace:
    """Two-disk polar (2D) density → B_m → projection vectors → the 2D MTIP
    on `device` (the stepwise iteration on RealCircularHarmonics). Asking
    for a CUDA device where none exists raises. `shapes` describes
    `rho_true` as simulate_ccd shape settings with (r, φ) centers;
    `initial_density_batch(seed_or_generator, n_restarts)` as in
    make_demo_problem."""
    device = _device(device, "make_demo_problem_2d")
    if q_max is None:
        q_max = 0.4 * n_radial / 32.0
    ft = PolarFourierTransform(n_radial, m_max, n_phi, q_max, mode=mode,
                               reciprocity_coefficient=reciprocity_coefficient,
                               real_dtype=real_dtype, device=device)
    np_real = np.float32 if real_dtype == torch.float32 else np.float64
    phis = 2 * np.pi * np.arange(n_phi) / n_phi
    grid = polar_grid(ft.rs, phis)
    radius = ft.r_max / 2.2
    shapes = dict(types=["sphere", "sphere"],
                  centers=[(radius / 2, 0.7), (radius / 2.2, 3.9)],
                  sizes=[radius / 2.5, radius / 3.0], densities=[1.0, 0.7])
    rho_true = sum(ball_density(grid, size, center=c, amplitude=a)
                   for size, c, a in zip(shapes["sizes"], shapes["centers"],
                                         shapes["densities"]))

    cht = RealCircularHarmonics(n_phi, m_max)
    rho_t = torch.as_tensor(rho_true.astype(np_real), device=device)
    psi = ft.forward(rho_t.to(ft.complex_dtype))
    coeff = cht.forward((psi * psi.conj()).real)
    del rho_t, psi
    bm = itools.harmonic_coeff_to_deg2_invariants_2d(coeff)
    bm[1::2] = 0  # Friedel symmetry
    vecs, eigs = itools.deg2_invariant_to_projection_vectors_2d(bm)
    bm, vecs, eigs = bm.cpu().numpy(), vecs.cpu().numpy(), eigs.cpu().numpy()
    avg_intensity = coeff[:, 0].real.cpu().numpy().astype(np.float64)
    total_intensity = float(np.trapezoid(avg_intensity * ft.qs, ft.qs)
                            * 2 * np.pi)

    integ = PolarIntegrator(ft.rs, n_phi, real_dtype=real_dtype,
                            device=device)
    initial_support = grid[..., 0] < radius * 1.2
    rc = ReciprocalConstraintPolar.build(
        list(vecs), ft.qs, m_max, use_averaged_intensity=True,
        average_intensity=avg_intensity, odd_orders_to_0=True,
        real_dtype=real_dtype, device=device)
    real = RealConstraint(limit_imag=2.0)
    sw = ShrinkWrap.build(ft.qs, grid_rank=2, real_dtype=real_dtype,
                          device=device)
    w_err = integ._w.cpu().numpy() * initial_support
    mtip = MTIP(ft, rc, real, sw, w_err, initial_support,
                enforce_initial_support_limit=6e-3, harmonic=cht,
                real_dtype=real_dtype, device=device)

    bump = get_test_function(support=[-radius, radius], slope=0.3)(ft.rs)
    shape = (n_radial, n_phi)

    def initial_density_batch(seed_or_generator, n_restarts):
        """(n_restarts, n_r, n_φ) smoothed random bump guesses."""
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(gen))
        rho0 = bump_density_guess(gen, bump, shape, snr=2.0,
                                  total_intensity=total_intensity,
                                  integration_weights=integ._w,
                                  n_restarts=n_restarts,
                                  real_dtype=real_dtype)
        return ft.inverse(ft.forward(rho0))

    return SimpleNamespace(
        ft=ft, mtip=mtip, grid=grid, rho_true=rho_true, shapes=shapes, bm=bm,
        cht=cht, projection_vectors=vecs, eigenvalues=eigs,
        average_intensity=avg_intensity, total_intensity=total_intensity,
        radius=radius, integrator=integ, initial_support=initial_support,
        initial_density_batch=initial_density_batch,
    )
