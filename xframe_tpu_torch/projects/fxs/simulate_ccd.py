"""The simulate_ccd worker: a synthetic cross-correlation dataset from
analytic shapes or a deposited structure, on a 3D (r,θ,φ) grid or a 2D
polar (r,φ) one (`dimensions`).

Port of `xframe_tpu.projects.fxs.simulate_ccd`. On the worker's device:
the density from the shape settings (`device_density_from_shapes`, built
from the grid's 1D axes, never the cartesian grid) → B1 (FusedSHT.forward
of the complex density) → the Hankel transform (per-order matmul) → B2
(FusedSHT.inverse, ψ) → B3 (FusedSHT.forward_real_abs2, the intensity's
coefficients I_lm) → B_l = Re(I_l I_l†) per order (one batched GEMM, with
the N-particle scaling and the odd orders zeroed) → C_n summed order by
order → CC(q1,q2,Δ) by an irfft in float64, cast to float32, exactly
q1↔q2 symmetric. In 2D: the density on the polar grid → |FT|² through
the polar FT (torch.fft and the per-m Hankel matmul) → its circular
harmonics m = 0..M in float64 → B_m = I_m I_m† with the odd orders zeroed
and the N-particle scaling → CC = irfft over the B_m, float64 as the JAX
package writes it. The noise stays host numpy so that it equals the JAX
package's. CUDA tensors run the SHT kernels; CPU tensors their plain
versions. `fourier_transform.fused_sht: false` (the JAX package's default)
runs the plain transforms in place of B1, B2 and B3 on either device. The result is written as a ccd archive (projects/fxs/store.py);
in 3D the model density, strided to at most model_vtk_max_points, beside
it as model_density.vts (IO.files.ccd.options.save_model_vtk).

Host pieces are numpy copies of the JAX module's: `_shape_specs` (the same
rotations from the same rng stream, so host and device densities agree),
`build_density_from_shapes` (analytic shapes and pdb/map files on a
materialised grid) and `_resolve_max_q`.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
from scipy.stats import special_ortho_group

from xframe_tpu_torch.io import vtk
from xframe_tpu_torch.library import pdb as pdb_io
from xframe_tpu_torch.library.legendre import sph_legendre_table
from xframe_tpu_torch.library.physics import ewald_sphere_theta_pi
from xframe_tpu_torch.library.shapes import (SHAPE_BUILDERS,
                                             _tetrahedron_planes, polar_grid,
                                             spherical_grid,
                                             spherical_to_cartesian)
from xframe_tpu_torch.ops.fourier import (PolarFourierTransform,
                                          SphericalFourierTransform)
from xframe_tpu_torch.ops.hankel import reciprocity_relation
from xframe_tpu_torch.projects.fxs import invariants as itools


def _shape_specs(shapes_opt, grid_dim, rng=None):
    """The shapes settings as (type, cartesian center, size, amplitude,
    rotation or None) per shape; the rotations consume the rng stream in
    build_density_from_shapes' order."""
    types = list(shapes_opt["types"])
    centers = list(shapes_opt["centers"])
    sizes = list(shapes_opt["sizes"])
    amplitudes = list(shapes_opt["densities"])
    randoms = list(shapes_opt.get("random_orientation", [False] * len(types)))
    specs = []
    for typ, center, size, amp, rnd in zip(types, centers, sizes, amplitudes,
                                           randoms):
        center = np.asarray(center, dtype=float)
        if grid_dim == 2 and center.size == 3:
            center = center[[0, 2]]
        elif center.size != grid_dim:
            raise ValueError(
                f"shape center {center.tolist()} has {center.size} "
                f"coordinates but the {grid_dim}D grid expects {grid_dim} "
                f"({'r, phi' if grid_dim == 2 else 'r, theta, phi'})")
        rot = None
        if rnd:
            rot = special_ortho_group.rvs(grid_dim,
                                          random_state=rng or
                                          np.random.default_rng())
        specs.append((str(typ), spherical_to_cartesian(center),
                      float(np.asarray(size).ravel()[0]), float(amp), rot))
    return specs


def _f32(x):
    """A host constant rounded to float32, as a Python float."""
    return float(np.float32(x))


def device_density_from_shapes(axes, shapes_opt, rng=None, device="cuda"):
    """The shapes of `shapes_opt` superposed on the (r, θ, φ) grid of the 1D
    `axes`, or the polar (r, φ) grid of two, float32 on `device`: the
    cartesian coordinates are broadcast products of the axes' sines and
    cosines, evaluated per shape."""
    dim = len(axes)
    specs = _shape_specs(shapes_opt, dim, rng)
    ax = [torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
          for a in axes]
    if dim == 3:
        rs, th, ph = ax
        r = rs[:, None, None]
        sin_t, cos_t = torch.sin(th)[None, :, None], torch.cos(th)[None, :, None]
        cos_p, sin_p = torch.cos(ph)[None, None, :], torch.sin(ph)[None, None, :]
        shape = (rs.numel(), th.numel(), ph.numel())
        coords = (r * sin_t * cos_p, r * sin_t * sin_p,
                  (r * cos_t).expand(shape))
    else:
        rs, ph = ax
        shape = (rs.numel(), ph.numel())
        coords = (rs[:, None] * torch.cos(ph)[None, :],
                  rs[:, None] * torch.sin(ph)[None, :])
    density = torch.zeros(shape, dtype=torch.float32, device=device)
    for typ, center, size, amp, rot in specs:
        c = [x - _f32(cc) for x, cc in zip(coords, center)]
        if rot is not None:
            # build_density_from_shapes applies cart @ rot: out_j = Σ_i c_i rot[i, j]
            c = [sum(c[i] * _f32(rot[i, j]) for i in range(dim))
                 for j in range(dim)]
        if typ in ("sphere", "ball"):
            mask = sum(x * x for x in c) < _f32(size * size)
        elif typ == "cube":
            half = _f32(size / 2)
            mask = torch.ones(shape, dtype=torch.bool, device=device)
            for x in c:
                mask &= x.abs() < half
        elif typ == "tetrahedron":
            mask = torch.ones(shape, dtype=torch.bool, device=device)
            for base, normal in _tetrahedron_planes(size):
                d = _f32(base @ normal) - sum(
                    x * _f32(n) for x, n in zip(c, normal))
                mask &= d >= 0
        else:
            raise ValueError(f"unknown shape type {typ!r}")
        density += torch.where(mask, _f32(amp), 0.0)
    return density


def build_density_from_shapes(grid, shapes_opt, rng=None):
    """Superpose the configured shapes on an (n_r, n_θ, n_φ, 3) spherical
    grid or an (n_r, n_φ, 2) polar one (host numpy). shapes_opt: 'types',
    'centers' ((r, θ, φ), or (r, φ) in 2D, where a 3-coordinate center
    reads as (r, φ) = (c[0], c[2])), 'sizes', 'densities' and optionally
    'random_orientation', one entry per shape; or types ['pdb'] with a
    local 'map_file' (CCP4/MRC, sampled nearest neighbour; in 2D its z = 0
    slice) or 'pdb_file' (atoms smeared at 'resolution', 3D only: the JAX
    package reads a polar grid's (x, y) pairs as (x, y, z) triples
    there)."""
    grid_dim = grid.shape[-1]
    if str(shapes_opt.get("types", [""])[0]) == "pdb":
        src = str(shapes_opt.get("map_file") or shapes_opt["pdb_file"])
        cart = spherical_to_cartesian(grid)
        if pdb_io.is_map_file(src):
            if grid_dim == 2:
                cart = np.concatenate(
                    [cart, np.zeros(cart.shape[:-1] + (1,))], axis=-1)
            return pdb_io.map_density(src, cart)
        if grid_dim == 2:
            raise NotImplementedError(
                "a pdb_file on a 2D polar grid: atoms are smeared in 3D only "
                "(use a map_file, whose z = 0 slice is taken)")
        return pdb_io.pdb_density(
            src, spherical_to_cartesian(grid),
            resolution=float(shapes_opt.get("resolution", 4.0)))
    types = list(shapes_opt["types"])
    centers = list(shapes_opt["centers"])
    sizes = list(shapes_opt["sizes"])
    amplitudes = list(shapes_opt["densities"])
    randoms = list(shapes_opt.get("random_orientation", [False] * len(types)))
    # one float32 cartesian grid shared by every shape: the binary masks do
    # not need more, and the conversion dominates at simulation grids
    cart = spherical_to_cartesian(
        np.asarray(grid, dtype=np.float32)).astype(np.float32)
    density = np.zeros(grid.shape[:-1])
    for typ, center, size, amp, rnd in zip(types, centers, sizes, amplitudes,
                                           randoms):
        center = np.asarray(center, dtype=float)
        if grid_dim == 2 and center.size == 3:
            center = center[[0, 2]]
        elif center.size != grid_dim:
            raise ValueError(
                f"shape center {center.tolist()} has {center.size} "
                f"coordinates but the {grid_dim}D grid expects {grid_dim} "
                f"({'r, phi' if grid_dim == 2 else 'r, theta, phi'})")
        density += SHAPE_BUILDERS[str(typ)](
            grid, float(np.asarray(size).ravel()[0]), center=center,
            amplitude=float(amp), random_orientation=bool(rnd), rng=rng,
            cart=cart)
    return density


def intensity_coefficients(ft, density):
    """I_lm (n_q, 2L+1, L+1) of |FT(ρ)|² for a real density on ft's device:
    B1, the Hankel transform, B2, B3; under fourier_transform.fused_sht
    false the plain transforms in their place, as the JAX package's
    default."""
    c = ft.harmonic.forward(density.to(torch.complex64))
    psi = ft.harmonic.inverse(ft.hankel.forward(c))
    return ft.harmonic.forward_real_abs2(psi)


def bl_from_coeff(coeff, n_particles):
    """B_l = Re(I_l I_l†) (L+1, n_q, n_q) float32, every order scaled by N
    and B_0 by N² (N dilute particles), the odd orders zero (|F|² is
    centrosymmetric)."""
    c = coeff.permute(2, 0, 1)
    bl = torch.matmul(c, c.conj().transpose(1, 2)).real
    ls = np.arange(bl.shape[0])
    scale = np.where(ls == 0, n_particles * n_particles,
                     np.where(ls % 2 == 1, 0.0, n_particles))
    return bl * torch.as_tensor(scale.astype(np.float32),
                                device=bl.device)[:, None, None]


def synthesize_cc(bl, wavelength, qs, n_phi):
    """CC(q1,q2,Δ) float32 host array from B_l (L+1, n_q, n_q) float32 on
    its device: C_n = Σ_l B_l·P̄ⁿ_l(θ1)P̄ⁿ_l(θ2)/(2l+1), accumulated order
    by order (n ≤ l) on the device, its q1 ≤ q2 triangle mirrored onto the
    other, then irfft(C_n·n_φ) in float64, mirrored again, so that the CC
    is exactly q1↔q2 symmetric."""
    dev = bl.device
    L = bl.shape[0] - 1
    thetas = ewald_sphere_theta_pi(wavelength, np.asarray(qs))
    tab = torch.as_tensor(
        sph_legendre_table(L, np.cos(thetas)).astype(np.float32), device=dev)
    scale = (1.0 / (2 * np.arange(L + 1) + 1)).astype(np.float32)
    bls = bl * torch.as_tensor(scale, device=dev)[:, None, None]
    n_q = tab.shape[0]
    cns = torch.zeros((n_q, n_q, L + 1), dtype=torch.float32, device=dev)
    for l in range(L + 1):
        col = tab[:, None, : l + 1, l] * tab[None, :, : l + 1, l]
        cns[..., : l + 1] += bls[l][:, :, None] * col
    upper = torch.ones((n_q, n_q), dtype=torch.bool, device=dev).triu()
    cns = torch.where(upper[..., None], cns, cns.transpose(0, 1))
    cc = torch.fft.irfft(cns.to(torch.float64) * n_phi, n_phi,
                         dim=-1).to(torch.float32)
    del cns
    cc = torch.where(upper[..., None], cc, cc.transpose(0, 1))
    return cc.cpu().numpy()


def _apply_noise(cc, opt):
    """Optional additive noise (`noise: {apply: true, snr: X, seed: s}`):
    per (q1,q2) the scale of that pair's CC over Δ over snr, drawn by
    numpy's default_rng(seed) on the host, then q1↔q2 symmetrized."""
    nopt = opt.get("noise", {})
    if not bool(nopt.get("apply", False)):
        return cc
    snr = float(nopt.get("snr", 100.0))
    rng = np.random.default_rng(int(nopt.get("seed", 0)))
    scale = np.abs(cc).std(axis=-1, keepdims=True) / snr
    noisy = cc + rng.normal(size=cc.shape) * scale
    return 0.5 * (noisy + np.swapaxes(noisy, 0, 1))


def _resolve_max_q(opt, n_radial):
    """grid.max_q, or where it is False: the reciprocity relation at
    grid.oversampling × the outermost shape extent (shapes.shape_size / 2
    where given)."""
    mq = opt["grid"].get("max_q", False)
    if not isinstance(mq, bool) and mq:
        return float(mq)
    over = float(opt["grid"].get("oversampling", 8))
    shp = opt["shapes"]
    centers = np.atleast_2d(np.asarray(shp["centers"], dtype=float))
    sizes = np.asarray(shp["sizes"], dtype=float)
    size_given = shp.get("shape_size", "not given")
    if isinstance(size_given, (int, float)):
        max_particle_radius = float(size_given) / 2
    else:
        max_particle_radius = float((centers[:, 0] + sizes).max())
    rc = float(opt["fourier_transform"]["reciprocity_coefficient"])
    return reciprocity_relation(over * max_particle_radius, n_radial, rc)


class ProjectWorker:
    """simulate_ccd: shape settings → a ccd archive. After `run` the worker
    keeps the archive's (path, run) (`saved`)."""

    def __init__(self, settings: dict, device="cuda"):
        from xframe_tpu_torch.projects.fxs.reconstruct import device_of
        from xframe_tpu_torch.projects.fxs.store import ProjectStore
        self.settings = settings
        self.device = device_of(device)
        self.store = ProjectStore(settings.get("structure_name", "default"),
                                  settings)

    def run(self):
        """Simulate and archive the dataset. → the ccd dict (the JAX
        worker's keys) with its "timing" (seconds per stage: weights,
        transforms, density, intensity_coefficients, bl, cc_synthesis,
        noise, save; 2D: weights, transforms, density, intensity, bm,
        cc_synthesis, noise, save), which the archive does not hold."""
        timing = {}
        self._model = None
        if int(self.settings.get("dimensions", 3)) == 2:
            data = self._run_2d(self.settings, timing)
        else:
            data = self._run_3d(self.settings, timing)
        t0 = time.perf_counter()
        self.saved = self.store.save("ccd", data)
        if self._model is not None:
            density, (rs, thetas, phis) = self._model
            vtk.save_spherical(os.path.join(os.path.dirname(self.saved[0]),
                                            "model_density.vts"),
                               rs, thetas, phis, {"density": density})
        timing["save_s"] = time.perf_counter() - t0
        data["timing"] = timing
        print(f"simulate_ccd: saved synthetic CC dataset to "
              f"{self.saved[0]}")
        return data

    def _stage(self, timing, name, t0):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timing[name + "_s"] = time.perf_counter() - t0
        return time.perf_counter()

    def _run_3d(self, opt, timing):
        from xframe_tpu_torch.projects.fxs.reconstruct import (
            _fused_sht, load_cached_weights)
        dev = self.device
        gopt, fopt = opt["grid"], opt["fourier_transform"]
        N, L = int(gopt["n_radial_points"]), int(gopt["max_order"])
        q_max = _resolve_max_q(opt, N)
        wavelength = float(opt["cross_correlation"]["xray_wavelength"])
        mode = str(fopt["type"])
        rc = float(fopt["reciprocity_coefficient"])

        t0 = time.perf_counter()
        weights = load_cached_weights(L, N, rc, 3, mode)
        t0 = self._stage(timing, "weights", t0)
        ft = SphericalFourierTransform(
            N, L, q_max=q_max, mode=mode, reciprocity_coefficient=rc,
            weights_dict=weights,
            n_theta=int(gopt.get("n_theta", 0) or 0) or None,
            n_phi=int(gopt.get("n_phi_internal", 0) or 0) or None,
            fused_sht=_fused_sht(opt), device=dev)
        del weights
        t0 = self._stage(timing, "transforms", t0)
        axes = (ft.rs, ft.sht.theta, ft.sht.phi)
        if str(opt["shapes"].get("types", [""])[0]) == "pdb":
            density = torch.as_tensor(build_density_from_shapes(
                spherical_grid(*axes), opt["shapes"]).astype(np.float32),
                device=dev)
        else:
            density = device_density_from_shapes(axes, opt["shapes"],
                                                 device=dev)
        t0 = self._stage(timing, "density", t0)
        if bool(self.store.io_option("ccd", "save_model_vtk", True)):
            self._model = self._model_sample(density, axes)
        coeff = intensity_coefficients(ft, density)
        del density
        t0 = self._stage(timing, "intensity_coefficients", t0)
        n_part = float(opt.get("n_particles", 1) or 1)
        bl = bl_from_coeff(coeff, n_part)
        t0 = self._stage(timing, "bl", t0)
        n_phi = int(gopt.get("n_phi") or 0)
        if n_phi <= 0:
            n_phi = 2 ** int(np.ceil(np.log2(2 * (L + 1))))
        cc = synthesize_cc(bl, wavelength, ft.qs, n_phi)
        del bl
        t0 = self._stage(timing, "cc_synthesis", t0)
        cc = _apply_noise(cc, opt)
        self._stage(timing, "noise", t0)
        # the angular mean of the intensity a(q) = I_00(q)·Y_00, consistent
        # with the scaled invariants: √(diag B_0) = N·a(q)
        avg_intensity = n_part * coeff[:, L, 0].cpu().numpy().real \
            / (2 * np.sqrt(np.pi))
        return {
            "dimensions": 3,
            "radial_points": ft.qs,
            "angular_points": 2 * np.pi * np.arange(n_phi) / n_phi,
            "xray_wavelength": wavelength,
            "average_intensity": avg_intensity,
            "cross_correlation": {"I1I1": cc.real},
            "num_images_processed": 1,
            "num_images_good": 1,
        }

    def _model_sample(self, density, axes):
        """The model density and its axes for model_density.vts, strided on
        every axis to at most IO.files.ccd.options.model_vtk_max_points
        points (default 2,000,000; 0: all) before the copy to the host."""
        cap = int(self.store.io_option("ccd", "model_vtk_max_points",
                                       2_000_000) or 0)
        if cap and density.numel() > cap:
            s = int(np.ceil((density.numel() / cap) ** (1 / 3)))
            density = density[::s, ::s, ::s]
            axes = tuple(a[::s] for a in axes)
        return density.cpu().numpy(), axes

    def _run_2d(self, opt, timing):
        from xframe_tpu_torch.projects.fxs.reconstruct import \
            load_cached_weights
        dev = self.device
        gopt, fopt = opt["grid"], opt["fourier_transform"]
        N, M = int(gopt["n_radial_points"]), int(gopt["max_order"])
        q_max = _resolve_max_q(opt, N)
        mode = str(fopt["type"])
        rc = float(fopt["reciprocity_coefficient"])
        n_phi = int(gopt.get("n_phi") or 0)
        if n_phi <= 0:
            n_phi = 2 ** int(np.ceil(np.log2(2 * (M + 1))))

        t0 = time.perf_counter()
        weights = load_cached_weights(M, N, rc, 2, mode)
        t0 = self._stage(timing, "weights", t0)
        ft = PolarFourierTransform(N, M, n_phi, q_max, mode=mode,
                                   reciprocity_coefficient=rc,
                                   weights_dict=weights, device=dev)
        del weights
        t0 = self._stage(timing, "transforms", t0)
        phi_axis = 2 * np.pi * np.arange(n_phi) / n_phi
        if str(opt["shapes"].get("types", [""])[0]) == "pdb":
            density = torch.as_tensor(build_density_from_shapes(
                polar_grid(ft.rs, phi_axis), opt["shapes"]).astype(
                    np.float32), device=dev)
        else:
            density = device_density_from_shapes((ft.rs, phi_axis),
                                                 opt["shapes"], device=dev)
        t0 = self._stage(timing, "density", t0)
        psi = ft.forward(density.to(torch.complex64))
        intensity = (psi * psi.conj()).real.to(torch.float64)
        del density, psi
        t0 = self._stage(timing, "intensity", t0)
        # the circular harmonics of the intensity, float64 as the JAX
        # package's host FFT
        coeff = torch.fft.fft(intensity, dim=-1) / n_phi
        del intensity
        bm = itools.harmonic_coeff_to_deg2_invariants_2d(coeff[:, : M + 1])
        bm[1::2] = 0
        # N dilute particles: every B_m scales by N, B_0 by N²
        n_part = float(opt.get("n_particles", 1) or 1)
        bm *= n_part
        bm[0] *= n_part
        t0 = self._stage(timing, "bm", t0)
        cc = itools.deg2_invariant_to_cc_2d(bm, n_phi=n_phi).cpu().numpy()
        del bm
        t0 = self._stage(timing, "cc_synthesis", t0)
        cc = _apply_noise(cc, opt)
        self._stage(timing, "noise", t0)
        return {
            "dimensions": 2,
            "radial_points": ft.qs,
            "angular_points": 2 * np.pi * np.arange(n_phi) / n_phi,
            "xray_wavelength": float(opt["cross_correlation"]
                                     ["xray_wavelength"]),
            "average_intensity": n_part * coeff[:, 0].real.cpu().numpy(),
            "cross_correlation": {"I1I1": cc},
            "num_images_processed": 1,
            "num_images_good": 1,
        }
