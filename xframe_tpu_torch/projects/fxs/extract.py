"""The extract worker: cross-correlation data → B_l invariants →
projection matrices V_l (3D), or B_m → rank-1 projection vectors v_m (2D).

Port of `xframe_tpu.projects.fxs.extract`. The worker reads a ccd archive
(projects/fxs/store.py), applies the CC mask and modifications, extracts
the B_l (back substitution and its variants, legendre, lstsq), enforces
PSD on each order's q-limits, factors B_l ≈ V_l V_l† by torch.linalg.eigh
and writes the invariants archive the reconstruct worker reads. All of it
runs in torch float64 on the worker's device (projects/fxs/invariants.py);
`extraction_mode: shapes` takes the B_l of an analytic density through the
SHT kernels instead. Several datasets (I1I1, I2I2, I2I1) give I2I2's
projection matrices and the unknown unitary I2I1, and two of them the FQC.
The options for experimental data run their transforms through FusedSHT
(B2 and B9 on the card): the prephasing of V_l
(`projection_matrices.prephase`, iterations × 10 round trips), the
SHT-constraint optimization of the low-resolution coefficients
(`optimize_projection_matrices`) and the particle-number estimate
(`number_of_particles.estimate`, one B2).

In 2D (the ccd archive's `dimensions`, else the settings'): no CC mask,
the modifications as in 3D, B_m = the circular harmonics of the CC, B_0
from the averaged intensity, the nearest PSD matrix of every order, and
v_m from one batched eigendecomposition. The 3D-only options (the CC mask
types, the SHT-constraint options, I2I2/I2I1, the error estimates) are
skipped there, as in the JAX package.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from xframe_tpu_torch.projects.fxs import invariants as itools

F64, C128 = torch.float64, torch.complex128


def _host(tree):
    """Tensors in nested dicts and lists → numpy arrays."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return tree


class ProjectWorker:
    """extract: a ccd archive (or analytic shapes) → an invariants archive.
    After `run` the worker keeps the archive's (path, run) (`saved`)."""

    def __init__(self, settings: dict, device="cuda"):
        from xframe_tpu_torch.projects.fxs.reconstruct import device_of
        from xframe_tpu_torch.projects.fxs.store import ProjectStore
        self.settings = settings
        self.device = device_of(device)
        self.store = ProjectStore(settings.get("structure_name", "default"),
                                  settings)

    def run(self):
        """Extract and archive the invariants. → the invariants dict (the
        JAX worker's keys, host arrays) with its "timing" (load, extract,
        save seconds) and, where an SHT-constraint option ran,
        "sht_constraint" ("prephase", "low_resolution": converged,
        iterations; "number_of_particles": the scan), which the archive
        does not hold."""
        opt = self.settings
        timing = {}
        self.sht_constraint = {}
        t0 = time.perf_counter()
        if str(opt.get("extraction_mode", "cross_correlation")) == "shapes":
            data = self.extract_from_shapes()
        else:
            inp = opt.get("input", {})
            run_no = inp.get("ccd_run") or None
            ccd = self.store.load_ccd(run=int(run_no) if run_no else None,
                                      path=inp.get("ccd_path") or None)
            timing["load_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            dim = int(ccd.get("dimensions", opt.get("dimensions", 3)))
            data = self.extract(ccd, dim)
        data = _host(data)
        timing["extract_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.saved = self.store.save("invariants", data)
        timing["save_s"] = time.perf_counter() - t0
        data["timing"] = timing
        if self.sht_constraint:
            data["sht_constraint"] = self.sht_constraint
        print(f"extract: saved invariants to {self.saved[0]}")
        return data

    # ---------------------------------------------------------------- extract
    def extract(self, ccd, dim=3):
        """The invariants of a ccd dict (host arrays) on the worker's device;
        tensors in the result. dim: 3, or 2 for a polar ccd."""
        opt, dev = self.settings, self.device
        qs = np.asarray(ccd["radial_points"], dtype=float)
        wavelength = float(ccd["xray_wavelength"])
        avg_intensity = np.asarray(ccd["average_intensity"], dtype=float)
        L = int(opt["max_order"])
        wanted = [str(n) for n in
                  opt["cross_correlation"].get("datasets_to_process",
                                               ["I1I1"])]
        present = [n for n in wanted if n in ccd["cross_correlation"]]
        if not present:
            raise ValueError(
                f"none of datasets_to_process {wanted} found in the ccd file "
                f"(has {sorted(ccd['cross_correlation'])})")
        for name in present:
            sh = np.shape(ccd["cross_correlation"][name])
            if sh[0] != len(qs) or sh[1] != len(qs):
                raise ValueError(
                    f"ccd dataset {name} has radial shape {sh[:2]} but "
                    f"radial_points has {len(qs)} entries: invariant "
                    "extraction needs a full square C(q1,q2,Δ)")
        apply_psd = bool(opt.get("invariant_constraints", {})
                         .get("positive_semidefinite", {}).get("apply", True))
        bls, mask_dict, qlim_dict = {}, {}, {}
        for name in present:
            bl, mask_dict[name], qlim_dict[name] = self._extract_bl(
                ccd, name, qs, wavelength, avg_intensity, L, dim)
            # the mixed invariant I2I1 is not Hermitian PSD; a dataset's
            # bl_enforce_psd overrides the global flag. 3D projects each
            # order's q-limit block, 2D the whole B_m.
            ds_psd = opt["cross_correlation"].get("datasets", {}) \
                .get(name, {}).get("bl_enforce_psd", None)
            if (apply_psd if ds_psd is None else bool(ds_psd)) \
                    and name != "I2I1":
                bl = itools.apply_psd_on_q_limits(bl, qlim_dict[name]) \
                    if dim == 3 else \
                    itools.nearest_positive_semidefinite_matrix(bl)
            bls[name] = bl
        primary = present[0]
        out, proj1, eig1 = self._invariants_to_output(
            bls[primary], qs, wavelength, avg_intensity,
            np.asarray(ccd["angular_points"]), q_limits=qlim_dict[primary],
            dim=dim)
        out["deg_2_invariant"] = {n: bls[n] for n in present}
        out["deg_2_invariant_masks"] = {n: mask_dict[n] for n in present}
        out["data_projection_matrix_error_estimates"] = {
            primary: itools.projection_matrix_error_estimate(bls[primary],
                                                             proj1)} \
            if dim == 3 else {}

        if dim == 3 and "I2I2" in bls and primary != "I2I2":
            proj2, eig2 = itools.deg2_invariant_to_projection_matrices(
                bls["I2I2"], q_id_limits=qlim_dict["I2I2"],
                rank_cap=bool(opt.get("projection_matrices", {})
                              .get("rank_cap", True)))
            out["data_projection_matrices"]["I2I2"] = proj2
            out["data_projection_matrix_error_estimates"]["I2I2"] = \
                itools.projection_matrix_error_estimate(bls["I2I2"], proj2)
            if "I2I1" in bls:
                # the reference's key, typo included
                method = str(opt.get(
                    "I2I1_unknown_tranrform_extraction_method", None)
                    or opt.get("unknown_transform", {})
                    .get("method", "procrustes"))
                W, w_err = itools.calc_unknown_unitary_transform(
                    proj1, eig1, proj2, eig2, bls["I2I1"], qs, method=method)
                out["data_projection_matrices"]["I2I1"] = W
                out["data_projection_matrix_error_estimates"]["I2I1"] = w_err

        fqc_opt = opt.get("resolution_metrics", {}).get("FQC", {})
        if bool(fqc_opt.get("apply", False)):
            pair = [str(n) for n in fqc_opt.get("datasets", present[:2])]
            if len(pair) >= 2 and all(p in ccd["cross_correlation"]
                                      for p in pair[:2]):
                from xframe_tpu_torch.projects.fxs import \
                    resolution_metrics as rm
                f_q, f_2d = rm.fqc(
                    np.asarray(ccd["cross_correlation"][pair[0]], dtype=float),
                    np.asarray(ccd["cross_correlation"][pair[1]], dtype=float),
                    skip_odd_orders=bool(fqc_opt.get("skip_odd_orders", True)),
                    max_order=L)
                out["fqc"] = {"datasets": "_".join(pair[:2]),
                              "curve": f_q, "q1q2": f_2d}
        return out

    # --------------------------------------------------- shapes ground truth
    def extract_from_shapes(self):
        """extraction_mode 'shapes': B_l of an analytic shape density on the
        FT grid of shapes_source (B1, Hankel, B2, B3 on the worker's device;
        in 2D the polar FT and the circular harmonics of |FT|² in float64),
        no cross-correlation involved."""
        from xframe_tpu_torch.library.shapes import spherical_grid
        from xframe_tpu_torch.ops.fourier import SphericalFourierTransform
        from xframe_tpu_torch.projects.fxs.reconstruct import \
            load_cached_weights
        from xframe_tpu_torch.projects.fxs.simulate_ccd import (
            bl_from_coeff, build_density_from_shapes, intensity_coefficients)
        opt, dev = self.settings, self.device
        sh = opt["shapes_source"]
        N = int(sh["grid"]["n_radial_points"])
        L = int(opt["max_order"])
        mode = str(sh["fourier_transform"]["type"])
        rc = float(sh["fourier_transform"]["reciprocity_coefficient"])
        if int(opt.get("dimensions", 3)) == 2:
            return self._extract_from_shapes_2d(sh, N, L, mode, rc)
        ft = SphericalFourierTransform(
            N, L, q_max=float(sh["grid"]["max_q"]), mode=mode,
            reciprocity_coefficient=rc,
            weights_dict=load_cached_weights(L, N, rc, 3, mode), device=dev)
        density = build_density_from_shapes(
            spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi), sh["shapes"])
        coeff = intensity_coefficients(
            ft, torch.as_tensor(density.astype(np.float32), device=dev))
        bl = bl_from_coeff(coeff, 1.0).to(C128)
        avg_intensity = coeff[:, L, 0].real.cpu().numpy() \
            / (2 * np.sqrt(np.pi))
        out, _, _ = self._invariants_to_output(
            bl, np.asarray(ft.qs), float(sh["xray_wavelength"]),
            avg_intensity, ft.sht.phi)
        out["deg_2_invariant"] = {"I1I1": bl}
        out["deg_2_invariant_masks"] = {
            "I1I1": torch.ones(bl.shape, dtype=torch.bool, device=dev)}
        return out

    def _extract_from_shapes_2d(self, sh, N, L, mode, rc):
        from xframe_tpu_torch.library.shapes import polar_grid
        from xframe_tpu_torch.ops.fourier import PolarFourierTransform
        from xframe_tpu_torch.projects.fxs.simulate_ccd import \
            build_density_from_shapes
        dev = self.device
        n_phi = int(sh["grid"].get("n_phi") or 0) or \
            2 ** int(np.ceil(np.log2(2 * (L + 1))))
        ft = PolarFourierTransform(N, L, n_phi, float(sh["grid"]["max_q"]),
                                   mode=mode, reciprocity_coefficient=rc,
                                   device=dev)
        angular = 2 * np.pi * np.arange(n_phi) / n_phi
        density = build_density_from_shapes(polar_grid(ft.rs, angular),
                                            sh["shapes"])
        psi = ft.forward(torch.as_tensor(density.astype(np.complex64),
                                         device=dev))
        cm = torch.fft.fft((psi * psi.conj()).real.to(F64), dim=-1) / n_phi
        bl = itools.harmonic_coeff_to_deg2_invariants_2d(cm[:, : L + 1])
        bl[1::2] = 0
        avg_intensity = cm[:, 0].real.cpu().numpy()
        out, _, _ = self._invariants_to_output(
            bl, np.asarray(ft.qs), float(sh["xray_wavelength"]),
            avg_intensity, angular, dim=2)
        out["deg_2_invariant"] = {"I1I1": bl}
        out["deg_2_invariant_masks"] = {
            "I1I1": torch.ones(bl.shape, dtype=torch.bool, device=dev)}
        return out

    def _extract_bl(self, ccd, name, qs, wavelength, avg_intensity, L,
                    dim=3):
        """One CC dataset → (B_l, its mask, its q-id limits): the CC mask
        (3D only), the modifications, the extraction."""
        opt, dev = self.settings, self.device
        datasets = opt["cross_correlation"]["datasets"]
        # unlisted datasets take the primary dataset's options
        ds_opt = datasets.get(name) or datasets.get("I1I1", {})
        cc = torch.as_tensor(np.asarray(ccd["cross_correlation"][name]),
                             device=dev).to(F64)
        phis = np.asarray(ccd["angular_points"], dtype=float)
        mask_opt = ds_opt.get("cc_mask", {})
        mask_type = str(mask_opt.get("type", "none"))
        # per-type parameters nested under the type's name (the reference's
        # schema) win over the flat keys
        sub = mask_opt.get(mask_type, {})
        mask_eff = {**mask_opt, **(sub if isinstance(sub, dict) else {})}
        mask = itools.cc_mask(
            qs, phis, mask_type=mask_type, xray_wavelength=wavelength,
            pixel_size=mask_eff.get("pixel_size"),
            mask_at_pi=bool(mask_eff.get("mask_at_pi", True)),
            threshold=float(mask_eff.get("threshold", 0.01)),
            n_masked_pixels_phi=float(mask_eff.get("n_masked_pixels_phi", 0.0)
                                      or 0.0),
            n_masked_pixels_q=float(mask_eff.get("n_masked_pixels_q",
                                    mask_eff.get("n_masked_q1q2", 0.0))
                                    or 0.0),
            custom=mask_eff.get("mask"), device=dev) if dim == 3 else \
            torch.ones(cc.shape, dtype=torch.bool, device=dev)

        mod = ds_opt.get("modify_cc", {})
        subtracted_avg = bool(mod.get("subtract_average_intensity", True))
        avg = torch.as_tensor(avg_intensity, dtype=F64, device=dev)
        if subtracted_avg:
            # a(q1)a(q2) is the B_0 term of the CC (n = 0 in Δ)
            cc = cc - avg[:, None, None] * avg[None, :, None]
        lpq = mod.get("low_pass_order_in_q", False)
        if lpq:
            cc = itools.low_pass_cc_in_q(cc, float(lpq))
        lp = mod.get("low_pass_order", False)
        if lp or mod.get("enforce_max_order", False) \
                or mod.get("zero_odd_harmonics", False):
            # enforce_max_order caps at L; low_pass_order may tighten it
            caps = ([int(lp)] if lp else []) \
                + ([L] if mod.get("enforce_max_order", False) else [])
            cc = itools.zero_cc_harmonics(
                cc, max_order=min(caps) if caps else None,
                zero_odd=bool(mod.get("zero_odd_harmonics", False)))
        if mod.get("q1q2_symmetrize", False):
            cc, mask = itools.symmetrize_cc_q1q2(cc, mask)
        if mod.get("pi_periodicity", False):
            cc, mask = itools.enforce_pi_periodicity(cc, mask)
        if mod.get("binned_mean", False):
            cc, mask, phis = itools.binned_mean_cc(cc, mask, L, phis)
        if not bool(mask.all()):
            if mod.get("interpolate_masked", True):
                cc = itools.interpolate_masked_cc(cc, mask)
            else:
                cc = torch.where(mask, cc, torch.zeros_like(cc))

        if dim == 2:
            bl = itools.cc_to_deg2_invariant_2d(cc, L)
        else:
            bl = itools.cc_to_deg2_invariant_3d(
                cc, wavelength, qs, L,
                assume_zero_odd_orders=bool(ds_opt.get(
                    "assume_zero_odd_orders", True)),
                mode=str(ds_opt.get("bl_extraction_method",
                                    "back_substitution")))
        del cc
        if subtracted_avg:
            # B_0 = I_00 I_00* = 4π a(q1) a(q2); in 2D a(q1) a(q2)
            scale = 4 * np.pi if dim == 3 else 1.0
            bl[0] = (scale * torch.outer(avg, avg)).to(C128)
        bl_mask, qlim = self._bl_masks(ds_opt, qs, L)
        return bl, bl_mask, qlim

    def _bl_masks(self, ds_opt, qs, L):
        """bl_q_limits → (mask (L+1, n_q, n_q) on the device, q_id_limits
        (L+1, 2)): 'line' limits bound each order's q range; otherwise the
        global invariant_constraints.q_limits."""
        lim_opt = ds_opt.get("bl_q_limits", {})

        def line(side):
            s = lim_opt.get(side, {})
            if str(s.get("type", "none")) == "line":
                pts = s.get("line")
                return (tuple(float(v) for v in pts[0]),
                        tuple(float(v) for v in pts[1]))
            return None
        min_line, max_line = line("min"), line("max")
        if min_line is None and max_line is None:
            qlim = np.asarray(self._q_id_limits(L + 1, len(qs)))
            mask = torch.zeros((L + 1, len(qs), len(qs)), dtype=torch.bool,
                               device=self.device)
            for l in range(L + 1):
                lo, hi = qlim[l]
                mask[l, lo:hi, lo:hi] = True
            return mask, qlim
        return itools.line_q_id_limits(qs, L, min_line=min_line,
                                       max_line=max_line, device=self.device)

    def _invariants_to_output(self, bl, qs, wavelength, avg_intensity,
                              angular_points, q_limits=None, dim=3):
        """Projection matrices and the invariants archive's schema; bl is
        PSD-enforced (or PSD by construction). → (dict, V_l, eigenvalues);
        in 2D V_l is v_m as an (n_q, 1) column."""
        opt = self.settings
        if q_limits is None:
            q_limits = self._q_id_limits(bl.shape[0], len(qs))
        sort_mode = 1 if str(opt.get("bl_eig_sort_mode", "eigenvalue")) \
            == "median_of_scaled_eigenvector" else 0
        if dim == 2:
            vecs, eigs = itools.deg2_invariant_to_projection_vectors_2d(
                bl, sort_mode=sort_mode)
            proj = [v[:, None] for v in vecs]
            n_particles = float(opt.get("number_of_particles", {})
                                .get("value", 1))
            return self._output(2, bl, qs, wavelength, avg_intensity,
                                angular_points, proj, q_limits,
                                avg_intensity * 2 * np.sqrt(np.pi),
                                n_particles), proj, eigs
        proj, eigs = itools.deg2_invariant_to_projection_matrices(
            bl, q_id_limits=q_limits,
            rank_cap=bool(opt.get("projection_matrices", {})
                          .get("rank_cap", True)),
            sort_mode=sort_mode)
        L = bl.shape[0] - 1
        pp = opt.get("projection_matrices", {}).get("prephase", {})
        if bool(pp.get("apply", False)):
            proj, converged, n_iter = itools.enforce_sht_constraint(
                proj, self._fused_sht(L),
                iterations=int(pp.get("iterations", 10)) * 10)
            self.sht_constraint["prephase"] = dict(converged=converged,
                                                   iterations=n_iter)
            print(f"extract: prephasing "
                  f"{'converged' if converged else 'ran its budget'} "
                  f"after {n_iter} iterations")

        pn_opt = opt.get("number_of_particles", {})
        n_particles = float(pn_opt.get("value", 1))
        eopt = pn_opt.get("estimate", {})
        if bool(eopt.get("apply", False)):
            n_particles, grad, neg, scales = \
                itools.estimate_number_of_particles(
                    proj, self._fused_sht(L),
                    search_space=tuple(eopt.get("search_space",
                                                [1.0, 10.0, 64])),
                    average_intensity=avg_intensity,
                    method=str(eopt.get("method", "onset")))
            self.sht_constraint["number_of_particles"] = dict(
                value=n_particles, negative_fractions=neg, scales=scales,
                gradient=grad)
            print(f"extract: estimated number_of_particles = "
                  f"{n_particles:.3g}")

        # the low-resolution intensity coefficients the reconstruct
        # worker's low_resolution_autocorrelation guess reads: the first
        # orders' V_l, optionally SHT-constraint optimized, or with
        # max_order 0 the isotropic I_00 = a(q)·2√π
        lr_opt = opt.get("low_resolution_intensity_approximation", {})
        lr_max = min(int(lr_opt.get("max_order", 0)), L)
        if lr_max > 0:
            lr = [v.clone() for v in proj[: lr_max + 1]]
            if bool(opt.get("optimize_projection_matrices", {})
                    .get("use", False)):
                lr, converged, n_iter = itools.enforce_sht_constraint(
                    lr, self._fused_sht(lr_max),
                    iterations=int(lr_opt.get("n_iterations", 100)),
                    rel_err_limit=float(lr_opt.get("error_change_limit",
                                                   1e-5)))
                self.sht_constraint["low_resolution"] = dict(
                    converged=converged, iterations=n_iter)
            low_res = {str(l): v for l, v in enumerate(lr)}
        else:
            low_res = avg_intensity * 2 * np.sqrt(np.pi)
        return self._output(3, bl, qs, wavelength, avg_intensity,
                            angular_points, proj, q_limits, low_res,
                            n_particles), proj, eigs

    @staticmethod
    def _output(dim, bl, qs, wavelength, avg_intensity, angular_points, proj,
                q_limits, low_res, n_particles):
        """The invariants archive's schema."""
        return {
            "dimensions": dim,
            "xray_wavelength": wavelength,
            "max_order": bl.shape[0] - 1,
            "average_intensity": avg_intensity,
            "data_radial_points": qs,
            "data_angular_points": np.asarray(angular_points),
            "data_projection_matrices": {"I1I1": proj},
            "data_projection_matrices_q_id_limits": np.asarray(q_limits),
            "data_low_resolution_intensity_coefficients": low_res,
            "number_of_particles": n_particles,
        }

    def _fused_sht(self, l_max):
        """The SHT kernels of order l_max on the default grid of the JAX
        package's SphericalHarmonicTransform(l_max), on the worker's
        device (the plain transforms on the CPU)."""
        from xframe_tpu_torch.ops.fused_sht import FusedSHT
        from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
        return FusedSHT(SphericalHarmonicTransform(l_max,
                                                   device=self.device))

    def _q_id_limits(self, n_orders, n_q):
        ql = self.settings.get("invariant_constraints", {}).get("q_limits",
                                                                {})
        if str(ql.get("type", "none")) == "manual":
            lo, hi = ql["manual"]["limits"]
            hi = int(hi) if hi else n_q
            return [[int(lo), hi]] * n_orders
        return [[0, n_q]] * n_orders
