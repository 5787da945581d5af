"""The average worker: align multi-start reconstructions and average them.

Port of `xframe_tpu.projects.fxs.average` (3D and 2D): load reconstructions
(error-filtered) → center each (reciprocal phase ramp) → normalize → take
the lowest-error one as the reference → SO(3) alignment of the spherical
harmonic coefficients with point inversion → drop alignments above the l2
limit → average → PRTF, FSC and FQCB → an archive
(projects/fxs/store.py).

The candidates are one batch on one device: one centering call, one
correlation call over every candidate and its point inverse, one rotation
and synthesis call, through the port's `Aligner` (the SHT kernels B1 and B2
on the card). With more than one device the `mesh` settings spread the
candidates as the JAX package's `_make_mesh` does (mesh.restarts ranks,
clamped to the devices and the reconstructions; parallel/mesh.py): each
rank centers, normalizes and aligns the reference and its rows of the
wrap-padded candidates, the refinement stops when every rank's candidates
are within the l2 limit, and rank 0 gathers the rotated densities, l2s
and rotations and alone computes the metrics and writes the archive. The stored reciprocal amplitudes of each reconstruction ride
along and get the same shift, inversion and rotation, for the
data-relative PRTF variants. Everything stays on the device until the host
metrics (resolution_metrics.py, numpy) need it. In 2D the polar FT and
`Aligner2D` (circular correlation) take their place, the metrics average
over φ alone, and FQCB compares B_m with v_m v_m†.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from xframe_tpu_torch.ops.fourier import (PolarFourierTransform,
                                          SphericalFourierTransform)
from xframe_tpu_torch.ops.integrate import PolarIntegrator, SphericalIntegrator
from xframe_tpu_torch.projects.fxs import invariants as itools
from xframe_tpu_torch.projects.fxs import resolution_metrics as rm
from xframe_tpu_torch.parallel.mesh import make_mesh, run_ranks
from xframe_tpu_torch.projects.fxs.alignment import Aligner, Aligner2D
from xframe_tpu_torch.projects.fxs.reconstruct import (device_of,
                                                       load_cached_weights,
                                                       mesh_devices,
                                                       synchronize)
from xframe_tpu_torch.projects.fxs.store import ProjectStore


def _rank_run(mesh, settings):
    """One rank of a spawned mesh: the worker on the rank's device.
    → (results, saved) on rank 0."""
    w = ProjectWorker(settings, device=mesh.device, mesh=mesh)
    return w.run(), w.saved


class ProjectWorker:
    """average: reconstructions → one aligned, averaged density."""

    uses_mesh = True          # main.py hands it the mesh of --distributed

    def __init__(self, settings: dict, device="cuda", devices=None,
                 mesh=None):
        """devices, mesh: as the reconstruct worker's (the devices the
        candidates may spread over; a rank's mesh)."""
        self.settings = settings
        self.mesh = mesh
        self.device = device_of(mesh.device if mesh is not None else device)
        self.devices = mesh_devices(self.device, devices)
        self.store = ProjectStore(settings.get("structure_name", "default"),
                                  settings)
        self.saved = None

    def _make_mesh(self, n_candidates):
        """The candidates' mesh, as the JAX package's `_make_mesh`:
        mesh.restarts ranks ("all": every device), clamped to the devices
        and the candidates; None where that leaves one."""
        if len(self.devices) <= 1 or n_candidates <= 1:
            return None
        r = self.settings.get("mesh", {}).get("restarts", "all")
        n_r = len(self.devices) if (isinstance(r, str) and r == "all") \
            else int(r)
        n_r = max(1, min(n_r, n_candidates, len(self.devices)))
        return None if n_r <= 1 else make_mesh({"restarts": n_r},
                                               self.devices)

    def run(self):
        """→ the results dict; the archive's path and run number are kept
        in self.saved, the times in results["timing"]. Over a mesh the
        ranks run it and rank 0's results come back; on the other ranks of
        a mesh, None."""
        opt = self.settings
        routine = str(opt.get("load_routine", "load_reconstructions"))
        if routine != "load_reconstructions":
            raise NotImplementedError(
                f"load_routine {routine!r} is not ported; the port loads "
                "reconstructions only")
        t0 = time.perf_counter()
        recs, cfg = self._load_reconstructions()
        t_load = time.perf_counter() - t0
        densities, psis, errors, meta, masks = self._select(recs)
        if len(densities) == 0:
            raise RuntimeError("no reconstructions pass the selection filter")
        if self.mesh is None:
            mesh = self._make_mesh(len(densities))
            if mesh is not None:
                del recs, densities, psis, masks
                result, self.saved = run_ranks(mesh, _rank_run, opt)
                return result
        proj_per_file = [r.get("projection_matrices") for r in recs]
        t0 = time.perf_counter()
        result = self.average(densities, psis, errors, cfg, meta,
                              proj_per_file=proj_per_file, masks=masks)
        synchronize(self.device)
        if result is None:              # a rank other than 0
            return None
        t_avg = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.saved = self.store.save("average_results", result)
        t_save = time.perf_counter() - t0
        result["timing"] = dict(self.timing, load_s=t_load, average_s=t_avg,
                                save_s=t_save)
        print(f"average: aligned {len(result['aligned'])} of "
              f"{len(densities)} reconstructions; saved to {self.saved[0]}")
        return result

    # --------------------------------------------------------------- loading
    # result fields the averaging never reads, left on disk
    UNREAD = ("last_real_density", "initial_density", "last_support_mask",
              "initial_support", "fxs_unknowns")

    def _load_reconstructions(self):
        """reconstruction_files: run numbers or archive paths; none = the
        latest run."""
        files = list(self.settings.get("reconstruction_files", []) or [])
        load = self.store.load_reconstructions
        if not files:
            data = [load(skip=self.UNREAD)]
        else:
            data = [load(run=f, skip=self.UNREAD)
                    if isinstance(f, (int, np.integer))
                    else load(path=str(f), skip=self.UNREAD) for f in files]
        return data, data[0]["configuration"]

    def _select(self, recs):
        """Candidates within selection.error_limit (or the manual ids) and
        the density window, error-sorted, at most n_reconstructions; a
        manual_specifier moves its reconstruction to the front, where it is
        the reference. → (densities, ψs or None, errors, meta, masks or
        None)."""
        sel = self.settings.get("selection", {})
        limit = float(sel.get("error_limit", 1.0))
        n_max = sel.get("n_reconstructions", "all")
        metric = str(sel.get("error_metric", "final"))
        d_lo, d_hi = (sel.get("max_density_range", [None, None])
                      or [None, None])
        densities, psis, masks, errors, meta = [], [], [], [], []
        for fi, rec in enumerate(recs):
            for key, res in rec["reconstruction_results"].items():
                e = np.asarray(res["error_dict"].get(
                    metric, res["error_dict"]["final"]))
                err = float(e.reshape(-1)[-1]) if e.ndim else float(e)
                manual_ids = sel.get("manual_ids", None) or None
                if str(sel.get("method", "least_error")) == "manual" \
                        and manual_ids is not None:
                    if int(key) not in [int(i) for i in manual_ids]:
                        continue
                elif err > limit:
                    continue
                rho = np.asarray(res["real_density"])
                dmax = float(np.abs(rho.real).max())
                if not isinstance(d_lo, (bool, type(None))) \
                        and dmax < float(d_lo):
                    continue
                if not isinstance(d_hi, (bool, type(None))) \
                        and dmax > float(d_hi):
                    continue
                densities.append(rho)
                psi = res.get("reciprocal_density")
                psis.append(None if psi is None else np.asarray(psi))
                m = res.get("support_mask")
                masks.append(None if m is None else np.asarray(m))
                errors.append(err)
                meta.append({"file_index": fi, "result_key": key,
                             "error": err})
        order = np.argsort(errors)
        if not (isinstance(n_max, str) and n_max == "all"):
            order = order[: int(n_max)]
        if str(sel.get("method", "least_error")) == "manual" \
                and sel.get("manual_specifier") is not None:
            f_spec, k_spec = list(sel["manual_specifier"])[:2]
            pos = [j for j, i in enumerate(order)
                   if meta[i]["file_index"] == int(f_spec)
                   and str(meta[i]["result_key"]) == str(k_spec)]
            if not pos:
                raise RuntimeError(
                    f"selection.manual_specifier "
                    f"{list(sel['manual_specifier'])} does not match any "
                    "loaded reconstruction (after error/density filtering)")
            order = np.concatenate(([order[pos[0]]],
                                    np.delete(order, pos[0])))
        if any(p is None for p in psis):
            psis = None          # files without stored amplitudes
        else:
            psis = [psis[i] for i in order]
        masks = None if any(m is None for m in masks) \
            else [masks[i] for i in order]
        return ([densities[i] for i in order], psis,
                [errors[i] for i in order], [meta[i] for i in order], masks)

    # -------------------------------------------------------------- averaging
    def average(self, densities, psis, errors, cfg, meta, proj_per_file=None,
                masks=None):
        opt, dev = self.settings, self.device
        self.timing = {}
        t0 = time.perf_counter()
        grid_cfg = cfg["internal_grid"]
        rs = np.asarray(grid_cfg["real_grid"])
        qs = np.asarray(grid_cfg["reciprocal_grid"])
        thetas = np.asarray(grid_cfg.get("thetas", []))
        phis = np.asarray(grid_cfg["phis"])
        L = int(cfg.get("max_order", len(thetas) - 1))
        rc = float(cfg.get("reciprocity_coefficient", 2.0))
        dim = int(cfg.get("dimensions", 3))
        ft_mode = str(cfg.get("fourier_transform_mode", "midpoint"))
        q_max = float(cfg.get("q_max", 0) or
                      (qs[-1] + qs[0] if ft_mode == "midpoint" else qs[-1]))
        fr = opt.get("find_rotation", {})
        rl = fr.get("r_limit_ids", "all")
        r_ids = None if (isinstance(rl, str) and rl == "all") \
            else np.asarray(rl, dtype=int)
        weights = load_cached_weights(L, len(rs), rc, dim, ft_mode)
        if dim == 3:
            ft = SphericalFourierTransform(
                len(rs), L, q_max=q_max, mode=ft_mode,
                reciprocity_coefficient=rc, weights_dict=weights,
                n_theta=len(thetas), n_phi=len(phis), device=dev)
            integ = SphericalIntegrator(rs, len(thetas), len(phis),
                                        device=dev)
            lma = fr.get("l_max_align", "auto")
            aligner = Aligner(ft, integ._w, r_limit_ids=r_ids,
                              bandwidth=int(fr.get("so3_n_beta") or 0)
                              or None,
                              l_max_align=None if isinstance(lma, str)
                              else int(lma))
            theta_weights = ft.sht.gl_weights
        else:
            ft = PolarFourierTransform(len(rs), L, len(phis), q_max,
                                       mode=ft_mode,
                                       reciprocity_coefficient=rc,
                                       weights_dict=weights, device=dev)
            integ = PolarIntegrator(rs, len(phis), device=dev)
            aligner = Aligner2D(ft, integ._w, r_limit_ids=r_ids)
            theta_weights = None
        del weights
        self.ft, self.aligner = ft, aligner
        grid_dims = tuple(range(-dim, 0))

        have_psi = psis is not None
        # over a mesh: the reference (row 0) and this rank's rows of the
        # wrap-padded candidates 1…n−1
        mesh, n = self.mesh, len(densities)
        rows = np.arange(n) if mesh is None or n <= 1 \
            else np.concatenate([[0], 1 + mesh.rows(n - 1)])
        rho_stack = torch.as_tensor(np.stack(
            [densities[i] for i in rows]).astype(np.complex64), device=dev)
        psi_stack = torch.as_tensor(np.stack(
            [psis[i] for i in rows]).astype(np.complex64),
            device=dev) if have_psi else None

        # center; companions get the same phase ramp
        if bool(opt.get("center_reconstructions", True)):
            rho_stack, psi_stack, coms = aligner.center_batch(rho_stack,
                                                              psi_stack)
            if bool(opt.get("use_masks", False)) and masks is not None:
                # shift each support mask by its density's ramp and zero the
                # density where the shifted mask falls below the threshold
                thr = float(opt.get("shifted_mask_threshold", 0.5))
                m = torch.as_tensor(np.stack(
                    [masks[i] for i in rows]).astype(np.complex64),
                    device=dev)
                m_shift = ft.inverse(aligner.psi_shift(ft.forward(m),
                                                       coms)).real
                rho_stack = torch.where(m_shift >= thr, rho_stack,
                                        torch.zeros_like(rho_stack))

        # normalize ρ and its companion by the same factor
        nopt = opt.get("normalize_reconstructions", {})
        mode = str(nopt.get("mode", "max"))
        scaling_factors = np.ones(len(rows))
        if bool(nopt.get("use", True)):
            a = rho_stack.abs()
            s = a.amax(dim=grid_dims) if mode == "max" \
                else torch.clamp(a.mean(dim=grid_dims), min=1e-30)
            s = torch.clamp(s, min=1e-30)
            per = s.reshape((-1,) + (1,) * dim)
            rho_stack = rho_stack / per
            if have_psi:
                psi_stack = psi_stack / per
            scaling_factors = s.cpu().numpy().astype(float)

        # the reference: the lowest error, optionally point-inverted so that
        # the average takes the opposite handedness
        if bool(opt.get("pointinvert_reference", False)):
            ref_d = ft.inverse(ft.forward(rho_stack[0]).conj())
            rho_stack = torch.cat([ref_d[None], rho_stack[1:]])
            if have_psi:
                psi_stack = torch.cat([psi_stack[:1].conj(), psi_stack[1:]])
        else:
            ref_d = rho_stack[0]
        ref = ref_d.cpu().numpy()
        ref_coeff = aligner.coefficients(ref_d)

        lim = opt.get("alignment_error_limit", None)
        l2_limit = float(lim) if not isinstance(lim, (bool, type(None))) \
            else float(opt.get("l2_error_limit", 0.5))
        check_inv = bool(fr.get("check_point_inversion", True))
        max_iter = max(int(opt.get("max_iterations", 1)), 1)
        aligned = [ref]
        align_info = [{"angles": (0.0, 0.0, 0.0), "score": np.inf,
                       "inverted": False, "l2_to_ref": 0.0}]
        used_meta = [meta[0]]
        sel_idx = []                    # candidate rows within l2_limit
        rho_rot = psi_rot = None
        if rho_stack.shape[0] > 1:
            cand_psi = psi_stack[1:] if have_psi else None
            rho_rot, psi_rot, l2s, infos = aligner.align_batch(
                rho_stack[1:], ref_coeff, ref_rho=ref_d, psis=cand_psi,
                check_point_inversion=check_inv)
            # refinement: re-align the rotated candidates, keeping a
            # candidate's new rotation where its l2 to the reference fell
            for _ in range(max_iter - 1):
                done = bool((l2s <= l2_limit).all())
                if done if mesh is None else mesh.all_true(done):
                    break
                rho2, psi2, l2s2, _ = aligner.align_batch(
                    rho_rot, ref_coeff, ref_rho=ref_d, psis=psi_rot,
                    check_point_inversion=False)
                better = l2s2 < l2s
                pick = torch.as_tensor(better, device=dev).reshape(
                    (-1,) + (1,) * dim)
                rho_rot = torch.where(pick, rho2, rho_rot)
                if psi_rot is not None:
                    psi_rot = torch.where(pick, psi2, psi_rot)
                l2s = np.where(better, l2s2, l2s)
                for i, b in enumerate(better):
                    infos[i]["refined"] = bool(b) \
                        or infos[i].get("refined", False)
            if mesh is not None:
                got = self._gather_alignment(mesh, n, rho_rot, psi_rot, l2s,
                                             infos, scaling_factors)
                if got is None:
                    return None
                rho_rot, psi_rot, l2s, infos, scaling_factors = got
            rho_rot_h = rho_rot.cpu().numpy()
            for i, info in enumerate(infos):
                info["l2_to_ref"] = float(l2s[i])
                if l2s[i] > l2_limit:
                    continue
                sel_idx.append(i)
                aligned.append(rho_rot_h[i])
                align_info.append(info)
                used_meta.append(meta[i + 1])
        synchronize(dev)
        self.timing["align_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        def head_plus_selected(head, rows):
            if sel_idx:
                return torch.cat([head[None], rows[sel_idx]])
            return head[None]

        aligned_d = head_plus_selected(ref_d, rho_rot)
        avg_d = aligned_d.mean(dim=0)
        avg = avg_d.cpu().numpy()
        centered_avg = aligner.center(avg_d)[0].cpu().numpy()
        psi_avg = ft.forward(avg_d).cpu().numpy()
        # the reciprocal amplitudes of every aligned density
        psis_from_rho = ft.forward(aligned_d).cpu().numpy()
        intensity_from_density = np.mean(np.abs(psis_from_rho) ** 2, axis=0)
        if have_psi:
            psi_aligned_d = head_plus_selected(psi_stack[0], psi_rot)
            avg_ft_density = psi_aligned_d.mean(dim=0).cpu().numpy()
            intensity_from_ft_density = (psi_aligned_d.abs() ** 2).mean(
                dim=0).cpu().numpy()

        metrics = {}
        ropt = opt.get("resolution_metrics", {})
        # the angular axes: (θ, φ) in 3D, φ alone in 2D
        axes = None if dim == 3 else (-1,)
        prtf_axes = None if dim == 3 else (1,)
        if bool(ropt.get("PRTF", True)):
            prtf_vals = rm.prtf(psis_from_rho, theta_weights=theta_weights,
                                axes=axes)
            q_res, _ = rm.prtf_resolution(prtf_vals, qs)
            metrics["PRTF"] = prtf_vals
            metrics["PRTF_qs"] = qs
            metrics["PRTF_resolution_q"] = q_res
            p, s = rm.prtf_fxs(psi_avg, intensity_from_density,
                               axes=prtf_axes)
            metrics["PRTF_from_density"] = p
            metrics["PRTF_from_density_std"] = s
            if have_psi:
                p, s = rm.prtf_fxs(psi_avg, intensity_from_density,
                                   avg_ft_density, intensity_from_ft_density,
                                   axes=prtf_axes)
                metrics["PRTF_fxs"] = p
                metrics["PRTF_fxs_std"] = s
                p, s = rm.prtf_fxs(avg_ft_density, intensity_from_ft_density,
                                   axes=prtf_axes)
                metrics["PRTF_from_ft_density"] = p
                metrics["PRTF_from_ft_density_std"] = s
                p, s = rm.prtf_fxs(psi_avg, intensity_from_ft_density,
                                   axes=prtf_axes)
                metrics["PRTF_ftI"] = p
                metrics["PRTF_ftI_std"] = s
                # pseudo-FSC: the average's FT against the averaged
                # projected amplitude
                metrics["pseudo_FSC"] = np.abs(rm.fsc(
                    psi_avg, avg_ft_density, theta_weights, axes=axes))
        if bool(ropt.get("FSC", False)) and len(aligned) >= 2:
            half = len(aligned) // 2
            psi_a = np.mean(psis_from_rho[:half], axis=0)
            psi_b = np.mean(psis_from_rho[half:], axis=0)
            metrics["FSC"] = np.abs(rm.fsc(psi_a, psi_b, theta_weights,
                                           axes=axes))
            n_shell = max(len(thetas), 1) * len(phis) * np.ones(len(qs))
            metrics["FSC_half_bit"] = rm.half_bit_threshold(n_shell)

        proj_matrices = self._averaged_projection_matrices(
            proj_per_file, used_meta, scaling_factors, meta)
        if bool(ropt.get("FQCB", False)) and proj_matrices is not None:
            # invariant-space fidelity: B_l of the averaged density against
            # the data's B_l = V_l V_l† (in 2D B_m against v_m v_m†)
            intensity = np.abs(psi_avg) ** 2
            if dim == 3:
                b_rec = itools.harmonic_coeff_to_deg2_invariants_3d(
                    ft.harmonic.forward(torch.as_tensor(
                        intensity.astype(np.complex64), device=dev))
                    .cpu().numpy())
                b_target = itools.projection_matrices_to_deg2_invariant_3d(
                    proj_matrices)
            else:
                cm = np.fft.fft(intensity, axis=-1)[:, : L + 1] / len(phis)
                b_rec = itools.harmonic_coeff_to_deg2_invariants_2d(
                    torch.as_tensor(cm)).numpy()
                vecs = [np.atleast_2d(np.asarray(v)).reshape(len(qs), -1)
                        for v in proj_matrices]
                b_target = np.stack([v @ v.conj().T for v in vecs])
            f_q, f_std, _ = rm.fqcb(b_rec, b_target, skip_odd_orders=True)
            metrics["FQCB_from_density"] = f_q
            metrics["FQCB_from_density_std"] = f_std
            f_qz, f_stdz, _ = rm.fqcb(b_rec, b_target, skip_odd_orders=True,
                                      include_zero_order=True)
            metrics["FQCB_from_density_with_zero_order"] = f_qz
            metrics["FQCB_from_density_with_zero_order_std"] = f_stdz

        # min-max normalized density, with an optional fixed floor
        d_min = opt.get("average_normalization_min", False)
        d_min = float(np.real(avg).min()) if isinstance(d_min, bool) \
            else float(d_min)
        d_max = float(np.real(avg).max())
        norm_avg = (avg - d_min) / max(d_max - d_min, 1e-30)
        avg_group = {
            "real_density": avg,
            "normalized_real_density": norm_avg,
            # the mean of the aligned projected amplitudes where stored,
            # else the FT of the averaged density
            "reciprocal_density": (avg_ft_density if have_psi else psi_avg),
            "intensity_from_densities": intensity_from_density,
        }
        if have_psi:
            avg_group["intensity_from_ft_densities"] = \
                intensity_from_ft_density
        self.timing["metrics_s"] = time.perf_counter() - t0
        return {
            "average": avg_group,
            "centered_average": centered_avg,
            "aligned": {str(i): a for i, a in enumerate(aligned)},
            "input": {str(i): d for i, d in enumerate(densities)},
            "input_meta": {str(i): m for i, m in enumerate(used_meta)},
            "scaling_factors": scaling_factors,
            "resolution_metrics": metrics,
            "rotation_metric": {
                "angles": np.asarray([list(i["angles"]) for i in align_info]),
                "scores": np.asarray([i["score"] for i in align_info]),
                "inverted": np.asarray([i["inverted"] for i in align_info]),
                "l2_to_ref": np.asarray([i["l2_to_ref"]
                                         for i in align_info]),
            },
            "so3_grid": ({"alphas": aligner.corr.alphas,
                          "betas": aligner.corr.betas,
                          "gammas": aligner.corr.gammas} if dim == 3
                         else {"alphas": aligner.alphas}),
            "grid": {"rs": rs, "thetas": thetas, "phis": phis, "qs": qs},
        }

    def _gather_alignment(self, mesh, n, rho_rot, psi_rot, l2s, infos,
                          scaling_factors):
        """Every rank's aligned candidates to rank 0, padding trimmed to the
        n − 1 candidates. → on rank 0 (ρ rotated, ψ rotated or None, l2s,
        infos, scaling factors with the reference's first) on its device,
        elsewhere None."""
        arrays = {"rho_rot": rho_rot.cpu().numpy(), "l2": np.asarray(l2s),
                  "scale": scaling_factors[1:]}
        if psi_rot is not None:
            arrays["psi_rot"] = psi_rot.cpu().numpy()
        got = mesh.gather(arrays, name="alignment")
        infos = mesh.gather_objects(infos)
        if got is None:
            return None
        got = {k: v[: n - 1] for k, v in got.items()}
        psi = got.get("psi_rot")
        return (torch.as_tensor(got["rho_rot"], device=self.device),
                None if psi is None else torch.as_tensor(psi,
                                                         device=self.device),
                got["l2"], [i for part in infos for i in part][: n - 1],
                np.concatenate([scaling_factors[:1], got["scale"]]))

    @staticmethod
    def _averaged_projection_matrices(proj_per_file, used_meta,
                                      scaling_factors, all_meta):
        """V̄_l = mean over the files of V_l^(f) / s_f², s_f the mean
        normalization scale over all of file f's selected reconstructions
        (those the l2 filter drops included); only files with at least one
        used candidate enter the mean."""
        if not proj_per_file or proj_per_file[0] is None:
            return None
        used_files = sorted({m["file_index"] for m in used_meta})
        usable = [f for f in used_files if proj_per_file[f] is not None]
        if not usable:
            return None
        file_scale = {}
        for f in usable:
            ids = [i for i, m in enumerate(all_meta) if m["file_index"] == f]
            file_scale[f] = float(np.mean(scaling_factors[ids])) if ids \
                else 1.0

        def as_list(pm):
            if isinstance(pm, dict):
                return [np.asarray(pm[k]) for k in
                        sorted(pm, key=lambda x: int(x))]
            return [np.asarray(v) for v in pm]

        stacks = {f: as_list(proj_per_file[f]) for f in usable}
        n_l = min(len(s) for s in stacks.values())
        out = []
        for l in range(n_l):
            acc = None
            for f in usable:
                v = stacks[f][l] / file_scale[f] ** 2
                acc = v if acc is None else acc + v
            out.append(acc / len(usable))
        return out
