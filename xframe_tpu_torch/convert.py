"""Carry tables and state across from the JAX package as host arrays.

`mtip_arrays(mtip)` reads the host arrays of an `xframe_tpu` MTIP (duck
typed: np.asarray on its attributes, without importing jax);
`mtip_from_numpy(arrays, config, device)` builds the port's MTIP from them,
so that both packages run on identical tables. `state_from_numpy` builds the
port's PhasingState from host arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from xframe_tpu_torch.ops.fourier import SphericalFourierTransform
from xframe_tpu_torch.ops.fused_sht import FusedSHT
from xframe_tpu_torch.ops.hankel import SphericalHankelTransform
from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
from xframe_tpu_torch.projects.fxs.phasing import MTIP, PhasingState
from xframe_tpu_torch.projects.fxs.projections import (
    ReciprocalConstraint, RealConstraint, ShrinkWrap,
)

_FUSED = ("E_re", "E_im", "I_re", "I_im", "PW", "P_t")


def mtip_arrays(mtip):
    """(arrays, config) of a JAX-package MTIP: the Hankel, SHT and FusedSHT
    tables (m-padding rows dropped), the reciprocal constraint's tensors,
    supports and weights, and whether it runs the fused iteration."""
    ft, rc, real, sw = mtip.ft, mtip.rc, mtip.real, mtip.sw
    sht = ft.sht
    n_m = sht.n_m
    a = {"h_wf": ft.hankel._wf, "h_wi": ft.hankel._wi,
         "sht_P": sht._P, "sht_PW": sht._PW,
         "rs": ft.rs, "qs": ft.qs,
         "V_pad": rc.V_pad, "PD": rc.PD, "eye_diag": rc.eye_diag,
         "use_order": rc.use_order, "radial_mask": rc.radial_mask,
         "initial_support": mtip.initial_support,
         "w_err": mtip._w_err_host, "w_rec": mtip._w_rec_host,
         "q_radii": sw.q_radii}
    fused = ft._fused
    if fused is not None:
        for name in _FUSED:
            a["fused_" + name] = np.asarray(getattr(fused, "_" + name))[:n_m]
    arrays = {k: np.asarray(v) for k, v in a.items()}
    config = dict(
        l_max=sht.l_max, n_q=len(ft.qs), n_theta=sht.n_theta,
        n_phi=sht.n_phi, r_max=float(ft.r_max), q_max=float(ft.q_max),
        hankel_mode=ft.hankel.mode,
        threshold_low=real.threshold_low, threshold_high=real.threshold_high,
        limit_imag=real.limit_imag, apply_support=real.apply_support,
        apply_value_threshold=real.apply_value_threshold,
        apply_limit_imag=real.apply_limit_imag,
        apply_assert_real=real.apply_assert_real,
        considered_projections=tuple(real.considered_projections),
        enforce_limit=mtip.enforce_limit, n_particles=rc.n_particles,
        procrustes_method=rc.procrustes_method,
        ns_iterations=rc.ns_iterations, ns_schedule=rc.ns_schedule,
        default_sigma=sw.default_sigma, sw_mode=sw.mode,
        fix_global_phase=mtip.fix_global_phase,
        fused_pipeline=mtip._fi is not None,
        k2_fwd=bool(mtip._k2_fwd), k1_abs2=bool(mtip._k1_abs2))
    return arrays, config


def mtip_from_numpy(arrays, config, device):
    """The port's MTIP built from host arrays and scalars (see mtip_arrays
    for the keys); the transforms' own tables are replaced by the given
    ones; config["fused_pipeline"] picks the fused or the stepwise
    iteration, config["k2_fwd"] and config["k1_abs2"] the fused one's
    variants. Without FusedSHT tables in `arrays` (a JAX problem built with
    fused_sht=False) the kernel tables are built from the SHT tables."""
    device = torch.device(device)
    L = config["l_max"]
    sht = SphericalHarmonicTransform(L, config["n_theta"], config["n_phi"],
                                     device=device)
    sht.set_tables(arrays["sht_P"], arrays["sht_PW"])
    fused = FusedSHT(sht)
    if "fused_E_re" in arrays:
        fused.set_tables(*(arrays["fused_" + n] for n in _FUSED))
    hankel = SphericalHankelTransform.from_tables(
        arrays["h_wf"], arrays["h_wi"], config["hankel_mode"], device=device)
    ft = SphericalFourierTransform.from_parts(
        arrays["rs"], arrays["qs"], config["r_max"], config["q_max"], fused,
        hankel)
    rc = ReciprocalConstraint.from_numpy(
        arrays["V_pad"], arrays["PD"], arrays["eye_diag"],
        arrays["use_order"], arrays["radial_mask"],
        n_particles=config["n_particles"], l_max=L,
        procrustes_method=config["procrustes_method"],
        ns_iterations=config["ns_iterations"],
        ns_schedule=config["ns_schedule"], device=device)
    real = RealConstraint(
        apply_support=config["apply_support"],
        apply_value_threshold=config["apply_value_threshold"],
        threshold_low=config["threshold_low"],
        threshold_high=config["threshold_high"],
        apply_limit_imag=config["apply_limit_imag"],
        limit_imag=config["limit_imag"],
        apply_assert_real=config["apply_assert_real"],
        considered_projections=config["considered_projections"])
    sw = ShrinkWrap(
        q_radii=torch.as_tensor(np.asarray(arrays["q_radii"], np.float32),
                                device=device),
        default_sigma=config["default_sigma"], mode=config["sw_mode"])
    return MTIP(ft, rc, real, sw, arrays["w_err"], arrays["initial_support"],
                enforce_initial_support_limit=config["enforce_limit"],
                fix_global_phase=config["fix_global_phase"],
                fused_pipeline=config["fused_pipeline"],
                reciprocal_weights=arrays["w_rec"],
                k2_fwd=config["k2_fwd"], k1_abs2=config["k1_abs2"],
                device=device)


def state_from_numpy(rho, support, device, best_rho=None, best_mask=None,
                     best_err=None, last_err=None):
    """PhasingState from host arrays with a leading restart axis; missing
    best fields start from rho/support with infinite errors."""
    dev = torch.device(device)
    rho = torch.as_tensor(np.asarray(rho, np.complex64), device=dev)
    sup = torch.as_tensor(np.asarray(support, bool), device=dev).expand(
        rho.shape)
    n = rho.shape[0]

    def opt(x, like, dtype):
        return like if x is None else torch.as_tensor(np.asarray(x, dtype),
                                                      device=dev)
    inf = torch.full((n,), torch.inf, device=dev)
    return PhasingState(rho=rho, support=sup,
                        best_rho=opt(best_rho, rho, np.complex64),
                        best_mask=opt(best_mask, sup, bool),
                        best_err=opt(best_err, inf, np.float32),
                        last_err=opt(last_err, inf, np.float32))
