"""Carry tables and state across from the JAX package as host arrays.

`mtip_arrays(mtip)` reads the host arrays of an `xframe_tpu` MTIP (duck
typed: np.asarray on its attributes, without importing jax);
`mtip_from_numpy(arrays, config, device)` builds the port's MTIP from them,
so that both packages run on identical tables; a 2D (polar) MTIP carries
ReciprocalConstraintPolar's tensors and the polar Hankel tables instead.
Both carry the options: the error configuration and its deg-2 reference,
the particle-number tables, the fixed-volume shrink-wrap and the linked
ft-stab history's length. `state_arrays(state)` reads
the host arrays of a JAX-package PhasingState, replay anchors and the
enforce history included, and
`state_from_numpy` builds the port's PhasingState from host arrays, so that
both packages can continue from one mid-run state. `save_ccd`,
`save_invariants` and `save_reconstructions` write the JAX workers'
cross-correlation, invariants and reconstructions dicts as the port's
`.npz` archives (projects/fxs/store.py),
so that both packages' workers run on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from xframe_tpu_torch.ops.fourier import (PolarFourierTransform,
                                          SphericalFourierTransform)
from xframe_tpu_torch.ops.fused_sht import FusedSHT
from xframe_tpu_torch.ops.hankel import (PolarHankelTransform,
                                         SphericalHankelTransform)
from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
from xframe_tpu_torch.projects.fxs.phasing import MTIP, PhasingState
from xframe_tpu_torch.projects.fxs.projections import (
    RealCircularHarmonics, ReciprocalConstraint, ReciprocalConstraintPolar,
    RealConstraint, ShrinkWrap,
)
from xframe_tpu_torch.projects.fxs.store import save_npz

_FUSED = ("E_re", "E_im", "I_re", "I_im", "PW", "P_t")
INVARIANT_KEYS = ("data_radial_points", "max_order", "average_intensity",
                  "xray_wavelength", "dimensions", "number_of_particles",
                  "data_projection_matrices_q_id_limits",
                  "data_low_resolution_intensity_coefficients")


def _host_tree(tree):
    """Nested dicts and lists of array-likes (jax arrays among them) →
    dicts, lists and numpy arrays."""
    if isinstance(tree, dict):
        return {str(k): _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    if tree is None or isinstance(tree, (str, bool, int, float, complex)):
        return tree
    return np.asarray(tree)


CCD_KEYS = ("dimensions", "radial_points", "angular_points",
            "xray_wavelength", "average_intensity", "cross_correlation",
            "num_images_processed", "num_images_good")


def save_ccd(ccd, path):
    """A JAX simulate_ccd result (or ProjectDB.load_ccd) → a ccd archive at
    `path`, the extract worker's input."""
    save_npz(path, _host_tree({k: ccd[k] for k in CCD_KEYS
                               if ccd.get(k) is not None}))


def save_invariants(inv, path):
    """The keys of a JAX extract result (or ProjectDB.load_invariants) that
    the reconstruct worker reads → an invariants archive at `path`."""
    data = {k: inv[k] for k in INVARIANT_KEYS if inv.get(k) is not None}
    data["data_projection_matrices"] = {
        k: [np.asarray(v) for v in vs]
        for k, vs in inv["data_projection_matrices"].items()}
    save_npz(path, _host_tree(data))


def save_reconstructions(results, path):
    """A JAX reconstruct result → a reconstructions archive at `path`."""
    save_npz(path, _host_tree(results))


def _real_config(mtip):
    """The scalars of an MTIP's real constraint, shrink-wrap, gauge, error
    configuration, particle-number estimate and linked ft-stab."""
    real, sw, rc = mtip.real, mtip.sw, mtip.rc
    deg2 = getattr(mtip, "_deg2_ref", None)
    error_config = dict(
        real=list(mtip._real_metrics), reciprocal=list(mtip._rec_metrics),
        real_inside_initial_support=bool(mtip._err_real_masked),
        main={"metrics": {"real": list(mtip._main_metrics[0]),
                          "reciprocal": list(mtip._main_metrics[1])},
              "type": mtip._main_type})
    if deg2 is not None:
        error_config["deg2_order"] = int(deg2[0])
    return dict(
        precision="float64" if "float64" in str(getattr(mtip, "rdtype", ""))
        else "float32",
        threshold_low=real.threshold_low, threshold_high=real.threshold_high,
        limit_imag=real.limit_imag, apply_support=real.apply_support,
        apply_value_threshold=real.apply_value_threshold,
        apply_limit_imag=real.apply_limit_imag,
        apply_assert_real=real.apply_assert_real,
        considered_projections=tuple(real.considered_projections),
        enforce_limit=mtip.enforce_limit, n_particles=rc.n_particles,
        default_sigma=sw.default_sigma, sw_mode=sw.mode,
        sw_volume_fraction=float(sw.volume_fraction),
        sw_fixed_volume_method=sw.fixed_volume_method,
        sw_max_volume_change=sw.max_volume_change,
        fix_global_phase=mtip.fix_global_phase, best_mode=mtip.best_mode,
        error_config=error_config,
        pn_project=bool(getattr(rc, "pn_project", False)),
        pn_estimate_in=getattr(mtip, "_pn_estimate_in", None),
        link_hist_len=int(getattr(mtip, "_link_hist_len", 0)))


def _option_arrays(mtip):
    """The host arrays of an MTIP's options: the fixed-volume weights, the
    deg-2 reference (B_k and its mask) and the particle-number tables,
    where the MTIP has them."""
    sw, rc = mtip.sw, mtip.rc
    a = {}
    if sw.vol_weights is not None:
        a["sw_vol_weights"] = sw.vol_weights
        a["sw_initial_support"] = sw.initial_support
    deg2 = getattr(mtip, "_deg2_ref", None)
    if deg2 is not None:
        a["deg2_B"], a["deg2_mask"] = deg2[1], deg2[2]
    if getattr(rc, "pn_s", None) is not None:
        for k in ("pn_s", "pn_Ns", "pn_x", "pn_a"):
            a[k] = getattr(rc, k)
    return a


def _mtip_arrays_2d(mtip):
    ft, rc = mtip.ft, mtip.rc
    a = {"h_wf": ft.hankel._wf, "h_wi": ft.hankel._wi, "rs": ft.rs,
         "qs": ft.qs, "V": rc.V, "VD": rc.VD, "use_order": rc.use_order,
         "radial_mask": rc.radial_mask,
         "initial_support": mtip.initial_support, "w_err": mtip._w_err_host,
         "w_rec": mtip._w_rec_host, "q_radii": mtip.sw.q_radii,
         **_option_arrays(mtip)}
    config = dict(_real_config(mtip), dimensions=2, m_max=ft.m_max,
                  n_q=len(ft.qs), n_phi=ft.n_phi, r_max=float(ft.r_max),
                  q_max=float(ft.q_max), hankel_mode=ft.hankel.mode,
                  so_pin_order=rc.so_pin_order, fused_pipeline=False)
    return {k: np.asarray(v) for k, v in a.items()}, config


def mtip_arrays(mtip):
    """(arrays, config) of a JAX-package MTIP: the Hankel, SHT and FusedSHT
    tables (m-padding rows dropped), the reciprocal constraint's tensors,
    supports and weights, and whether it runs the fused iteration. For a
    2D MTIP (ReciprocalConstraintPolar): the polar Hankel tables, V, VD,
    use_order, radial_mask, the SO(2) pin, supports and weights."""
    if hasattr(mtip.rc, "VD"):
        return _mtip_arrays_2d(mtip)
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
         "q_radii": sw.q_radii, **_option_arrays(mtip)}
    fused = ft._fused
    if fused is not None:
        # bf16 tables (ml_dtypes arrays) go to float32 on the host: exact
        for name in _FUSED:
            a["fused_" + name] = np.asarray(getattr(fused, "_" + name))[
                :n_m].astype(np.float32)
    arrays = {k: np.asarray(v) for k, v in a.items()}
    config = dict(
        _real_config(mtip), dimensions=3,
        l_max=sht.l_max, n_q=len(ft.qs), n_theta=sht.n_theta,
        n_phi=sht.n_phi, r_max=float(ft.r_max), q_max=float(ft.q_max),
        hankel_mode=ft.hankel.mode,
        procrustes_method=rc.procrustes_method,
        ns_iterations=rc.ns_iterations, ns_schedule=rc.ns_schedule,
        fused_pipeline=mtip._fi is not None,
        k2_fwd=bool(mtip._k2_fwd), k1_abs2=bool(mtip._k1_abs2),
        table_dtype=None if fused is None else fused.table_dtype.name)
    return arrays, config


def _real_dtype(config):
    """The torch real dtype of config["precision"] (float32 by default)."""
    return torch.float64 if config.get("precision") == "float64" \
        else torch.float32


def _real_parts(arrays, config, device):
    """(RealConstraint, ShrinkWrap) from config and the q radii."""
    real = RealConstraint(
        apply_support=config["apply_support"],
        apply_value_threshold=config["apply_value_threshold"],
        threshold_low=config["threshold_low"],
        threshold_high=config["threshold_high"],
        apply_limit_imag=config["apply_limit_imag"],
        limit_imag=config["limit_imag"],
        apply_assert_real=config["apply_assert_real"],
        considered_projections=config["considered_projections"])
    def tensor(name, dtype):
        return torch.as_tensor(np.asarray(arrays[name], dtype), device=device) \
            if name in arrays else None
    rdt = np.float64 if config.get("precision") == "float64" else np.float32
    sw = ShrinkWrap(
        q_radii=tensor("q_radii", rdt),
        default_sigma=config["default_sigma"], mode=config["sw_mode"],
        volume_fraction=config["sw_volume_fraction"],
        vol_weights=tensor("sw_vol_weights", rdt),
        initial_support=tensor("sw_initial_support", bool),
        fixed_volume_method=config["sw_fixed_volume_method"],
        max_volume_change=config["sw_max_volume_change"])
    return real, sw


def _with_options(mtip, arrays, config):
    """Set the carried deg-2 reference and linked ft-stab length on the
    port's MTIP. → mtip."""
    if "deg2_B" in arrays:
        k, _, _, _ = mtip._deg2_ref
        B = torch.as_tensor(np.array(arrays["deg2_B"])).to(mtip.cdtype)
        norm = float((B * B.conj()).real.sum())
        mtip._deg2_ref = (k, B.to(mtip.device),
                          torch.as_tensor(np.array(arrays["deg2_mask"]),
                                          device=mtip.device),
                          norm if norm > 0 else float("inf"))
    mtip._link_hist_len = int(config.get("link_hist_len", 0))
    return mtip


def _mtip_from_numpy_2d(arrays, config, device):
    real_dtype = _real_dtype(config)
    hankel = PolarHankelTransform.from_tables(
        arrays["h_wf"], arrays["h_wi"], config["hankel_mode"],
        real_dtype=real_dtype, device=device)
    ft = PolarFourierTransform.from_parts(
        arrays["rs"], arrays["qs"], config["r_max"], config["q_max"],
        config["n_phi"], hankel)
    rc = ReciprocalConstraintPolar.from_numpy(
        arrays["V"], arrays["VD"], arrays["use_order"], arrays["radial_mask"],
        n_particles=config["n_particles"], m_max=config["m_max"],
        so_pin_order=config["so_pin_order"], real_dtype=real_dtype,
        device=device)
    real, sw = _real_parts(arrays, config, device)
    return _with_options(MTIP(
        ft, rc, real, sw, arrays["w_err"], arrays["initial_support"],
        enforce_initial_support_limit=config["enforce_limit"],
        fix_global_phase=config["fix_global_phase"],
        reciprocal_weights=arrays["w_rec"],
        harmonic=RealCircularHarmonics(config["n_phi"], config["m_max"]),
        best_mode=config.get("best_mode", "eager"),
        error_config=config["error_config"], real_dtype=real_dtype,
        device=device), arrays, config)


def mtip_from_numpy(arrays, config, device):
    """The port's MTIP built from host arrays and scalars (see mtip_arrays
    for the keys); the transforms' own tables are replaced by the given
    ones; config["fused_pipeline"] picks the fused or the stepwise
    iteration, config["k2_fwd"] and config["k1_abs2"] the fused one's
    variants, config["best_mode"] (default eager) the best tracking. Without
    FusedSHT tables in `arrays` (a JAX problem built with
    fused_sht=False) the kernel tables are built from the SHT tables.
    config["precision"] "float64" (a JAX MTIP under x64 with real_dtype
    float64) builds a float64 MTIP on the plain transforms, as the JAX
    package's. config["table_dtype"] "bfloat16" (a JAX FusedSHT with bf16
    tables) gives the FusedSHT bf16 Legendre tables, those of `arrays`
    (exact in float32), and keeps the port's float32 DFT tables.
    config["dimensions"] == 2 builds the 2D MTIP."""
    device = torch.device(device)
    if config.get("dimensions", 3) == 2:
        return _mtip_from_numpy_2d(arrays, config, device)
    L = config["l_max"]
    real_dtype = _real_dtype(config)
    sht = SphericalHarmonicTransform(L, config["n_theta"], config["n_phi"],
                                     real_dtype=real_dtype, device=device)
    sht.set_tables(arrays["sht_P"], arrays["sht_PW"])
    harmonic = sht
    if real_dtype == torch.float32:
        bf16 = config.get("table_dtype") == "bfloat16"
        harmonic = FusedSHT(sht, table_dtype=torch.bfloat16 if bf16
                            else torch.float32)
        if "fused_E_re" in arrays:
            tables = [arrays["fused_" + n] for n in _FUSED]
            if bf16:
                # the JAX package's bf16 DFT tables: the port's DFTs stay
                # float32 and keep its own
                tables[:4] = [None] * 4
            harmonic.set_tables(*tables)
    hankel = SphericalHankelTransform.from_tables(
        arrays["h_wf"], arrays["h_wi"], config["hankel_mode"],
        real_dtype=real_dtype, device=device)
    ft = SphericalFourierTransform.from_parts(
        arrays["rs"], arrays["qs"], config["r_max"], config["q_max"],
        harmonic, hankel)
    rc = ReciprocalConstraint.from_numpy(
        arrays["V_pad"], arrays["PD"], arrays["eye_diag"],
        arrays["use_order"], arrays["radial_mask"],
        n_particles=config["n_particles"], l_max=L,
        procrustes_method=config["procrustes_method"],
        ns_iterations=config["ns_iterations"],
        ns_schedule=config["ns_schedule"],
        pn_project=config["pn_project"], real_dtype=real_dtype,
        device=device, **{k: arrays[k] for k in ("pn_s", "pn_Ns", "pn_x",
                                                 "pn_a") if k in arrays})
    real, sw = _real_parts(arrays, config, device)
    return _with_options(MTIP(
        ft, rc, real, sw, arrays["w_err"], arrays["initial_support"],
        enforce_initial_support_limit=config["enforce_limit"],
        fix_global_phase=config["fix_global_phase"],
        fused_pipeline=config["fused_pipeline"],
        reciprocal_weights=arrays["w_rec"], k2_fwd=config["k2_fwd"],
        k1_abs2=config["k1_abs2"], best_mode=config.get("best_mode", "eager"),
        error_config=config["error_config"],
        pn_estimate_in=config["pn_estimate_in"], real_dtype=real_dtype,
        device=device), arrays, config)


# each field's kind: complex, real (at rho's precision), or a fixed dtype
_STATE_DTYPES = dict(
    rho="c", support=bool, best_rho="c", best_mask=bool, best_err="r",
    last_err="r", err_snapshot="r", anchor_rho="c", anchor_sup=bool,
    anchor_z="c", anchor_z2="c", anchor_start=np.int32,
    anchor_len=np.int32, anchor_gate=np.float32, enforce_hist=bool)
_ANCHORS = tuple(k for k in _STATE_DTYPES if k.startswith("anchor_"))


def state_arrays(state):
    """Host arrays of a PhasingState's fields (either package's; fields
    that are None are left out)."""
    out = {}
    for k in _STATE_DTYPES:
        v = getattr(state, k, None)
        if v is not None:
            out[k] = v.cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    return out


def state_from_numpy(rho, support, device, best_rho=None, best_mask=None,
                     best_err=None, last_err=None, err_snapshot=None,
                     enforce_hist=None, **anchors):
    """PhasingState from host arrays with a leading restart axis; missing
    best fields start from rho/support with infinite errors. enforce_hist:
    the linked ft-stab history (B, D). `anchors`: replay's anchor_*
    fields, all or none (anchor_gate defaults to 1). A complex128 rho (a
    float64 run) keeps complex128 and float64 fields, any other complex64
    and float32."""
    dev = torch.device(device)
    wide = np.asarray(rho).dtype == np.complex128
    kinds = {"c": np.complex128 if wide else np.complex64,
             "r": np.float64 if wide else np.float32}

    def tensor(name, x):
        # a C-ordered copy: arrays read from JAX are not writable, and a
        # broadcast view would keep another layout, which changes the order
        # of later sums
        dtype = _STATE_DTYPES[name]
        return torch.as_tensor(np.array(x, kinds.get(dtype, dtype),
                                        order="C"), device=dev)
    rho = tensor("rho", rho)
    sup = tensor("support", support).expand(rho.shape)
    n = rho.shape[0]
    inf = torch.full((n,), torch.inf, dtype=torch.float64 if wide
                     else torch.float32, device=dev)
    state = PhasingState(
        rho=rho, support=sup,
        best_rho=rho if best_rho is None else tensor("best_rho", best_rho),
        best_mask=sup if best_mask is None else tensor("best_mask",
                                                       best_mask),
        best_err=inf if best_err is None else tensor("best_err", best_err),
        last_err=inf if last_err is None else tensor("last_err", last_err),
        err_snapshot=None if err_snapshot is None
        else tensor("err_snapshot", err_snapshot),
        enforce_hist=None if enforce_hist is None
        else tensor("enforce_hist", enforce_hist))
    if not anchors:
        return state
    anchors.setdefault("anchor_gate", np.ones(n, np.float32))
    if set(anchors) != set(_ANCHORS):
        raise ValueError(f"anchor fields {sorted(anchors)} are not "
                         f"{sorted(_ANCHORS)}")
    return state._replace(**{k: tensor(k, v).contiguous()
                             for k, v in anchors.items()})
