"""The MTIP phasing loop in PyTorch.

Port of `xframe_tpu.projects.fxs.phasing`: the schedule (`Segment`,
`build_schedule`), the state, and `MTIP` with its two iterations:

  * the fused iteration `_mtip_iteration_fused`, the default as in the JAX
    package: the SHT analysis of ρ, then the kernels of `ops/fused_mtip.py`
    and `FusedSHT.forward_real_abs2` around the batched per-order
    Procrustes and one Hankel inverse;
  * the stepwise `mtip_iteration` (`fused_pipeline=False`, the 2D
    polar pipeline, whose transforms have no kernels, and, as in the JAX
    package, a non-default error configuration or the particle-number
    estimate): 2 FTs + an intensity harmonic pair + the batched data
    projection + elementwise projections.

Linked ft-stab (`link_to_enforce_initial_support`) runs on both: each
restart carries the enforce flags of its last D shrink-wraps
(`PhasingState.enforce_hist`), and a linked segment scales its ft-stab
correction by the 0/1 gate they give (`MTIP._ft_gate`).

`MTIP.finalize` recomputes ψ_p and the unknowns W for an output density.
Shrink-wrap (with SW_center's center-of-mass shift once `enable_centering`
has the grid's cartesian tables), snapshot/reset-to-best and eager best
tracking serve both; the
fused iteration also tracks the best in replay mode (`best_mode="replay"`):
an anchor per restart and a replay of at most REPLAY_ANCHOR_CHUNK − 1
iterations when the best is needed, in place of a grid-sized select per
iteration. Restarts are the leading axis of every state tensor, the grid
(r,θ,φ) or (r,φ) the rest; segments run
as Python loops, and nothing waits for the device inside the loop: the phase
anchor, every sum and the anchor bookkeeping stay on the device, one value
per restart. Materialising a replayed best reads the anchors' positions
once. Under a profiler each segment, iteration, projection, shrink-wrap and
replay is a named range (`xframe_tpu_torch.tracing.span`).

`MTIP.theta_shard` gives the stepwise MTIP on a θ shard of the 3D grid
(the JAX package's `mesh.theta` on its plain transforms): the rank's θ
rows of the state, the weights and the supports; the analyses and every
reduction over the grid (`_grid_reduce`, the shrink-wrap's max and min)
reduced over the θ ranks through one projections.ThetaShard, so that
every decision is taken on the same bits on each of them.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from xframe_tpu_torch.library.ramps import ExponentialRamp, LinearRamp
from xframe_tpu_torch.ops.fused_mtip import FusedIteration
from xframe_tpu_torch.ops.fused_sht import FusedSHT
from xframe_tpu_torch.ops.integrate import PolarIntegrator, SphericalIntegrator
from xframe_tpu_torch.projects.fxs.projections import (
    RealConstraint, ShrinkWrap, project_to_modified_intensity, hio_update,
    er_update, raar_update, grid_reduce, ThetaShard,
)
from xframe_tpu_torch.tracing import span

@dataclass
class Segment:
    """One contiguous run of a single method in the flattened schedule."""
    method: str                 # 'HIO' | 'ER' | 'RAAR' | 'SW' | markers
    n: int = 1
    betas: Any = None           # (n,) float array for HIO/RAAR
    ft_stab: bool = False
    sigma: float = 0.0          # SW gaussian sigma
    threshold: float = 0.0      # SW relative threshold
    ft_stab_link_delay: int = 0


def build_schedule(main_loop_opt, hio_beta_opt, sw_sigmas_opt,
                   sw_thresholds_opt, method_ft_stab, default_sigma):
    """Flatten the sub-loops tree into Segments (same semantics as
    `xframe_tpu.projects.fxs.phasing.build_schedule`, including β and
    shrink-wrap ramps, best_density_not_in_first_n_iterations markers and
    per-method ft_stab)."""
    segments = []
    for loop_id, loop_name in enumerate(main_loop_opt['order']):
        loop = main_loop_opt[loop_name]
        beta_spec = hio_beta_opt[loop_id] if loop_id < len(hio_beta_opt) \
            else [0.5, 0.5, -1 / 700, 1600]
        beta_ramp = ExponentialRamp(*beta_spec)
        sigma_spec = sw_sigmas_opt[loop_id] if loop_id < len(sw_sigmas_opt) \
            else False
        if not isinstance(sigma_spec, (list, tuple)):
            sigma_spec = [sigma_spec]
        sigma_ramp = LinearRamp(*sigma_spec, default_start=default_sigma,
                                default_stop=default_sigma)
        th_spec = sw_thresholds_opt[loop_id] \
            if loop_id < len(sw_thresholds_opt) else 0.1
        if not isinstance(th_spec, (list, tuple)):
            th_spec = [th_spec]
        th_ramp = LinearRamp(*th_spec)

        def ramp_val(ramp, x, default):
            v = ramp(x)
            return default if (ramp.undefined or not np.isfinite(v)) \
                else float(v)

        step = 0
        sw_step = 0
        n_first = loop.get('best_density_not_in_first_n_iterations', None) \
            if hasattr(loop, 'get') else None
        if n_first is not None and (n_first is False
                                    or not np.isfinite(float(n_first))):
            n_first = None
        n_iters = int(loop['iterations'])
        if n_first is not None and int(n_first) >= n_iters:
            n_first = None
        for it in range(n_iters):
            if n_first is not None and it == int(n_first):
                segments.append(Segment(method='SNAPSHOT'))
            for method in loop['order']:
                mopt = loop['methods'][method]
                if hasattr(mopt, 'get'):
                    repeats = int(mopt.get('iterations', 0))
                else:
                    repeats = int(mopt)
                if method in ('SW', 'SW_center'):
                    for _ in range(repeats):
                        segments.append(Segment(
                            method=method,
                            sigma=ramp_val(sigma_ramp, sw_step, default_sigma),
                            threshold=ramp_val(th_ramp, sw_step, 0.1)))
                        sw_step += 1
                else:
                    base = method.replace('_non_FXS', '')
                    betas = np.array([beta_ramp(step + i)
                                      for i in range(repeats)],
                                     dtype=np.float64)
                    step += repeats
                    fts = mopt.get('ft_stab', None) \
                        if hasattr(mopt, 'get') else None
                    link_delay = 0
                    if isinstance(fts, str):
                        if fts != 'link_to_enforce_initial_support':
                            raise ValueError(
                                f"unknown ft_stab mode {fts!r} for {method}")
                        link = mopt.get('link_to_enforce_initial_support',
                                        None) if hasattr(mopt, 'get') else None
                        delay = link.get('delay', 1) \
                            if link is not None and hasattr(link, 'get') else 1
                        link_delay = max(int(delay), 1)
                        fts = True
                    if fts is None:
                        fts = bool(method_ft_stab.get(loop_name, {})
                                   .get(method, False))
                    segments.append(Segment(
                        method=base, n=repeats, betas=betas,
                        ft_stab=bool(fts), ft_stab_link_delay=link_delay))
        if n_first is not None:
            segments.append(Segment(method='RESET_TO_BEST'))
    return segments


class PhasingState(NamedTuple):
    """Restart-batched state: rho/best_rho (B, n_q, n_θ, n_φ) or (B, n_q,
    n_φ) complex64 (complex128 under real_dtype float64),
    support/best_mask bool of the same shape, best_err/last_err (B,) at the
    real dtype.

    Replay best tracking keeps, per restart, an anchor instead of the best
    iterate: the entry state of the chunk that holds the running best (its
    exit state when the best is the chunk's last iterate), anchor_z/z2 its
    phase-anchor sums, anchor_start its global iteration index in the
    schedule tables and anchor_len the iterations to replay (0: the anchor
    is the best). best_rho/best_mask hold the last materialised best until
    materialize_best fills them. anchor_gate is the ft-stab gate of the
    anchor's segment (1 outside linked segments). enforce_hist (B, D) bool:
    the enforce flags of each restart's last D shrink-wraps, newest last,
    all True at the start; None unless the schedule links ft-stab."""
    rho: Any
    support: Any
    best_rho: Any
    best_mask: Any
    best_err: Any
    last_err: Any
    err_snapshot: Any = None
    anchor_rho: Any = None       # (B, n_q, n_θ, n_φ), rho's dtype
    anchor_sup: Any = None       # bool, the anchor segment's support
    anchor_z: Any = None         # (B,) complex64
    anchor_z2: Any = None
    anchor_start: Any = None     # (B,) int32
    anchor_len: Any = None       # (B,) int32
    anchor_gate: Any = None      # (B,) float32
    enforce_hist: Any = None     # (B, D) bool


def _per_restart(x, ndim):
    """(B,) → (B, 1, ..., 1) of ndim dims for broadcasting against a
    batch of grids."""
    return x.reshape(x.shape + (1,) * (ndim - x.ndim))


class MTIP:
    """Transforms + constraints → the phasing program."""

    shard = None              # a θ shard (ThetaShard); None: whole grid

    def __init__(self, ft, reciprocal, real: RealConstraint,
                 shrink_wrap: ShrinkWrap, integration_weights, initial_support,
                 enforce_initial_support_limit=np.inf,
                 fix_global_phase=True, fused_pipeline=None, error_config=None,
                 best_mode="eager", reciprocal_weights=None, harmonic=None,
                 pn_estimate_in=None, *, k2_fwd=True, k1_abs2=False,
                 real_dtype=torch.float32, device="cuda"):
        """integration_weights: error weights broadcastable to the grid,
        either already masked by the initial support (full grid) or the
        separable (n_r, n_θ, 1) form, masked here. reciprocal_weights: the
        reciprocal-grid weights ((n_q, n_θ, 1), or (n_q, n_φ) on a polar
        grid); built from ft.qs if None. harmonic: the intensity ↔
        coefficient transform of the data projection, ft.harmonic by
        default; projections.RealCircularHarmonics for the 2D polar
        pipeline, whose initial support is (n_r, n_φ).
        fused_pipeline: None or True runs the fused iteration where it
        applies (a FusedSHT, a RealConstraint, the default error
        configuration and no particle-number estimate), False the stepwise
        one. error_config: the JAX package's (see _parse_error_config).
        pn_estimate_in: the methods whose iterations estimate the particle
        number when the reciprocal constraint has its tables (None: all).
        best_mode: 'eager' selects the best into best_rho every iteration;
        'replay' keeps an anchor and replays to the best when it is needed
        (the fused iteration only; without it replay resolves to eager, as
        in the JAX package); 'lazy' gives eager's results and resolves to
        eager. k2_fwd,
        k1_abs2: the fused iteration's variants, the JAX package's
        XF_FUSED_K2FWD and XF_FUSED_ABS2 with their defaults: without
        k2_fwd the projection writes ψ_p (B11) and B1 analyses it; with
        k1_abs2 the Hankel forward runs as a matmul and one launch
        synthesizes ψ and analyses |ψ|² (B12). real_dtype: float32, or
        float64 (complex128 state) with the transforms and constraints
        built at float64; the fused iteration needs a FusedSHT, so float64
        runs the stepwise one."""
        self._parse_error_config(error_config)
        if best_mode not in ("eager", "lazy", "replay"):
            raise ValueError(f"best_tracking must be 'eager', 'lazy' or "
                             f"'replay', got {best_mode!r}")
        self.device = torch.device(device)
        self.rdtype = real_dtype
        self.cdtype = torch.complex64 if real_dtype == torch.float32 \
            else torch.complex128
        self._np_real = np.float32 if real_dtype == torch.float32 \
            else np.float64
        self.ft = ft
        self.sht = harmonic if harmonic is not None else ft.harmonic
        self.rc = reciprocal
        self.real = real
        self.sw = shrink_wrap
        # the particle-number estimate adds the error column n_hat
        self._pn_enabled = bool(getattr(reciprocal, "pn_enabled", False))
        self._pn_estimate_in = None if pn_estimate_in is None \
            else tuple(pn_estimate_in)
        sup = np.asarray(initial_support)
        # the grid's axes of every state tensor: (r,θ,φ) or (r,φ)
        self._grid = tuple(range(-sup.ndim, 0))
        self._w_host = np.asarray(integration_weights, dtype=self._np_real)
        self.set_initial_support(sup)
        if reciprocal_weights is None and sup.ndim == 2:
            reciprocal_weights = PolarIntegrator(
                np.asarray(ft.qs), sup.shape[1], real_dtype=real_dtype,
                device=self.device)._w
        elif reciprocal_weights is None:
            reciprocal_weights = SphericalIntegrator(
                np.asarray(ft.qs), sup.shape[1], sup.shape[2],
                real_dtype=real_dtype, device=self.device).w_broadcast
        self._w_rec = torch.as_tensor(reciprocal_weights, dtype=real_dtype,
                                      device=self.device)
        self.enforce_limit = float(enforce_initial_support_limit)
        self.fix_global_phase = bool(fix_global_phase)
        self.k2_fwd, self.k1_abs2 = bool(k2_fwd), bool(k1_abs2)
        # the fused iteration: intensity squaring, amplitude projection,
        # ft-stab correction, phase anchor, real constraint, update and the
        # error and anchor sums run inside the kernels of ops/fused_mtip.py
        self._deg2_ref = self._build_deg2_ref(self._deg2_order) \
            if self._deg2_order is not None else None
        self._err_cols = 2 + int(self._pn_enabled) + len(
            self._err_extra_names)
        self._fi = None
        if (fused_pipeline is None or fused_pipeline) \
                and isinstance(self.sht, FusedSHT) \
                and isinstance(real, RealConstraint) \
                and self._default_err_cfg and not self._pn_enabled:
            self._fi = FusedIteration(self.sht, w_rec=self._w_rec[..., 0],
                                      hankel=ft.hankel)
        # lazy tracking gives eager's results; without the fused iteration
        # the JAX package resolves replay to eager as well
        self.best_mode = "replay" if best_mode == "replay" \
            and self._fi is not None else "eager"
        # replay's per-iteration (method, ft_stab) and β over the whole
        # schedule (set_schedule_tables)
        self._replay_combos = ()
        self._replay_betas = np.zeros(1, np.float32)
        self._replay_cidx = np.zeros(1, np.int32)
        # SW_center's cartesian tables (enable_centering)
        self._r_cart = self._q_cart = None
        # linked ft-stab: the enforce history's length, the largest delay
        # of the whole schedule (register_schedule_dynamics); 0: off
        self._link_hist_len = 0

    def set_initial_support(self, initial_support):
        """The initial support and the error weights it masks: the given
        integration weights (already masked, or the separable (n_r, n_θ, 1)
        form, masked here), and the fused iteration's reduction weights,
        the (n_q, n_θ) plane when the weights are separable and the support
        radial, else the masked grid."""
        sup = np.asarray(initial_support)
        w = self._w_host
        self.initial_support = torch.as_tensor(sup, device=self.device)
        self._w_err = torch.as_tensor(w, device=self.device)
        # real_inside_initial_support False: the real error's weights
        # unmasked (weights that come masked stay so)
        self._w_err_real = self._w_err
        if w.shape != sup.shape:
            self._w_err = self._w_err * self.initial_support
            if self._err_real_masked:
                self._w_err_real = self._w_err
        self._w2d = None
        if w.shape != sup.shape and w.ndim == 3 and w.shape[-1] == 1 \
                and sup.ndim == 3 and bool((sup == sup[:, :1, :1]).all()):
            self._w2d = torch.as_tensor(w[..., 0] * sup[:, :1, 0],
                                        device=self.device)

    def theta_shard(self, mesh):
        """This MTIP on the θ rows of a rank of `mesh` (a θ axis): the FT's
        θ shard, its analyses summed over the rank's θ group; those rows of
        the error and reciprocal weights, the initial support and
        SW_center's cartesian tables; the shrink-wrap and the
        particle-number scan reduced over the group. The 3D stepwise
        iteration on the plain transforms only (precision float64 or
        fused_sht false), as the JAX package shards θ only there.
        → a new MTIP sharing the rest."""
        if len(self._grid) != 3 or isinstance(self.sht, FusedSHT):
            raise ValueError("a θ shard needs the 3D stepwise MTIP on the "
                             "plain transforms (precision float64 or "
                             "fused_sht false)")
        shard = ThetaShard(mesh, self.initial_support.shape)
        rows = shard.rows
        new = copy.copy(self)
        new.shard = shard
        new.ft = self.ft.theta_shard(shard)
        new.sht = new.ft.harmonic
        new._w_host = self._w_host[:, rows]
        new.set_initial_support(self.initial_support.cpu().numpy()[:, rows])
        new._w_rec = self._w_rec[:, rows]
        if self._r_cart is not None:
            new._r_cart, new._q_cart = (self._r_cart[:, rows],
                                        self._q_cart[:, rows])
        new.sw, new.rc = copy.copy(self.sw), copy.copy(self.rc)
        new.sw.shard = new.rc.shard = shard
        return new

    def _grid_reduce(self, *xs, keepdim=False):
        """Each of xs summed over the grid (on a θ shard then over the θ
        ranks, in one exchange). → a tuple."""
        return grid_reduce(xs, self._grid, "sum", self.shard, keepdim)

    # known error metrics of the JAX package's error_config
    KNOWN_REAL_METRICS = frozenset({"l2_projection_diff"})
    KNOWN_RECIPROCAL_METRICS = frozenset({"l2_projection_diff",
                                          "deg2_invariant_l2_diff"})

    def _parse_error_config(self, error_config):
        """The JAX package's error_config: per-metric lists under 'real' and
        'reciprocal', 'real_inside_initial_support', 'deg2_order' (the
        order k of deg2_invariant_l2_diff) and the 'main' combiner
        {'metrics': {'real': [...], 'reciprocal': [...]}, 'type': 'mean' |
        'min' | 'max' | 'prod'}. Unknown metric names raise ValueError. The
        default (the real l2_projection_diff inside the initial support,
        alone, combined by 'mean') is the first error column alone; any
        other configuration adds a column per listed metric and runs the
        stepwise iteration, as in the JAX package."""
        cfg = dict(error_config or {})
        self._err_real_masked = bool(cfg.get("real_inside_initial_support",
                                             True))
        self._real_metrics = tuple(cfg.get("real", ("l2_projection_diff",)))
        self._rec_metrics = tuple(cfg.get("reciprocal", ()))
        main = cfg.get("main", None) or {}
        mm = main.get("metrics", None) or {}
        self._main_metrics = (tuple(mm.get("real", ("l2_projection_diff",))),
                              tuple(mm.get("reciprocal", ())))
        self._main_type = str(main.get("type", "mean"))
        unknown = ((set(self._real_metrics) | set(self._main_metrics[0]))
                   - self.KNOWN_REAL_METRICS) \
            | ((set(self._rec_metrics) | set(self._main_metrics[1]))
               - self.KNOWN_RECIPROCAL_METRICS)
        if unknown:
            raise ValueError(
                f"unknown error metrics {sorted(unknown)}; known real="
                f"{sorted(self.KNOWN_REAL_METRICS)}, reciprocal="
                f"{sorted(self.KNOWN_RECIPROCAL_METRICS)}")
        if self._main_type not in self._COMBINERS:
            raise ValueError(f"unknown main error type {self._main_type!r}; "
                             f"known {sorted(self._COMBINERS)}")
        self._default_err_cfg = (
            self._err_real_masked
            and self._real_metrics == ("l2_projection_diff",)
            and not self._rec_metrics
            and self._main_metrics == (("l2_projection_diff",), ())
            and self._main_type == "mean")
        self._deg2_order = int(cfg.get("deg2_order", 2)) \
            if "deg2_invariant_l2_diff" in (set(self._rec_metrics)
                                            | set(self._main_metrics[1])) \
            else None
        self._err_extra_names = [] if self._default_err_cfg else (
            [f"real_{n}" for n in self._real_metrics]
            + [f"reciprocal_{n}" for n in self._rec_metrics])

    _COMBINERS = {"mean": lambda x: x.mean(0), "min": lambda x: x.amin(0),
                  "max": lambda x: x.amax(0), "prod": lambda x: x.prod(0)}

    @property
    def error_names(self):
        """Names of the error columns: main, reciprocal, n_particles under
        the particle-number estimate, then each configured metric's."""
        return (["main", "reciprocal"]
                + (["n_particles"] if self._pn_enabled else [])
                + list(self._err_extra_names))

    def _build_deg2_ref(self, k):
        """The data's order-k invariant B_k = V_k V_k† (2D: v_k v_k†), order
        0 divided by the particle number, masked to the radial mask's
        shells, and its squared norm: (k, B_k, mask, norm), as the JAX
        package builds them on the host."""
        if hasattr(self.rc, "V_pad"):
            vk = self.rc.V_pad[k].cpu().numpy()
            B = vk @ vk.conj().T
        else:
            vk = self.rc.V[k].cpu().numpy().reshape(-1)
            B = np.outer(vk, vk.conj())
        if k == 0:
            B = B / float(self.rc.n_particles)
        rmask = self.rc.radial_mask[k].cpu().numpy().reshape(-1)
        m2 = rmask[:, None] & rmask[None, :]
        B = B * m2
        norm = float((B * B.conj()).real.sum())
        return (int(k), torch.as_tensor(B, device=self.device).to(
                    self.cdtype),
                torch.as_tensor(m2, device=self.device),
                norm if norm > 0 else float("inf"))

    def _deg2_error(self, Ilm):
        """Relative L2 difference of each restart's order-k invariant
        I_k·I_k† (a batched matmul) against the data's."""
        k, B_ref, m2, norm = self._deg2_ref
        Ik = Ilm[..., k] if hasattr(self.rc, "V_pad") else Ilm[..., k:k + 1]
        d = B_ref - (Ik @ Ik.conj().transpose(-1, -2)) * m2
        return torch.sum((d * d.conj()).real, dim=(-2, -1)) / norm

    # ------------------------------------------------------------- iteration
    def _real_error(self, rho_p, rho_proj):
        """Relative L2 projection difference inside the initial support
        (everywhere under real_inside_initial_support False), per
        restart."""
        w = self._w_err_real
        d = rho_p - rho_proj
        num, den = self._grid_reduce(w * (d * d.conj()).real,
                                     w * (rho_p * rho_p.conj()).real)
        return torch.where(den > 0, num / den, torch.inf)

    def _reciprocal_error(self, psi, psi_p):
        """Relative L2 distance of the amplitude projection on the
        reciprocal grid, per restart."""
        d = psi - psi_p
        num, den = self._grid_reduce(self._w_rec * (d * d.conj()).real,
                                     self._w_rec * (psi * psi.conj()).real)
        return torch.where(den > 0, num / den, torch.inf)

    def _anchor_global_phase(self, rho):
        """Rotate out the global phase per restart: φ = ½·arg Σ w ρ², sign
        chosen so the supported real part is net-positive."""
        z, = self._grid_reduce(self._w_err * rho * rho, keepdim=True)
        rho_g = rho * torch.exp(-0.5j * torch.angle(z)).to(rho.dtype)
        s = torch.sign(*self._grid_reduce(self._w_err * rho_g.real,
                                          keepdim=True))
        return rho_g * torch.where(s < 0, -1.0, 1.0).to(rho.dtype)

    def _restart(self, x):
        """(B,) → (B, 1, ...) against a batch of grids."""
        return _per_restart(x, len(self._grid) + 1)

    def _analyse(self, intensity):
        """Coefficients of a real intensity: the harmonic's real path
        where it has one (the SHT), else its forward (the 2D rfft)."""
        return getattr(self.sht, "forward_real", self.sht.forward)(intensity)

    def _synthesize_real(self, coeff):
        inverse_real = getattr(self.sht, "inverse_real", None)
        return inverse_real(coeff) if inverse_real is not None \
            else self.sht.inverse(coeff).real

    def mtip_iteration(self, rho_in, support, beta, method: str,
                       ft_stab: bool, ft_gate=None):
        """One HIO/ER/RAAR step on (B, n_q, n_θ, n_φ) or (B, n_q, n_φ)
        densities; ft_gate (B,) scales the ft-stab correction (a linked
        segment). → (rho_new, main error (B,), reciprocal error (B,), the
        further error columns: n_hat (0 where the method does not
        estimate) under the particle-number estimate, then each configured
        metric's)."""
        with span("xf.iteration"):
            if self.fix_global_phase:
                rho_in = self._anchor_global_phase(rho_in)
            if ft_stab:
                psi, roundtrip = self.ft.forward_and_roundtrip(rho_in)
            else:
                psi, roundtrip = self.ft.forward(rho_in), None
            intensity = (psi * psi.conj()).real
            Ilm = self._analyse(intensity)
            with span("xf.projection"):
                Ilm_proj = self.rc(Ilm)
            I_new = self._synthesize_real(Ilm_proj)
            extras = []
            if self._pn_enabled:
                if self._pn_estimate_in is None \
                        or method in self._pn_estimate_in:
                    n_hat, I_new = self.rc.particle_number_estimate(I_new)
                else:
                    n_hat = torch.zeros(rho_in.shape[:1], dtype=self.rdtype,
                                        device=rho_in.device)
                extras.append(n_hat)
            psi_p = project_to_modified_intensity(psi, intensity, I_new)
            rho_p = self.ft.inverse(psi_p)
            if ft_stab:
                # add back the FT round-trip defect of the input, except on the
                # radial row r = 0 of each restart's grid
                corr = rho_in - roundtrip
                if ft_gate is not None:
                    corr = corr * self._restart(ft_gate).to(corr.dtype)
                corr.select(self._grid[0], 0).zero_()
                rho_p = rho_p + corr
            rho_proj, invalid = self.real(rho_p, support)
            err_real = self._real_error(rho_p, rho_proj)
            err_rec = self._reciprocal_error(psi, psi_p)
            err = err_real
            if not self._default_err_cfg:
                # the configured metrics and the main combiner
                vals = {("real", "l2_projection_diff"): err_real,
                        ("reciprocal", "l2_projection_diff"): err_rec}
                if self._deg2_ref is not None:
                    vals[("reciprocal", "deg2_invariant_l2_diff")] = \
                        self._deg2_error(Ilm)
                sel = [vals[("real", n)] for n in self._main_metrics[0]] \
                    + [vals[("reciprocal", n)] for n in self._main_metrics[1]]
                if sel:
                    err = self._COMBINERS[self._main_type](torch.stack(sel))
                extras += [vals[("real", n)] for n in self._real_metrics] \
                    + [vals[("reciprocal", n)] for n in self._rec_metrics]
            if method == 'HIO':
                rho_new = hio_update(rho_in, rho_p, rho_proj, invalid, beta)
            elif method == 'RAAR':
                rho_new = raar_update(rho_in, rho_p, rho_proj, invalid, beta)
            else:
                rho_new = er_update(rho_proj)
            return rho_new, err, err_rec, extras

    # ------------------------------------------------------- fused iteration
    def _anchor_scalar(self, z, z2):
        """Unit phase factor of _anchor_global_phase per restart from the
        sums z = Σwρ², z2 = Σwρ; the kernel applies it."""
        e = torch.exp(-0.5j * torch.angle(z)).to(self.cdtype)
        s = torch.sign((e * z2).real)
        return e * torch.where(s < 0, -1.0, 1.0)

    def _anchor_stats(self, rho):
        return self._grid_reduce(self._w_err * rho * rho, self._w_err * rho)

    def _k4_weights(self):
        """B5's reduction weights: the (n_q, n_θ) plane when the initial
        support is radial, else the masked (n_q, n_θ, n_φ) grid."""
        return self._w2d if self._w2d is not None else self._w_err

    def _mtip_iteration_fused(self, rho_in, support, beta, method: str,
                              ft_stab: bool, z, z2, ft_gate=None):
        """One fused HIO/ER/RAAR step. rho_in is not anchored: the anchor
        scalar from the previous iteration's sums z, z2 rides through the
        linear reciprocal chain and is applied in synthesize_update.
        ft_gate (B,): a linked segment's ft-stab gate.
        → (rho_new, real error (B,), reciprocal error (B,), z', z2')."""
        with span("xf.iteration"):
            if self.fix_global_phase:
                c_phase = self._anchor_scalar(z, z2)
            else:
                c_phase = torch.ones(rho_in.shape[:1], dtype=self.cdtype,
                                     device=rho_in.device)
            ft, fi = self.ft, self._fi
            c0 = ft._analysis(rho_in)
            if self.k1_abs2:
                cf = ft.hankel.forward(c0)
                psi, Ilm = fi.synthesize_abs2(cf)
            else:
                psi, cf = fi.hankel_synthesize(c0)
                Ilm = self.sht.forward_real_abs2(psi)
            with span("xf.projection"):
                Ilm_proj = self.rc(Ilm)
            if self.k2_fwd:
                c_p, rnum, rden = fi.inverse_real_project_fwd(Ilm_proj, psi)
            else:
                psi_p, rnum, rden = fi.inverse_real_project(Ilm_proj, psi)
                c_p = ft._analysis(psi_p)
            if ft_stab:
                # synthesis and Hankel inverse are linear and per q: ρ_p +
                # (ρ_in − rt)·[q≠0]
                #   = iSHT(H⁻¹(c_p − cf))|row 0 reset + ρ_in·[q≠0];
                # a linked segment scales cf and B5's ρ_in add by its gate
                # g, so that g = 0 gives the iteration without ft-stab
                if ft_gate is not None:
                    cf = cf * _per_restart(ft_gate, cf.dim()).to(cf.dtype)
                d = ft.hankel.inverse(c_p - cf)
                d[..., 0, :, :] += ft.hankel.inverse_row0(cf)
            else:
                d = ft.hankel.inverse(c_p)
            rho_new, num, den, z_n, z2_n = fi.synthesize_update(
                d, rho_in, support, self._k4_weights(), beta, c_phase,
                method=method, ft_stab=ft_stab, real_constraint=self.real,
                fix_phase=self.fix_global_phase, ft_gate=ft_gate)
            err = torch.where(den > 0, num / den, torch.inf)
            err_rec = torch.where(rden > 0, rnum / rden, torch.inf)
            return rho_new, err, err_rec, z_n, z2_n

    # -------------------------------------------------------------- segments
    def _run_segment(self, state: PhasingState, seg: Segment, pos=0):
        """Eager best tracking: best_rho follows every strict improvement;
        replay mode on the fused iteration runs _run_segment_replay. pos:
        the global schedule index of the segment's first iteration.
        → (state, errors (B, n, error columns))."""
        gate = self._ft_gate(state, seg)
        if self._fi is not None and self.best_mode == "replay":
            return self._run_segment_replay(state, seg, pos, gate)
        rho, best_rho, best_mask = state.rho, state.best_rho, state.best_mask
        best_err, last_err = state.best_err, state.last_err
        if self._fi is not None:
            support, z, z2 = self._segment_entry(state)
        cols = []
        for beta in np.asarray(seg.betas, dtype=self._np_real):
            extras = ()
            if self._fi is not None:
                rho, err, err_rec, z, z2 = self._mtip_iteration_fused(
                    rho, support, float(beta), seg.method, seg.ft_stab, z, z2,
                    gate)
            else:
                rho, err, err_rec, extras = self.mtip_iteration(
                    rho, state.support, float(beta), seg.method, seg.ft_stab,
                    gate)
            better = self._restart(err < best_err)
            best_rho = torch.where(better, rho, best_rho)
            best_mask = torch.where(better, state.support, best_mask)
            best_err = torch.minimum(err, best_err)
            last_err = err
            cols.append(torch.stack([err, err_rec, *extras], dim=-1))
        return state._replace(rho=rho, best_rho=best_rho, best_mask=best_mask,
                              best_err=best_err, last_err=last_err), \
            torch.stack(cols, dim=1)

    def _segment_entry(self, state: PhasingState):
        """The fused iteration's loop invariants at a segment's start: one
        contiguous copy of the support, and the anchor sums of state.rho."""
        rho = state.rho
        if self.fix_global_phase:
            z, z2 = self._anchor_stats(rho)
        else:
            z = z2 = torch.zeros(rho.shape[:1], dtype=self.cdtype,
                                 device=rho.device)
        return state.support.contiguous(), z, z2

    # ------------------------------------------------------- replay best
    # the anchor's granularity: a segment runs in chunks of this many
    # iterations, each followed by one conditional anchor update, so a
    # replay is at most CHUNK − 1 iterations long
    REPLAY_ANCHOR_CHUNK = 16

    # ------------------------------------------------- linked ft-stab
    def register_schedule_dynamics(self, schedule):
        """Record the largest link_to_enforce_initial_support delay of the
        WHOLE schedule as the enforce history's length. Runners call it
        before they split the schedule: a chunk's own largest delay would
        drop history carried across chunks. → the length."""
        d = max((int(getattr(s, "ft_stab_link_delay", 0) or 0)
                 for s in schedule), default=0)
        self._link_hist_len = max(self._link_hist_len, d)
        return self._link_hist_len

    def _init_enforce_hist(self, state, schedule=None):
        """Attach the all-True (B, D) enforce history when the schedule
        links ft-stab and the state has none."""
        if schedule is not None:
            self.register_schedule_dynamics(schedule)
        if self._link_hist_len and state.enforce_hist is None:
            state = state._replace(enforce_hist=torch.ones(
                state.last_err.shape + (self._link_hist_len,),
                dtype=torch.bool, device=state.last_err.device))
        return state

    def _ft_gate(self, state, seg):
        """A linked segment's (B,) 0/1 gate: 1 iff none of the restart's
        last `delay` shrink-wraps enforced the initial support (the
        all-True start keeps it 0 until `delay` shrink-wraps have run).
        None for any other segment."""
        d = int(getattr(seg, "ft_stab_link_delay", 0) or 0)
        if not d:
            return None
        hist = state.enforce_hist
        if hist is None:
            raise ValueError(
                "segment has ft_stab_link_delay but the state carries no "
                "enforce history: call register_schedule_dynamics with the "
                "whole schedule before running chunks")
        d = min(d, hist.shape[-1])
        return 1.0 - hist[..., -d:].any(-1).to(self.rdtype)

    def set_schedule_tables(self, schedule):
        """Per-iteration (method, ft_stab, link delay) index and β over the
        WHOLE flattened schedule, which replay's anchor positions index.
        Runners call it once with the complete schedule."""
        self.register_schedule_dynamics(schedule)
        betas, cidx, combos = [], [], []
        for seg in schedule:
            if seg.method in ("SW", "SW_center", "SNAPSHOT", "RESET_TO_BEST"):
                continue
            key = (seg.method, bool(seg.ft_stab),
                   int(getattr(seg, "ft_stab_link_delay", 0) or 0))
            if key not in combos:
                combos.append(key)
            betas.extend(np.asarray(seg.betas, dtype=np.float64).tolist())
            cidx.extend([combos.index(key)] * int(seg.n))
        self._replay_combos = tuple(combos)
        self._replay_betas = np.asarray(betas or [0.0], np.float32)
        self._replay_cidx = np.asarray(cidx or [0], np.int32)

    def _anchor_fields(self, rho, support):
        """Fresh replay anchors at (rho, support): nothing to replay."""
        b, dev = rho.shape[:1], rho.device
        zero_c = torch.zeros(b, dtype=self.cdtype, device=dev)
        zero_i = torch.zeros(b, dtype=torch.int32, device=dev)
        return dict(anchor_rho=rho, anchor_sup=support.contiguous(),
                    anchor_z=zero_c, anchor_z2=zero_c.clone(),
                    anchor_start=zero_i, anchor_len=zero_i.clone(),
                    anchor_gate=torch.ones(b, device=dev))

    def _run_segment_replay(self, state: PhasingState, seg: Segment, pos,
                            gate=None):
        """A fused segment without a grid-sized best select per iteration:
        after each chunk of at most REPLAY_ANCHOR_CHUNK iterations, one
        conditional anchor update per restart, on the device. The anchor
        records the segment's ft-stab gate, which its replay runs under."""
        support, z, z2 = self._segment_entry(state)
        rho, best_err = state.rho, state.best_err
        a_rho, a_sup = state.anchor_rho, state.anchor_sup
        a_z, a_z2 = state.anchor_z, state.anchor_z2
        a_start, a_len = state.anchor_start, state.anchor_len
        ones = torch.ones(rho.shape[:1], device=rho.device)
        a_gate = ones if state.anchor_gate is None else state.anchor_gate
        gate_val = ones if gate is None else gate
        betas = np.asarray(seg.betas, dtype=np.float32)
        cols = []
        for c0 in range(0, len(betas), self.REPLAY_ANCHOR_CHUNK):
            # the chunk's entry state is held by reference: every iteration
            # allocates its outputs and never writes into its inputs (the
            # wrappers of ops/fused_mtip.py and ops/fused_sht.py). A loop
            # that reuses buffers (CUDA graphs) must copy it here.
            entry_rho, entry_z, entry_z2 = rho, z, z2
            chunk = []
            for beta in betas[c0:c0 + self.REPLAY_ANCHOR_CHUNK]:
                rho, err, err_rec, z, z2 = self._mtip_iteration_fused(
                    rho, support, float(beta), seg.method, seg.ft_stab, z, z2,
                    gate)
                chunk.append(torch.stack([err, err_rec], dim=-1))
            errs = torch.stack(chunk, dim=1)               # (B, k, 2)
            cols.append(errs)
            em = errs[..., 0]
            arg = torch.argmin(em, dim=1)      # first occurrence: eager's pick
            seg_min = em.gather(1, arg[:, None])[:, 0]
            improved = seg_min < best_err
            at_end = arg == em.shape[1] - 1
            grid_imp = self._restart(improved)
            a_rho = torch.where(grid_imp, torch.where(
                self._restart(at_end), rho, entry_rho), a_rho)
            a_sup = torch.where(grid_imp, support, a_sup)
            a_z = torch.where(improved, torch.where(at_end, z, entry_z), a_z)
            a_z2 = torch.where(improved, torch.where(at_end, z2, entry_z2),
                               a_z2)
            a_start = torch.where(improved, pos + c0, a_start).to(
                torch.int32)
            a_len = torch.where(improved, torch.where(
                at_end, 0, arg.to(torch.int32) + 1), a_len).to(torch.int32)
            a_gate = torch.where(improved, gate_val, a_gate)
            best_err = torch.minimum(seg_min, best_err)
        errors = torch.cat(cols, dim=1)
        return state._replace(
            rho=rho, best_err=best_err, last_err=errors[:, -1, 0],
            anchor_rho=a_rho, anchor_sup=a_sup, anchor_z=a_z, anchor_z2=a_z2,
            anchor_start=a_start, anchor_len=a_len, anchor_gate=a_gate), \
            errors

    def _replay_best(self, state: PhasingState):
        """The best iterate of every restart: anchor_len iterations from its
        anchor through the main loop's iteration, (method, ft_stab, link
        delay) and β from the schedule tables, a linked segment under the
        gate its anchor recorded. At replay step i the whole batch runs
        once for each distinct (method, ft_stab, delay, β) among the
        restarts still replaying, and keeps only those restarts' rows: every
        launch has the main loop's shapes, and every kernel is
        row-independent, so the replayed best equals eager's. Reads the
        anchors' positions once."""
        starts = state.anchor_start.cpu().numpy()
        lens = state.anchor_len.cpu().numpy()
        rho, z, z2 = state.anchor_rho, state.anchor_z, state.anchor_z2
        sup = state.anchor_sup
        for i in range(int(lens.max(initial=0))):
            keys = {}
            for r in np.flatnonzero(i < lens):
                at = starts[r] + i
                keys.setdefault((int(self._replay_cidx[at]),
                                 float(self._replay_betas[at])), []).append(r)
            new = [rho, z, z2]
            for (ci, beta), rows in keys.items():
                method, ft_stab, link = self._replay_combos[ci]
                gate = (state.anchor_gate,) if link else ()
                out = self._mtip_iteration_fused(rho, sup, beta, method,
                                                 ft_stab, z, z2, *gate)
                keep = torch.zeros(len(lens), dtype=torch.bool)
                keep[rows] = True
                keep = keep.to(rho.device)
                new = [torch.where(_per_restart(keep, x.dim()), o, x)
                       for o, x in zip((out[0], out[3], out[4]), new)]
            rho, z, z2 = new
        return rho

    def materialize_best(self, state: PhasingState):
        """Replay mode: fill best_rho/best_mask from the anchors and re-anchor
        at the best, so that a later call replays nothing. A no-op in eager
        mode."""
        if self.best_mode != "replay" or state.anchor_rho is None:
            return state
        with span("xf.replay"):
            best = self._replay_best(state)
        return state._replace(best_rho=best, best_mask=state.anchor_sup,
                              anchor_rho=best,
                              anchor_len=torch.zeros_like(state.anchor_len))

    # --------------------------------------------------------- centering
    def enable_centering(self, r_cart, q_cart):
        """Cartesian tables (n_r, n_θ, n_φ, 3) of the real and the
        reciprocal grid, which enable SW_center's center-of-mass shift and
        _center_density. Without them SW_center is a plain shrink-wrap, as
        in the JAX package."""
        def table(x):
            return torch.as_tensor(np.asarray(x, self._np_real),
                                   device=self.device)
        self._r_cart, self._q_cart = table(r_cart), table(q_cart)

    def _center_density(self, rho):
        """Shift each restart's |ρ| center of mass (error weights) to the
        origin by a reciprocal phase ramp: (B, *grid) → the same."""
        w = rho.abs() * self._w_err
        moment = torch.einsum("...c,b...->bc", self._r_cart, w)
        mass = w.sum(self._grid)
        if self.shard is not None:
            moment, mass = self.shard.all_reduce((moment, mass))
        com = moment / mass[:, None]
        psi = self.ft.forward(rho)
        phase = torch.einsum("...c,bc->b...", self._q_cart, com)
        return self.ft.inverse(psi * torch.polar(torch.ones_like(phase),
                                                 phase))

    def _shrink_wrap(self, state: PhasingState, seg: Segment):
        """Blurred-|ρ| support update plus the error-gated enforcement of
        the initial support, per restart; SW_center first moves each
        density's center of mass to the origin (once centering is
        enabled)."""
        rho = state.rho
        if seg.method == 'SW_center' and self._r_cart is not None:
            rho = self._center_density(rho)
        blurred = self.ft.inverse(
            self.ft.forward(rho.abs().to(self.cdtype))
            * self.sw.gaussian_values(seg.sigma))
        new_support = self.sw.new_support(blurred, seg.threshold,
                                          current_support=state.support)
        enforce = state.last_err > self.enforce_limit
        support = torch.where(self._restart(enforce),
                              new_support & self.initial_support, new_support)
        hist = state.enforce_hist
        if hist is not None:
            # one enforce flag per shrink-wrap, newest last
            hist = torch.cat([hist[:, 1:], enforce[:, None]], dim=1)
        return state._replace(rho=rho, support=support, enforce_hist=hist)

    def _snapshot(self, state: PhasingState):
        return state._replace(err_snapshot=state.best_err)

    def _reset_to_best(self, state: PhasingState):
        """Continue from the best state iff it improved after the snapshot;
        replay mode materialises the best first."""
        if state.err_snapshot is None:
            return state
        state = self.materialize_best(state)
        late = self._restart(state.best_err < state.err_snapshot)
        return state._replace(rho=torch.where(late, state.best_rho, state.rho),
                              support=torch.where(late, state.best_mask,
                                                  state.support),
                              err_snapshot=None)

    # ------------------------------------------------------------------ run
    def finalize(self, rho):
        """Reciprocal-side quantities of an output density (..., *grid):
        → (ψ_p, the amplitude-projected FT of ρ, and W, the last unknowns
        (..., L+1, n_m, n_m), in 2D the phases (..., M+1)), restarts
        leading."""
        psi = self.ft.forward(rho.to(self.cdtype))
        intensity = (psi * psi.conj()).real
        Ilm = self._analyse(intensity)
        W = self.rc.approximate_unknowns(Ilm)
        I_new = self._synthesize_real(self.rc.project_coefficients(Ilm, W))
        return project_to_modified_intensity(psi, intensity, I_new), W

    def initial_state_batch(self, rho0_batch, support=None):
        """Fresh state for (B, *grid) starting densities, with fresh anchors
        in replay mode."""
        rho = torch.as_tensor(rho0_batch, device=self.device).to(self.cdtype)
        if support is None:
            support = self.initial_support
        sup = torch.as_tensor(support, device=self.device).expand(rho.shape)
        inf = torch.full(rho.shape[:1], torch.inf, dtype=self.rdtype,
                         device=self.device)
        state = PhasingState(rho=rho, support=sup, best_rho=rho,
                             best_mask=sup, best_err=inf, last_err=inf)
        if self.best_mode == "replay":
            state = state._replace(**self._anchor_fields(rho, sup))
        return self._init_enforce_hist(state)

    def run_from(self, state: PhasingState, schedule, pos=0,
                 materialize=True):
        """Continue a run from `state`. pos: the global iteration index of
        `schedule`'s first iteration in the schedule given to
        set_schedule_tables (replay mode; set from `schedule` if none was).
        materialize: fill the replayed best at the end.
        → (state, errors (B, n_iter, error columns))."""
        if self.best_mode == "replay" and not self._replay_combos:
            self.set_schedule_tables(schedule)
        # the enforce history exists before any shrink-wrap runs
        state = self._init_enforce_hist(state, schedule)
        err_chunks = []
        for seg in schedule:
            if seg.method in ('SW', 'SW_center'):
                with span("xf.shrink_wrap"):
                    state = self._shrink_wrap(state, seg)
            elif seg.method == 'SNAPSHOT':
                state = self._snapshot(state)
            elif seg.method == 'RESET_TO_BEST':
                state = self._reset_to_best(state)
            else:
                with span(f"xf.segment.{seg.method}"):
                    state, errs = self._run_segment(state, seg, pos)
                pos += int(seg.n)
                err_chunks.append(errs)
        if materialize:
            state = self.materialize_best(state)
        if err_chunks:
            errors = torch.cat(err_chunks, dim=1)
        else:
            errors = torch.zeros((state.rho.shape[0], 0, self._err_cols),
                                 dtype=self.rdtype, device=self.device)
        return state, errors

    def run_chunk(self, state: PhasingState, structure, args, pos0=0):
        """One schedule chunk as a runner splits it
        (parallel/mesh._chunk_structure_args): structure holds ('SW',),
        ('SNAPSHOT',), ('RESET_TO_BEST',) or (method, n, ft_stab[, delay]),
        args the matching (σ, threshold), () or β array; pos0 is the global
        iteration index of the chunk's start. The replayed best is not
        materialised. → (state, errors (B, n_iter, error columns))."""
        segs = []
        for seg_s, a in zip(structure, args):
            if seg_s[0] in ('SW', 'SW_center'):
                segs.append(Segment(seg_s[0], sigma=float(a[0]),
                                    threshold=float(a[1])))
            elif seg_s[0] in ('SNAPSHOT', 'RESET_TO_BEST'):
                segs.append(Segment(seg_s[0]))
            else:
                method, n, ft_stab = seg_s[:3]
                segs.append(Segment(method, n,
                                    betas=np.asarray(a, self._np_real),
                                    ft_stab=ft_stab,
                                    ft_stab_link_delay=seg_s[3]
                                    if len(seg_s) > 3 else 0))
        return self.run_from(state, segs, pos=pos0, materialize=False)

    def run_batch(self, rho0_batch, schedule):
        """Multi-start phasing: rho0_batch (n_restarts, *grid).
        → (state, errors (n_restarts, n_iter, error columns)); in replay
        mode the best is materialised."""
        if self.best_mode == "replay":
            self.set_schedule_tables(schedule)
        return self.run_from(self.initial_state_batch(rho0_batch), schedule)


# ------------------------------------------------------------- density guess
def bump_density_guess(generator, bump_envelope, grid_shape, snr,
                       total_intensity, integration_weights, n_restarts=1,
                       real_dtype=torch.float32):
    """Random bump-envelope initial densities (n_restarts, *grid_shape) on
    an (r,θ,φ) or (r,φ) grid:
    ρ = (1 + U[0,1)/SNR)·bump(r), rescaled per restart so ∫ρ² equals
    total_intensity, complex at real_dtype. The float32 uniform draws come
    from `generator`, on its device, whatever the dtype, as in the JAX
    package."""
    device = generator.device
    amp = 1.0 + torch.rand((n_restarts,) + tuple(grid_shape),
                           generator=generator, device=device) / snr
    env = torch.as_tensor(np.asarray(bump_envelope), device=device).to(
        real_dtype).reshape((-1,) + (1,) * (len(grid_shape) - 1))
    rho = amp.to(real_dtype) * env
    total_sq = torch.sum(integration_weights * rho * rho,
                         dim=tuple(range(1, rho.ndim)), keepdim=True)
    rho = rho * torch.sqrt(total_intensity / total_sq)
    return rho.to(torch.complex64 if real_dtype == torch.float32
                  else torch.complex128)
