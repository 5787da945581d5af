"""The reference MTIP: the reconstruct worker's 3D set-up and iteration,
worked out again from the merged settings tree (plain nested dicts) and
the invariants (data q grid, per-order projection matrices V_l, average
intensity).

One step from a density ρ and a support S:
  ρ ← ρ·e^{−i·arg(Σwρ²)/2}, its sign making Σw·Re ρ positive (the anchor);
  ψ = FT(ρ) (with the round trip iFT(ψ) under ft-stab), I = |ψ|²;
  I_lm = SHT(I); per order B = V̄ᵀD²I_l, W = polar(B + rms·E), the
  complement E of the order's window padded at B's RMS singular value,
  polar by the settings' Newton–Schulz minimax schedule, on each crop
  bucket where 2L+1 > 128; I_l ← V_l·W on used orders and data shells,
  row 0 ← the data column / √N_particles;
  ψ_p = ψ·√(I_new/I) where I > 0 and I_new ≥ 0, else 0;
  ρ_p = iFT(ψ_p) (+ (ρ − iFT(ψ)) off the r = 0 row under ft-stab);
  ρ_s = P_S(ρ_p): 0 off the support, negative real parts to 0, |Im| ≥ the
  limit to 0; the errors Σw|ρ_p − ρ_s|²/Σw|ρ_p|² (w the integration
  weights inside the initial support) and Σw_q|ψ − ψ_p|²/Σw_q|ψ|²;
  HIO: ρ ← ρ_s where valid, ρ − β(ρ_p − ρ_s) where not; ER: ρ ← ρ_s.
A shrink-wrap blurs |ρ| by a Gaussian of width σ (its Fourier transform
√(π/a)·e^{−π²q²/a}, a = 1/(2σ²)) and keeps c ≥ c_min + t·(c_max − c_min),
c the blur's clipped real part; where the last error exceeds the
enforcement limit the initial support is intersected with it.
"""
from __future__ import annotations

import numpy as np
import torch

from fxsbench.reference.transforms import Transforms
from fxsbench.work import crop_buckets

# the settings' ns_coefficients "minimax" at ns_sigma_min 1e-7: the
# published per-step quintic coefficients (a, b, c), 14 steps
MINIMAX_SCHEDULE = (
    (8.3473509604470308, -23.823541976554029, 16.998243482319499),
    (4.1736710381989175, -2.9779406568262012, 0.53119511093287242),
    (4.1736505861882556, -2.9779272529311722, 0.53119369407648187),
    (4.1735651103018396, -2.9778711109047031, 0.53118772425811456),
    (4.1732082272683311, -2.9776363981659353, 0.53116268307573211),
    (4.1717196201396032, -2.9766573046212752, 0.53105822116741475),
    (4.1655215821064022, -2.9725796720622202, 0.53062317626592592),
    (4.1398988109007648, -2.9557049392215768, 0.5288228027645826),
    (4.0370935219759208, -2.8877195330642076, 0.52157325781157493),
    (3.6704342986757559, -2.6412034958889161, 0.49535767455635554),
    (2.7937069762789752, -2.0153751781889429, 0.42983058907334448),
    (1.9962693187381422, -1.3509579013524158, 0.36563451104163619),
    (1.8575159970392476, -1.2139399664162491, 0.35645176252774696),
    (1.8565202504357181, -1.2133131895874749, 0.35679235576442675),
)


def interp_radial(y, qs_data, qs_new):
    """Linear interpolation along axis 0, zero outside the data range."""
    y = np.asarray(y)
    flat = y.reshape(len(qs_data), -1)
    cols = [np.interp(qs_new, qs_data, flat[:, j].real)
            + (1j * np.interp(qs_new, qs_data, flat[:, j].imag)
               if np.iscomplexobj(y) else 0.0)
            for j in range(flat.shape[1])]
    out = np.stack(cols, axis=1).reshape((len(qs_new),) + y.shape[1:])
    out[(qs_new < qs_data[0]) | (qs_new > qs_data[-1])] = 0.0
    return out


# ---------------------------------------------------------------- schedule
def exponential_ramp(start, stop, exponent, stop_argument=1):
    """A·e^(x·exponent)+B through (0, start) and (stop_argument, stop),
    clamped at stop; the exponent's sign follows the direction."""
    exponent = -abs(exponent) if stop < start else abs(exponent)
    a = (start - stop) / (1 - np.exp(exponent * stop_argument))
    b = start - a

    def ramp(x):
        v = a * np.exp(float(x) * exponent) + b
        return max(v, stop) if start > stop else min(v, stop)
    return ramp


def _number(x):
    return not isinstance(x, bool) and isinstance(x, (int, float))


def linear_ramp(spec, default):
    """The shrink-wrap ramps: a number, or [start, stop, slope] with
    start = value or [value, x], stop = [value or False, x]; False values
    take `default`. Linear from start, clamped at stop."""
    spec = list(spec) if isinstance(spec, (list, tuple)) else [spec]
    start = spec[0] if isinstance(spec[0], (list, tuple)) else (spec[0], 0)
    start = (start[0] if _number(start[0]) else default, start[1])
    stop = spec[1] if len(spec) > 1 else False
    slope = spec[2] if len(spec) > 2 else False
    has_stop = isinstance(stop, (list, tuple)) and _number(stop[1]) \
        and stop[1] >= start[1]
    if has_stop:
        stop = (stop[0] if _number(stop[0]) else default, stop[1])
    if not has_stop and not _number(slope):
        return lambda x: float(start[0])
    if has_stop:
        cap = stop[0]
        a = slope if _number(slope) else (
            0.0 if stop[1] == start[1]
            else (stop[0] - start[0]) / (stop[1] - start[1]))
    else:
        cap, a = (np.sign(slope) * np.inf if slope else np.nan), slope
    b = start[0] - a * start[1]

    def ramp(x):
        v = a * x + b
        return max(v, cap) if a < 0 else (min(v, cap) if a > 0 else v)
    return ramp


def flatten_schedule(main_loop, real, default_sigma):
    """main_loop.sub_loops → (iterations, shrink-wraps): iterations a list
    of (method, β, ft_stab) in order; shrink-wraps a list of (position,
    σ, threshold), position the number of iterations run before it."""
    loops = main_loop["sub_loops"]
    fts = main_loop.get("ft_stabilization", {})
    betas = real["HIO"]["beta"]
    sigmas = real["shrink_wrap"]["sigmas"]
    thresholds = real["shrink_wrap"]["thresholds"]
    iters, sws = [], []
    for loop_id, name in enumerate(loops["order"]):
        loop = loops[name]
        if loop.get("best_density_not_in_first_n_iterations") not in (
                None, False):
            raise NotImplementedError("best_density_not_in_first_n_iterations")
        beta = exponential_ramp(*(betas[loop_id] if loop_id < len(betas)
                                  else [0.5, 0.5, -1 / 700, 1600]))
        sigma = linear_ramp(sigmas[loop_id] if loop_id < len(sigmas)
                            else False, default_sigma)
        thresh = linear_ramp(thresholds[loop_id]
                             if loop_id < len(thresholds) else 0.1, 0.1)
        step = sw_step = 0
        for _ in range(int(loop["iterations"])):
            for method in loop["order"]:
                mopt = loop["methods"][method]
                n = int(mopt.get("iterations", 0)) if isinstance(mopt, dict) \
                    else int(mopt)
                if method == "SW":
                    for _ in range(n):
                        sws.append((len(iters), sigma(sw_step),
                                    thresh(sw_step)))
                        sw_step += 1
                    continue
                if method not in ("HIO", "ER"):
                    raise NotImplementedError(method)
                stab = mopt.get("ft_stab") if isinstance(mopt, dict) else None
                if stab is None:
                    stab = bool(fts.get(name, {}).get(method, False))
                if not isinstance(stab, bool):
                    raise NotImplementedError(f"ft_stab {stab!r}")
                for i in range(n):
                    iters.append((method, beta(step + i), stab))
                step += n
    return iters, sws


# -------------------------------------------------------------------- MTIP
class ReferenceMTIP:
    """The reference of one configuration on `device` at `precision`
    (transforms.Precision)."""

    def __init__(self, settings, inv, precision, device):
        self.p, self.device = precision, torch.device(device)
        g, f = settings["grid"], settings["fourier_transform"]
        if str(f["type"]) != "midpoint":
            raise NotImplementedError(f"Hankel mode {f['type']}")
        if str(settings.get("precision", "float32")) != "float32":
            raise NotImplementedError("precision other than float32")
        qs_data = np.asarray(inv["data_radial_points"], dtype=np.float64)
        L = min(int(g["max_order"]), int(inv["max_order"]))
        N = int(g["n_radial_points"])
        q_max = float(g["max_q"]) if g.get("max_q") else float(qs_data.max())
        self.t = t = Transforms(N, L, q_max,
                                float(f["reciprocity_coefficient"]),
                                precision, device,
                                n_theta=int(g.get("n_theta") or 0) or None,
                                n_phi=int(g.get("n_phi") or 0) or None)
        self.L, self.N = L, N
        rdt, cdt = precision.real, precision.complex
        dev = self.device

        # the data on the internal q grid, scaled to O(1)
        rec = settings["projections"]["reciprocal"]
        if str(rec.get("q_mask", {}).get("type", "none")) != "none":
            raise NotImplementedError("q_mask")
        if str(rec.get("regrid", {}).get("interpolation", "linear")) \
                != "linear":
            raise NotImplementedError("regrid interpolation")
        proj = [interp_radial(np.atleast_2d(np.asarray(v)).astype(complex),
                              qs_data, t.qs)
                for v in inv["data_projection_matrices"]["I1I1"]]
        avg = interp_radial(np.asarray(inv["average_intensity"], float),
                            qs_data, t.qs).real
        scale = float(max(np.abs(avg).max(),
                          max(np.abs(v).max() for v in proj), 1e-30))
        self.data_scale = scale
        proj = [v / scale for v in proj]
        avg = avg / scale
        n_m = 2 * L + 1
        V = np.zeros((L + 1, N, n_m), dtype=complex)
        for l in range(min(L + 1, len(proj))):
            k = min(proj[l].shape[1], 2 * l + 1, N)
            V[l, :, L - l:L - l + k] = proj[l][:, :k]
        if bool(rec.get("odd_orders_to_0",
                        rec.get("assume_zero_odd_orders", True))):
            V[1::2] = 0
        if bool(rec.get("use_averaged_intensity", True)):
            V[0] = 0
            V[0, :, L] = avg * 2 * np.sqrt(np.pi)
        PD = np.conj(np.swapaxes(V, 1, 2)) * (t.qs ** 2)[None, None, :]
        eye = np.ones((L + 1, n_m))
        for l in range(L + 1):
            eye[l, L - l:L + l + 1] = 0.0
        used = rec.get("used_order_ids", "all")
        use = np.zeros(L + 1, bool)
        if isinstance(used, str):
            use[:] = True
        else:
            ids = np.asarray(used, int)
            use[ids[ids <= L]] = True
        inside = (t.qs >= qs_data.min()) & (t.qs <= qs_data.max())
        take = use[:, None] & inside[None, :]
        self.V = torch.as_tensor(V, device=dev).to(cdt)
        self.PD = torch.as_tensor(PD, device=dev).to(cdt)
        self.eye = torch.as_tensor(eye, device=dev).to(rdt)
        self.take = torch.as_tensor(take, device=dev)
        self.sizes = torch.as_tensor(2.0 * np.arange(L + 1) + 1.0,
                                     device=dev).to(rdt)
        pn = rec.get("number_of_particles", {})
        n0 = pn.get("initial", 1)
        if not _number(n0) or bool(pn.get("estimate", {}).get("apply",
                                                              False)):
            raise NotImplementedError("number_of_particles")
        self.n_particles = float(n0)
        method = str(rec.get("procrustes_method", "newton_schulz"))
        if method not in ("newton_schulz", "newton_schulz_pallas") \
                or str(rec.get("ns_coefficients", "minimax")) != "minimax" \
                or abs(float(rec.get("ns_sigma_min", 1e-7)) - 1e-7) > 1e-12:
            raise NotImplementedError("procrustes other than the minimax "
                                      "Newton–Schulz schedule")
        self.schedule = [tuple(float(np.float32(v)) for v in row)
                         for row in MINIMAX_SCHEDULE]

        # the real side: supports, weights, constraint
        real = settings["projections"]["real"]
        popt = real["projections"]
        radius = float(popt["support"]["initial_support"].get(
            "max_radius", settings["particle_radius"]))
        if str(popt["support"]["initial_support"].get("type",
                                                      "max_radius")) \
                != "max_radius":
            raise NotImplementedError("initial support type")
        shape = t.grid_shape
        self.initial_support = torch.as_tensor(
            np.broadcast_to((t.rs < radius)[:, None, None], shape).copy(),
            device=dev)
        w = t.integration_weights(t.rs)
        self.w_err = w * self.initial_support
        self.w_rec = t.integration_weights(t.qs)
        apply = list(popt.get("apply", ["support", "value_threshold",
                                        "limit_imag"]))
        unit = 1.0 / np.sqrt(scale)
        thr = popt.get("value_threshold", {}).get("threshold", [0, False])
        if set(apply) - {"support", "value_threshold", "limit_imag"} \
                or (len(thr) > 1 and thr[1] is not False):
            raise NotImplementedError("real constraint")
        self.apply = set(apply)
        self.low = None if thr[0] is False else float(thr[0]) * unit
        self.limit_imag = float(popt.get("limit_imag", {})
                                .get("threshold", 2.0)) * unit
        enf = popt["support"].get("enforce_initial_support", {})
        self.enforce = float(enf.get("if_error_bigger_than", np.inf)) \
            if enf.get("apply", False) else np.inf
        sw = real["shrink_wrap"]
        if str(sw.get("mode", "threshold")) != "threshold":
            raise NotImplementedError("shrink-wrap mode")
        self.q_col = torch.as_tensor(t.qs, device=dev).to(rdt)[:, None, None]
        self.iterations, self.shrink_wraps = flatten_schedule(
            settings["main_loop"], real, default_sigma=float(t.rs[1]
                                                             - t.rs[0]))

    # ------------------------------------------------------ reciprocal side
    def polar(self, M):
        """Newton–Schulz polar factor on the minimax schedule."""
        a = M.abs()
        norm = torch.sqrt(a.sum(-1).amax(-1) * a.sum(-2).amax(-1))
        X = M / (norm[..., None, None] + 1e-12)
        for ca, cb, cc in self.schedule:
            A = self.p.cmm(X.mH, X)
            X = ca * X + self.p.cmm(X, cb * A + cc * self.p.cmm(A, A))
        return X

    def project(self, Ilm):
        """Ilm (B, n_q, n_m, L+1) → the data projection, same layout."""
        L, n_m = self.L, 2 * self.L + 1
        It = Ilm.movedim(-1, -3)                       # (B, L+1, n_q, n_m)
        Bm = self.p.cmm(self.PD, It)                   # (B, L+1, n_m, n_m)
        rms = torch.sqrt((Bm.abs() ** 2).sum((-2, -1)) / self.sizes)
        M = Bm + torch.diag_embed(self.eye * (rms[..., None] + 1e-20)) \
            .to(Bm.dtype)
        if n_m > 128:
            W = torch.zeros_like(M)
            idx = torch.arange(n_m, device=M.device)
            for lo, hi, h in crop_buckets(L):
                sl = slice(L - h, L + h + 1)
                Wb = self.polar(M[..., lo:hi + 1, sl, sl])
                outside = ((idx < L - h) | (idx > L + h)).to(M.dtype)
                W[..., lo:hi + 1, :, :] = torch.diag_embed(outside)
                W[..., lo:hi + 1, sl, sl] = Wb
        else:
            W = self.polar(M)
        proj = self.p.cmm(self.V, W)
        proj[:, 0] = self.V[0]
        out = torch.where(self.take[:, :, None], proj, It)
        out[:, 0] = out[:, 0] / np.sqrt(self.n_particles)
        return out.movedim(-3, -1)

    # ------------------------------------------------------------ real side
    def real_constraint(self, rho, support):
        """→ (projected density, invalid points)."""
        out, invalid = rho, torch.zeros(rho.shape, dtype=torch.bool,
                                        device=rho.device)
        zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
        if "support" in self.apply:
            out = torch.where(support, out, zero)
            invalid = invalid | ~support
        if "value_threshold" in self.apply and self.low is not None:
            m = out.real < self.low
            out = torch.where(m, torch.complex(
                torch.full_like(out.real, self.low), out.imag), out)
            invalid = invalid | m
        if "limit_imag" in self.apply:
            m = out.imag.abs() >= self.limit_imag
            out = torch.where(m, torch.complex(out.real,
                                               torch.zeros_like(out.real)),
                              out)
            invalid = invalid | m
        return out, invalid

    def _sum(self, x):
        return x.sum((-3, -2, -1))

    def anchor(self, rho):
        z = self._sum(self.w_err * rho * rho)
        g = rho * torch.exp(-0.5j * torch.angle(z))[:, None, None, None]
        s = torch.sign(self._sum(self.w_err * g.real))
        return g * torch.where(s < 0, -1.0, 1.0).to(g.dtype)[:, None, None,
                                                              None]

    def step(self, rho, support, method, beta, ft_stab):
        """One iteration of (B, r, θ, φ) densities on (B or 1, r, θ, φ)
        supports. → (new density, real error (B,), reciprocal error (B,))."""
        t = self.t
        rho = self.anchor(rho.to(self.p.complex))
        if ft_stab:
            psi, rt = t.forward_and_roundtrip(rho)
        else:
            psi, rt = t.forward(rho), None
        inten = (psi * psi.conj()).real
        i_new = t.sht_inverse(self.project(t.sht_forward(inten))).real
        valid = (inten > 0) & (i_new >= 0)
        ratio = torch.where(valid, i_new / torch.where(valid, inten, 1.0),
                            0.0)
        psi_p = psi * torch.sqrt(ratio)
        rho_p = t.inverse(psi_p)
        if ft_stab:
            corr = rho - rt
            corr[:, 0] = 0
            rho_p = rho_p + corr
        rho_s, invalid = self.real_constraint(rho_p, support)
        d = rho_p - rho_s
        err = self._sum(self.w_err * (d * d.conj()).real) \
            / self._sum(self.w_err * (rho_p * rho_p.conj()).real)
        dq = psi - psi_p
        err_rec = self._sum(self.w_rec * (dq * dq.conj()).real) \
            / self._sum(self.w_rec * (psi * psi.conj()).real)
        if method == "HIO":
            new = torch.where(invalid, rho - beta * (rho_p - rho_s), rho_s)
        elif method == "ER":
            new = rho_s
        else:
            raise NotImplementedError(method)
        return new, err, err_rec

    def shrink_wrap(self, rho, support, sigma, threshold, last_err):
        """→ the new support of (B, r, θ, φ) densities."""
        t = self.t
        a = 1.0 / (2.0 * float(sigma) ** 2)
        gauss = np.sqrt(np.pi / a) * torch.exp(-np.pi ** 2
                                               * self.q_col ** 2 / a)
        blur = t.inverse(t.forward(rho.abs().to(self.p.complex)) * gauss)
        c = torch.clamp(blur.real, min=0.0)
        cmax = c.amax((-3, -2, -1), keepdim=True)
        cmin = c.amin((-3, -2, -1), keepdim=True)
        new = c >= cmin + threshold * (cmax - cmin)
        enforce = (last_err > self.enforce)[:, None, None, None]
        return torch.where(enforce, new & self.initial_support, new)
