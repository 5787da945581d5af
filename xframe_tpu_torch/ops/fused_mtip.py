"""The fused MTIP-iteration kernels through hand-written CUDA.

Port of `xframe_tpu.ops.pallas_mtip.FusedIteration` (hankel_synthesize,
inverse_real_project_fwd, synthesize_update, and the two variants
inverse_real_project and synthesize_abs2). Each method dispatches on the
input's device, as `FusedSHT` does:

  * a CPU tensor takes the plain PyTorch version (`*_plain` below);
  * a CUDA tensor launches the kernel of `csrc/mtip.cu`, or raises;
  * any other device raises.

Each kernel launch adds one to `self.launches[<method>]`; nothing else does.

Inputs carry a leading batch of restarts before the radial axis:
(..., n_q, θ, φ) grids and (..., n_q, 2L+1, L+1) coefficients. Every sum
runs over (q, θ, φ), so it is per restart, as the JAX package's sums are
under its `vmap` over restarts; the rows q = 0 that the ft-stab add skips
are those of each restart.

The kernels read the FusedSHT's own tables: the m ≥ 0 rows L..2L of P_t and
I serve the real synthesis of I_new, with the weights w_0 = 1, w_{m>0} = 2
applied in the kernel. Hermitianization happens by index in the kernel. The
TPU package's q-blocks, VMEM plans, row padding, (8, 128) scalar tiles and
hermitianize matmuls have no counterpart here.

Every kernel has two routes, chosen from n_φ before the launch: where
n_φ = 2^a·3^b·5^c its φ-transforms are Stockham FFTs in shared memory, on
the FusedSHT's FFT plan (`ops/fft_plan.py`: radices, twiddle table, bin
map); any other n_φ keeps the dense DFTs against the E/I tables
(`projection_route` for B4, `synthesis_route` for the others). On the FFT
route the syntheses of B5, B6, B11 and B12 are the Legendre stage as a
per-order GEMM into a scratch of Fourier columns, then the FFTs with the
output, as B2's and B10's (`FusedSHT.inverse`, `inverse_real`): (rows,
2L+1, n_θ) columns for B5, B6 and B12, whose output is ψ and, for B12, the
analysis of |ψ|² into a second (rows, L+1, n_θ) scratch; (rows, L+1, n_θ)
for B11, whose real synthesis of I_new runs two θ lines per FFT and ends
in the amplitude projection. An FFT block's θ lines follow from n_φ and
the card (`FusedSHT.fft_lines`), and so do B4's, B5's and B11's per-tile
partial sums.

The kernels follow the FusedSHT's `table_dtype`, as the JAX package's
FusedIteration follows its FusedSHT's: under bf16 tables they launch the
entry points' bf16 forms on the FusedSHT's bf16 P_t and PW (counted under
`<method>_bf16`), each Legendre product on bf16-rounded operands and
float32 sums, B4's and B11's coefficients rounded after their Hermitian
fold; the Hankel weights stay float32. The `*_plain` methods then run on
the FusedSHT's plain version of that form (`FusedSHT.plain`), which rounds
in the same way.
"""
from __future__ import annotations

import torch

from xframe_tpu_torch.ops import _build
from xframe_tpu_torch.ops.fft_plan import (  # noqa: F401  (re-exported)
    FftPlan, fft_bins, fft_plan, fft_radices, fft_twiddles)

METHODS = ("hankel_synthesize", "inverse_real_project_fwd",
           "synthesize_update", "inverse_real_project", "synthesize_abs2")
BF16_METHODS = tuple(m + _build.BF16_SUFFIX for m in METHODS)
UPDATE_METHODS = {"HIO": 0, "ER": 1, "RAAR": 2}
_THETA_TILE = 16   # kTT of csrc/sht.cuh: θ lines per dense-route block
_GRID = (-3, -2, -1)


class FusedIteration:
    """Kernel-backed epilogues of the fused MTIP iteration around a
    FusedSHT. w_rec: optional (n_q, n_θ) reciprocal-grid weight plane of the
    reciprocal-error sums (None: unweighted). hankel: the FT's
    SphericalHankelTransform, needed by hankel_synthesize; its forward
    weights, with a zero k = 0 row prepended when the transform skips
    r = 0, must be square in (k, q′)."""

    def __init__(self, fused_sht, w_rec=None, hankel=None):
        self.f = fused_sht
        self.device = fused_sht.device
        self.launches = dict.fromkeys((m + fused_sht._tag for m in METHODS),
                                      0)
        self._fft = fused_sht.fft
        self._w_rec = None if w_rec is None else torch.as_tensor(
            w_rec, dtype=torch.float32, device=self.device).contiguous()
        self.hankel = hankel
        self._wf = None
        if hankel is not None:
            wf = hankel._wf
            if hankel.skip_zero:
                wf = torch.cat([wf.new_zeros((1,) + wf.shape[1:]), wf])
            n_q = wf.shape[1]
            if tuple(wf.shape) != (n_q, n_q, fused_sht.l_max + 1):
                raise ValueError(f"Hankel forward weights {tuple(wf.shape)} "
                                 f"are not square in (k, q′)")
            self._wf = wf.contiguous()

    def reset_launches(self):
        for k in self.launches:
            self.launches[k] = 0

    # ------------------------------------------------------------ dispatch
    def _on_card(self, x):
        """False for a CPU tensor (plain path), True for one on the tables'
        CUDA device; raises otherwise."""
        if x.device.type == "cpu":
            return False
        if x.device.type != "cuda":
            raise RuntimeError(f"FusedIteration takes CPU or CUDA tensors, "
                               f"got {x.device}")
        if x.device != self.f._PW.device:
            raise RuntimeError(f"input on {x.device}, tables on "
                               f"{self.f._PW.device}")
        return True

    def _launch(self, method, entry, tensors, ints):
        """entry(*tensors (None: a null pointer), *ints, stream) of the
        FusedSHT's table form, counted as one launch of `method` in that
        form."""
        tag = self.f._tag
        _build.launch(entry + tag, tensors[0].device,
                      *map(_build.ptr, tensors), *ints)
        self.launches[method + tag] += 1

    def _coef_shape(self):
        return (self.f.n_m, self.f.l_max + 1)

    def _check(self, name, x, tail):
        if tuple(x.shape[-len(tail):]) != tuple(tail):
            raise ValueError(f"{name}: expected trailing shape {tuple(tail)}, "
                             f"got {tuple(x.shape)}")

    # ---------------------------------------------------------------- B6
    def hankel_synthesize(self, c):
        """Analysis coefficients c (..., n_q, 2L+1, L+1) in r → (ψ =
        iSHT(H(c)) (..., n_q, θ, φ), cf = H(c)) through one entry point:
        the Hankel GEMM, then the synthesis of cf on the route's kernels."""
        if self._wf is None:
            raise ValueError("hankel_synthesize needs FusedIteration(..., "
                             "hankel=...)")
        if not self._on_card(c):
            return self.hankel_synthesize_plain(c)
        f = self.f
        tail = (self._wf.shape[0],) + self._coef_shape()
        self._check("hankel_synthesize", c, tail)
        lead = c.shape[:-3]
        x = _build.kernel_input(c.reshape((-1,) + tail), torch.complex64)
        batch = x.shape[0]
        psi = torch.empty((batch, tail[0], f.n_theta, f.n_phi),
                          dtype=torch.complex64, device=x.device)
        cf = torch.empty_like(x)
        (tw, fm), ints = f.fft_operands(batch * tail[0], f.n_m, "synthesis")
        self._launch("hankel_synthesize", "xf_hankel_synthesize",
                     (x, self._wf, f._P_t, f._I_re, f._I_im, tw, fm, psi, cf),
                     (batch, tail[0], f.n_theta, f.n_phi, f.l_max, *ints))
        return psi.reshape(lead + psi.shape[1:]), cf.reshape(lead + tail)

    def hankel_synthesize_plain(self, c):
        cf = self.hankel.forward(c)
        return self.f.plain.inverse(cf), cf

    # ------------------------------------------------------------ B4, B11
    def _project_inputs(self, name, c, psi):
        """Checked contiguous kernel inputs of B4 and B11: (coefficient rows,
        ψ rows, weight plane or None, n_q)."""
        f = self.f
        self._check(name, psi, (f.n_theta, f.n_phi))
        if psi.dim() < 3 or tuple(c.shape) != tuple(psi.shape[:-2]) \
                + self._coef_shape():
            raise ValueError(f"coefficients {tuple(c.shape)} do not match "
                             f"ψ {tuple(psi.shape)}")
        n_q = psi.shape[-3]
        w = self._w_rec
        if w is not None and tuple(w.shape) != (n_q, f.n_theta):
            raise ValueError(f"w_rec plane {tuple(w.shape)} does not match "
                             f"(n_q, n_θ) = {(n_q, f.n_theta)}")
        x = _build.kernel_input(c.reshape((-1,) + self._coef_shape()),
                                torch.complex64)
        p = _build.kernel_input(psi.reshape((-1, f.n_theta, f.n_phi)),
                                torch.complex64)
        return x, p, w, n_q

    @property
    def projection_route(self):
        """"fft" or "dense": how B4 runs its φ-transforms at this n_φ."""
        return "dense" if self._fft is None else "fft"

    @property
    def synthesis_route(self):
        """"fft" or "dense": how B5, B6, B11 and B12 run their φ-synthesis
        at this n_φ (synthesis_fft_kernel, or synthesis_kernel and B11's
        project_dft_kernel, of csrc/)."""
        return "dense" if self._fft is None else "fft"

    def _partials(self, rows, sums, tile):
        """Scratch for `sums` per-block partial sums per (row, θ tile): θ
        tiles of `tile` lines, what an FFT block of the line rule's count
        covers, or of _THETA_TILE where tile = 0 (the dense kernels)."""
        tile = tile or _THETA_TILE
        return torch.empty((rows, -(-self.f.n_theta // tile), sums),
                           dtype=torch.float32, device=self.device)

    @staticmethod
    def _restart_sums(parts, n_q, lead):
        """Per-block partials (rows, tiles, 2) → the two sums per restart."""
        sums = parts.reshape(parts.shape[0] // n_q, -1, 2).sum(1)
        return sums[:, 0].reshape(lead), sums[:, 1].reshape(lead)

    def inverse_real_project_fwd(self, c, psi):
        """(I_lm (..., n_q, 2L+1, L+1), ψ (..., n_q, θ, φ)) → (analysis
        coefficients of ψ_p = ψ·√(I_new/|ψ|²), Σw|ψ−ψ_p|², Σw|ψ|²) with
        I_new = Re iSHT(I_lm); the sums have shape (...). Neither I_new nor
        ψ_p reaches device memory."""
        if not self._on_card(psi):
            return self.inverse_real_project_fwd_plain(c, psi)
        f = self.f
        x, p, w, n_q = self._project_inputs("inverse_real_project_fwd", c,
                                            psi)
        rows = x.shape[0]
        g = torch.empty((rows, f.n_theta, f.n_m), dtype=torch.complex64,
                        device=x.device)
        out = torch.empty_like(x)
        fft = self._fft
        lines = 0 if fft is None else f.fft_lines("projection")
        parts = self._partials(rows, 2, lines)
        self._launch("inverse_real_project_fwd",
                     "xf_inverse_real_project_fwd",
                     (x, f._P_t, f._I_re, f._I_im, p, w, f._E_re, f._E_im,
                      f._PW, None if fft is None else fft.twiddles,
                      None if fft is None else fft.bins, g, out, parts),
                     (rows, n_q, f.n_theta, f.n_phi, f.l_max,
                      0 if fft is None else fft.code, lines))
        return (out.reshape(c.shape),
                *self._restart_sums(parts, n_q, psi.shape[:-3]))

    def inverse_real_project_fwd_plain(self, c, psi):
        psi_p, num, den = self.inverse_real_project_plain(c, psi)
        return self.f.plain.forward(psi_p), num, den

    def inverse_real_project(self, c, psi):
        """B11, the projection of inverse_real_project_fwd without the
        analysis: → (ψ_p (..., n_q, θ, φ), Σw|ψ−ψ_p|², Σw|ψ|²). I_new never
        reaches device memory. On the FFT route the real synthesis of I_new
        runs two θ lines per FFT line, so a block's partial sums cover
        2·lines θ lines."""
        if not self._on_card(psi):
            return self.inverse_real_project_plain(c, psi)
        f = self.f
        x, p, w, n_q = self._project_inputs("inverse_real_project", c, psi)
        rows = x.shape[0]
        psi_p = torch.empty_like(p)
        (tw, fm), (code, lines) = f.fft_operands(rows, f.l_max + 1,
                                                 "synthesis")
        parts = self._partials(rows, 2, 2 * lines)
        self._launch("inverse_real_project", "xf_inverse_real_project",
                     (x, f._P_t, f._I_re, f._I_im, p, w, tw, fm, psi_p,
                      parts),
                     (rows, n_q, f.n_theta, f.n_phi, f.l_max, code, lines))
        return (psi_p.reshape(psi.shape),
                *self._restart_sums(parts, n_q, psi.shape[:-3]))

    def inverse_real_project_plain(self, c, psi):
        I_new = self.f.plain.inverse_real(c)
        inten = (psi * psi.conj()).real
        valid = (inten > 0) & (I_new >= 0)
        ratio = torch.where(valid, I_new / torch.where(valid, inten, 1.0),
                            0.0)
        psi_p = psi * torch.sqrt(ratio)
        d = psi - psi_p
        w = 1.0 if self._w_rec is None else self._w_rec[..., None]
        num = torch.sum(w * (d * d.conj()).real, dim=_GRID)
        den = torch.sum(w * inten, dim=_GRID)
        return psi_p, num, den

    # ---------------------------------------------------------------- B12
    def synthesize_abs2(self, cf):
        """Coefficients cf (..., 2L+1, L+1) → (ψ = iSHT(cf) (..., θ, φ), the
        analysis of |ψ|² (..., 2L+1, L+1), its m < 0 rows filled from
        c_{l,−m} = (−1)^m conj(c_{l,m})) through one entry point: the
        intensity grid never exists and ψ is not read back. On the FFT
        route the |ψ|² columns go to a (rows, L+1, n_θ) scratch beside the
        synthesis's (rows, 2L+1, n_θ) one; on the dense route they are
        (rows, n_θ, L+1)."""
        if not self._on_card(cf):
            return self.synthesize_abs2_plain(cf)
        f = self.f
        self._check("synthesize_abs2", cf, self._coef_shape())
        x = _build.kernel_input(cf.reshape((-1,) + self._coef_shape()),
                                torch.complex64)
        rows = x.shape[0]
        psi = torch.empty((rows, f.n_theta, f.n_phi), dtype=torch.complex64,
                          device=x.device)
        (tw, fm), ints = f.fft_operands(rows, f.n_m, "synthesis")
        (_, g), _ = f.fft_operands(rows, f.l_max + 1, "synthesis")
        if g is None:
            g = torch.empty((rows, f.n_theta, f.l_max + 1),
                            dtype=torch.complex64, device=x.device)
        out = torch.empty_like(x)
        self._launch("synthesize_abs2", "xf_synthesize_abs2",
                     (x, f._P_t, f._I_re, f._I_im, f._E_re, f._E_im, f._PW,
                      tw, fm, psi, g, out),
                     (rows, f.n_theta, f.n_phi, f.l_max, *ints))
        return (psi.reshape(cf.shape[:-2] + (f.n_theta, f.n_phi)),
                out.reshape(cf.shape))

    def synthesize_abs2_plain(self, cf):
        psi = self.f.plain.inverse(cf)
        return psi, self.f.plain.forward_real_abs2(psi)

    # ---------------------------------------------------------------- B5
    def synthesize_update(self, d, rho_in, support, w, beta, c_phase, *,
                          method: str, ft_stab: bool, real_constraint,
                          fix_phase: bool = True, ft_gate=None):
        """ρ_new = update(real_constraint(c·(iSHT(d) + ft_stab·g·ρ_in·[q≠0])))
        with the input anchored as c·ρ_in, c = c_phase per restart; also the
        real-error numerator and denominator and the next anchor sums
        z = Σwρ_new², z2 = Σwρ_new, each of shape (...).

        d (..., n_q, 2L+1, L+1): under ft-stab the combined set H⁻¹(c_ψp −
        g·cf) with row 0 reset to H⁻¹(c_ψp)[0], else H⁻¹(c_ψp). rho_in and
        support (bool) (..., n_q, θ, φ). w: the (n_q, n_θ) weight plane (a
        radial initial support) or the (n_q, n_θ, n_φ) grid that every
        restart shares; the plain version also takes a grid per restart.
        ft_gate: None (g = 1) or the linked ft-stab gate g per restart,
        shape (...). ρ_p, the correction and the anchored ρ_in never reach
        device memory."""
        if method not in UPDATE_METHODS:
            raise ValueError(f"unknown update method {method!r}")
        if not self._on_card(rho_in):
            return self.synthesize_update_plain(
                d, rho_in, support, w, beta, c_phase, method=method,
                ft_stab=ft_stab, real_constraint=real_constraint,
                fix_phase=fix_phase, ft_gate=ft_gate)
        f = self.f
        self._check("synthesize_update", rho_in, (f.n_theta, f.n_phi))
        n_q = rho_in.shape[-3]
        plane = (n_q, f.n_theta)
        if tuple(w.shape) not in (plane, plane + (f.n_phi,)):
            raise ValueError(f"weights {tuple(w.shape)} are neither the "
                             f"plane {plane} nor the grid "
                             f"{plane + (f.n_phi,)}")
        if tuple(d.shape) != tuple(rho_in.shape[:-2]) + self._coef_shape():
            raise ValueError(f"coefficients {tuple(d.shape)} do not match "
                             f"ρ {tuple(rho_in.shape)}")
        lead = rho_in.shape[:-3]
        x = _build.kernel_input(d.reshape((-1,) + self._coef_shape()),
                                torch.complex64)
        grid = (-1, f.n_theta, f.n_phi)
        rin = _build.kernel_input(rho_in.reshape(grid), torch.complex64)
        sup = support if support.dtype == torch.bool else support != 0
        sup = sup.expand(rho_in.shape).reshape(grid).contiguous()
        w = _build.kernel_input(w, torch.float32)
        rows = x.shape[0]
        c = torch.as_tensor(c_phase, dtype=torch.complex64,
                            device=x.device).expand(lead).reshape(-1)
        rc = real_constraint
        t_low = rc.apply_value_threshold and rc.threshold_low is not None
        t_high = rc.apply_value_threshold and rc.threshold_high is not None
        re = c.real

        def full(v):
            return torch.full_like(re, float(v))
        # slot 6, the gate, is read under a gate only (flag bit 11): else
        # any column fills it, without a launch of its own
        gate = re if ft_gate is None else torch.as_tensor(
            ft_gate, dtype=torch.float32, device=x.device).expand(
                lead).reshape(-1)
        scal = torch.stack([full(beta), re, c.imag,
                            full(rc.threshold_low if t_low else 0.0),
                            full(rc.threshold_high if t_high else 0.0),
                            full(rc.limit_imag), gate], dim=-1).contiguous()
        flags = sum(int(bool(on)) << bit for bit, on in enumerate((
            ft_stab, fix_phase, rc.apply_support, t_low, t_high,
            rc.apply_limit_imag, rc.apply_assert_real,
            rc._considered("support"), rc._considered("value_threshold"),
            rc._considered("limit_imag"), w.dim() == 3,
            ft_gate is not None)))
        rho_new = torch.empty_like(rin)
        (tw, fm), (code, lines) = f.fft_operands(rows, f.n_m, "synthesis")
        parts = self._partials(rows, 6, lines)
        self._launch("synthesize_update", "xf_synthesize_update",
                     (x, f._P_t, f._I_re, f._I_im, tw, fm, rin, sup, w, scal,
                      rho_new, parts),
                     (rows, n_q, f.n_theta, f.n_phi, f.l_max,
                      UPDATE_METHODS[method], flags, code, lines))
        s = parts.reshape(rows // n_q, -1, 6).sum(1).reshape(lead + (6,))
        return (rho_new.reshape(rho_in.shape), s[..., 0], s[..., 1],
                torch.complex(s[..., 2], s[..., 3]),
                torch.complex(s[..., 4], s[..., 5]))

    def pre_constraint_plain(self, d, rho_in, c_phase, *, ft_stab,
                             fix_phase=True, ft_gate=None):
        """(ρ_p, ρ_in) as the real constraint of synthesize_update sees
        them: iSHT(d) + ft_stab·g·ρ_in·[q≠0], both times c_phase under
        fix_phase."""
        rp = self.f.plain.inverse(d)
        rin = rho_in.to(torch.complex64)
        if ft_stab:
            keep = torch.ones((rin.shape[-3], 1, 1), device=rin.device)
            keep[0] = 0.0
            if ft_gate is not None:
                g = torch.as_tensor(ft_gate, dtype=torch.float32,
                                    device=rin.device)
                keep = keep * g.reshape(g.shape + (1, 1, 1))
            rp = rp + rin * keep
        if fix_phase:
            c = torch.as_tensor(c_phase, dtype=torch.complex64,
                                device=rin.device)
            c = c.reshape(c.shape + (1, 1, 1))
            rp, rin = rp * c, rin * c
        return rp, rin

    def synthesize_update_plain(self, d, rho_in, support, w, beta, c_phase,
                                *, method, ft_stab, real_constraint,
                                fix_phase=True, ft_gate=None):
        rp, rin = self.pre_constraint_plain(d, rho_in, c_phase,
                                            ft_stab=ft_stab,
                                            fix_phase=fix_phase,
                                            ft_gate=ft_gate)
        sup = support if support.dtype == torch.bool else support != 0
        out, invalid = real_constraint(rp, sup)
        w3 = w[..., None] if w.dim() == 2 else w
        dd = rp - out
        num = torch.sum(w3 * (dd * dd.conj()).real, dim=_GRID)
        den = torch.sum(w3 * (rp * rp.conj()).real, dim=_GRID)
        if method == "HIO":
            new = torch.where(invalid, rin - beta * dd, out)
        elif method == "RAAR":
            new = torch.where(invalid, beta * rin + (1 - 2 * beta) * rp, out)
        else:
            new = out
        z = torch.sum(w3 * new * new, dim=_GRID)
        z2 = torch.sum(w3 * new, dim=_GRID)
        return new, num, den, z, z2


def away_from_thresholds(rho_p, real_constraint, margin):
    """Points of the pre-constraint ρ_p farther than `margin` from every
    threshold the real constraint applies (t_low, t_high on the real part,
    limit_imag on |imag|). Nearer than that, a rounding difference can flip
    the constraint and give an O(1) difference, so comparisons of
    synthesize_update with its plain version skip those points."""
    rc = real_constraint
    keep = torch.ones(rho_p.shape, dtype=torch.bool, device=rho_p.device)
    for on, t, v in ((rc.apply_value_threshold, rc.threshold_low, rho_p.real),
                     (rc.apply_value_threshold, rc.threshold_high,
                      rho_p.real),
                     (rc.apply_limit_imag, rc.limit_imag, rho_p.imag.abs())):
        if on and t is not None:
            keep &= (v - t).abs() > margin
    return keep
