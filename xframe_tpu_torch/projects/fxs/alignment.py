"""Centering and rotational alignment of 3D and 2D reconstructions.

Port of `xframe_tpu.projects.fxs.alignment.Aligner` and `Aligner2D`.
3D: centering is a
reciprocal-space phase ramp, the rotation search is the SO(3)
cross-correlation of per-shell SH coefficients (ops/so3.py), and point
inversion is the parity flip f_lm → (-1)^l f_lm. The SH transforms run
through the FT's FusedSHT (`ft.harmonic`, the kernels B1 and B2 on the
card) and the FT itself, so nothing here takes the plain transforms on a
CUDA device. The batched path correlates every candidate and its point
inverse in one call. 2D: the rotation search is the circular correlation
of circular-harmonic coefficients over the n_φ grid angles (point
inversion is a rotation by π there), applied by a cyclic shift; centering
as in 3D. The JAX package's candidate mesh (`_CandidateSharding`) lives in
the average worker here: over a mesh each rank aligns its rows of the
candidates as one batch (projects/fxs/average.py, parallel/mesh.py).
"""
from __future__ import annotations

import numpy as np
import torch

from xframe_tpu_torch.ops.so3 import SO3Correlator, wigner_D_single


class Aligner:
    """The transforms and the SO(3) correlator for one internal grid, on
    the FT's device."""

    def __init__(self, ft, integration_weights, r_limit_ids=None,
                 bandwidth=None, l_max_align=None):
        """l_max_align caps the band of the rotation SEARCH (default
        min(L, 32): the Wigner-d table grows as O(n_β·L·(2L+1)²)); the
        rotation found is applied at the full band limit."""
        self.ft = ft
        self.sht = ft.harmonic
        self.device = ft.sht.device
        L = ft.sht.l_max
        self.l_max = L
        self.l_align = min(int(l_max_align), L) if l_max_align \
            else min(L, 32)
        self.corr = SO3Correlator(self.l_align, bandwidth=bandwidth,
                                  device=self.device)
        n_r = ft.n_radial_points
        if r_limit_ids is None:
            r_limit_ids = np.arange(n_r)
        ids = np.asarray(r_limit_ids, dtype=int)
        w = np.zeros(n_r)
        w[ids] = np.asarray(ft.rs)[ids] ** 2
        self._w_r = self._tensor(w / max(w.sum(), 1e-30))
        self._w_int = self._tensor(integration_weights)
        # parity: Y_lm(-x) = (-1)^l Y_lm(x)
        self._parity = self._tensor((-1.0) ** np.arange(L + 1))
        # unit vectors of the angular grid (3, n_θ, n_φ): the cartesian
        # grids are the radii times these
        theta, phi = ft.sht.theta[:, None], ft.sht.phi[None, :]
        self._unit = self._tensor(np.stack(np.broadcast_arrays(
            np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
            np.cos(theta))))
        self._rs = self._tensor(ft.rs)
        self._qs = self._tensor(ft.qs)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float64) if not isinstance(
            x, torch.Tensor) else x, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------- ops
    def _ramp(self, com):
        """e^{i q·com} on the reciprocal grid, (..., n_q, n_θ, n_φ) for com
        (..., 3): shifting ρ by −com multiplies ψ by it."""
        g = torch.einsum("ctp,...c->...tp", self._unit, com)
        arg = self._qs[:, None, None] * g[..., None, :, :]
        return torch.polar(torch.ones_like(arg), arg)

    def center(self, rho):
        """Move the |ρ| center of mass of each density (..., n_r, n_θ, n_φ)
        to the origin by a reciprocal phase ramp. → (ρ centered, com
        (..., 3))."""
        w = rho.abs() * self._w_int
        com = torch.einsum("...rtp,r,ctp->...c", w, self._rs, self._unit) \
            / w.sum((-3, -2, -1))[..., None]
        return self.ft.inverse(self.ft.forward(rho) * self._ramp(com)), com

    def coefficients(self, rho):
        return self.sht.forward(rho)

    def invert_parity(self, coeff):
        return coeff * self._parity

    def _truncate(self, coeff):
        """Full-band centered layout → the alignment band."""
        L, La = self.l_max, self.l_align
        if La == L:
            return coeff
        return coeff[..., L - La: L + La + 1, : La + 1]

    def _euler(self, flat_index):
        shape = (len(self.corr.alphas), len(self.corr.betas),
                 len(self.corr.gammas))
        ia, ib, ig = np.unravel_index(flat_index, shape)
        return (self.corr.alphas[ia], self.corr.betas[ib],
                self.corr.gammas[ig])

    def find_rotation(self, ref_coeff, coeff):
        """→ ((α, β, γ) maximizing Re⟨Λ(R)·coeff, ref_coeff⟩, the maximum)."""
        C = self.corr.correlate(self._truncate(ref_coeff),
                                self._truncate(coeff),
                                radial_weights=self._w_r).cpu().numpy()
        k = int(np.argmax(C))
        return tuple(float(a) for a in self._euler(k)), float(C.flat[k])

    def rotate(self, coeff, angles):
        D = torch.as_tensor(wigner_D_single(self.l_max, *angles),
                            dtype=torch.complex64, device=self.device)
        return torch.einsum("lmn,...nl->...ml", D, coeff)

    def l2_distance(self, rho_a, rho_b):
        return float(self._l2(rho_a, rho_b))

    def _l2(self, rhos, ref):
        den = torch.clamp((self._w_int * ref.abs() ** 2).sum(), min=1e-30)
        return torch.sqrt((self._w_int * (rhos - ref).abs() ** 2).sum(
            (-3, -2, -1)) / den)

    def align(self, rho, ref_coeff, check_point_inversion=True):
        """Align rho to the reference: try the signal and its point inverse
        and keep the better rotation. → (aligned rho, coeff, info)."""
        coeff = self.coefficients(rho)
        candidates = [("direct", coeff)]
        if check_point_inversion:
            candidates.append(("inverted", self.invert_parity(coeff)))
        best = None
        for tag, c in candidates:
            angles, score = self.find_rotation(ref_coeff, c)
            if best is None or score > best[0]:
                best = (score, tag, c, angles)
        score, tag, c, angles = best
        rot = self.rotate(c, angles)
        return self.sht.inverse(rot), rot, {"angles": angles, "score": score,
                                            "inverted": tag == "inverted"}

    # ----------------------------------------------------------- batched path
    def psi_shift(self, psis, coms):
        """Reciprocal amplitudes (N, n_q, n_θ, n_φ) of densities shifted by
        −com (N, 3): ψ·e^{i q·com}, the ramp `center` applies."""
        return psis * self._ramp(coms)

    def center_batch(self, rhos, psis=None):
        """Centering of (N, n_r, n_θ, n_φ) densities; companion reciprocal
        amplitudes get the same phase ramp. → (ρ centered, ψ centered or
        None, coms (N, 3))."""
        rhos_c, coms = self.center(rhos)
        psis_c = None if psis is None else self.psi_shift(psis, coms)
        return rhos_c, psis_c, coms

    def _rotate_synth(self, coeffs, D, par):
        rot = torch.einsum("nlmk,nrkl->nrml", D, coeffs * par[:, None, None])
        return self.sht.inverse(rot)

    def align_batch(self, rhos, ref_coeff, ref_rho=None, psis=None,
                    check_point_inversion=True):
        """Align N candidates (N, n_r, n_θ, n_φ) with ONE correlation call
        over the candidates and their point inverses; psis are companion
        reciprocal amplitudes rotated and inverted identically.
        → (ρ rotated (N, ...), ψ rotated or None, l2 to ref_rho (N,) or
        None, infos)."""
        n = rhos.shape[0]
        coeffs = self.coefficients(rhos)
        cand = self._truncate(coeffs)
        par_t = self._parity[: self.l_align + 1]
        C = self.corr.correlate(self._truncate(ref_coeff),
                                torch.cat([cand, cand * par_t]),
                                radial_weights=self._w_r)
        scores2, idx2 = C.reshape(2 * n, -1).max(dim=1)
        scores2, idx2 = scores2.cpu().numpy(), idx2.cpu().numpy()
        if check_point_inversion:
            inverted = scores2[n:] > scores2[:n]
        else:
            inverted = np.zeros(n, dtype=bool)
        scores = np.where(inverted, scores2[n:], scores2[:n])
        idx = np.where(inverted, idx2[n:], idx2[:n])
        angles = np.stack(self._euler(idx.astype(int)), axis=1)
        D = torch.as_tensor(np.stack([wigner_D_single(self.l_max, *a)
                                      for a in angles]),
                            dtype=torch.complex64, device=self.device)
        par = torch.where(torch.as_tensor(inverted, device=self.device)[
            :, None], self._parity, torch.ones_like(self._parity))
        rho_rot = self._rotate_synth(coeffs, D, par)
        psi_rot = None if psis is None \
            else self._rotate_synth(self.coefficients(psis), D, par)
        l2 = None if ref_rho is None \
            else self._l2(rho_rot, ref_rho).cpu().numpy()
        infos = [{"angles": tuple(float(a) for a in angles[i]),
                  "score": float(scores[i]), "inverted": bool(inverted[i])}
                 for i in range(n)]
        return rho_rot, psi_rot, l2, infos


class Aligner2D:
    """Polar (2D) alignment on the polar FT's device: C(α) = Σ_{r,m} w_r
    f_m(r) conj(g_m(r)) e^{imα} over α_k = 2πk/n_φ, rotation f(φ − α) as
    a spectral or cyclic shift. Point inversion is the rotation by π, which
    the search covers."""

    def __init__(self, ft, integration_weights, r_limit_ids=None):
        self.ft = ft
        self.device = ft.hankel.device
        self.n_phi = ft.n_phi
        n_r = ft.n_radial_points
        if r_limit_ids is None:
            r_limit_ids = np.arange(n_r)
        ids = np.asarray(r_limit_ids, dtype=int)
        w = np.zeros(n_r)
        w[ids] = np.asarray(ft.rs)[ids]
        self._w_r = self._tensor(w / max(w.sum(), 1e-30))
        self._w_int = self._tensor(integration_weights)
        self._ms = np.fft.fftfreq(self.n_phi, 1 / self.n_phi)
        self.alphas = 2 * np.pi * np.arange(self.n_phi) / self.n_phi
        phis = self._tensor(self.alphas)
        self._unit = torch.stack([torch.cos(phis), torch.sin(phis)])
        self._rs = self._tensor(ft.rs)
        self._qs = self._tensor(ft.qs)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float64) if not isinstance(
            x, torch.Tensor) else x, dtype=torch.float32, device=self.device)

    def _ramp(self, com):
        """e^{i q·com} on the reciprocal grid, (..., n_q, n_φ) for com
        (..., 2)."""
        g = torch.einsum("cp,...c->...p", self._unit, com)
        arg = self._qs[:, None] * g[..., None, :]
        return torch.polar(torch.ones_like(arg), arg)

    def center(self, rho):
        """Move the |ρ| center of mass of each density (..., n_r, n_φ) to
        the origin. → (ρ centered, com (..., 2))."""
        w = rho.abs() * self._w_int
        com = torch.einsum("...rp,r,cp->...c", w, self._rs, self._unit) \
            / w.sum((-2, -1))[..., None]
        return self.ft.inverse(self.ft.forward(rho) * self._ramp(com)), com

    def psi_shift(self, psis, coms):
        return psis * self._ramp(coms)

    def center_batch(self, rhos, psis=None):
        rhos_c, coms = self.center(rhos)
        psis_c = None if psis is None else self.psi_shift(psis, coms)
        return rhos_c, psis_c, coms

    def coefficients(self, rho):
        return torch.fft.fft(rho.to(torch.complex64), dim=-1) / self.n_phi

    def _correlate(self, f, g):
        """C(α_k) for reference coefficients f (n_r, n_φ) and candidates g
        (..., n_r, n_φ) → (..., n_φ)."""
        M = torch.einsum("r,rm,...rm->...m", self._w_r.to(torch.complex64),
                         f, g.conj())
        return torch.fft.ifft(M, dim=-1).real * self.n_phi

    def rotate_density(self, rho, alpha):
        """f(φ − α) by a spectral shift."""
        ms = torch.as_tensor(self._ms, dtype=torch.float32,
                             device=self.device)
        return torch.fft.ifft(torch.fft.fft(rho, dim=-1) * torch.polar(
            torch.ones_like(ms), -ms * float(alpha)), dim=-1)

    def _roll(self, rhos, ks):
        """Each candidate cyclically shifted by its grid angle k:
        out[..., j] = rho[..., (j − k) mod n_φ]."""
        n = self.n_phi
        idx = (torch.arange(n, device=rhos.device)[None, :]
               - ks[:, None]) % n
        idx = idx.reshape((len(ks),) + (1,) * (rhos.dim() - 2) + (n,))
        return torch.gather(rhos, -1, idx.expand(rhos.shape))

    def _l2(self, rhos, ref):
        den = torch.clamp((self._w_int * ref.abs() ** 2).sum(), min=1e-30)
        return torch.sqrt((self._w_int * (rhos - ref).abs() ** 2).sum(
            (-2, -1)) / den)

    def align(self, rho, ref_coeff, check_point_inversion=True):
        """→ (ρ rotated to the best grid angle, None, info)."""
        C = self._correlate(ref_coeff, self.coefficients(rho)).cpu().numpy()
        k = int(np.argmax(C))
        alpha = 2 * np.pi * k / self.n_phi
        return self.rotate_density(rho, alpha), None, {
            "angles": (alpha, 0.0, 0.0), "score": float(C[k]),
            "inverted": False}

    def align_batch(self, rhos, ref_coeff, ref_rho=None, psis=None,
                    check_point_inversion=True):
        """One circular correlation over the N candidates (N, n_r, n_φ);
        companion psis get the same cyclic shift. → (ρ rotated, ψ rotated or
        None, l2 to ref_rho or None, infos)."""
        C = self._correlate(ref_coeff, self.coefficients(rhos))
        scores, ks = C.max(dim=-1)
        rho_rot = self._roll(rhos, ks)
        psi_rot = None if psis is None else self._roll(psis, ks)
        l2 = None if ref_rho is None \
            else self._l2(rho_rot, ref_rho).cpu().numpy()
        scores, ks = scores.cpu().numpy(), ks.cpu().numpy()
        infos = [{"angles": (2 * np.pi * int(k) / self.n_phi, 0.0, 0.0),
                  "score": float(sc), "inverted": False}
                 for sc, k in zip(scores, ks)]
        return rho_rot, psi_rot, l2, infos
