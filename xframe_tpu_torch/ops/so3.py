"""SO(3) rotations and the cross-correlation of spherical-harmonic
expansions.

Port of `xframe_tpu.ops.so3`. The Wigner-d tables are built on the host in
numpy, exactly as there (eigendecomposition of J_y, stable to high l);
rotating coefficients and correlating two expansions run in torch on the
caller's device:

  C(α,β,γ) = Σ_{l,m,m'} f^l_m  g^{l*}_{m'}  e^{-imα} d^l_{mm'}(β) e^{-im'γ}

evaluated as M^l_{mm'} = Σ_r w_r f^l_m(r) g^{l*}_{m'}(r), T_b = Σ_l
d^l(β_b)·M^l, then one inverse 2D FFT over (m, m'). These are library
calls (einsum, FFT), as in the JAX package, which computes them outside any
Pallas kernel.

Coefficient layout as ops.sht: (..., n_m = 2L+1, L+1), centered m.
"""
from __future__ import annotations

import numpy as np
import torch


# ----------------------------------------------------------- Wigner-d (host)
def _jy_matrix(l: int) -> np.ndarray:
    """⟨m'|J_y|m⟩ for spin l, (2l+1)² Hermitian; basis m = -l..l."""
    ms = np.arange(-l, l + 1)
    cp = np.sqrt(l * (l + 1) - ms * (ms + 1))  # J+ |m> -> |m+1>
    J = np.zeros((2 * l + 1, 2 * l + 1), dtype=complex)
    for i, m in enumerate(ms[:-1]):
        J[i + 1, i] = cp[i] / 2j * (-1)   # -i/2 * c+  at (m+1, m)
        J[i, i + 1] = np.conj(J[i + 1, i])
    return J


def wigner_d_blocks(l_max: int, betas: np.ndarray) -> list:
    """[d^l(β)] for l = 0..L; each (n_beta, 2l+1, 2l+1) real float64:
    d^l(β) = exp(+iβ J_y), so that D^l_{mm'}(α,β,γ) = e^{-imα} d e^{-im'γ}
    implements (Λ(R)f)(x) = f(R⁻¹x) with R = Rz(α)Ry(β)Rz(γ)."""
    betas = np.atleast_1d(np.asarray(betas, dtype=float))
    out = []
    for l in range(l_max + 1):
        lam, V = np.linalg.eigh(_jy_matrix(l))
        phase = np.exp(1j * betas[:, None] * lam[None, :])
        d = np.einsum("mk,bk,nk->bmn", V, phase, V.conj())
        out.append(d.real)
    return out


def wigner_d_padded(l_max: int, betas: np.ndarray) -> np.ndarray:
    """Dense padded table (n_beta, L+1, n_m, n_m), centered-m window per l."""
    blocks = wigner_d_blocks(l_max, betas)
    n_beta = blocks[0].shape[0]
    n_m = 2 * l_max + 1
    table = np.zeros((n_beta, l_max + 1, n_m, n_m))
    for l, d in enumerate(blocks):
        s = slice(l_max - l, l_max + l + 1)
        table[:, l, s, s] = d
    return table


def wigner_D_single(l_max: int, alpha: float, beta: float,
                    gamma: float) -> np.ndarray:
    """Padded D^l_{m m'}(α,β,γ) = e^{-imα} d^l_{mm'}(β) e^{-im'γ},
    (L+1, n_m, n_m) complex."""
    d = wigner_d_padded(l_max, [beta])[0]
    ms = np.arange(-l_max, l_max + 1)
    return (np.exp(-1j * ms * alpha)[None, :, None] * d
            * np.exp(-1j * ms * gamma)[None, None, :])


def so3_grid(bandwidth: int):
    """SOFT sampling: α, γ uniform on [0, 2π) with 2B points,
    β_j = π(2j+1)/(4B)."""
    B = int(bandwidth)
    alphas = 2 * np.pi * np.arange(2 * B) / (2 * B)
    betas = np.pi * (2 * np.arange(2 * B) + 1) / (4 * B)
    gammas = alphas.copy()
    return alphas, betas, gammas


# ------------------------------------------------------------------ device
def rotate_coeff(coeff, D):
    """(Λ(R)f)^l_m = Σ_{m'} D^l_{m m'} f^l_{m'}; coeff (..., n_m, L+1), D
    (L+1, n_m, n_m), as a host array or a tensor."""
    D = torch.as_tensor(D, device=coeff.device).to(coeff.dtype)
    return torch.einsum("lmn,...nl->...ml", D, coeff)


class SO3Correlator:
    """Correlation of SH-expanded signals over the full rotation group.

    l_max: the band limit; bandwidth B sets the 2B-point (α, β, γ) grid
    (default l_max + 1). The padded Wigner-d table (n_beta, L+1, n_m, n_m)
    is built once, float32, on `device`."""

    def __init__(self, l_max: int, bandwidth: int = None, *, device="cuda"):
        self.l_max = int(l_max)
        B = int(bandwidth) if bandwidth else self.l_max + 1
        self.bandwidth = B
        self.alphas, self.betas, self.gammas = so3_grid(B)
        self.n_ab = 2 * B
        self.device = torch.device(device)
        self._d = torch.as_tensor(
            wigner_d_padded(self.l_max, self.betas).astype(np.float32),
            device=self.device)
        self._m_cols = torch.as_tensor(
            np.arange(-self.l_max, self.l_max + 1) % self.n_ab,
            device=self.device)

    def correlate(self, f_coeff, g_coeff, radial_weights=None):
        """C(α,β,γ), real, (..., 2B, 2B, 2B) with axes (α, β, γ).

        f_coeff (n_r, n_m, L+1) or (n_m, L+1); g_coeff the same, or with
        leading candidate axes, each correlated against f."""
        f = torch.as_tensor(f_coeff, device=self.device).to(torch.complex64)
        g = torch.as_tensor(g_coeff, device=self.device).to(torch.complex64)
        if f.dim() == 2:
            f, g = f[None], g[..., None, :, :]
        if radial_weights is None:
            M = torch.einsum("rml,...rnl->...lmn", f, g.conj())
        else:
            w = torch.as_tensor(radial_weights, dtype=torch.float32,
                                device=self.device).to(torch.complex64)
            M = torch.einsum("r,rml,...rnl->...lmn", w, f, g.conj())
        # T_β = Σ_l d^l(β)·M^l on (re, im) pairs: the table stays real
        T = torch.view_as_complex(torch.einsum(
            "blmn,...lmnc->...bmnc", self._d,
            torch.view_as_real(M).contiguous()).contiguous())
        # C(α,β,γ) = Re Σ_{mm'} T_β[m,m'] e^{+imα} e^{+im'γ}: argmax C is the
        # rotation with rotate_coeff(g, D(α̂,β̂,γ̂)) ≈ f. Centered (m, m')
        # go into FFT bins and one inverse 2D FFT evaluates both sums.
        full = torch.zeros(T.shape[:-2] + (self.n_ab, self.n_ab),
                           dtype=torch.complex64, device=self.device)
        full[..., self._m_cols[:, None], self._m_cols[None, :]] = T
        C = torch.fft.ifft2(full, dim=(-2, -1)) * self.n_ab ** 2
        return torch.movedim(C.real, -3, -2)  # (..., α, β, γ)

    def argmax_euler(self, C):
        """Euler angles (α, β, γ) of the correlation maximum (zyz)."""
        ia, ib, ig = np.unravel_index(int(torch.argmax(C)), tuple(C.shape))
        return (float(self.alphas[ia]), float(self.betas[ib]),
                float(self.gammas[ig]))
