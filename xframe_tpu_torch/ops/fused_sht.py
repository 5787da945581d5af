"""Spherical harmonic transforms through the hand-written CUDA kernels.

Port of `xframe_tpu.ops.pallas_sht.FusedSHT` (forward, inverse,
forward_real, inverse_real, forward_real_abs2). Each method dispatches on the
input's device:

  * a CPU tensor takes the plain PyTorch version (`ops/sht.py`);
  * a CUDA tensor launches the kernel of `csrc/sht.cu`, or raises;
  * any other device raises.

There is no fallback: a failed build or a non-zero cudaError_t raises. Each
kernel launch adds one to `self.launches[<method>]`; nothing else does.

The tables follow `pallas_sht.py:312-342` without the TPU's padding of m to
a multiple of 8: the analysis DFT E[j, φ] = e^{−imφ}·2π/n_φ, the synthesis
DFT I[j, φ] = e^{+imφ}, the quadrature table PW[j, θ, l] and the transposed
synthesis table P_t[j, l, θ], j = m + L. The real-input analyses read rows
L..2L of E and PW (the JAX package's separate Ep/PWp tables). The tables are
also those of the fused MTIP kernels (`ops/fused_mtip.py`).
"""
from __future__ import annotations

import numpy as np
import torch

from xframe_tpu_torch.ops import _build

METHODS = ("forward", "inverse", "forward_real", "inverse_real",
           "forward_real_abs2")


class FusedSHT:
    """Kernel-backed forward/inverse/forward_real/inverse_real/
    forward_real_abs2 for a SphericalHarmonicTransform; same shapes and
    layouts as its methods."""

    def __init__(self, sht):
        self.sht = sht
        self.device = sht.device
        self.l_max, self.n_theta, self.n_phi = sht.l_max, sht.n_theta, sht.n_phi
        self.n_m = sht.n_m
        self.launches = dict.fromkeys(METHODS, 0)
        L, n_phi = self.l_max, self.n_phi
        phi = 2 * np.pi * np.arange(n_phi) / n_phi
        ms = np.arange(-L, L + 1)
        E = np.exp(-1j * np.outer(ms, phi)) * (2 * np.pi / n_phi)
        I = np.exp(1j * np.outer(ms, phi))
        self.set_tables(E.real, E.imag, I.real, I.imag,
                        sht._PW.cpu().numpy(),
                        np.swapaxes(sht._P.cpu().numpy(), 1, 2))

    def set_tables(self, E_re, E_im, I_re, I_im, PW, P_t):
        """Install the kernel tables from host arrays (float32, contiguous)."""
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                                   device=self.device)
        self._E_re, self._E_im = dev(E_re), dev(E_im)
        self._I_re, self._I_im = dev(I_re), dev(I_im)
        self._PW, self._P_t = dev(PW), dev(P_t)

    def reset_launches(self):
        for k in self.launches:
            self.launches[k] = 0

    # ------------------------------------------------------------ dispatch
    def _rows(self, x, tail, dtype):
        """(..., *tail) → contiguous (rows, *tail) of `dtype` on the card;
        None for a CPU tensor (plain path)."""
        if x.device.type == "cpu":
            return None
        if x.device.type != "cuda":
            raise RuntimeError(f"FusedSHT takes CPU or CUDA tensors, got "
                               f"{x.device}")
        if x.device != self._PW.device:
            raise RuntimeError(f"input on {x.device}, tables on "
                               f"{self._PW.device}")
        if tuple(x.shape[-len(tail):]) != tail:
            raise ValueError(f"expected trailing shape {tail}, got "
                             f"{tuple(x.shape)}")
        return _build.kernel_input(x.reshape((-1,) + tail), dtype)

    def _launch(self, method, entry, x, tables, out):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.launch(entry, x.data_ptr(), *(t.data_ptr() for t in tables),
                      out.data_ptr(), x.shape[0], self.n_theta, self.n_phi,
                      self.l_max, stream)
        self.launches[method] += 1
        return out

    # ---------------------------------------------------------- transforms
    def forward(self, f):
        """f(..., θ, φ) complex → coefficients (..., 2L+1, L+1)."""
        grid = (self.n_theta, self.n_phi)
        x = self._rows(f, grid, torch.complex64)
        if x is None:
            return self.sht.forward(f)
        out = torch.empty((x.shape[0], self.n_m, self.l_max + 1),
                          dtype=torch.complex64, device=x.device)
        self._launch("forward", "xf_sht_forward", x,
                     (self._E_re, self._E_im, self._PW), out)
        return out.reshape(f.shape[:-2] + out.shape[1:])

    def forward_real(self, f):
        """Real f(..., θ, φ) → coefficients (..., 2L+1, L+1); the kernel
        fills the m < 0 rows from c_{l,−m} = (−1)^m conj(c_{l,m})."""
        grid = (self.n_theta, self.n_phi)
        x = self._rows(f, grid, torch.float32)
        if x is None:
            return self.sht.forward_real(f)
        out = torch.empty((x.shape[0], self.n_m, self.l_max + 1),
                          dtype=torch.complex64, device=x.device)
        self._launch("forward_real", "xf_sht_forward_real", x,
                     (self._E_re, self._E_im, self._PW), out)
        return out.reshape(f.shape[:-2] + out.shape[1:])

    def forward_real_abs2(self, psi):
        """Complex ψ(..., θ, φ) → analysis of |ψ|², (..., 2L+1, L+1); the
        kernel squares ψ in registers, so the intensity grid never exists."""
        grid = (self.n_theta, self.n_phi)
        x = self._rows(psi, grid, torch.complex64)
        if x is None:
            return self.sht.forward_real_abs2(psi)
        out = torch.empty((x.shape[0], self.n_m, self.l_max + 1),
                          dtype=torch.complex64, device=x.device)
        self._launch("forward_real_abs2", "xf_sht_forward_real_abs2", x,
                     (self._E_re, self._E_im, self._PW), out)
        return out.reshape(psi.shape[:-2] + out.shape[1:])

    def inverse(self, c):
        """Coefficients (..., 2L+1, L+1) → complex f(..., θ, φ)."""
        coef = (self.n_m, self.l_max + 1)
        x = self._rows(c, coef, torch.complex64)
        if x is None:
            return self.sht.inverse(c)
        out = torch.empty((x.shape[0], self.n_theta, self.n_phi),
                          dtype=torch.complex64, device=x.device)
        self._launch("inverse", "xf_sht_inverse", x,
                     (self._P_t, self._I_re, self._I_im), out)
        return out.reshape(c.shape[:-2] + out.shape[1:])

    def inverse_real(self, c):
        """Coefficients (..., 2L+1, L+1) → Re(inverse(c)), float32."""
        coef = (self.n_m, self.l_max + 1)
        x = self._rows(c, coef, torch.complex64)
        if x is None:
            return self.sht.inverse_real(c)
        out = torch.empty((x.shape[0], self.n_theta, self.n_phi),
                          dtype=torch.float32, device=x.device)
        self._launch("inverse_real", "xf_sht_inverse_real", x,
                     (self._P_t, self._I_re, self._I_im), out)
        return out.reshape(c.shape[:-2] + out.shape[1:])
