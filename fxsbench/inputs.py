"""The invariants input of a reconstruct run, made in plain code from the
configuration alone: a particle of uniform spheres, simulate_ccd's
tutorial shapes (a centre sphere and a ring of five, radius 70, at 140
from the centre). The seed does not touch it: a run's seed draws the
restarts' starting densities, and every seed then asks for the same work
(replay's share of a batch follows where the restarts' bests lie, which
the particle sets). Its scattered amplitude is exact, a sum of
sphere form factors, ψ(q) = Σ_s ρ_s·4π(sin qa − qa·cos qa)/q³·e^{−iq·c_s},
on the data's q grid (N midpoint shells up to the configuration's q_max)
and the angular grid of the rule at L. The invariants are those the
extract worker hands to reconstruct: B_l(q1, q2) = Σ_m I_lm(q1)·conj
I_lm(q2) of the intensity's harmonic coefficients, odd orders zero, as
per-order projection matrices V_l (the top min(2l+1, N) eigenpairs,
V_l = U·√Λ), and the average intensity √(B_0(q, q)/4π).
"""
from __future__ import annotations

import numpy as np
import torch

from fxsbench.reference.transforms import Precision, Transforms

WAVELENGTH = 1.23984   # the tutorial's x-ray wavelength (Å)


def particle(spheres):
    """→ (centres (S, 3) cartesian, radii (S,), densities (S,)) of the
    configuration's spheres (centres in r, θ, φ)."""
    c = np.asarray(spheres["centers"], dtype=np.float64)
    xyz = np.stack([c[:, 0] * np.sin(c[:, 1]) * np.cos(c[:, 2]),
                    c[:, 0] * np.sin(c[:, 1]) * np.sin(c[:, 2]),
                    c[:, 0] * np.cos(c[:, 1])], axis=1)
    return xyz, np.asarray(spheres["sizes"], np.float64), \
        np.asarray(spheres["densities"], np.float64)


def make_invariants(data, n_q, l_max, device):
    """The invariants dict the reconstruct worker's set-up takes, for
    `data` = the configuration's {"q_max", "spheres"}."""
    t = Transforms(n_q, l_max, float(data["q_max"]), 2.0,
                   Precision("float64"), device, hankel=False)
    centres, radii, dens = particle(data["spheres"])
    dev = torch.device(device)
    q = torch.as_tensor(t.qs, device=dev)[:, None, None]
    th = torch.as_tensor(t.theta, device=dev)[None, :, None]
    ph = torch.as_tensor(t.phi, device=dev)[None, None, :]
    qv = (q * torch.sin(th) * torch.cos(ph), q * torch.sin(th)
          * torch.sin(ph), q * torch.cos(th))
    psi = torch.zeros(t.grid_shape, dtype=torch.complex128, device=dev)
    for c, a, rho in zip(centres, radii, dens):
        x = q * a
        form = rho * 4 * np.pi * (torch.sin(x) - x * torch.cos(x)) / q ** 3
        phase = -(qv[0] * c[0] + qv[1] * c[1] + qv[2] * c[2])
        psi += form * torch.polar(torch.ones_like(phase), phase)
    intensity = (psi * psi.conj()).real
    del psi
    coeff = t.sht_forward(intensity[None])[0]              # (q, m, l)
    bl = torch.einsum("aml,bml->lab", coeff, coeff.conj())
    bl = 0.5 * (bl + bl.mH)
    bl[1::2] = 0
    lam, vec = torch.linalg.eigh(bl)                       # ascending
    proj = []
    for l in range(l_max + 1):
        k = min(2 * l + 1, n_q)
        if l % 2:
            proj.append(np.zeros((n_q, k), np.complex128))
            continue
        top = torch.clamp(lam[l, -k:].flip(0), min=0.0)
        proj.append((vec[l, :, -k:].flip(1) * torch.sqrt(top)).cpu().numpy())
    avg = torch.sqrt(torch.clamp(torch.diagonal(bl[0]).real, min=0.0)
                     / (4 * np.pi)).cpu().numpy()
    return {"data_radial_points": t.qs, "max_order": int(l_max),
            "dimensions": 3, "data_projection_matrices": {"I1I1": proj},
            "average_intensity": avg, "xray_wavelength": WAVELENGTH}
