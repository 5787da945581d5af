"""Scattering geometry (Ewald sphere) helpers (host numpy).

Numpy copy of `xframe_tpu.library.physics` (see `library/legendre.py` for
why the port keeps copies); `tests/test_torch_host_tables.py` holds it
equal to the original.
"""
from __future__ import annotations

import numpy as np

# units (reference xframe/library/units.py): lengths in Å, energies in eV
H_EV_S = 4.135667696e-15
C_A_PER_S = 2.99792458e18


def ewald_sphere_theta_pi(wavelength: float, qs: np.ndarray) -> np.ndarray:
    """Polar angle of the Ewald sphere point at momentum transfer q
    (2π-convention): θ(q) = arccos(qλ/4π)   (physicsLibrary.py:94)."""
    return np.arccos(np.asarray(qs) * wavelength / (4 * np.pi))


def ewald_sphere_q_pi(wavelength: float, theta) -> np.ndarray:
    return 4 * np.pi * np.cos(theta) / wavelength


def scattering_angle_to_reciprocal_radii(scattering_angle, xray_wavelength):
    """|q| = 4π sin(2θ/2)/λ  (physicsLibrary.py:65)."""
    return 4 * np.pi * np.sin(np.asarray(scattering_angle) / 2) / xray_wavelength


def energy_to_wavelength(energy_ev: float) -> float:
    """photon energy [eV] → wavelength [Å]  (physicsLibrary.py:105)."""
    return H_EV_S * C_A_PER_S / energy_ev


def spherical_formfactor(q, radius=1000.0):
    """|F|² of a homogeneous sphere (physicsLibrary.py:111)."""
    q = np.asarray(q, dtype=float)
    R = radius
    V = (4 / 3) * np.pi * R ** 3
    f = np.empty_like(q)
    zero = q == 0.0
    f[zero] = 4 * np.pi * V ** 2
    qq = q[~zero] * R
    f[~zero] = 36 * np.pi * V ** 2 * ((np.sin(qq) - qq * np.cos(qq)) / qq ** 3) ** 2
    return f


def pixel_grid_to_scattering_grid(pixel_grid: np.ndarray, wavelength: float,
                                  approximation: str = 'None') -> np.ndarray:
    """Lab-frame detector pixel positions → spherical scattering coordinates
    (q, θ, φ) on the Ewald sphere (physicsLibrary.py:47-88). Beam along z,
    sample at origin."""
    g = np.asarray(pixel_grid, dtype=float)
    r = np.linalg.norm(g, axis=-1)
    z = g[..., 2]
    zr = np.clip(z / np.where(r == 0, 1.0, r), -1.0, 1.0)
    scattering_angle = np.where(z < 0, np.pi - np.arccos(-zr), np.arccos(zr))
    q = 4 * np.pi * np.sin(scattering_angle / 2) / wavelength
    theta = (np.pi - scattering_angle) / 2
    phi = np.arctan2(g[..., 1], g[..., 0])
    return np.stack((q, theta, phi), axis=-1)
