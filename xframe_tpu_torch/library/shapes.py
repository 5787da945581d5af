"""Spherical and polar grids and analytic densities (host numpy).

Numpy copy of the parts of `xframe_tpu.library.shapes` the phasing slice
and the ground-truth densities use (see `library/legendre.py` for why it is
a copy): the coordinate conversions, the ball, cube and tetrahedron
densities and the bump envelope. The densities take an (r, θ, φ) grid or a
polar (r, φ) one.
"""
from __future__ import annotations

import numpy as np
from scipy.stats import special_ortho_group


def spherical_to_cartesian(grid: np.ndarray) -> np.ndarray:
    """(r,θ,φ)→(x,y,z) or (r,φ)→(x,y); θ polar from +z. Keeps a float32
    input dtype."""
    g = np.asarray(grid)
    if g.dtype != np.float32:
        g = g.astype(float)
    out = g.copy()
    if g.shape[-1] == 2:
        r, phi = g[..., 0], g[..., 1]
        out[..., 0] = r * np.cos(phi)
        out[..., 1] = r * np.sin(phi)
        return out
    r, theta, phi = g[..., 0], g[..., 1], g[..., 2]
    s = r * np.sin(theta)
    out[..., 0] = s * np.cos(phi)
    out[..., 1] = s * np.sin(phi)
    out[..., 2] = r * np.cos(theta)
    return out


def cartesian_to_spherical(grid: np.ndarray) -> np.ndarray:
    """(x,y,z)→(r,θ,φ) or (x,y)→(r,φ), φ in [0, 2π)."""
    g = np.asarray(grid, dtype=float)
    out = g.copy()
    if g.shape[-1] == 2:
        x, y = g[..., 0], g[..., 1]
        out[..., 0] = np.hypot(x, y)
        phi = np.arctan2(y, x)
        out[..., 1] = np.where(phi < 0, phi + 2 * np.pi, phi)
    else:
        x, y, z = g[..., 0], g[..., 1], g[..., 2]
        r = np.sqrt(x * x + y * y + z * z)
        out[..., 0] = r
        with np.errstate(invalid="ignore", divide="ignore"):
            out[..., 1] = np.where(r != 0, np.arccos(np.clip(
                np.divide(z, np.where(r == 0, 1, r)), -1, 1)), 0.0)
        phi = np.arctan2(y, x)
        out[..., 2] = np.where(phi < 0, phi + 2 * np.pi, phi)
    return out


def spherical_grid(rs: np.ndarray, thetas: np.ndarray, phis: np.ndarray) -> np.ndarray:
    """Meshgrid (n_r, n_θ, n_φ, 3) of spherical coordinates."""
    R, T, P = np.meshgrid(rs, thetas, phis, indexing="ij")
    return np.stack((R, T, P), axis=-1)


def polar_grid(rs: np.ndarray, phis: np.ndarray) -> np.ndarray:
    """Meshgrid (n_r, n_φ, 2) of polar coordinates."""
    R, P = np.meshgrid(rs, phis, indexing="ij")
    return np.stack((R, P), axis=-1)


def _shape_frame(grid_spherical, center, random_orientation, rng, cart):
    """Cartesian points relative to `center`, randomly rotated on request;
    `cart` is a precomputed cartesian grid shared across shapes."""
    if cart is None:
        cart = spherical_to_cartesian(grid_spherical)
    if center is not None:
        cart = cart - spherical_to_cartesian(np.asarray(center, dtype=float))
    if random_orientation:
        rng = rng or np.random.default_rng()
        rot = special_ortho_group.rvs(cart.shape[-1], random_state=rng)
        cart = cart @ rot
    return cart


def ball_density(grid_spherical, radius, center=None, amplitude=1.0,
                 random_orientation=False, rng=None, cart=None):
    """Homogeneous ball of given radius at `center` (spherical coords)."""
    cart = _shape_frame(grid_spherical, center, random_orientation, rng, cart)
    mask = np.einsum("...i,...i->...", cart, cart) < radius * radius
    return np.where(mask, amplitude, 0.0)


def cube_density(grid_spherical, edge_lengths, center=None, amplitude=1.0,
                 random_orientation=False, rng=None, cart=None):
    """Axis-aligned (or randomly rotated) rectangular box."""
    cart = _shape_frame(grid_spherical, center, random_orientation, rng, cart)
    lengths = np.broadcast_to(np.asarray(edge_lengths, dtype=float),
                              (cart.shape[-1],))
    mask = np.all(np.abs(cart) < lengths / 2, axis=-1)
    return np.where(mask, amplitude, 0.0)


def _tetrahedron_planes(radius=1.0):
    """Four (base, normal) plane pairs of a regular tetrahedron."""
    z = 1 / np.sqrt(2)
    R = radius / np.linalg.norm([0, -1, -z])
    b1 = R * np.array([0.0, -1.0, -z])
    b2 = R * np.array([-1.0, 0.0, z])
    x1 = np.array([0.0, 2.0, 0.0])
    x2 = np.array([2.0, 0.0, 0.0])
    y1 = b1 / R - np.array([1.0, 0.0, z])
    y2 = b1 / R - np.array([-1.0, 0.0, z])
    y3 = b2 / R - np.array([0.0, -1.0, -z])
    y4 = b2 / R - np.array([0.0, 1.0, -z])
    planes = []
    for base, xd, yd in ((b1, x1, y1), (b1, x1, y2), (b2, x2, y3),
                         (b2, x2, y4)):
        n = np.cross(xd, yd)
        n = n / np.linalg.norm(n)
        if base @ n < 0:  # normal points away from origin
            n = -n
        planes.append((base, n))
    return planes


def tetrahedron_density(grid_spherical, radius, center=None, amplitude=1.0,
                        random_orientation=False, rng=None, cart=None):
    """Regular tetrahedron of circumradius `radius`."""
    cart = _shape_frame(grid_spherical, center, random_orientation, rng, cart)
    mask = np.ones(cart.shape[:-1], dtype=bool)
    for base, normal in _tetrahedron_planes(radius):
        mask &= base @ normal - cart @ normal >= 0
    return np.where(mask, amplitude, 0.0)


SHAPE_BUILDERS = {
    "sphere": ball_density,
    "ball": ball_density,
    "cube": cube_density,
    "tetrahedron": tetrahedron_density,
}


def get_test_function(support=(-1.0, 1.0), slope=1.0):
    """Smooth bump exp(-slope·s²/(s²-(x-c)²)) on the support, 0 outside."""
    center = (support[0] + support[1]) / 2
    size = support[1] - center

    def test_function(x):
        x = np.asarray(x, dtype=float)
        inside = (x > support[0]) & (x < support[1])
        vals = np.zeros_like(x)
        xi = x[inside] - center
        vals[inside] = np.exp(-slope * size ** 2 / (size ** 2 - xi ** 2))
        return vals

    return test_function
