"""Analytic sample densities of the simulate_ccd shape settings (host numpy).

Port of the analytic branch of
`xframe_tpu.projects.fxs.simulate_ccd.build_density_from_shapes`; the rest
of the simulate_ccd worker is not ported yet (ROADMAP A.12).
"""
from __future__ import annotations

import numpy as np

from xframe_tpu_torch.library.shapes import (SHAPE_BUILDERS,
                                             spherical_to_cartesian)


def build_density_from_shapes(grid, shapes_opt, rng=None):
    """Superpose the configured shapes on an (n_r, n_θ, n_φ, 3) spherical
    grid. shapes_opt: 'types', 'centers' (r, θ, φ), 'sizes', 'densities'
    and optionally 'random_orientation', one entry per shape."""
    if str(shapes_opt.get("types", [""])[0]) == "pdb":
        raise NotImplementedError("pdb and map densities are not ported "
                                  "(ROADMAP A.12)")
    if grid.shape[-1] != 3:
        raise NotImplementedError("2D polar grids are not ported "
                                  "(ROADMAP A.16)")
    types = list(shapes_opt["types"])
    centers = list(shapes_opt["centers"])
    sizes = list(shapes_opt["sizes"])
    amplitudes = list(shapes_opt["densities"])
    randoms = list(shapes_opt.get("random_orientation", [False] * len(types)))
    # one float32 cartesian grid shared by every shape: the binary masks do
    # not need more, and the conversion dominates at simulation grids
    cart = spherical_to_cartesian(
        np.asarray(grid, dtype=np.float32)).astype(np.float32)
    density = np.zeros(grid.shape[:-1])
    for typ, center, size, amp, rnd in zip(types, centers, sizes, amplitudes,
                                           randoms):
        center = np.asarray(center, dtype=float)
        if center.size != 3:
            raise ValueError(
                f"shape center {center.tolist()} has {center.size} "
                f"coordinates but the 3D grid expects 3 (r, theta, phi)")
        density += SHAPE_BUILDERS[str(typ)](
            grid, float(np.asarray(size).ravel()[0]), center=center,
            amplitude=float(amp), random_orientation=bool(rnd), rng=rng,
            cart=cart)
    return density
