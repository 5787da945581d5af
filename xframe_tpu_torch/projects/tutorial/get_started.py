"""The tutorial project: a minimal ProjectWorker showing the framework
around a worker (settings, a run folder, one computation on the device).

The counterpart of `xframe_tpu.projects.tutorial.get_started`: a ball
density on the spherical grid, its intensity |FT(ρ)|² through the port's
SphericalFourierTransform (on the card B1, the analysis of the complex
density, then the Hankel matmul and B2), and the profile at θ = φ = 0
written to <home>/data/tutorial/run_<n>/result.h5 (result.npz where h5py
is not installed; projects/fxs/store.save_archive).

    python -m xframe_tpu_torch tutorial get_started
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xframe_tpu_torch.interfaces import ProjectWorkerInterface
from xframe_tpu_torch.projects.fxs.store import latest_run, save_archive
from xframe_tpu_torch.settings import home_dir


def next_run_folder(folder):
    """<folder>/run_<n> for the next n, created. → (path, n)"""
    n = latest_run(folder) + 1
    path = os.path.join(folder, f"run_{n}")
    os.makedirs(path, exist_ok=True)
    return path, n


class ProjectWorker(ProjectWorkerInterface):
    def run(self):
        """→ the intensity (n_points, n_θ, n_φ) as a host array."""
        from xframe_tpu_torch.library.shapes import (ball_density,
                                                     spherical_grid)
        from xframe_tpu_torch.ops.fourier import SphericalFourierTransform
        opt = self.settings
        n = int(opt.get("n_points", 64))
        radius = float(opt.get("radius", 10.0))
        ft = SphericalFourierTransform(n, int(opt.get("max_order", 8)),
                                       q_max=float(opt.get("max_q", 0.5)),
                                       device=self.device)
        grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
        rho = torch.as_tensor(np.asarray(ball_density(grid, radius),
                                         dtype=np.float32),
                              device=self.device)
        psi = ft.forward(rho.to(torch.complex64))
        intensity = (psi * psi.conj()).real.cpu().numpy()
        run_path, _ = next_run_folder(os.path.join(home_dir(), "data",
                                                   "tutorial"))
        path = save_archive(os.path.join(run_path, "result.h5"), {
            "radial_points": ft.qs,
            "intensity_q00": intensity[:, 0, 0],
            "settings_used": {"n_points": n, "radius": radius},
        })
        print(f"tutorial: ball of radius {radius} -> intensity profile saved "
              f"to {path}")
        return intensity
