"""The headless density viewer: reconstruction and average archives drawn
as PNG composites (density slices, support, error metrics, PRTF).

A copy of `xframe_tpu.presenters.viewer`, read through the port's archives
(HDF5 or `.npz`, `projects/fxs/store.load_archive`):

    python -m xframe_tpu_torch view <archive> [-o DIR] [-n N]

writes <stem>_view_<key>.png for the first N results of a reconstructions
archive, or <stem>_view.png for an average. matplotlib is imported inside
the functions that draw (backend Agg); full 3D inspection uses the `.vts`
exports.
"""
from __future__ import annotations

import os

import numpy as np

from xframe_tpu_torch.projects.fxs.figures import pyplot as _plt


# ----------------------------------------------------------------- slices
def _equatorial_slice(rho, thetas):
    """(r, φ) slice nearest the equator θ=π/2 of a (r,θ,φ) volume."""
    i = int(np.argmin(np.abs(np.asarray(thetas) - np.pi / 2)))
    return rho[:, i, :]


def _meridional_slice(rho, phis):
    """(r, θ) half-plane slice at φ≈0 joined with φ≈π so the panel shows a
    full great-circle cut through the pole axis."""
    phis = np.asarray(phis)
    i0 = int(np.argmin(np.abs(phis)))
    i1 = int(np.argmin(np.abs(phis - np.pi)))
    # right half: θ∈[0,π] at φ=0; left half mirrored at φ=π
    return rho[:, :, i0], rho[:, :, i1]


def _polar_panel(ax, data, rs, angles, title, full_circle=True):
    data = np.abs(np.asarray(data))
    a = np.asarray(angles)
    if full_circle:
        a = np.concatenate([a, a[:1] + 2 * np.pi])
        data = np.concatenate([data, data[:, :1]], axis=1)
    A, R = np.meshgrid(a, rs)
    pc = ax.pcolormesh(A, R, data, cmap="viridis", shading="auto")
    ax.set_title(title, fontsize=9)
    ax.set_yticklabels([])
    ax.tick_params(labelsize=6)
    return pc


def _density_panels(fig, axes, rho, grid):
    """Fill polar axes with density slices; handles 3D (r,θ,φ) and 2D (r,φ)."""
    rs = np.asarray(grid["rs"])
    if rho.ndim == 3:
        thetas, phis = np.asarray(grid["thetas"]), np.asarray(grid["phis"])
        eq = _equatorial_slice(rho, thetas)
        pc = _polar_panel(axes[0], eq, rs, phis, "|ρ| equatorial (θ=π/2)")
        right, left = _meridional_slice(rho, phis)
        mer = np.concatenate([right, left[:, ::-1]], axis=1)
        ang = np.concatenate([thetas, 2 * np.pi - thetas[::-1]])
        _polar_panel(axes[1], mer, rs, ang, "|ρ| meridional (φ=0,π)",
                     full_circle=False)
    else:
        phis = np.asarray(grid["phis"])
        pc = _polar_panel(axes[0], rho, rs, phis, "|ρ|")
        axes[1].set_axis_off()
    fig.colorbar(pc, ax=list(axes[:2]), shrink=0.7)


def grid_from_config(cfg):
    real = np.asarray(cfg["internal_grid"]["real_grid"])
    out = {"rs": real}
    for k in ("thetas", "phis"):
        if k in cfg["internal_grid"]:
            out[k] = np.asarray(cfg["internal_grid"][k])
    return out


# ---------------------------------------------------------------- figures
def reconstruction_figure(result, grid, key=""):
    plt = _plt()
    rho = np.asarray(result["real_density"])
    fig = plt.figure(figsize=(13, 4))
    axes = [fig.add_subplot(1, 4, 1, projection="polar"),
            fig.add_subplot(1, 4, 2, projection="polar"),
            fig.add_subplot(1, 4, 3, projection="polar"),
            fig.add_subplot(1, 4, 4)]
    _density_panels(fig, axes, rho, grid)
    # support mask on the equatorial slice
    sup = np.asarray(result.get("support_mask", np.ones_like(rho, float)))
    sup_sl = _equatorial_slice(sup, grid["thetas"]) if sup.ndim == 3 else sup
    _polar_panel(axes[2], sup_sl.astype(float), grid["rs"],
                 grid["phis"], "support")
    err = result.get("error_dict", {})
    for name in ("main", "real_relative_l2"):
        if name in err:
            axes[3].semilogy(np.asarray(err[name]), label=name, lw=0.9)
    axes[3].set_xlabel("iteration", fontsize=8)
    axes[3].set_title("error metrics", fontsize=9)
    axes[3].legend(fontsize=6)
    axes[3].tick_params(labelsize=6)
    fig.suptitle(f"reconstruction {key}", fontsize=11)
    return fig


def average_figure(data):
    """An average archive: average/real_density, grid/{rs,thetas,phis},
    resolution_metrics/{PRTF,PRTF_qs}, rotation_metric/{angles,
    l2_to_ref}."""
    plt = _plt()
    rho = np.asarray(data["average"]["real_density"])
    grid = {k: np.asarray(v) for k, v in data["grid"].items()}
    fig = plt.figure(figsize=(13, 4))
    axes = [fig.add_subplot(1, 4, 1, projection="polar"),
            fig.add_subplot(1, 4, 2, projection="polar"),
            fig.add_subplot(1, 4, 3),
            fig.add_subplot(1, 4, 4)]
    _density_panels(fig, axes, rho, grid)
    rm = data.get("resolution_metrics", {})
    if "PRTF" in rm:
        prtf = np.asarray(rm["PRTF"])
        qs = np.asarray(rm.get("PRTF_qs", np.arange(len(prtf))))
        axes[2].plot(qs, prtf, lw=1.0)
        axes[2].axhline(1 / np.e, color="r", ls="--", lw=0.8, label="1/e")
        axes[2].set_title("PRTF", fontsize=9)
        axes[2].set_ylim(0, 1.05)
        axes[2].legend(fontsize=6)
        axes[2].tick_params(labelsize=6)
    else:
        axes[2].set_axis_off()
    rot = data.get("rotation_metric", {})
    if "l2_to_ref" in rot:
        l2 = np.asarray(rot["l2_to_ref"])
        axes[3].bar(np.arange(len(l2)), l2)
        axes[3].set_title("post-alignment L2 to reference", fontsize=9)
        axes[3].set_xlabel("input #", fontsize=8)
        axes[3].tick_params(labelsize=6)
    else:
        axes[3].set_axis_off()
    fig.suptitle("average", fontsize=11)
    return fig


# -------------------------------------------------------------------- CLI
def view_file(path, out_dir=None, max_results=4):
    """Draw what the archive at `path` holds. → the PNG paths written."""
    from xframe_tpu_torch.projects.fxs.store import load_archive
    plt = _plt()
    data = load_archive(path)
    out_dir = out_dir or os.path.dirname(os.path.abspath(path))
    stem = os.path.splitext(os.path.basename(path))[0]
    os.makedirs(out_dir, exist_ok=True)
    written = []

    if "reconstruction_results" in data:
        grid = grid_from_config(data["configuration"])
        results = data["reconstruction_results"]
        for i, key in enumerate(sorted(results, key=lambda k: int(k))):
            if i >= max_results:
                break
            fig = reconstruction_figure(results[key], grid, key=key)
            p = os.path.join(out_dir, f"{stem}_view_{key}.png")
            fig.savefig(p, dpi=110)
            plt.close(fig)
            written.append(p)
    elif "average" in data:
        fig = average_figure(data)
        p = os.path.join(out_dir, f"{stem}_view.png")
        fig.savefig(p, dpi=110)
        plt.close(fig)
        written.append(p)
    else:
        raise ValueError(
            f"{path}: no reconstruction_results or average group to view")
    return written
