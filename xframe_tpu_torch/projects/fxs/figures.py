"""The PNG figures of a ProjectStore save, drawn as the JAX package's
`ProjectDB` draws them (`xframe_tpu.projects.fxs._database_`): the first
invariants, the density slices of the first reconstructions, the error
curves and the PRTF, each under its IO.files.<name>.options toggle.

matplotlib is imported inside the functions that draw (backend Agg);
`available()` says whether it imports here. As in the JAX package, a
figure that fails to draw is left out and never stops a save.
"""
from __future__ import annotations

import os

import numpy as np

MISSING = "matplotlib is not installed"


def available() -> bool:
    """Whether matplotlib imports here."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def pyplot():
    """matplotlib.pyplot on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw(kind, data, folder, io_option):
    """The figures of a save of `kind` into `folder`; io_option(kind, key,
    default) reads the toggles."""
    if kind == "invariants":
        if bool(io_option(kind, "plot_first_invariants", True)):
            plot_first_invariants(data, folder, io_option)
    elif kind == "reconstructions":
        if bool(io_option(kind, "plot_error_metrics", True)):
            plot_errors(data, folder)
        if bool(io_option(kind, "plot_first_used_invariants", True)):
            proj = data.get("projection_matrices")
            if isinstance(proj, dict):
                proj = [proj[k] for k in sorted(proj, key=int)]
            if proj is not None and len(proj):
                plot_matrix_stack(bl_from_projection_matrices(proj), folder,
                                  "first_used_invariants.png")
        n_img = io_option(kind, "generate_2d_images", 2)
        if n_img is not False:
            export_reconstruction_images(
                data, folder, max_exports=2 if n_img is True else int(n_img))
    elif kind == "average_results":
        if bool(io_option(kind, "plot_resolution_metrics", True)):
            plot_prtf(data, folder)


def plot_matrix_stack(bl, folder, fname, n=4, label="B"):
    """Log-magnitude images of the first n nonzero orders of a stacked
    (L+1, n_q, n_q) matrix family."""
    try:
        plt = pyplot()
        bl = np.asarray(bl)
        orders = [l for l in range(min(2 * n, bl.shape[0]))
                  if np.abs(bl[l]).max() > 0][:n]
        if not orders:
            return
        fig, axes = plt.subplots(1, len(orders),
                                 figsize=(4 * len(orders), 3.5))
        axes = np.atleast_1d(axes)
        for ax, l in zip(axes, orders):
            im = ax.imshow(np.log10(np.abs(bl[l]) + 1e-20), origin="lower")
            ax.set_title(f"log10 |{label}_{l}|")
            fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(os.path.join(folder, fname), dpi=100)
        plt.close(fig)
    except Exception:  # a figure never breaks a save
        pass


def bl_from_projection_matrices(proj_list):
    """B_l = V_l V_l† from a per-l matrix list."""
    out = []
    n_q = np.atleast_2d(np.asarray(proj_list[0])).shape[0]
    for v in proj_list:
        v = np.atleast_2d(np.asarray(v))
        if v.shape[0] != n_q:
            v = v.T
        out.append(v @ v.conj().T)
    return np.asarray(out)


def plot_first_invariants(data, folder, io_option, n=4):
    """|B_l| of the data, optionally the V_l V_l† rebuild and the
    factorization error estimates (the invariants options
    plot_first_invariants_from_proj_matrices and
    plot_first_projection_matrix_error_estimates)."""
    try:
        bl = np.asarray(data["deg_2_invariant"]["I1I1"])
        plot_matrix_stack(bl, folder, "first_invariants.png", n)
        if bool(io_option("invariants",
                          "plot_first_invariants_from_proj_matrices", True)):
            proj = data.get("data_projection_matrices", {}).get("I1I1")
            if isinstance(proj, dict):
                proj = [proj[k] for k in sorted(proj, key=int)]
            if proj:
                plot_matrix_stack(bl_from_projection_matrices(proj), folder,
                                  "first_invariants_from_proj_matrices.png",
                                  n)
        if bool(io_option("invariants",
                          "plot_first_projection_matrix_error_estimates",
                          False)):
            est = data.get("data_projection_matrix_error_estimates",
                           {}).get("I1I1")
            if est is not None:
                plot_matrix_stack(
                    np.abs(np.asarray(est)), folder,
                    "first_projection_matrix_error_estimates.png", n,
                    label="err")
    except Exception:  # a figure never breaks a save
        pass


def export_reconstruction_images(data, folder, max_exports=2):
    """real_density_<key>.png: the viewer's figure of each of the first
    results."""
    try:
        from xframe_tpu_torch.presenters.viewer import (grid_from_config,
                                                        reconstruction_figure)
        plt = pyplot()
        grid = grid_from_config(data["configuration"])
        results = data.get("reconstruction_results", {})
        for i, key in enumerate(sorted(results, key=int)):
            if i >= max_exports:
                break
            fig = reconstruction_figure(results[key], grid, key=key)
            fig.savefig(os.path.join(folder, f"real_density_{key}.png"),
                        dpi=100)
            plt.close(fig)
    except Exception:  # a figure never breaks a save
        pass


def plot_errors(data, folder):
    """errors.png: the main error of every restart per iteration."""
    try:
        plt = pyplot()
        fig, ax = plt.subplots(figsize=(6, 4))
        for key, res in data.get("reconstruction_results", {}).items():
            err = np.asarray(res["error_dict"]["main"])
            ax.semilogy(err, label=f"run {key}", alpha=0.7)
        ax.set_xlabel("iteration")
        ax.set_ylabel("relative L2 error")
        if len(data.get("reconstruction_results", {})) <= 8:
            ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(os.path.join(folder, "errors.png"), dpi=100)
        plt.close(fig)
    except Exception:  # a figure never breaks a save
        pass


def plot_prtf(data, folder):
    """PRTF.png: the phase-retrieval transfer function with its 1/e
    line."""
    try:
        plt = pyplot()
        metrics = data.get("resolution_metrics", {})
        if "PRTF" not in metrics:
            return
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(np.asarray(metrics.get("PRTF_qs", np.arange(
            len(metrics["PRTF"])))), np.asarray(metrics["PRTF"]))
        ax.axhline(1 / np.e, color="gray", ls="--", label="1/e")
        ax.set_xlabel("q")
        ax.set_ylabel("PRTF")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(folder, "PRTF.png"), dpi=100)
        plt.close(fig)
    except Exception:  # a figure never breaks a save
        pass
