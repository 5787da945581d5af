"""Figure factories of the library: each class's `get_fig(data, ...)`
returns a matplotlib Figure (backend Agg).

A copy of `xframe_tpu.presenters.matplotlib_presenter`; matplotlib is
imported inside the functions that draw.
"""
from __future__ import annotations

import numpy as np

from xframe_tpu_torch.projects.fxs.figures import pyplot as _plt


class plot1D:
    """Line plot(s); data (n,) or (k, n)."""

    @staticmethod
    def get_fig(data, x=None, labels=None, ylog=False, xlabel="", ylabel="",
                title=""):
        plt = _plt()
        fig, ax = plt.subplots(figsize=(6, 4))
        data = np.atleast_2d(np.asarray(data))
        for i, row in enumerate(data):
            lbl = labels[i] if labels else None
            if x is None:
                ax.plot(row, label=lbl)
            else:
                ax.plot(np.asarray(x), row, label=lbl)
        if ylog:
            ax.set_yscale("log")
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        if labels:
            ax.legend(fontsize=8)
        fig.tight_layout()
        return fig


class heat2D:
    """Cartesian heat map."""

    @staticmethod
    def get_fig(data, log_scale=False, title="", cmap="viridis", extent=None):
        plt = _plt()
        fig, ax = plt.subplots(figsize=(5.5, 4.5))
        values = np.asarray(data).real
        if log_scale:
            values = np.log10(np.abs(values) + 1e-20)
        im = ax.imshow(values, origin="lower", cmap=cmap, extent=extent,
                       aspect="auto")
        fig.colorbar(im, ax=ax)
        ax.set_title(title)
        fig.tight_layout()
        return fig

    @staticmethod
    def get_fig_multi(datasets, titles=None, log_scale=False, cmap="viridis"):
        plt = _plt()
        n = len(datasets)
        fig, axes = plt.subplots(1, n, figsize=(4.5 * n, 4))
        axes = np.atleast_1d(axes)
        for i, (ax, d) in enumerate(zip(axes, datasets)):
            values = np.asarray(d).real
            if log_scale:
                values = np.log10(np.abs(values) + 1e-20)
            im = ax.imshow(values, origin="lower", cmap=cmap, aspect="auto")
            fig.colorbar(im, ax=ax)
            if titles:
                ax.set_title(titles[i])
        fig.tight_layout()
        return fig


class heatPolar2D:
    """Polar heat map of (n_r, n_phi) data."""

    @staticmethod
    def get_fig(data, rs=None, phis=None, log_scale=False, title="",
                cmap="inferno"):
        plt = _plt()
        values = np.asarray(data).real
        n_r, n_phi = values.shape
        if rs is None:
            rs = np.arange(n_r)
        if phis is None:
            phis = 2 * np.pi * np.arange(n_phi) / n_phi
        if log_scale:
            values = np.log10(np.abs(values) + 1e-20)
        fig, ax = plt.subplots(figsize=(5.5, 4.8),
                               subplot_kw={"projection": "polar"})
        # close the φ seam
        P, R = np.meshgrid(np.append(phis, phis[0] + 2 * np.pi), rs)
        V = np.concatenate([values, values[:, :1]], axis=1)
        pcm = ax.pcolormesh(P, R, V, cmap=cmap, shading="auto")
        fig.colorbar(pcm, ax=ax)
        ax.set_title(title)
        fig.tight_layout()
        return fig


class sphericalSlices:
    """θ-slices of spherical (n_r, n_theta, n_phi) data as polar maps."""

    @staticmethod
    def get_fig(data, rs=None, theta_ids=None, log_scale=False, title=""):
        plt = _plt()
        values = np.asarray(data).real
        n_theta = values.shape[1]
        if theta_ids is None:
            theta_ids = [n_theta // 4, n_theta // 2, 3 * n_theta // 4]
        fig, axes = plt.subplots(1, len(theta_ids),
                                 figsize=(4.5 * len(theta_ids), 4),
                                 subplot_kw={"projection": "polar"})
        axes = np.atleast_1d(axes)
        for ax, ti in zip(axes, theta_ids):
            v = values[:, ti, :]
            if log_scale:
                v = np.log10(np.abs(v) + 1e-20)
            n_r, n_phi = v.shape
            r = rs if rs is not None else np.arange(n_r)
            phis = 2 * np.pi * np.arange(n_phi) / n_phi
            P, R = np.meshgrid(np.append(phis, phis[0] + 2 * np.pi), r)
            V = np.concatenate([v, v[:, :1]], axis=1)
            pcm = ax.pcolormesh(P, R, V, shading="auto")
            fig.colorbar(pcm, ax=ax)
            ax.set_title(f"θ index {ti}")
        fig.suptitle(title)
        fig.tight_layout()
        return fig


class detector_heat:
    """Scatter-style detector view from lab-frame pixel positions and
    values, for any geometry."""

    @staticmethod
    def get_fig(pixel_xy, values, log_scale=False, title="", cmap="viridis",
                point_size=1.0):
        plt = _plt()
        xy = np.asarray(pixel_xy).reshape(-1, 2)
        v = np.asarray(values).ravel().real
        if log_scale:
            v = np.log10(np.abs(v) + 1e-20)
        fig, ax = plt.subplots(figsize=(5.5, 5))
        sc = ax.scatter(xy[:, 0], xy[:, 1], c=v, s=point_size, cmap=cmap,
                        marker="s", linewidths=0)
        fig.colorbar(sc, ax=ax)
        ax.set_aspect("equal")
        ax.set_title(title)
        fig.tight_layout()
        return fig
