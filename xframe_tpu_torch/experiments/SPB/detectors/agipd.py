"""AGIPD-1M detector geometry: module pixel positions in the lab frame.

Numpy copy of the geometry part of `xframe_tpu.experiments.SPB.detectors.
agipd` (see `library/legendre.py` for why the port keeps copies): per-module
corner/fast/slow vectors → (16, 512, 128, 3) pixel-center lab coordinates →
Ewald-sphere scattering coordinates, from a CrystFEL `.geom` file (plain
text, module- or asic-granular panels) or the nominal quadrant layout. It
gives the correlate worker's PanelCorrelator and the SPB experiment
(`experiments/SPB/experiment.py`) a real 1,048,576-pixel geometry. Beam
along +z; distances in meters.
`tests/test_torch_host_tables.py` holds it equal to the original.
"""
from __future__ import annotations

import re

import numpy as np

from xframe_tpu_torch.library.physics import pixel_grid_to_scattering_grid

PIXEL_SIZE = 2.0e-4          # 200 µm
N_MODULES = 16
MODULE_SHAPE = (512, 128)    # (slow, fast) pixels


def module_slow_offsets(n_ss=MODULE_SHAPE[0], ss0=0):
    """Physical slow-axis pixel-center offsets, in pixel units.

    The AGIPD sensor is 519 columns: every 65th physical column (index 64,
    129, …) is an insensitive double-width (0.4 mm) pixel at an ASIC
    boundary (reference agipd.py:132-175, Allagholi et al. §4.2). Data
    column j therefore sits at physical position j + 2·⌊j/64⌋ + ½ standard
    pixels from the module edge (each skipped wide column displaces the
    following ASIC by one extra standard width on both of its flanks)."""
    j = np.arange(ss0, ss0 + n_ss)
    return j + 2 * (j // 64) + 0.5


def nominal_panels(detector_distance=0.217):
    """Nominal 4-quadrant AGIPD-1M layout (approximate EuXFEL arrangement;
    production runs should load a calibrated CrystFEL .geom)."""
    # quadrant corner offsets in pixels (x, y), one per 4-module group
    quads = [(-525.0, 625.0), (-550.0, -10.0), (520.0, -160.0), (542.5, 475.0)]
    panels = {}
    for m in range(N_MODULES):
        q = m // 4
        qx, qy = quads[q]
        # modules stack along -y within a quadrant, 512-px extent + gap
        my = qy - (m % 4) * (MODULE_SHAPE[1] + 4)
        if q < 2:
            fs = np.array([0.0, -1.0, 0.0])   # fast axis
            ss = np.array([-1.0, 0.0, 0.0])   # slow axis
            corner = np.array([qx + MODULE_SHAPE[0], my, 0.0])
        else:
            fs = np.array([0.0, 1.0, 0.0])
            ss = np.array([1.0, 0.0, 0.0])
            corner = np.array([qx - MODULE_SHAPE[0], my - MODULE_SHAPE[1], 0.0])
        panels[f"p{m}"] = {"fs": fs, "ss": ss,
                           "corner": corner * PIXEL_SIZE
                           + np.array([0, 0, detector_distance])}
    return panels


def parse_crystfel_geom(path, detector_distance=None):
    """Minimal CrystFEL .geom reader: `p<m>[a<n>]/{fs,ss,corner_x,corner_y}`
    plus global `res`, `clen`, `coffset`. → panels dict in meters."""
    entries = {}
    globals_ = {"res": 1.0 / PIXEL_SIZE, "clen": detector_distance or 0.217,
                "coffset": 0.0}
    pat = re.compile(r"^\s*(?:(p\d+(?:a\d+)?)/)?(\w+)\s*=\s*(.+?)\s*(?:;.*)?$")
    with open(path) as f:
        for line in f:
            m = pat.match(line)
            if not m:
                continue
            panel, key, value = m.groups()
            if panel is None:
                if key in ("res", "clen", "coffset"):
                    try:
                        globals_[key] = float(value)
                    except ValueError:
                        pass
                continue
            entries.setdefault(panel, {})[key] = value

    def parse_vec(s):
        v = np.zeros(3)
        for num, axis in re.findall(r"([+-]?[\d.]*)\s*([xyz])", s):
            v["xyz".index(axis)] = float(num) if num not in ("", "+", "-") \
                else (1.0 if num != "-" else -1.0)
        return v

    px = 1.0 / globals_["res"]
    z = globals_["clen"] + globals_["coffset"]
    panels = {}
    for name, e in entries.items():
        if "corner_x" not in e:
            continue
        panels[name] = {
            "fs": parse_vec(e["fs"]),
            "ss": parse_vec(e["ss"]),
            "corner": np.array([float(e["corner_x"]) * px,
                                float(e["corner_y"]) * px, z]),
        }
    return panels


class AGIPD:
    """Pixel-center lab coordinates and scattering geometry of AGIPD-1M."""

    data_shape = (N_MODULES,) + MODULE_SHAPE
    pixel_size = PIXEL_SIZE

    def __init__(self, geometry_file=None, detector_distance=0.217,
                 origin=(0.0, 0.0, 0.0)):
        if geometry_file:
            panels = parse_crystfel_geom(geometry_file, detector_distance)
        else:
            panels = nominal_panels(detector_distance)
        self.panels = panels
        self.origin = np.asarray(origin, dtype=float)
        self.pixel_centers = self._assemble(panels)  # (16, 512, 128, 3), m

    def _assemble(self, panels):
        grid = np.zeros(self.data_shape + (3,))
        for name, p in panels.items():
            m = re.match(r"p(\d+)(?:a(\d+))?$", name)
            if not m:
                continue
            mod = int(m.group(1))
            if mod >= N_MODULES:
                continue
            asic = m.group(2)
            ss0 = int(asic) * 64 if asic is not None else 0
            n_ss = 64 if asic is not None else MODULE_SHAPE[0]
            if asic is None:
                # full-module panel: the corner anchors the physical sensor
                # edge, so wide ASIC-boundary pixels shift later rows
                ss_idx = module_slow_offsets(n_ss)[:, None, None]
            else:
                # asic-granular panel: its corner already encodes the wide
                # pixels between ASICs; spacing within one ASIC is uniform
                ss_idx = (np.arange(n_ss) + 0.5)[:, None, None]
            fs_idx = (np.arange(MODULE_SHAPE[1]) + 0.5)[None, :, None]
            pos = p["corner"][None, None, :] \
                + ss_idx * p["ss"][None, None, :] * PIXEL_SIZE \
                + fs_idx * p["fs"][None, None, :] * PIXEL_SIZE
            grid[mod, ss0: ss0 + n_ss] = pos - self.origin[None, None, :]
        return grid

    def pixel_grid_reciprocal(self, wavelength):
        """(16, 512, 128, 3) spherical scattering coordinates (q, θ, φ) on
        the Ewald sphere; wavelength in Å, q in Å⁻¹
        (reference get_pixel_grid_reciprocal path)."""
        return pixel_grid_to_scattering_grid(self.pixel_centers, wavelength)

    @property
    def pixel_xy(self):
        """Flat (N, 2) transverse positions for detector plots."""
        return self.pixel_centers[..., :2].reshape(-1, 2)
