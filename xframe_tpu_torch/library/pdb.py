"""PDB reader and electron densities from PDB and map files (host numpy).

Numpy copy of `xframe_tpu.library.pdb` (see `library/legendre.py` for why
the port keeps copies): density from a local CCP4/MRC map (`read_ccp4`,
`MapDensity`, `map_density`: header bookkeeping, crs<->xyz conversions and
nearest-neighbour sampling with out-of-map fill values) and, without a
map, atoms of a local PDB file smeared with Gaussians (`parse_pdb`,
`pdb_density`). `write_ccp4` writes a map (test fixtures, interchange).
`tests/test_torch_host_tables.py` holds the copy equal to the original.
"""
from __future__ import annotations

import gzip
import struct

import numpy as np

# electron counts of common elements (neutral atoms)
ELECTRONS = {
    "H": 1, "HE": 2, "LI": 3, "BE": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "NE": 10, "NA": 11, "MG": 12, "P": 15, "S": 16, "CL": 17,
    "K": 19, "CA": 20, "MN": 25, "FE": 26, "CO": 27, "NI": 28, "CU": 29,
    "ZN": 30, "SE": 34, "BR": 35, "I": 53,
}


def parse_pdb(path):
    """→ (positions (N,3) Å, electrons (N,), occupancies (N,))."""
    opener = gzip.open if str(path).endswith(".gz") else open
    pos, zs, occ = [], [], []
    with opener(path, "rt") as f:
        for line in f:
            if not (line.startswith("ATOM") or line.startswith("HETATM")):
                continue
            try:
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
                o = float(line[54:60]) if line[54:60].strip() else 1.0
            except ValueError:
                continue
            elem = line[76:78].strip().upper()
            if not elem:  # fall back to the atom-name column
                elem = "".join(c for c in line[12:16].strip()
                               if c.isalpha())[:1].upper()
            pos.append((x, y, z))
            zs.append(ELECTRONS.get(elem, 6))
            occ.append(o)
    if not pos:
        raise ValueError(f"no ATOM/HETATM records in {path}")
    return (np.asarray(pos, dtype=float), np.asarray(zs, dtype=float),
            np.asarray(occ, dtype=float))


def pdb_density(path, grid_cartesian, resolution=4.0, center=True,
                chunk_atoms=512):
    """Electron density on `grid_cartesian` (..., 3) from a PDB file:
    ρ(x) = Σ_i Z_i·occ_i·N(σ)·exp(-|x-x_i|²/2σ²), σ = resolution/(2√(2ln2))
    (FWHM = resolution). Chunked over atoms to bound memory."""
    pos, zs, occ = parse_pdb(path)
    if center:
        com = (pos * (zs * occ)[:, None]).sum(0) / (zs * occ).sum()
        pos = pos - com
    sigma = float(resolution) / (2 * np.sqrt(2 * np.log(2)))
    norm = 1.0 / ((2 * np.pi) ** 1.5 * sigma ** 3)
    grid = np.asarray(grid_cartesian, dtype=np.float32)
    flat = grid.reshape(-1, 3)
    out = np.zeros(len(flat), dtype=np.float64)
    w = (zs * occ * norm).astype(np.float64)
    for i in range(0, len(pos), chunk_atoms):
        p = pos[i: i + chunk_atoms].astype(np.float32)
        d2 = ((flat[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        out += np.exp(-d2 / (2 * sigma ** 2)) @ w[i: i + chunk_atoms]
    return out.reshape(grid.shape[:-1])

# --------------------------------------------------------- CCP4 / MRC maps

def _orthogonalization_matrix(a, b, c, alpha, beta, gamma):
    """Fractional → cartesian (Å) matrix, standard PDB convention."""
    ca, cb, cg = (np.cos(np.deg2rad(x)) for x in (alpha, beta, gamma))
    sg = np.sin(np.deg2rad(gamma))
    v = np.sqrt(1.0 - ca * ca - cb * cb - cg * cg + 2.0 * ca * cb * cg)
    return np.array([
        [a, b * cg, c * cb],
        [0.0, b * sg, c * (ca - cb * cg) / sg],
        [0.0, 0.0, c * v / sg]])


def read_ccp4(path):
    """Parse a CCP4/MRC electron-density map file → MapDensity.

    Header per the CCP4 map spec (+ MRC-2000 ORIGIN words); data mode 2
    (float32) or 0 (int8) or 1 (int16). The density is exposed indexed
    [column, row, section] to match the reference's `density.T` layout
    (pdb_plugin.py:41-46)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        head = f.read(1024)
        if len(head) < 1024:
            raise ValueError(f"{path}: truncated CCP4 header")
        ints = struct.unpack("<56i", head[:224])
        flts = struct.unpack("<56f", head[:224])
        magic = head[208:212]
        if magic not in (b"MAP ", b"MAP\x00"):
            # try big-endian before giving up
            ints_be = struct.unpack(">56i", head[:224])
            if head[208:212] in (b"MAP ", b"MAP\x00") or ints_be[0] > 0:
                raise ValueError(
                    f"{path}: big-endian CCP4 maps are not supported")
            raise ValueError(f"{path}: not a CCP4/MRC map (no MAP magic)")
        n_crs = np.asarray(ints[0:3])
        mode = ints[3]
        crs_start = np.asarray(ints[4:7])
        xyz_interval = np.asarray(ints[7:10])
        cell = np.asarray(flts[10:16])
        mapcrs = np.asarray(ints[16:19]) - 1          # (MAPC, MAPR, MAPS)
        nsymbt = ints[23]
        origin_words = np.asarray(flts[49:52])
        f.read(nsymbt)
        count = int(np.prod(n_crs))
        dt = {0: np.int8, 1: np.int16, 2: np.float32}.get(mode)
        if dt is None:
            raise ValueError(f"{path}: unsupported CCP4 mode {mode}")
        data = np.frombuffer(f.read(count * np.dtype(dt).itemsize),
                             dtype=np.dtype(dt).newbyteorder("<"),
                             count=count)
    # file order: column fastest, then row, then section → (s, r, c); the
    # reference samples a [c, r, s]-indexed array (its pdb_eda `.T`)
    density = np.ascontiguousarray(
        data.reshape(n_crs[::-1]).T.astype(np.float32))
    return MapDensity(density, n_crs=n_crs, crs_start=crs_start,
                      xyz_interval=xyz_interval, cell=cell, mapcrs=mapcrs,
                      origin_words=origin_words)


def write_ccp4(path, density_crs, cell, mapcrs=(1, 2, 3), crs_start=(0, 0, 0),
               xyz_interval=None, origin=None):
    """Minimal CCP4 writer (fixture/interchange; the reference raises
    NotImplementedError on PDB save). density_crs: [column, row, section]
    indexed, written as mode-2 float32. cell: (a, b, c, α, β, γ)."""
    d = np.asarray(density_crs, dtype=np.float32)
    n_crs = d.shape
    if xyz_interval is None:
        # one cell spanning the map along each xyz axis
        xyz_interval = tuple(np.asarray(n_crs)[np.argsort(
            np.asarray(mapcrs) - 1)])
    head = bytearray(1024)
    struct.pack_into("<3i", head, 0, *n_crs)
    struct.pack_into("<i", head, 12, 2)                      # MODE 2
    struct.pack_into("<3i", head, 16, *crs_start)
    struct.pack_into("<3i", head, 28, *xyz_interval)
    struct.pack_into("<6f", head, 40, *cell)
    struct.pack_into("<3i", head, 64, *mapcrs)
    struct.pack_into("<3f", head, 76, float(d.min()), float(d.max()),
                     float(d.mean()))
    struct.pack_into("<i", head, 92, 0)                      # NSYMBT (word 24)
    if origin is not None:
        struct.pack_into("<3f", head, 196, *origin)          # words 50-52
    head[208:212] = b"MAP "
    struct.pack_into("<4B", head, 212, 0x44, 0x44, 0, 0)     # LE machine stamp
    with open(path, "wb") as f:
        f.write(bytes(head))
        # file order: column fastest → transpose [c,r,s] → (s,r,c)
        f.write(np.ascontiguousarray(d.T).tobytes())


class MapDensity:
    """Experimental electron-density map with the reference DensityExtractor's
    sampling surface (pdb_plugin.py:47-133): header bookkeeping, crs↔xyz
    conversions (orthogonal fast path + orthogonalization matrix for non-90°
    cells), nearest-neighbor xyz sampling with out-of-map fill values."""

    def __init__(self, density, n_crs, crs_start, xyz_interval, cell, mapcrs,
                 origin_words=(0.0, 0.0, 0.0)):
        self.density = np.asarray(density)                  # [c, r, s]
        self.n_crs = np.asarray(n_crs, dtype=int)
        self.crs_start = np.asarray(crs_start, dtype=int)
        self.xyz_interval = np.asarray(xyz_interval, dtype=int)
        self.cell = np.asarray(cell, dtype=float)
        a, b, c, self.alpha, self.beta, self.gamma = self.cell
        mapcrs = np.asarray(mapcrs, dtype=int)
        # map_to_xyz[j] = which crs component counts along xyz axis j;
        # map_to_crs[i] = which xyz axis crs component i counts along
        # (reference header_part.map_to_xyz/map_to_crs)
        self.map_to_crs = mapcrs
        self.map_to_xyz = np.argsort(mapcrs)
        self.grid_length = self.cell[:3] / self.xyz_interval
        self.ortho_mat = _orthogonalization_matrix(a, b, c, self.alpha,
                                                   self.beta, self.gamma)
        self.inv_ortho_mat = np.linalg.inv(self.ortho_mat)
        ow = np.asarray(origin_words, dtype=float)
        # MRC-2000 ORIGIN words win when set; else CCP4 crsStart convention
        # (same rule pdb_eda applies)
        self.origin = ow if np.any(ow != 0.0) \
            else self.crs_start[self.map_to_xyz] * self.grid_length
        self._orthogonal = (self.alpha == self.beta == self.gamma == 90.0)

    # ------------------------------------------------- coordinate transforms
    def crs2xyz(self, crs):
        """crs index triples (N, 3) → cartesian Å (pdb_plugin.py:77-89)."""
        crs = np.atleast_2d(crs)
        if self._orthogonal:
            xyz = crs[:, self.map_to_xyz] * self.grid_length[None, :] \
                + self.origin[None, :]
        else:
            frac = (crs[:, self.map_to_xyz]
                    + self.crs_start[None, self.map_to_xyz]) \
                / self.xyz_interval[None, :]
            xyz = (self.ortho_mat @ frac.T).T
        return np.squeeze(xyz)

    def xyz2crs(self, xyz):
        """Cartesian Å → nearest crs index triples (pdb_plugin.py:91-102)."""
        xyz = np.atleast_2d(xyz)
        if self._orthogonal:
            crs = np.rint((xyz - self.origin[None, :])
                          / self.grid_length[None, :])[:, self.map_to_crs]
        else:
            frac = (self.inv_ortho_mat @ xyz.T).T
            crs = (np.rint(frac * self.xyz_interval[None, :])
                   - self.crs_start[None, self.map_to_xyz])[:, self.map_to_crs]
        return np.squeeze(crs).astype(int)

    # ------------------------------------------------------------- sampling
    def valid_crs(self, coords, return_mask=False):
        """Triples with 0 <= v[i] < n_crs[i] (pdb_plugin.py:124-133)."""
        coords = np.atleast_2d(coords)
        mask = np.all((coords >= 0) & (coords < self.n_crs[None, :]), axis=-1)
        if return_mask:
            return coords[mask], mask
        return coords[mask]

    def sample_xyz(self, points, fill_value=0.0):
        """Nearest-neighbor density at cartesian points (..., 3)
        (pdb_plugin.py:104-123)."""
        shape = np.shape(points)
        crs = self.xyz2crs(np.reshape(points, (-1, 3)))
        crs = np.atleast_2d(crs)
        valid, mask = self.valid_crs(crs, return_mask=True)
        out = np.full(crs.shape[0], fill_value, dtype=self.density.dtype)
        out[mask] = self.density[valid[:, 0], valid[:, 1], valid[:, 2]]
        return out.reshape(shape[:-1])

    def center_of_mass_xyz(self):
        """Density-weighted center (for recentring particles on our grids)."""
        idx = np.stack(np.meshgrid(*[np.arange(n) for n in self.n_crs],
                                   indexing="ij"), axis=-1).reshape(-1, 3)
        xyz = np.atleast_2d(self.crs2xyz(idx))
        w = np.clip(self.density.reshape(-1), 0.0, None).astype(np.float64)
        tot = w.sum()
        return (xyz * w[:, None]).sum(0) / tot if tot > 0 \
            else xyz.mean(axis=0)


def map_density(path, grid_cartesian, center=True, fill_value=0.0):
    """Experimental density from a local CCP4/MRC file sampled onto an
    arbitrary cartesian grid (..., 3) in Å — the local-file counterpart of
    the reference's pdb_eda 2Fo-Fc path. center=True shifts the map's
    density center of mass to the grid origin (our spherical grids are
    particle-centered)."""
    m = read_ccp4(path)
    pts = np.asarray(grid_cartesian, dtype=float)
    if center:
        pts = pts + m.center_of_mass_xyz()
    return m.sample_xyz(pts, fill_value=fill_value)


MAP_EXTENSIONS = (".ccp4", ".mrc", ".map", ".ccp4.gz", ".mrc.gz", ".map.gz")


def is_map_file(path):
    return str(path).lower().endswith(MAP_EXTENSIONS)
