"""Minimal VTK XML writers for ParaView export, without the `vtk` library.

A numpy copy of `xframe_tpu.io.vtk` (tests/test_torch_host_tables.py holds
the two to the same bytes): spherical or polar grid data is written as a
.vts StructuredGrid (points in cartesian coordinates) with one DataArray
per field, base64-inlined binary.
"""
from __future__ import annotations

import base64
import re
import struct

import numpy as np

_VTK_TYPES = {
    np.dtype(np.float32): "Float32", np.dtype(np.float64): "Float64",
    np.dtype(np.int32): "Int32", np.dtype(np.int64): "Int64",
    np.dtype(np.uint8): "UInt8",
}


def _b64(arr: np.ndarray) -> str:
    """A UInt32 byte-count header, then the raw bytes, base64-encoded."""
    raw = arr.tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode("ascii")


def _data_array(name, arr, n_components=1):
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _VTK_TYPES:
        arr = arr.astype(np.float32)
    return (f'<DataArray type="{_VTK_TYPES[arr.dtype]}" Name="{name}" '
            f'NumberOfComponents="{n_components}" format="binary">\n'
            f"{_b64(arr)}\n</DataArray>\n")


def save_structured_grid(path, points: np.ndarray, fields: dict):
    """points: (n0, n1, n2, 3) cartesian; fields: {name: (n0, n1, n2) array}.

    VTK orders points with the first extent axis fastest, so arrays are
    flattened in Fortran order of the grid axes."""
    points = np.asarray(points, dtype=np.float64)
    n0, n1, n2 = points.shape[:3]
    pts_flat = points.transpose(2, 1, 0, 3).reshape(-1, 3) \
        if points.ndim == 4 else points
    extent = f"0 {n0 - 1} 0 {n1 - 1} 0 {n2 - 1}"
    parts = [
        '<?xml version="1.0"?>\n',
        '<VTKFile type="StructuredGrid" version="0.1" byte_order="LittleEndian" '
        'header_type="UInt32">\n',
        f'<StructuredGrid WholeExtent="{extent}">\n',
        f'<Piece Extent="{extent}">\n',
        "<PointData>\n",
    ]
    for name, arr in fields.items():
        arr = np.asarray(arr)
        if np.iscomplexobj(arr):
            parts.append(_data_array(name + "_real",
                                     arr.real.flatten(order="F")))
            parts.append(_data_array(name + "_imag",
                                     arr.imag.flatten(order="F")))
        else:
            parts.append(_data_array(name, arr.flatten(order="F")))
    parts += [
        "</PointData>\n<Points>\n",
        _data_array("Points", pts_flat, n_components=3),
        "</Points>\n</Piece>\n</StructuredGrid>\n</VTKFile>\n",
    ]
    with open(path, "w") as f:
        f.write("".join(parts))


def save_spherical(path, rs, thetas, phis, fields: dict, close_phi=True):
    """Spherical (r, θ, φ) data → .vts, closing the φ seam for ParaView."""
    from xframe_tpu_torch.library.shapes import (spherical_grid,
                                                 spherical_to_cartesian)
    rs, thetas, phis = map(np.asarray, (rs, thetas, phis))
    out_fields = {k: np.asarray(v) for k, v in fields.items()}
    if close_phi:
        phis = np.concatenate([phis, phis[:1] + 2 * np.pi])
        out_fields = {k: np.concatenate([v, v[..., :1]], axis=-1)
                      for k, v in out_fields.items()}
    grid = spherical_grid(rs, thetas, phis)
    save_structured_grid(path, spherical_to_cartesian(grid), out_fields)


def read_field(path, name):
    """The flat values of DataArray `name` of a .vts written here, in the
    file's point order and type."""
    types = {v: k for k, v in _VTK_TYPES.items()}
    with open(path) as f:
        text = f.read()
    m = re.search(rf'<DataArray type="(\w+)" Name="{re.escape(name)}" '
                  r'NumberOfComponents="\d+" format="binary">\n(\S*)\n',
                  text)
    if m is None:
        raise KeyError(f"no DataArray {name!r} in {path}")
    raw = base64.b64decode(m.group(2))
    (n,) = struct.unpack("<I", raw[:4])
    return np.frombuffer(raw[4:4 + n], dtype=types[m.group(1)])
