"""Nested dicts as HDF5 files, with the JAX package's on-disk conventions.

A copy of `xframe_tpu.io.hdf5` (tests/test_torch_hdf5.py holds each
package to reading the other's files): dicts are groups; lists and tuples
are groups tagged `type=list|tuple` whose children are named by their
index; strings are utf-8 datasets tagged `type=str`; None is a dataset
tagged `type=none`; object arrays are written as lists and unicode arrays
as byte strings; every other value is a plain dataset.

h5py is imported inside the functions that read or write, so the package
imports where h5py is not installed; `available()` says whether it is.
"""
from __future__ import annotations

import numpy as np

MISSING = "h5py is not installed"


def available() -> bool:
    """Whether h5py imports here."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def require():
    """h5py, or an ImportError that names it."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(f"{MISSING}: HDF5 files cannot be read or "
                          "written") from exc
    return h5py


def save(path, data: dict):
    with require().File(path, "w") as f:
        _save_group(f, data)


def load(path, skip=()) -> dict:
    """The nested dict of an HDF5 file; members named in `skip` are not
    read."""
    h5py = require()
    with h5py.File(path, "r") as f:
        return _load_group(h5py, f, frozenset(skip))


def _save_group(group, data: dict):
    for key, item in data.items():
        _save_item(group, str(key), item)


def _save_item(group, key, item):
    if item is None:
        d = group.create_dataset(key, data=np.uint8(0))
        d.attrs["type"] = "none"
    elif isinstance(item, str):
        d = group.create_dataset(key, data=item.encode("utf-8"))
        d.attrs["type"] = "str"
    elif isinstance(item, (bool, int, float, complex, bytes, np.number,
                           np.bool_)):
        group.create_dataset(key, data=item)
    elif isinstance(item, np.ndarray):
        if item.dtype == object:
            # ragged object arrays (per-l V_l) are written as lists
            _save_item(group, key, list(item))
        elif item.dtype.kind == "U":
            group.create_dataset(key, data=item.astype("S"))
        else:
            group.create_dataset(key, data=item)
    elif isinstance(item, (list, tuple)):
        sub = group.create_group(key)
        sub.attrs["type"] = "list" if isinstance(item, list) else "tuple"
        for i, elem in enumerate(item):
            _save_item(sub, str(i), elem)
    elif isinstance(item, dict):
        _save_group(group.create_group(key), item)
    elif hasattr(item, "__array__"):      # torch tensors on the CPU
        _save_item(group, key, np.asarray(item))
    else:
        raise TypeError(f"cannot save type {type(item)!r} at key {key!r}")


def _load_group(h5py, group, skip) -> dict:
    return {key: _load_item(h5py, item, skip)
            for key, item in group.items() if key not in skip}


def _load_item(h5py, item, skip):
    tag = item.attrs.get("type", None)
    if isinstance(item, h5py.Dataset):
        if tag == "none":
            return None
        if tag == "str":
            raw = item[()]
            return raw.decode("utf-8") if isinstance(raw, bytes) else str(raw)
        value = item[()]
        if isinstance(value, bytes):
            return value.decode("utf-8")
        return value
    if tag in ("list", "tuple"):
        seq = [_load_item(h5py, item[str(i)], skip) for i in range(len(item))]
        return seq if tag == "list" else tuple(seq)
    return _load_group(h5py, item, skip)
