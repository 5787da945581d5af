"""The raw-frame reader of the correlate worker: a C++ thread pool bound
with ctypes.

Port of `xframe_tpu.native.read_frame_batch` and `PrefetchingFrameLoader`
(`frame_reader.cpp` is a copy of the JAX package's). The library is built
with g++ on first use into `xframe_tpu_torch/_build/`, keyed by a hash of
the source and flags, never beside the source; nothing is built at import
time. A failed build raises: there is no numpy fallback. Per frame, `ok`
says whether the file was read whole; a missing file or a short read gives
a zero frame flagged bad.
"""
from __future__ import annotations

import concurrent.futures as cf
import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "frame_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
DTYPE_CODES = {
    np.dtype(np.float32): 0, np.dtype(np.float64): 1,
    np.dtype(np.int32): 2, np.dtype(np.uint16): 3, np.dtype(np.int16): 4,
}


def build() -> Path:
    """Compile the reader if no library for the current source exists.
    → its path. Concurrent builds each write their own temporary file and
    move it over the target, so a reader never loads half a library."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libframereader_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE.name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded reader with argtypes and restype set."""
    lib = ctypes.CDLL(str(build()))
    lib.read_frames.restype = ctypes.c_int
    lib.read_frames.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    return lib


def read_frame_batch(paths, frame_shape, dtype=np.float32, n_threads=8,
                     out=None):
    """Read len(paths) raw frames of `dtype` into a (B, *frame_shape)
    float32 array (`out` if given: C-contiguous float32 of that shape).
    → (batch, ok): ok is a (B,) bool mask of the frames read whole; the
    others are zero-filled."""
    dtype = np.dtype(dtype)
    if dtype not in DTYPE_CODES:
        raise ValueError(f"frame dtype {dtype} is not one of "
                         f"{sorted(map(str, DTYPE_CODES))}")
    shape = (len(paths),) + tuple(int(n) for n in frame_shape)
    batch = np.empty(shape, dtype=np.float32) if out is None else out
    if batch.shape != shape or batch.dtype != np.float32 \
            or not batch.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous float32 of shape {shape}")
    ok = np.zeros(len(paths), dtype=np.uint8)
    if not paths:
        return batch, ok.astype(bool)
    names = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    library().read_frames(
        names, len(paths),
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(np.prod(frame_shape)), DTYPE_CODES[dtype], int(n_threads),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return batch, ok.astype(bool)


class PrefetchingFrameLoader:
    """Double-buffered batch iterator: the next batch is read by the C++
    thread pool while the current one is consumed.

    With `buffers` (two C-contiguous float32 arrays of shape (batch_size,
    *frame_shape), e.g. views of pinned host tensors) the batches are read
    into them in turn, and a yielded batch stays valid until the next one
    is requested; a consumer that copies it to a device asynchronously
    waits for that copy before asking for the next batch. Without, every
    batch is a new array."""

    def __init__(self, paths, frame_shape, dtype=np.float32, batch_size=64,
                 n_threads=8, buffers=None):
        self.paths = list(paths)
        self.frame_shape = tuple(int(n) for n in frame_shape)
        self.dtype = np.dtype(dtype)
        self.batch_size = int(batch_size)
        self.n_threads = int(n_threads)
        self.buffers = buffers
        if buffers is not None and len(buffers) != 2:
            raise ValueError("buffers: two arrays, one per batch in flight")

    def _read(self, i, chunk):
        out = None if self.buffers is None else \
            self.buffers[i % 2][: len(chunk)]
        return read_frame_batch(chunk, self.frame_shape, self.dtype,
                                self.n_threads, out=out)

    def __iter__(self):
        """Yields (batch, ok) pairs; ok flags frames that loaded whole."""
        chunks = [self.paths[i: i + self.batch_size]
                  for i in range(0, len(self.paths), self.batch_size)]
        if not chunks:
            return
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(self._read, 0, chunks[0])
            for i in range(len(chunks)):
                batch, ok = pending.result()
                if i + 1 < len(chunks):
                    pending = pool.submit(self._read, i + 1, chunks[i + 1])
                yield batch, ok
