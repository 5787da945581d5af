"""Build and load the package's CUDA kernels.

`library()` compiles each `csrc/*.cu` with nvcc, all of them at once in
parallel, and links the objects into one shared library with a plain C
interface on first use, keyed by a hash of the sources, headers and flags,
under `xframe_tpu_torch/_build/`, and loads it with ctypes. Nothing here runs
at import time: the CPU tests import every module on machines without nvcc.
A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from xframe_tpu_torch.tracing import span

_PKG = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# C entry points: (pointer arguments, int arguments), then the stream.
_ENTRY_POINTS = {
    "xf_sht_forward": (7, 6),
    "xf_sht_forward_real": (7, 6),
    "xf_sht_forward_real_abs2": (7, 6),
    "xf_sht_inverse": (7, 6),
    "xf_sht_inverse_real": (7, 6),
    "xf_hankel_synthesize": (9, 7),
    "xf_inverse_real_project_fwd": (14, 7),
    "xf_synthesize_update": (12, 9),
    "xf_inverse_real_project": (10, 7),
    "xf_synthesize_abs2": (12, 6),
    "xf_polar_unitary": (5, 6),
    "xf_fused_projection": (8, 10),
    "xf_max_active_clusters": (1, 3),
}
# the bf16-table forms (fourier_transform.fused_bf16_tables) of the SHT and
# fused-iteration entry points: the same arguments, PW and Pt in bf16
BF16_SUFFIX = "_bf16"
_ENTRY_POINTS.update({
    name + BF16_SUFFIX: _ENTRY_POINTS[name] for name in (
        "xf_sht_forward", "xf_sht_forward_real", "xf_sht_forward_real_abs2",
        "xf_sht_inverse", "xf_sht_inverse_real", "xf_hankel_synthesize",
        "xf_inverse_real_project_fwd", "xf_synthesize_update",
        "xf_inverse_real_project", "xf_synthesize_abs2")})


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda, or PATH; raises if absent."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build xframe_tpu_torch's CUDA kernels")
    return found


def _sources():
    return sorted(SOURCE_DIR.glob("*.cu"))


def _run_all(cmds):
    """Run the commands in parallel; raise on the first that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> tuple[Path, float]:
    """Compile the kernels if no library for the current sources exists.
    → (library path, seconds spent compiling; 0.0 when already built)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SOURCE_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libxf_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in _sources()]
    t0 = time.perf_counter()
    _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(_sources(), objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out, seconds


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library with argtypes and restype set, and as
    `compile_s` the seconds its build() spent compiling."""
    with span("xf.kernels.load"):
        path, seconds = build()
        lib = ctypes.CDLL(str(path))
    lib.compile_s = seconds
    for name, (n_ptr, n_int) in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def compile_seconds() -> float:
    """The seconds this process spent compiling the kernels: library()'s
    build, 0.0 while the library is not loaded. Loading nothing itself."""
    return library().compile_s if library.cache_info().currsize else 0.0


def kernel_input(x, dtype):
    """x as a contiguous tensor of `dtype` whose memory holds its values. A
    lazily conjugated or negated view (x.conj(), or x.mH of a column-major
    tensor such as torch.linalg.qr's Q) can already be contiguous, and a
    kernel reads the memory behind data_ptr(), not the view."""
    return x.to(dtype).resolve_conj().resolve_neg().contiguous()


def ptr(x):
    """x.data_ptr(), or None (a null pointer) for None."""
    return None if x is None else x.data_ptr()


def launch(name: str, device, *args) -> None:
    """Call a C entry point on `device`'s current stream with `device` the
    current CUDA device: the C side reads the current device (the FFT line
    rule's cudaGetDevice, cudaFuncSetAttribute, the occupancy queries), and
    CUDA refuses a launch into another device's stream. Raise on a
    non-zero cudaError_t."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")
