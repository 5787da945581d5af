"""Projection: milliseconds of the union of the cuBLAS GEMM kernels'
intervals per restart-iteration (Newton–Schulz, PD·I and V·W, and any
Hankel GEMM on cuBLAS)."""
from fxsbench.trace import is_cublas


def read(w):
    ops = [k for k in w.kernels if is_cublas(k[0])]
    if not ops or not w.restart_iterations:
        return None
    return w.busy_s(ops) * 1e3 / w.restart_iterations
