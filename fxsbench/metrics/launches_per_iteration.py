"""Phasing dispatch: every CUDA kernel the traced window recorded (hand
kernels, cuBLAS, elementwise) per batch-iteration of the schedule."""


def read(w):
    if not w.kernels or not w.batch_iterations:
        return None
    return len(w.kernels) / w.batch_iterations
