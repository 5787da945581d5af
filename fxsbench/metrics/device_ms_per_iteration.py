"""Iteration: milliseconds of the union of the kernels' intervals per
restart-iteration."""


def read(w):
    if not w.kernels or not w.restart_iterations:
        return None
    return w.busy_s(w.kernels) * 1e3 / w.restart_iterations
