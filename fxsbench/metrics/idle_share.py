"""Device: the share of the window in which no kernel ran, in %."""


def read(w):
    if not w.kernels or w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s(w.kernels) / w.window_s)
