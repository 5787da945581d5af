"""Projection: milliseconds of the union of the device operations launched
inside the program's `xf.projection` spans (the reciprocal constraint's
call in every iteration: Newton–Schulz's GEMMs and elementwise steps, the
crops) outside `xf.replay`, per restart-iteration of the schedule, over
the share of those launches paired with their operations. None for a
program without the spans or a window whose launches do not pair with its
device operations (fxsbench/spans.py)."""
from fxsbench.spans import launched_in


def read(w):
    got = launched_in(w, "xf.projection", outside="xf.replay")
    if got is None or not w.restart_iterations:
        return None
    ops, paired = got
    return w.busy_s(ops) * 1e3 / w.restart_iterations / paired
