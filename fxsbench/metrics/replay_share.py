"""Phasing dispatch: the share of the window's device time, in %, spent on
the device operations launched inside the program's `xf.replay` spans
(materialising replay's best: up to 15 more whole-batch iterations), over
the share of those launches paired with their operations; unions of
intervals both. None for a program without the span or a window whose
launches do not pair with its device operations (fxsbench/spans.py)."""
from fxsbench.spans import launched_in


def read(w):
    got = launched_in(w, "xf.replay")
    busy = w.busy_s()
    if got is None or busy <= 0:
        return None
    ops, paired = got
    return 100.0 * w.busy_s(ops) / paired / busy
