"""Phasing dispatch: the host's milliseconds of work in one batch-iteration,
the median over the program's `xf.iteration` spans outside `xf.replay` of
the span's duration less its time inside calls of the CUDA API:
Python and torch dispatch, without the launch calls themselves, which
block once the launch queue is full. Read under the profiler, which adds
to it. None for a program without the spans."""
import statistics

from fxsbench.spans import Ranges, cuda_calls, spans


def read(w):
    replay = Ranges(spans(w, "xf.replay"))
    its = [(s, e) for s, e in spans(w, "xf.iteration") if s not in replay]
    if not its:
        return None
    calls = cuda_calls(w)
    return statistics.median(
        (e - s - calls.covered(s, e)) * 1e-3 for s, e in its)
