"""The program's spans in a traced Window, and the device operations each
launched.

The program names its phases with FUNCTION-scope host ranges
(`xframe_tpu_torch.tracing.span`: `xf.iteration`, `xf.projection`,
`xf.replay`, ...); they sit among `Window.host_ops` on the device
operations' clock and have no copy on the GPU row. A device operation
belongs to the spans around the host call that launched it. The trace
carries no link between the two that the Window keeps, so they are paired
by order: on one stream with an empty queue at the window's start the k-th
launch is the k-th device operation to start. The card's traces bend that
in two ways (tutorial.batch8, NVIDIA H100): a profiler session can lose the
records of its first few device operations (3 and 7 of ~208,000 in two
windows), and a fill can trade places with the kernel beside it. Their
times cannot check a pairing: the device's clock in the trace reads up to
~11 ms behind the host's in places, so that operations read as starting
before the launch calls that issued them (nine launches after a sync,
spaced as their nine operations to a few µs, each 230-255 µs after its
operation). So `pairs` pairs by order between anchors, the copies and
fills, which come about once an iteration: the anchors of launches and of
device operations matched from the window's end, a stretch between two
paired anchors paired only where it holds as many launches as operations. A
reader scales by the share of its launches paired and reads None below
MIN_PAIRED. Readers of a program without spans find no span and read None.
"""
from __future__ import annotations

import bisect
import re

from fxsbench.trace import union

# the host calls that put one operation on the device: those that
# tutorial.batch8's traced window records on the card (the CUDA API's
# cuda* and cu* calls; torch's kernels, cuBLAS, the hand kernels' library)
LAUNCHES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cudaMemcpyAsync", "cudaMemsetAsync"))
# a reader's launches of which fewer were paired read None
MIN_PAIRED = 0.99
# any call of the CUDA API: cudaLaunchKernel, cuLaunchKernel,
# cudaStreamSynchronize, ...
_CUDA_CALL = re.compile(r"^cu(da)?[A-Z]")


class Ranges:
    """Sorted, merged [start, end] intervals with a membership test."""

    def __init__(self, intervals):
        merged = union(intervals)
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]

    def __bool__(self):
        return bool(self.starts)

    def __contains__(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]

    def covered(self, s, e):
        """The length of [s, e] that the intervals cover."""
        i = max(bisect.bisect_right(self.starts, s) - 1, 0)
        out = 0.0
        while i < len(self.starts) and self.starts[i] < e:
            out += max(0.0, min(e, self.ends[i]) - max(s, self.starts[i]))
            i += 1
        return out


def spans(w, name):
    """[(start, end)] of the program's spans named `name`, in start order."""
    return sorted((s, e) for n, s, e in w.host_ops if n == name)


def launches(w):
    """(start, name) of the window's launch calls, in order."""
    return sorted((s, n) for n, s, _ in w.host_ops
                  if n in LAUNCHES and w.start <= s <= w.end)


def kind(name):
    """What a launch call or a device operation of this name is: 'Memcpy',
    'Memset' or 'kernel'."""
    for k in ("Memcpy", "Memset"):
        if name.startswith((k, "cuda" + k)):
            return k
    return "kernel"


def pairs(w):
    """[(launch start, its device operation or None)] of the window's
    launches in order: paired by order between anchors (the module's
    docstring), None where a stretch does not pair."""
    calls = launches(w)
    ops = sorted(w.device_ops, key=lambda op: op[1])
    kinds = [kind(n) for _, n in calls], [kind(op[0]) for op in ops]
    anchors = [[k for k, x in enumerate(ks) if x != "kernel"] for ks in kinds]
    m = min(map(len, anchors))
    bounds = [(-1, -1)] + list(zip(anchors[0][len(anchors[0]) - m:],
                                   anchors[1][len(anchors[1]) - m:])) \
        + [(len(calls), len(ops))]
    same = [i < 0 or i == len(calls) or kinds[0][i] == kinds[1][j]
            for i, j in bounds]
    out = [None] * len(calls)
    for k, ((i0, j0), (i1, j1)) in enumerate(zip(bounds, bounds[1:])):
        if same[k] and same[k + 1] and i1 - i0 == j1 - j0:
            for i, j in zip(range(i0 + 1, i1), range(j0 + 1, j1)):
                out[i] = ops[j]
        if i1 < len(calls) and same[k + 1]:
            out[i1] = ops[j1]
    return [(t, op) for (t, _), op in zip(calls, out)]


def launched_in(w, name, outside=None):
    """(the device operations launched inside spans named `name` and not
    inside spans named `outside`, the share of those launches paired);
    None without such a span or with a share under MIN_PAIRED."""
    inside = Ranges(spans(w, name))
    if not inside:
        return None
    skip = Ranges(spans(w, outside)) if outside else Ranges([])
    mine = [op for t, op in pairs(w) if t in inside and t not in skip]
    ops = [op for op in mine if op is not None]
    if not mine or len(ops) < MIN_PAIRED * len(mine):
        return None
    return ops, len(ops) / len(mine)


def cuda_calls(w):
    """Ranges of the host's time inside calls of the CUDA API."""
    return Ranges([(s, e) for n, s, e in w.host_ops if _CUDA_CALL.match(n)])
