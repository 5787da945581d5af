"""Named host ranges around the program's phases, for torch.profiler.

`span(name)` is a context. While a profiler runs it records a
FUNCTION-scope range, `torch._C._profiler._RecordFunctionFast(name)`: a
`cpu_op` in the profiler's trace, on the host clock the device operations
share, whose parent is the span or op that encloses it on the same thread.
Unlike `torch.profiler.record_function` (a user annotation) it puts no copy
of itself on the GPU row, so a trace's device operations are the same with
spans as without. With no profiler running, or on a torch without that
API, `span` returns one shared no-op context after one flag check. Nothing
is stored here: the profiler keeps the ranges and writes them out.

The spans (PERF.md lists each with what reads it): `xf.setup`,
`xf.kernels.load`, `xf.segment.<method>`, `xf.iteration`, `xf.projection`,
`xf.shrink_wrap`, `xf.replay`.
"""
from __future__ import annotations

import contextlib

import torch

_NONE = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def span(name: str):
    """A range named `name` while a profiler runs, else a no-op context."""
    if _Range is None or not _profiling():
        return _NONE
    return _Range(name)
