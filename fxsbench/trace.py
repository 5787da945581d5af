"""The traced window: the device operations and host ops that
torch.profiler recorded over it, the union of the device's busy intervals,
and the breakdown of the result line. Per-layer metric readers
(fxsbench/metrics/<name>.py) read a Window.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

MARKER = "fxsbench.window"

# the hand-written kernels of csrc/ by base name, and the fused-iteration
# or projection kernel ("B<n>") each belongs to on the default path
HAND_KERNELS = {
    "analysis_fft_kernel": "B1/B3/B9", "analysis_kernel": "B1/B3/B9",
    "quadrature_gemm_kernel": "B1/B3/B9", "quadrature_bf16_kernel": "B1/B3/B9",
    "legendre_gemm_kernel": "B2/B5/B6/B10", "legendre_bf16_kernel":
    "B2/B5/B6/B10", "synthesis_fft_kernel": "B2/B5/B6/B10",
    "synthesis_kernel": "B2/B5/B6/B10", "hankel_gemm_kernel": "B6",
    "project_fft_kernel": "B4", "project_dft_kernel": "B4",
    "quadrature_kernel": "B4", "polar_kernel": "B7", "project_kernel": "B8",
}
B4_KERNELS = ("project_fft_kernel", "project_dft_kernel", "quadrature_kernel")
_CUBLAS = re.compile(r"gemm|gemv|xmma|cutlass|cublas", re.IGNORECASE)
_HAND = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(HAND_KERNELS)
                   + r")(?=\s*[<(])")
_ANON = "(anonymous namespace)::"


def hand_kernel(name):
    """The hand-written kernel a demangled kernel name belongs to, or
    None: 'void (anonymous namespace)::k<8>(float*)' → 'k'."""
    m = _HAND.search(name)
    return m.group(1) if m else None


def is_cublas(name):
    """A library GEMM kernel: a GEMM-like name that no hand kernel has."""
    return hand_kernel(name) is None and bool(_CUBLAS.search(name))


def short_name(name):
    """The demangled name without its anonymous namespace, its return type
    'void ' and its parameter list."""
    name = name.replace(_ANON, "").strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[5:] if name.startswith("void ") else name


def label(name):
    """The breakdown's name of a device operation."""
    short = short_name(name)
    hand = hand_kernel(name)
    if hand:
        short = f"{HAND_KERNELS[hand]} {short}"
    elif is_cublas(name):
        short = f"cuBLAS {short}"
    return short[:120]


def union(intervals):
    """Merged (start, end) intervals of a list of (start, end)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclass
class Window:
    """What one traced window recorded, times in microseconds: kernels and
    device_ops (kernels, copies, fills) as (name, start, end), host_ops
    likewise, the window's [start, end], and what ran in it: batches of
    batch_size restarts, each through `iterations` iterations of the
    schedule, on a grid of `shapes` (n_q, l_max, n_theta, n_phi,
    restarts)."""
    kernels: list
    device_ops: list
    host_ops: list
    start: float
    end: float
    batches: int
    batch_size: int
    iterations: int
    shapes: dict = field(default_factory=dict)

    @property
    def window_s(self):
        return (self.end - self.start) * 1e-6

    @property
    def batch_iterations(self):
        return self.batches * self.iterations

    @property
    def restart_iterations(self):
        return self.batch_iterations * self.batch_size

    def busy_s(self, ops=None):
        """Seconds of the union of the given (default: all device)
        operations' intervals inside the window."""
        ops = self.device_ops if ops is None else ops
        spans = [(max(s, self.start), min(e, self.end)) for _, s, e in ops
                 if e > self.start and s < self.end]
        return sum(e - s for s, e in union(spans)) * 1e-6

    def idle_gaps(self):
        """[(host op at the gap's midpoint, seconds)] of every stretch of
        the window with no device operation, longest first."""
        busy = union([(max(s, self.start), min(e, self.end))
                      for _, s, e in self.device_ops
                      if e > self.start and s < self.end])
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:10]:
            mid = 0.5 * (s + e)
            inside = [(he - hs, n) for n, hs, he in self.host_ops
                      if hs <= mid <= he and n != MARKER]
            out.append((min(inside)[1] if inside else "(no host op)",
                        (e - s) * 1e-6))
        return out

    def top_device_ops(self, n=10):
        """[(label, seconds)] of the device operations by total time."""
        tot = {}
        for name, s, e in self.device_ops:
            key = label(name)
            tot[key] = tot.get(key, 0.0) + (e - s) * 1e-6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


def _raw_events(prof):
    """(name, is_device, start_us, end_us) of every recorded event."""
    from torch.autograd import DeviceType
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results",
                     None)
    if kineto is not None:
        out = []
        for e in kineto.events():
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
            else:
                s, d = float(e.start_us()), float(e.duration_us())
            out.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                        s + d))
        return out
    return [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
             e.time_range.end) for e in prof.events()]


def collect(prof, batches, batch_size, iterations, shapes):
    """A Window from a finished torch.profiler.profile whose window ran
    under record_function(MARKER); device operations outside it are left
    out."""
    host, device, marks = [], [], []
    for name, on_device, s, e in _raw_events(prof):
        if on_device:
            if name != MARKER:          # the range's copy on the GPU row
                device.append((name, s, e))
        elif name == MARKER:
            marks.append((s, e))
        else:
            host.append((name, s, e))
    if not marks:
        raise RuntimeError(f"the profiler recorded no {MARKER!r} range")
    start, end = min(s for s, _ in marks), max(e for _, e in marks)
    device = [op for op in device if op[2] > start and op[1] < end]
    kernels = [op for op in device
               if not op[0].startswith(("Memcpy", "Memset"))]
    return Window(kernels=kernels, device_ops=device, host_ops=host,
                  start=start, end=end, batches=batches,
                  batch_size=batch_size, iterations=iterations,
                  shapes=shapes)
