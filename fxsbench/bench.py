"""One run of one cell of the benchmark of `xframe_tpu_torch`'s reconstruct
worker: set-up through the user path, a closed loop of restart batches for
--seconds, the comparison that decides `correct`, and the result line.

Everything a cell needs is found by name: BENCHMARK.json names the cell's
configuration file and traffic mix (fxsbench/traffic/<traffic>.json), and
each per-layer metric is read by fxsbench/metrics/<metric>.py.

Set-up: the invariants of the configuration's particle
(fxsbench/inputs.py), then
ProjectWorker(settings).setup_mtip(inv), its schedule, a MultiStartRunner,
and one short batch through the cell's shapes. The window: batches of
`batch_size` restarts back to back, each its initial densities from
batch_seed(seed, i), the runner over the settings' whole schedule, then
rank_restarts; a batch starts only while the window has run less than
--seconds, and the batch in flight finishes. With --trace 1 the window is
one batch under torch.profiler. After the window the program's judged
batches (check.MIN_RESTARTS restarts or more, from a batch drawn from the
seed on; any the window did not run run then) go through the program's
stages that the comparison holds (program_taps, program_finals), and
the reference (fxsbench/check.py) judges what they produced.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from fxsbench import check, inputs, trace

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "xframe_tpu")
BATCH_SEED_BITS = 12      # batch i of a run with seed s: (s << 12) + i
ITERATING = ("HIO", "ER", "RAAR")


def batch_seed(seed, i):
    """The starting densities' seed of batch i (the warm-up's: -1): runs
    with nearby seeds share no batch."""
    return (int(seed) << BATCH_SEED_BITS) + (i % (1 << BATCH_SEED_BITS))


class Refused(Exception):
    """The run cannot be made here (no card, too few cards, a module that
    must not load); nothing is printed on standard output."""


def deep_merge(base, extra):
    out = dict(base)
    for k, v in extra.items():
        out[k] = deep_merge(out[k], v) \
            if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(root, workload):
    """→ (manifest, cell entry, configuration, traffic) of `workload`."""
    root = Path(root)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / "fxsbench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return manifest, cell, config, traffic


def cell_metrics(manifest, workload, kind):
    """The `kind` ("end_to_end" or "per_layer") metrics that `workload`
    reports: those that list it, or list no cells and move a metric the
    cell reports."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in moves]


def load_reader(root, name):
    """read(window) of fxsbench/metrics/<name>.py."""
    import importlib.util
    path = Path(root) / "fxsbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"fxsbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def warm_schedule(schedule, segment_cls):
    """Two iterations of each (method, ft-stab) the schedule runs, in its
    order, and its first and last shrink-wrap: every shape of the window."""
    out, seen = [], set()
    sws = [s for s in schedule if s.method in ("SW", "SW_center")]
    for seg in schedule:
        if seg.method in ("SW", "SW_center"):
            continue
        key = (seg.method, seg.ft_stab,
               getattr(seg, "ft_stab_link_delay", 0))
        if key in seen:
            continue
        seen.add(key)
        out.append(segment_cls(seg.method, 2, betas=seg.betas[:2],
                               ft_stab=seg.ft_stab,
                               ft_stab_link_delay=key[2]))
        if sws and len(out) == 1:
            out.append(sws[0])
    if len(sws) > 1:
        out.insert(len(out) - 1, sws[-1])
    return out


def iteration_spans(schedule):
    """(method, first iteration, end) of each iterating segment."""
    spans, pos = [], 0
    for seg in schedule:
        if seg.method in ITERATING:
            spans.append((seg.method, pos, pos + int(seg.n)))
            pos += int(seg.n)
    return spans


def tap_iterations(schedule, rng):
    """The iterations of the hio and er taps (check.py), drawn from rng:
    each k not its segment's first iteration, k + 1 inside the segment; the
    HIO tap among the later half of the schedule's HIO iterations."""
    def inner(method):
        return [k for m, a, e in iteration_spans(schedule) if m == method
                for k in range(a + 1, e - 1)]
    hio = inner("HIO")
    return {"hio": int(rng.choice(hio[len(hio) // 2:])),
            "er": int(rng.choice(inner("ER")))}


def cut(schedule, a, b, segment_cls):
    """The schedule's iterations [a, b) as segments, with the shrink-wraps
    and markers that run before iteration b and at or after iteration a."""
    out, pos = [], 0
    for seg in schedule:
        if seg.method not in ITERATING:
            if a <= pos < b:
                out.append(seg)
            continue
        lo, hi = max(a, pos), min(b, pos + int(seg.n))
        if lo < hi:
            out.append(segment_cls(
                seg.method, hi - lo, betas=seg.betas[lo - pos:hi - pos],
                ft_stab=seg.ft_stab,
                ft_stab_link_delay=getattr(seg, "ft_stab_link_delay", 0)))
        pos += int(seg.n)
    return out


def program_taps(mtip, schedule, segment_cls, batch, ks, device):
    """The program's taps of a judged batch (check.Tap): for each tap
    iteration k of ks, the batch run again through the same MTIP from its
    initial densities up to k in one stretch, as the window ran it, the
    state entering k kept, and the program's next two iterations from it
    recorded. Sets batch.rerun_equal[name]: whether that run recorded what
    the window did up to k, bit for bit."""
    import torch

    def host(x):
        return x.detach().to("cpu", copy=True)
    batch.rerun_equal = {}
    for name, k in ks.items():
        state, errs = mtip.run_from(
            mtip.initial_state_batch(batch.rho0.to(device)),
            cut(schedule, 0, k, segment_cls), materialize=False)
        _, rec = mtip.run_from(state, cut(schedule, k, k + 2, segment_cls),
                               pos=k, materialize=False)
        batch.taps[name] = check.Tap(
            k, host(state.rho), host(state.support.expand(state.rho.shape)),
            rec[..., 1].double().cpu().numpy())
        errs = errs.double().cpu().numpy()
        batch.rerun_equal[name] = bool(np.array_equal(
            errs, batch.errors[:, :k, :errs.shape[2]]))
        del state, errs, rec
        if device == "cuda":
            torch.cuda.empty_cache()


def program_finals(mtip, schedule, segment_cls, batch, device):
    """The program's stages on the batch's final state: the schedule's last
    shrink-wrap (sets batch.sw_support) and one more iteration at the last
    iteration's settings (sets batch.after, its (real, reciprocal) errors)."""
    import torch
    state = mtip.initial_state_batch(batch.rho.to(device),
                                     support=batch.support.to(device))
    state = state._replace(last_err=batch.last_err.to(
        dtype=state.last_err.dtype, device=state.last_err.device))
    sw = [s for s in schedule if s.method in ("SW", "SW_center")][-1]
    new, _ = mtip.run_from(state, [sw])
    batch.sw_support = new.support.detach().to("cpu", copy=True)
    n = sum(int(s.n) for s in schedule if s.method in ITERATING)
    _, rec = mtip.run_from(state, cut(schedule, n - 1, n, segment_cls),
                           pos=n, materialize=False)
    batch.after = rec[:, 0, :2].double().cpu().numpy()
    del state, new
    if device == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run(workload, seed, seconds, traced, *, root=ROOT, device="cuda",
        t_start=None, control=False):
    """One run; → the result dict (the keys the result line prints).
    control: the control in the program's place in the comparison
    (check.judge), which then has to come out not correct."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest, cell, config, traffic = load_cell(root, workload)
    import torch
    if device == "cuda":
        need = int(cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise Refused(f"cell {workload} needs {need} CUDA device(s); "
                          f"found {torch.cuda.device_count()}")
    from torch.profiler import record_function
    from xframe_tpu_torch.parallel.mesh import MultiStartRunner, rank_restarts
    from xframe_tpu_torch.projects.fxs.phasing import Segment
    from xframe_tpu_torch.projects.fxs.reconstruct import ProjectWorker
    from xframe_tpu_torch.settings import load_settings
    split = {"imports_s": time.perf_counter() - t_start}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    spec = config["settings"]
    bs = int(traffic["batch_size"])
    settings = load_settings(spec["worker"], spec["name"], overrides=deep_merge(
        spec.get("overrides", {}), {"multi_start": {"batch_size": bs}}))
    grid = settings["grid"]
    t = time.perf_counter()
    inv = inputs.make_invariants(config["data"], int(grid["n_radial_points"]),
                                 int(grid["max_order"]), device)
    sync()
    split["invariants_s"] = time.perf_counter() - t
    t = time.perf_counter()
    worker = ProjectWorker(settings, device=device)
    mtip, ft, aux = worker.setup_mtip(inv)
    schedule = worker._build_schedule(ft)
    runner = MultiStartRunner(mtip, schedule)
    sync()
    split["setup_mtip_s"] = time.perf_counter() - t
    n_iter = sum(s.n for s in schedule if s.method in ("HIO", "ER", "RAAR"))
    shapes = dict(n_q=int(ft.n_radial_points), l_max=int(ft.sht.l_max),
                  n_theta=int(ft.sht.n_theta), n_phi=int(ft.sht.n_phi),
                  restarts=bs)

    t = time.perf_counter()
    warm = MultiStartRunner(mtip, warm_schedule(schedule, Segment))
    states, _ = warm(aux["initial_density_batch"](batch_seed(seed, -1), bs))
    rank_restarts(states)
    del states, warm
    sync()
    split["warm_up_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng([int(seed), 1])
    first = 0 if traced else int(rng.integers(0, 2))
    judged = range(first, first + -(-check.MIN_RESTARTS // bs))
    ks = tap_iterations(schedule, rng)
    kept, failed, batches, busy = {}, 0, 0, 0.0

    def batch(i, marked=False):
        """Batch i; → its seconds and its restarts that failed. A judged
        batch is copied to the host after the clock stops."""
        t = time.perf_counter()
        with (record_function(trace.MARKER) if marked
              else contextlib.nullcontext()):
            rho0 = aux["initial_density_batch"](batch_seed(seed, i), bs)
            states, errors = runner(rho0)
            _, best = rank_restarts(states)
            sync()
        seconds = time.perf_counter() - t
        if i in judged:
            kept[i] = check.Batch.take(i, rho0, states, errors)
        return seconds, int((~np.isfinite(best)).sum())

    win = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device == "cuda" else [])
        with profile(activities=acts) as prof:
            busy, failed = batch(0, marked=True)
        batches = 1
        win = trace.collect(prof, 1, bs, n_iter, shapes)
        del prof
    else:
        # the window's seconds are the batches' own, back to back: a batch
        # starts only while they are under --seconds
        while batches == 0 or busy < seconds:
            dt, bad = batch(batches)
            busy, failed, batches = busy + dt, failed + bad, batches + 1
    window_s = busy
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    # after the window: the judged batches it did not run, then the
    # program's stages that the comparison holds on each
    t = time.perf_counter()
    for i in judged:
        if i not in kept:
            batch(i)
    for i in judged:
        program_finals(mtip, schedule, Segment, kept[i], device)
        program_taps(mtip, schedule, Segment, kept[i], ks, device)
    sync()
    stages_s = time.perf_counter() - t
    del runner, mtip, ft, aux, worker
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    checks, detail = check.judge(settings, inv, config["check"],
                                 [kept[i] for i in judged], device,
                                 control=control)
    check_s = time.perf_counter() - t
    found = forbidden_modules()
    if found:
        raise Refused("modules that must not load are loaded: "
                      + ", ".join(found))

    restarts = batches * bs
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu", "count": 1 if device == "cuda" else 0,
           "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": restarts, "failed": failed}
    if traced:
        metrics = {}
        for m in cell_metrics(manifest, workload, "per_layer"):
            v = load_reader(root, m["name"])(win)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev.update(busy_s=win.busy_s(), window_s=win.window_s)
        result.update(metrics=metrics, device=dev, breakdown={
            "device_ops": [[n, s] for n, s in win.top_device_ops()],
            "idle_gaps": [[n, s] for n, s in win.idle_gaps()]})
    else:
        values = {"restarts_per_hour": 3600.0 * restarts / window_s,
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        result.update(metrics={m["name"]: {"value": values[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell_metrics(manifest, workload,
                                                     "end_to_end")},
                      device=dev)
    result.update(
        window={"batches": batches, "restarts": restarts,
                "seconds": window_s, "batch_size": bs,
                "iterations": n_iter},
        setup={**split, "setup_s": setup_s}, stages_s=stages_s,
        check_s=check_s,
        power_limit=power_limit() if device == "cuda" else None,
        detail=detail, checks=checks)
    return result


def main(argv=None, t_start=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start=t_start)
    except Refused as err:
        print(f"fxsbench: {err}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"{name} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
