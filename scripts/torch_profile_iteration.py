#!/usr/bin/env python3
"""Device-time breakdown of the port's MTIP iteration on one GPU.

    python3 scripts/torch_profile_iteration.py
    python3 scripts/torch_profile_iteration.py --cell production

`tutorial` (the default) builds chip_smoke.py's tutorial problem (N_q=128,
L=64, 256×512, 2 restarts, Newton–Schulz with the minimax schedule, kernels
on) and profiles the fused iteration (the default), the stepwise one
(fused_pipeline=False) and the fused variants k2_fwd=False (B11 + B1 in
place of B4) and k1_abs2=True (B12 in place of B6 + B3). `production`
builds chip_smoke.py's production problem (N_q=256, L=127, 320×640, 1
restart, newton_schulz_pallas: the fused projection B8) and profiles its
fused iteration and the two variants. Each path runs 5
warm-up ft-stab HIO iterations, then traces 10 more under torch.profiler.
Prints one JSON line per path: wall seconds per iteration, the device-busy
share of the traced window (summed kernel time over wall time; overlapping
kernels would count twice) and the top kernels by device time, each hand
kernel labelled with the TPU kernel it replaces (B1-B12) and its part.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ITERS = 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=("tutorial", "production"),
                    default="tutorial")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_profile_iteration: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from chip_smoke import label
    from xframe_tpu_torch.projects.fxs.phasing import Segment

    if args.cell == "tutorial":
        p = chip_smoke.tutorial_problem()
        restarts = chip_smoke.N_RESTARTS
        paths = (("fused", p.mtip), ("stepwise", chip_smoke.stepwise(p)))
    else:
        p = chip_smoke.production_problem()
        restarts = chip_smoke.PROD["restarts"]
        paths = (("fused", p.mtip),)
    paths += (("k2_fwd=False", chip_smoke.variant(p, k2_fwd=False)),
              ("k1_abs2=True", chip_smoke.variant(p, k1_abs2=True)))
    rho0 = p.initial_density_batch(torch.Generator("cuda").manual_seed(0),
                                   restarts)

    def seg(n):
        return Segment("HIO", n, betas=np.full(n, 0.5), ft_stab=True)

    for path, mtip in paths:
        state = mtip.initial_state_batch(rho0)
        state, _ = mtip.run_from(state, [seg(5)])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = mtip.run_from(state, [seg(ITERS)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side entries are the kernels and copies themselves
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        device_us = sum(e.self_device_time_total for e in events)
        top = [{"name": e.key[:80], "kernel": label(e.key),
                "calls": e.count,
                "device_ms_per_iter": e.self_device_time_total / 1e3 / ITERS}
               for e in events[:20]]
        print(json.dumps({
            "cell": args.cell, "path": path, "iters": ITERS,
            "restarts": restarts,
            "wall_s_per_iteration": wall / ITERS,
            "device_ms_per_iteration": device_us / 1e3 / ITERS,
            "device_busy_share": device_us / 1e6 / wall,
            "top": top}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
