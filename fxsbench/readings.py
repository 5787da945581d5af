"""The readings that the limits of `correct` are set from: runs of a cell
on many seeds in one process, on the chip at the cell's own size; with
--control-seeds, runs on those seeds with the control, the reference in
TF32, in the program's place (check.judge). The benchmark's own runs never
run it.

    python3 fxsbench/readings.py --workload <cell> --seconds <s> \\
        --seeds <n>... [--control-seeds <n>...]

prints one JSON line per run: the seed, whether the control stood in, the
numbers compared beside their limits, and each restart's readings.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import fxsbench.run  # noqa: E402,F401  (the run's cache and home paths)
from fxsbench import bench  # noqa: E402


def main(argv=None):
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    runs = [(s, False) for s in args.seeds] + \
        [(s, True) for s in args.control_seeds]
    for seed, control in runs:
        r = bench.run(args.workload, seed, args.seconds, False,
                      device=args.device, t_start=time.perf_counter(),
                      control=control)
        print(json.dumps({"seed": seed, "control": control,
                          "correct": r["correct"], "checks": r["checks"],
                          "detail": r["detail"], "window": r["window"],
                          "stages_s": r["stages_s"], "check_s": r["check_s"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
