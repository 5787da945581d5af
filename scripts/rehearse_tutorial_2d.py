#!/usr/bin/env python3
"""Run the 2D tutorial chain (simulate_ccd → extract → reconstruct → average
on the `tutorial_2d` settings) on the CPU and print the ground-truth
correlation of the best restart and of the average, one JSON line per
package.

    python3 scripts/rehearse_tutorial_2d.py            # both packages
    python3 scripts/rehearse_tutorial_2d.py --package jax

The JAX package runs through xframe_tpu.select_project, the port through
xframe_tpu_torch.main.run_worker(device="cpu"), each in a temporary
XFRAME_TPU_HOME; the correlations come from each package's own
fidelity.align_to_ground_truth (dim=2) against the simulate settings'
shapes. chip_smoke.py's chain_2d phase takes its fidelity bounds from
this rehearsal of the JAX package.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
WORKERS = ("simulate_ccd", "extract", "reconstruct", "average")


def run_jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import xframe_tpu as xf
    from xframe_tpu.ops.fourier import PolarFourierTransform
    from xframe_tpu.ops.integrate import PolarIntegrator
    from xframe_tpu.projects.fxs.fidelity import align_to_ground_truth
    from xframe_tpu.settings.loader import load_project_settings
    out, walls = {}, {}
    for w in WORKERS:
        t0 = time.perf_counter()
        xf.select_project("fxs", w, "tutorial_2d")
        out[w] = xf.run()
        walls[w] = time.perf_counter() - t0
    shapes = load_project_settings("fxs", "simulate_ccd",
                                   "tutorial_2d")[0].shapes
    cfg = out["reconstruct"]["configuration"]
    g = cfg["internal_grid"]
    ft = PolarFourierTransform(len(g["real_grid"]), cfg["max_order"],
                               len(g["phis"]), cfg["q_max"],
                               mode=cfg["fourier_transform_mode"],
                               reciprocity_coefficient=cfg[
                                   "reciprocity_coefficient"])
    w = np.asarray(PolarIntegrator(ft.rs, ft.n_phi)._w)
    return out, walls, lambda d: align_to_ground_truth(
        d, shapes, ft, w, dim=2)[0]


def run_torch():
    from xframe_tpu_torch.main import run_worker
    from xframe_tpu_torch.ops.fourier import PolarFourierTransform
    from xframe_tpu_torch.ops.integrate import PolarIntegrator
    from xframe_tpu_torch.projects.fxs.fidelity import align_to_ground_truth
    from xframe_tpu_torch.settings import load_settings
    out, walls = {}, {}
    for w in WORKERS:
        t0 = time.perf_counter()
        out[w] = run_worker("fxs", w, "tutorial_2d", device="cpu")
        walls[w] = time.perf_counter() - t0
    shapes = load_settings("simulate_ccd", "tutorial_2d")["shapes"]
    cfg = out["reconstruct"]["configuration"]
    g = cfg["internal_grid"]
    ft = PolarFourierTransform(len(g["real_grid"]), cfg["max_order"],
                               len(g["phis"]), cfg["q_max"],
                               mode=cfg["fourier_transform_mode"],
                               reciprocity_coefficient=cfg[
                                   "reciprocity_coefficient"], device="cpu")
    w = PolarIntegrator(ft.rs, ft.n_phi, device="cpu")._w
    return out, walls, lambda d: align_to_ground_truth(
        d, shapes, ft, w, dim=2)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch", "both"),
                    default="both")
    args = ap.parse_args()
    for name in (("jax", "torch") if args.package == "both"
                 else (args.package,)):
        with tempfile.TemporaryDirectory() as home:
            os.environ["XFRAME_TPU_HOME"] = home
            out, walls, corr = run_jax() if name == "jax" else run_torch()
            rec = out["reconstruct"]["reconstruction_results"]
            print(json.dumps({
                "package": name, "wall_seconds": walls,
                "best_correlation": corr(rec["0"]["real_density"]),
                "average_correlation": corr(
                    out["average"]["average"]["real_density"]),
                "restart_final_errors": [float(rec[k]["error_dict"]["final"])
                                         for k in sorted(rec, key=int)],
                "aligned": len(out["average"]["aligned"])}), flush=True)


if __name__ == "__main__":
    main()
