#!/usr/bin/env python3
"""Device time of each CUDA kernel behind the SHT and fused-iteration entry
points, float32 tables against bf16 ones, on one GPU.

    python3 scripts/torch_kernel_parts.py
    python3 scripts/torch_kernel_parts.py --shapes production

At chip_smoke.py's kernel-phase shapes (tutorial: 2 restarts × 128 shells,
L = 64, 256×512; production: 256 shells, L = 127, 320×640) each of B1-B6
and B9-B12 runs on its FFT route with float32 tables and with bf16 tables
(fourier_transform.fused_bf16_tables): 2 warm-up calls, then 5 under
torch.profiler. Prints one JSON line per (kernel, table dtype): the
median call's milliseconds from CUDA events and the device milliseconds
a call of each launched kernel takes, labelled by chip_smoke.label (the
tensor-core GEMMs as "... bf16"), with the card's nvidia-smi line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CALLS = 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", choices=("tutorial", "production"),
                    default="tutorial")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_kernel_parts: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from xframe_tpu_torch.ops.fused_mtip import FusedIteration
    from xframe_tpu_torch.ops.fused_sht import FusedSHT
    from xframe_tpu_torch.projects.fxs.projections import RealConstraint

    smi = chip_smoke.nvidia_smi()
    sht, _, fi32, rng, lead = chip_smoke.kernel_fixture(torch, np,
                                                        args.shapes)
    grid = lead + (sht.n_theta, sht.n_phi)
    coef = lead + (sht.n_m, sht.l_max + 1)

    def cx(shape, mask=False):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.as_tensor((x * sht.lm_mask if mask else x).astype(
            np.complex64), device="cuda")
    f, c, psi, rho_in = cx(grid), cx(coef, True), cx(grid), cx(grid)
    support = torch.as_tensor(rng.uniform(size=grid) > 0.4, device="cuda")
    w = torch.as_tensor(rng.uniform(0.1, 1.0, lead[1:] + (sht.n_theta,)),
                        dtype=torch.float32, device="cuda")
    c_phase = torch.ones(lead[0], dtype=torch.complex64, device="cuda")
    scale = float(sht.inverse(c).abs().std())
    rc = RealConstraint(threshold_low=0.05 * scale, limit_imag=0.3 * scale)
    forms = {
        "float32": fi32,
        "bfloat16": FusedIteration(FusedSHT(sht, table_dtype=torch.bfloat16),
                                   w_rec=fi32._w_rec, hankel=fi32.hankel)}
    for table, fi in forms.items():
        fs = fi.f
        calls = {
            "sht_forward": lambda: fs.forward(f),
            "sht_inverse": lambda: fs.inverse(c),
            "sht_forward_real": lambda: fs.forward_real(f.real),
            "sht_inverse_real": lambda: fs.inverse_real(c),
            "sht_forward_real_abs2": lambda: fs.forward_real_abs2(f),
            "hankel_synthesize": lambda: fi.hankel_synthesize(c),
            "inverse_real_project_fwd":
                lambda: fi.inverse_real_project_fwd(c, psi),
            "inverse_real_project": lambda: fi.inverse_real_project(c, psi),
            "synthesize_abs2": lambda: fi.synthesize_abs2(c),
            "synthesize_update": lambda: fi.synthesize_update(
                c, rho_in, support, w, 0.6, c_phase, method="HIO",
                ft_stab=True, real_constraint=rc)}
        for name, call in calls.items():
            ms = chip_smoke.cuda_ms(torch, call, 10)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    call()
                torch.cuda.synchronize()
            parts = {}
            for e in prof.key_averages():
                lab = chip_smoke.label(e.key)
                if e.device_time_total > 0 and lab:
                    parts[lab] = parts.get(lab, 0.0) \
                        + e.device_time_total / 1e3 / CALLS
            print(json.dumps(dict(shapes=args.shapes, name=name, table=table,
                                  ms=ms, ms_by_kernel=parts,
                                  nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
