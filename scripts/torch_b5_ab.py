"""Time B5 (`FusedIteration.synthesize_update`, the plane form) of one
checkout of the port, for an A/B of two checkouts on one card.

    python3 scripts/torch_b5_ab.py --root <checkout> [--reps 30]

imports `xframe_tpu_torch` from <checkout>, builds its kernels there, and
prints one JSON line per shape: the median of `reps` CUDA-event timings of
the HIO, ft-stab, plane-weighted update at the tutorial (2 × 128 rows,
L = 64, 256×512) and production (256 rows, L = 127, 320×640) shapes, on
random inputs from seed 0, and the device time of its kernels per call
under torch.profiler (`device_ms`, by kernel in `kernels_ms`). The call
takes only arguments every version of the wrapper takes, so a parent
checkout runs it as well. Run two checkouts in turns (A, B, B, A) in one
command on one card, and compare there.
"""
import argparse
import json
import sys
import time

SHAPES = {"tutorial": (2, 128, 64, 256, 512),
          "production": (1, 256, 127, 320, 640)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch
    from xframe_tpu_torch.ops import _build
    from xframe_tpu_torch.ops.fused_mtip import FusedIteration
    from xframe_tpu_torch.ops.fused_sht import FusedSHT
    from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
    from xframe_tpu_torch.projects.fxs.projections import RealConstraint
    if not torch.cuda.is_available():
        print("torch_b5_ab: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    _build.library()
    rng = np.random.default_rng(0)
    for name, (b, n_q, L, n_theta, n_phi) in SHAPES.items():
        sht = SphericalHarmonicTransform(L, n_theta, n_phi, device="cuda")
        fi = FusedIteration(FusedSHT(sht))
        grid, coef = (b, n_q, n_theta, n_phi), (b, n_q, sht.n_m, L + 1)

        def cx(shape):
            return torch.as_tensor((rng.standard_normal(shape) + 1j
                                    * rng.standard_normal(shape))
                                   .astype(np.complex64), device="cuda")
        d = cx(coef) * torch.as_tensor(sht.lm_mask, device="cuda")
        rho_in = cx(grid)
        support = torch.as_tensor(rng.uniform(size=grid) > 0.4,
                                  device="cuda")
        w = torch.as_tensor(rng.uniform(0.1, 1.0, (n_q, n_theta)),
                            dtype=torch.float32, device="cuda")
        c_phase = torch.ones(b, dtype=torch.complex64, device="cuda")
        scale = float(sht.inverse(d).abs().std())
        rc = RealConstraint(threshold_low=0.05 * scale,
                            limit_imag=0.3 * scale)

        def call():
            fi.synthesize_update(d, rho_in, support, w, 0.6, c_phase,
                                 method="HIO", ft_stab=True,
                                 real_constraint=rc)
        for _ in range(3):
            call()
        times = []
        for _ in range(args.reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            call()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        times.sort()
        # the device time of the call's kernels, apart from the host's
        # gaps: torch.profiler over `reps` calls, per call
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                call()
            torch.cuda.synchronize()
        kernels = {e.key: e.self_device_time_total / args.reps / 1e3
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        print(json.dumps(dict(root=args.root, shapes=name,
                              ms=times[len(times) // 2], ms_min=times[0],
                              device_ms=sum(kernels.values()),
                              kernels_ms={k[:60]: v for k, v in sorted(
                                  kernels.items(), key=lambda kv: -kv[1])},
                              reps=args.reps, time=time.time())),
              flush=True)
        del sht, fi, d, rho_in, support
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
