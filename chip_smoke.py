#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xframe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-shapes production

Phases, each printing JSON lines with its seconds:

  1. device   card name and power limit (nvidia-smi), torch/CUDA versions;
              TF32 off for matmuls and cuDNN (the Newton-Schulz polar is
              pinned at float32).
  2. build    nvcc build of xframe_tpu_torch/csrc/*.cu, one nvcc per source,
              all in parallel.
  3. kernels  each of the eight kernels against its plain PyTorch version at
              tutorial shapes (2 restarts × 128 shells, L = 64, 256×512
              grid): max|kernel − plain| / max|plain| ≤ 1e-4 for every output
              (float32 sums taken in another order over 512 φ and 256 θ
              terms; the fused update is compared away from the real
              constraint's thresholds, where a rounding difference flips a
              point, and the count left out is printed), median times from
              CUDA events. The fused update runs (HIO, ft-stab), (ER, ft-stab)
              and (RAAR, no ft-stab) with threshold_low and limit_imag set.
  4. small    the fused and the stepwise slice at N_q=16, L=8 on the card
              against the same runs on the CPU through the plain versions
              (error series within 1e-4 on the first iteration, 0.05
              overall).
  5. slice    MTIP phasing at tutorial scale: make_demo_problem(128, 64,
              256×512, Newton-Schulz with the minimax schedule, kernels on),
              2 restarts through MTIP.run_batch on the tutorial schedule
              5×(60 HIO + SW + 40 ER) + SW + 100 ER with ft-stab: first the
              fused iteration (the default), then the stepwise one
              (fused_pipeline=False) from the same densities. Fails on a
              non-finite value, an error that does not fall below half the
              mean of the first five, a launch count that differs from the
              count the schedule implies, or first-iteration errors of the
              two iterations more than 1e-4 apart.

Then a line {"kernels": [...]}, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero.

`--kernel-shapes production` runs phases 1-3 only, with the kernels at the
production shapes (R = 256 rows, L = 127, 320×640), and prints no result
line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

N_Q, L_MAX, N_THETA, N_PHI, N_RESTARTS = 128, 64, 256, 512, 2
KERNEL_SHAPES = {  # (restarts, shells, L, n_θ, n_φ) of the kernel phase
    "tutorial": (N_RESTARTS, N_Q, L_MAX, N_THETA, N_PHI),
    "production": (2, 128, 127, 320, 640),
}
REL_TOL = 1e-4
SHT_SOURCE = "xframe_tpu_torch/csrc/sht.cu"
MTIP_SOURCE = "xframe_tpu_torch/csrc/mtip.cu"
KERNELS = (
    # name, launch counter (FusedSHT or FusedIteration method), the slice
    # path whose run counts its launches, source, TPU kernel
    ("sht_forward", "forward", "fused", SHT_SOURCE,
     "xframe_tpu/ops/pallas_sht.py:184"),
    ("sht_inverse", "inverse", "fused", SHT_SOURCE,
     "xframe_tpu/ops/pallas_sht.py:212"),
    ("sht_forward_real", "forward_real", "stepwise", SHT_SOURCE,
     "xframe_tpu/ops/pallas_sht.py:622"),
    ("sht_inverse_real", "inverse_real", "stepwise", SHT_SOURCE,
     "xframe_tpu/ops/pallas_sht.py:521"),
    ("sht_forward_real_abs2", "forward_real_abs2", "fused", SHT_SOURCE,
     "xframe_tpu/ops/pallas_sht.py:602"),
    ("hankel_synthesize", "hankel_synthesize", "fused", MTIP_SOURCE,
     "xframe_tpu/ops/pallas_mtip.py:115"),
    ("inverse_real_project_fwd", "inverse_real_project_fwd", "fused",
     MTIP_SOURCE, "xframe_tpu/ops/pallas_mtip.py:241"),
    ("synthesize_update", "synthesize_update", "fused", MTIP_SOURCE,
     "xframe_tpu/ops/pallas_mtip.py:321"),
)
UPDATE_CASES = (("HIO", True), ("ER", True), ("RAAR", False))


class CheckFailed(RuntimeError):
    pass


def emit(**obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() over `reps` timed calls (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare(torch, np, name, got, want, keep=None, scales=None):
    """max|got − want| (over `keep`) and its ratio to max|want| (or to the
    given scale), for each output of a kernel; fails above REL_TOL.
    → (max absolute error over the grid and coefficient outputs, the
    relative error of every output, sums included)."""
    errs, rels = [], []
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g - w).abs()
        if keep is not None and diff.shape == keep.shape:
            diff = diff[keep]
        err = float(diff.max())
        scale = float(w.abs().max() if scales is None or scales[i] is None
                      else scales[i].max())
        check(np.isfinite(err) and np.isfinite(scale) and scale > 0,
              f"{name}: non-finite or zero output")
        errs.append(err)
        rels.append(err / scale)
    check(max(rels) <= REL_TOL,
          f"{name}: relative errors {rels} exceed {REL_TOL}")
    return max(e for e, g in zip(errs, got) if g.dim() >= 3), rels


def kernel_fixture(torch, np, shapes):
    """FusedSHT and FusedIteration at the kernel phase's shapes, with a
    midpoint Hankel transform and a reciprocal weight plane, on the card."""
    from xframe_tpu_torch.ops.fused_mtip import FusedIteration
    from xframe_tpu_torch.ops.fused_sht import FusedSHT
    from xframe_tpu_torch.ops.hankel import (SphericalHankelTransform,
                                             generate_weights)
    from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
    b, n_q, l_max, n_theta, n_phi = KERNEL_SHAPES[shapes]
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device="cuda")
    fused = FusedSHT(sht)
    hankel = SphericalHankelTransform(
        generate_weights(l_max, n_q, 2.0, 3, "midpoint"), r_max=100.0,
        reciprocity_coefficient=2.0, device="cuda")
    rng = np.random.default_rng(0)
    w_rec = rng.uniform(0.1, 1.0, (n_q, n_theta)).astype(np.float32)
    fi = FusedIteration(fused, w_rec=w_rec, hankel=hankel)
    return sht, fused, fi, rng, (b, n_q)


def phase_kernels(torch, np, shapes):
    """Phase 3: the eight kernels against their plain versions."""
    from xframe_tpu_torch.ops.fused_mtip import away_from_thresholds
    from xframe_tpu_torch.projects.fxs.projections import RealConstraint
    sht, fused, fi, rng, lead = kernel_fixture(torch, np, shapes)
    L = sht.l_max
    grid = lead + (sht.n_theta, sht.n_phi)
    coef = lead + (sht.n_m, L + 1)

    def cgrid():
        return torch.as_tensor((rng.standard_normal(grid)
                                + 1j * rng.standard_normal(grid)).astype(
                                    np.complex64), device="cuda")

    def ccoef():
        c = rng.standard_normal(coef) + 1j * rng.standard_normal(coef)
        return torch.as_tensor((c * sht.lm_mask).astype(np.complex64),
                               device="cuda")

    f, c = cgrid(), ccoef()
    # name → (kernel, plain, inputs, comparison mask or None)
    cases = {
        "sht_forward": (fused.forward, sht.forward, (f,)),
        "sht_inverse": (fused.inverse, sht.inverse, (c,)),
        "sht_forward_real": (fused.forward_real, sht.forward_real,
                             (f.abs().contiguous(),)),
        "sht_inverse_real": (fused.inverse_real, sht.inverse_real, (c,)),
        "sht_forward_real_abs2": (fused.forward_real_abs2,
                                  sht.forward_real_abs2, (f,)),
        "hankel_synthesize": (fi.hankel_synthesize,
                              fi.hankel_synthesize_plain, (c,)),
        "inverse_real_project_fwd": (fi.inverse_real_project_fwd,
                                     fi.inverse_real_project_fwd_plain,
                                     (c, cgrid())),
    }
    results = {}
    for name, (kern, plain, args) in cases.items():
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, rels = compare(torch, np, name, got, want)
        ms = cuda_ms(torch, lambda: kern(*args), 10)
        plain_ms = cuda_ms(torch, lambda: plain(*args), 10)
        results[name] = dict(max_abs_err=err, rel_err=max(rels), ms=ms,
                             plain_ms=plain_ms)
        emit(phase="kernel", name=name, shapes=shapes,
             shape=list(args[0].shape), rel_errs=rels, **results[name])

    # the fused update: thresholds at the scale of the synthesized density
    d, rho_in = ccoef(), cgrid()
    support = torch.as_tensor(rng.uniform(size=grid) > 0.4, device="cuda")
    w = torch.as_tensor(rng.uniform(0.1, 1.0, lead[1:] + (sht.n_theta,)),
                        dtype=torch.float32, device="cuda")
    c_phase = torch.as_tensor(np.exp(1j * np.array([0.7, -2.1])[:lead[0]]),
                              dtype=torch.complex64, device="cuda")
    scale = float(sht.inverse(d).abs().std())
    rc = RealConstraint(threshold_low=0.05 * scale, limit_imag=0.3 * scale)
    for method, ft_stab in UPDATE_CASES:
        kw = dict(method=method, ft_stab=ft_stab, real_constraint=rc)
        args = (d, rho_in, support, w, 0.6, c_phase)
        got = fi.synthesize_update(*args, **kw)
        want = fi.synthesize_update_plain(*args, **kw)
        rp, _ = fi.pre_constraint_plain(d, rho_in, c_phase, ft_stab=ft_stab)
        keep = away_from_thresholds(rp, rc, 1e-4 * float(rp.abs().max()))
        # Σwρ² and Σwρ cancel down to ~√N of their terms, where one of the
        # ~N·1e-7 points that flip at a threshold weighs 1e-4; they are
        # held to the sums of the terms' magnitudes instead
        new = want[0].abs()
        scales = (None, None, None, (w[..., None] * new * new).sum((-3, -2, -1)),
                  (w[..., None] * new).sum((-3, -2, -1)))
        torch.cuda.synchronize()
        err, rels = compare(torch, np, f"synthesize_update {method}", got,
                            want, keep, scales)
        ms = cuda_ms(torch, lambda: fi.synthesize_update(*args, **kw), 10)
        plain_ms = cuda_ms(torch,
                           lambda: fi.synthesize_update_plain(*args, **kw), 10)
        left_out = int(keep.numel() - keep.sum())
        emit(phase="kernel", name="synthesize_update", shapes=shapes,
             method=method, ft_stab=ft_stab, shape=list(rho_in.shape),
             rel_errs=rels, max_abs_err=err, ms=ms, plain_ms=plain_ms,
             points_left_out=left_out, points=keep.numel())
        r = results.setdefault("synthesize_update",
                               dict(max_abs_err=err, ms=ms, plain_ms=plain_ms))
        r["max_abs_err"] = max(r["max_abs_err"], err)
    return results


def tutorial_problem():
    """The tutorial problem on the card: make_demo_problem(128, 64, 256×512,
    Newton-Schulz with the minimax schedule, SHT kernels, the fused
    iteration)."""
    from xframe_tpu_torch.ops.polar_schedule import DEFAULT_SCHEDULE
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    return make_demo_problem(N_Q, L_MAX, n_theta=N_THETA, n_phi=N_PHI,
                             procrustes_method="newton_schulz",
                             ns_schedule=DEFAULT_SCHEDULE, fused_sht=True,
                             device="cuda")


def stepwise(p):
    """The stepwise MTIP on the parts of a demo problem."""
    from xframe_tpu_torch.projects.fxs.phasing import MTIP
    m = p.mtip
    return MTIP(p.ft, m.rc, m.real, m.sw,
                p.integrator.w_broadcast.cpu().numpy(), p.initial_support,
                enforce_initial_support_limit=m.enforce_limit,
                fused_pipeline=False, device=m.device)


def tutorial_schedule(Segment, np, sigma):
    full = []
    for _ in range(5):
        full += [Segment("HIO", 60, betas=np.full(60, 0.5), ft_stab=True),
                 Segment("SW", sigma=sigma, threshold=0.1),
                 Segment("ER", 40, betas=np.zeros(40), ft_stab=True)]
    full += [Segment("SW", sigma=sigma, threshold=0.1),
             Segment("ER", 100, betas=np.zeros(100), ft_stab=True)]
    return full


def implied_launches(schedule, fused):
    """Kernel launches implied for the initial guess plus `schedule`. An FT
    is one analysis and one synthesis. A fused iteration runs the analysis
    of ρ, the Hankel-fused ψ synthesis, the |ψ|² analysis, the projection
    with the ψ_p analysis and the fused update, one launch each. A stepwise
    ft-stab iteration runs three syntheses (ψ, the round trip, ρ_p), two
    complex analyses, one real analysis and one real synthesis."""
    n = {"forward": 2, "inverse": 2, "forward_real": 0, "inverse_real": 0,
         "forward_real_abs2": 0, "hankel_synthesize": 0,
         "inverse_real_project_fwd": 0, "synthesize_update": 0}
    for seg in schedule:
        if seg.method == "SW":
            n["forward"] += 2
            n["inverse"] += 2
        elif seg.method in ("HIO", "ER", "RAAR") and fused:
            for k in ("forward", "hankel_synthesize", "forward_real_abs2",
                      "inverse_real_project_fwd", "synthesize_update"):
                n[k] += seg.n
        elif seg.method in ("HIO", "ER", "RAAR"):
            n["forward"] += 2 * seg.n
            n["inverse"] += (3 if seg.ft_stab else 2) * seg.n
            n["forward_real"] += seg.n
            n["inverse_real"] += seg.n
    return n


def launch_counts(mtip):
    from xframe_tpu_torch.ops.fused_mtip import METHODS
    counts = dict(mtip.ft.harmonic.launches)
    counts.update(dict.fromkeys(METHODS, 0) if mtip._fi is None
                  else mtip._fi.launches)
    return counts


def reset_launches(mtip):
    mtip.ft.harmonic.reset_launches()
    if mtip._fi is not None:
        mtip._fi.reset_launches()


def phase_small(torch, np):
    """Phase 4: the fused and the stepwise slice at a small size on the card
    (kernels, cuBLAS) against the same problem on the CPU (plain versions),
    from the same starting densities: relative error-series difference
    < 1e-4 on the first iteration and < 0.05 overall
    (tests/test_transforms.py:565-586)."""
    from xframe_tpu_torch.ops.polar_schedule import DEFAULT_SCHEDULE
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    from xframe_tpu_torch.projects.fxs.phasing import Segment

    t0 = time.perf_counter()
    errs = {}
    rho0 = None
    for device in ("cpu", "cuda"):
        p = make_demo_problem(16, 8, procrustes_method="newton_schulz",
                              ns_schedule=DEFAULT_SCHEDULE, fused_sht=True,
                              device=device)
        if rho0 is None:
            rho0 = p.initial_density_batch(0, 2)
        sigma = p.mtip.sw.default_sigma
        schedule = [Segment("HIO", 4, betas=np.full(4, 0.5), ft_stab=True),
                    Segment("SW", sigma=sigma, threshold=0.1),
                    Segment("ER", 2, betas=np.zeros(2), ft_stab=True)]
        for path, mtip in (("fused", p.mtip), ("stepwise", stepwise(p))):
            check((mtip._fi is not None) == (path == "fused"),
                  f"small {path} slice on {device} runs the wrong iteration")
            _, e = mtip.run_batch(rho0.to(device), schedule)
            errs[path, device] = e.cpu().numpy()
    for path in ("fused", "stepwise"):
        ref = errs[path, "cpu"]
        rel = np.abs(errs[path, "cuda"] - ref) / (np.abs(ref) + 1e-9)
        emit(phase="small", path=path, seconds=time.perf_counter() - t0,
             rel_first=float(rel[:, 0].max()), rel_max=float(rel.max()),
             rel_by_iteration=rel.max(axis=(0, 2)).tolist())
        check(rel[:, 0].max() < 1e-4 and rel.max() < 0.05,
              f"small {path} slice on the card departs from the CPU run: "
              f"{rel.max()}")


def run_slice(torch, np, p, mtip, path, schedule):
    """One tutorial-scale run, the initial guess from seed 0 and then
    MTIP.run_batch, with its checks. → (launch counts, errors (restarts,
    n_iter, 2))."""
    from xframe_tpu_torch.projects.fxs import invariants as itools

    torch.cuda.synchronize()
    reset_launches(mtip)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rho0 = p.initial_density_batch(gen, N_RESTARTS)
    state, errors = mtip.run_batch(rho0, schedule)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts(mtip)

    n_iter = sum(s.n for s in schedule if s.method != "SW")
    errs = errors.cpu().numpy()                 # (restarts, n_iter, 2)
    main = errs[:, :, 0]
    best = state.best_rho
    finite = bool(np.isfinite(errs).all()
                  and torch.isfinite(torch.view_as_real(best)).all())
    # B_l fingerprint of best_rho against the data, l = 0, 2, 4, q >= 4
    # (tests/test_phasing.py:92-104), through the plain transforms so that
    # it does not lean on the kernels it helps to judge
    sht, hankel = p.ft.sht, p.ft.hankel
    psi = sht.inverse(hankel.forward(sht.forward(best)))
    coeff = sht.forward_real((psi * psi.conj()).real).cpu().numpy()
    fingerprint = []
    for r in range(N_RESTARTS):
        bl_rec = itools.harmonic_coeff_to_deg2_invariants_3d(coeff[r])
        dev = {}
        for l in (0, 2, 4):
            ref = p.bl[l][4:, 4:]
            dev[l] = float(np.abs(bl_rec[l][4:, 4:] - ref).max()
                           / np.abs(ref).max())
        fingerprint.append(dev)
    implied = implied_launches(schedule, mtip._fi is not None)
    emit(phase="slice", path=path, seconds=seconds, iterations=n_iter,
         restarts=N_RESTARTS,
         s_per_iteration_per_restart=seconds / (n_iter * N_RESTARTS),
         restarts_per_hour=N_RESTARTS * 3600.0 / seconds,
         first_main_error=[float(v) for v in main[:, 0]],
         last_main_error=[float(v) for v in main[:, -1]],
         launches=launches, implied_launches=implied,
         bl_fingerprint_deviation=fingerprint)
    check(errs.shape == (N_RESTARTS, n_iter, 2)
          and tuple(best.shape) == (N_RESTARTS, N_Q, N_THETA, N_PHI),
          f"{path}: unexpected shapes {errs.shape}, {tuple(best.shape)}")
    check(finite, f"{path}: non-finite errors or density")
    for r in range(N_RESTARTS):
        check(main[r, -1] < 0.5 * main[r, :5].mean(),
              f"{path} restart {r}: final error {main[r, -1]} not below "
              f"half the first five's mean {main[r, :5].mean()}")
    check(launches == implied,
          f"{path}: launch counts {launches} differ from implied {implied}")
    return launches, errs


def phase_slice(torch, np):
    """Phase 5: tutorial-scale MTIP phasing through MTIP.run_batch, the
    fused iteration and then the stepwise one, each from the same seeded
    initial guess."""
    from xframe_tpu_torch.projects.fxs.phasing import Segment

    t0 = time.perf_counter()
    p = tutorial_problem()
    check(p.mtip._fi is not None, "the demo problem does not run the fused "
          "iteration")
    torch.cuda.synchronize()
    emit(phase="problem", seconds=time.perf_counter() - t0)

    schedule = tutorial_schedule(Segment, np, p.mtip.sw.default_sigma)
    launches, errs = {}, {}
    for path, mtip in (("fused", p.mtip), ("stepwise", stepwise(p))):
        launches[path], errs[path] = run_slice(torch, np, p, mtip, path,
                                               schedule)
    first = {k: e[:, 0] for k, e in errs.items()}
    rel = np.abs(first["fused"] - first["stepwise"]) \
        / np.abs(first["stepwise"])
    emit(phase="fused_vs_stepwise", rel_first_iteration=rel.tolist())
    check(rel.max() < 1e-4, f"fused and stepwise first-iteration errors "
          f"differ by {rel.max()}")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel-shapes", choices=sorted(KERNEL_SHAPES),
                    default="tutorial")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from xframe_tpu_torch.ops import _build

    t0 = time.perf_counter()
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", seconds=time.perf_counter() - t0, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    _build.library()
    emit(phase="build", seconds=time.perf_counter() - t0, nvcc_seconds=nvcc_s,
         library=path.name)

    t0 = time.perf_counter()
    results = phase_kernels(torch, np, args.kernel_shapes)
    emit(phase="kernels", seconds=time.perf_counter() - t0)
    if args.kernel_shapes != "tutorial":
        print(smi, flush=True)
        return 0

    phase_small(torch, np)
    launches = phase_slice(torch, np)

    emit(kernels=[dict(name=name, route="cuda", source=source,
                       replaces=where, launches=launches[path][counter],
                       max_abs_err=results[name]["max_abs_err"],
                       ms=results[name]["ms"],
                       plain_ms=results[name]["plain_ms"])
                  for name, counter, path, source, where in KERNELS])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
