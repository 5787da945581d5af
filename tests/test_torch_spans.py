"""The port's spans (xframe_tpu_torch.tracing) on the CPU.

Without a profiler `span` is one shared no-op. Under torch.profiler a tiny
multi-start run of the port's demo problem records one `xf.iteration` per
iteration it runs (the schedule's, and in replay mode replay's inside
`xf.replay`), one `xf.projection` inside each, an `xf.segment.<method>` per
segment and an `xf.shrink_wrap` per shrink-wrap, each a FUNCTION-scope
`cpu_op` that is no user annotation; the run's densities, supports and
error records are bitwise those of the run without a profiler. A
`profiling.enable` reconstruct writes the span names into its trace."""
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xframe_tpu_torch import tracing
from xframe_tpu_torch.main import select_worker
from xframe_tpu_torch.parallel.mesh import MultiStartRunner
from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
from xframe_tpu_torch.projects.fxs.phasing import MTIP, Segment

STATE = ("rho", "support", "best_rho", "best_mask", "best_err")


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch._C._autograd._profiler_enabled()
    assert tracing.span("xf.iteration") is tracing.span("xf.replay")
    with tracing.span("xf.iteration") as inside:
        assert inside is None


def _schedule(sigma):
    """A replay mid-run (SNAPSHOT … RESET_TO_BEST) and one at the end."""
    return [
        Segment("SNAPSHOT"),
        Segment("HIO", 7, betas=np.linspace(0.6, 0.4, 7), ft_stab=True),
        Segment("SW", sigma=sigma, threshold=0.1),
        Segment("ER", 5, betas=np.zeros(5), ft_stab=True),
        Segment("RESET_TO_BEST"),
        Segment("HIO", 4, betas=np.full(4, 0.5), ft_stab=False),
        Segment("SW", sigma=sigma, threshold=0.1),
        Segment("ER", 4, betas=np.zeros(4), ft_stab=True),
    ]


@pytest.fixture(scope="module")
def demo():
    torch.manual_seed(0)
    return make_demo_problem(8, 4, device="cpu")


def _mtip(p, fused):
    m = p.mtip
    return MTIP(p.ft, m.rc, m.real, m.sw,
                p.integrator.w_broadcast.cpu().numpy(), p.initial_support,
                enforce_initial_support_limit=m.enforce_limit,
                fused_pipeline=None if fused else False, best_mode="replay",
                device="cpu")


def _counted(mtip):
    """mtip with its iterations and replays counted on the instance."""
    counts = {"iterations": 0, "replays": 0}
    name = "_mtip_iteration_fused" if mtip._fi is not None \
        else "mtip_iteration"
    step, replay = getattr(mtip, name), mtip._replay_best

    def counted_step(*a, **k):
        counts["iterations"] += 1
        return step(*a, **k)

    def counted_replay(*a, **k):
        counts["replays"] += 1
        return replay(*a, **k)
    setattr(mtip, name, counted_step)
    mtip._replay_best = counted_replay
    return counts


def _ancestors(e):
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_spans_nest_and_leave_the_run_bitwise(demo, fused):
    sched = _schedule(demo.mtip.sw.default_sigma)
    rho0 = demo.initial_density_batch(0, 3)
    n_iter = sum(s.n for s in sched if s.method in ("HIO", "ER"))

    plain_mtip = _mtip(demo, fused)
    assert plain_mtip.best_mode == ("replay" if fused else "eager")
    counts = _counted(plain_mtip)
    plain = MultiStartRunner(plain_mtip, sched)(rho0.clone())
    traced_mtip = _mtip(demo, fused)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = MultiStartRunner(traced_mtip, sched)(rho0.clone())

    for k in STATE:
        assert torch.equal(getattr(plain[0], k), getattr(traced[0], k)), k
    assert torch.equal(plain[1], traced[1])

    spans = [e for e in prof.events() if e.name.startswith("xf.")]
    kineto = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("xf.")]
    assert len(kineto) == len(spans)
    assert not any(e.is_user_annotation() for e in kineto)
    names = [e.name for e in spans]
    iters = [e for e in spans if e.name == "xf.iteration"]
    in_replay = [e for e in iters if "xf.replay" in _ancestors(e)]
    assert len(iters) == counts["iterations"]
    assert len(iters) - len(in_replay) == n_iter
    assert names.count("xf.replay") == counts["replays"]
    if fused:
        # replays at RESET_TO_BEST and at the end, at least one iteration
        assert counts["replays"] == 2 and in_replay
    else:
        assert counts["replays"] == 0 and not in_replay
    for e in iters:
        if e not in in_replay:
            assert _ancestors(e)[0].startswith("xf.segment.")
    projections = [e for e in spans if e.name == "xf.projection"]
    assert len(projections) == len(iters)
    assert all(e.cpu_parent.name == "xf.iteration" for e in projections)
    assert names.count("xf.segment.HIO") == 2
    assert names.count("xf.segment.ER") == 2
    assert names.count("xf.shrink_wrap") == 2


def test_profiling_enable_writes_the_spans(tmp_path, monkeypatch):
    """A tiny reconstruct (N_q 8, L 4, 2 restarts, replay) under
    profiling.enable: its trace holds the spans; no kernels were built."""
    from xframe_tpu_torch.projects.fxs.store import save_npz
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    p = make_demo_problem(8, 4, device="cpu")
    path = str(tmp_path / "inv.npz")
    save_npz(path, {"data_radial_points": p.ft.qs, "max_order": 4,
                    "data_projection_matrices": {
                        "I1I1": p.projection_matrices},
                    "average_intensity": p.average_intensity,
                    "xray_wavelength": 1.0})
    folder = str(tmp_path / "traces")
    overrides = {
        "structure_name": "small",
        "particle_radius": float(p.radius * 1.2),
        "grid": {"n_radial_points": 8, "max_order": 4},
        "input": {"invariants_path": path},
        "multi_start": {"n_reconstructions": 2, "seed": 3},
        "main_loop": {"best_tracking": "replay", "sub_loops": {
            "order": ["main"], "main": {
                "iterations": 1, "order": ["HIO", "SW", "ER"],
                "methods": {"HIO": {"iterations": 3},
                            "SW": {"iterations": 1},
                            "ER": {"iterations": 2}}}}},
        "profiling": {"enable": True, "trace_dir": folder}}
    res = select_worker("fxs", "reconstruct", overrides=overrides,
                        device="cpu").run()
    assert res["timing"]["kernel_build_s"] == 0.0
    traces = glob.glob(os.path.join(folder, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    found = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"xf.setup", "xf.segment.HIO", "xf.segment.ER", "xf.iteration",
            "xf.projection", "xf.shrink_wrap", "xf.replay"} <= found
