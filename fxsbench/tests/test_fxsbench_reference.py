"""The plain reference against the port's CPU path at a tiny size: the
transforms and the steps against the port's float64 stepwise path, and
the comparison of a whole tiny run of the float32 program."""
import json

import numpy as np
import pytest
import torch

from conftest import REPO, TINY

from fxsbench import bench, check, inputs
from fxsbench.reference.mtip import ReferenceMTIP
from fxsbench.reference.transforms import Precision, Transforms, \
    spherical_bessel


def test_transforms_match_the_ports_plain_transforms():
    from xframe_tpu_torch.ops.fourier import SphericalFourierTransform
    t = Transforms(16, 8, 0.3, 2.0, Precision(), "cpu")
    ft = SphericalFourierTransform(16, 8, q_max=0.3, mode="midpoint",
                                   reciprocity_coefficient=2.0,
                                   real_dtype=torch.float64, fused_sht=False,
                                   device="cpu")
    assert t.grid_shape == ft.grid_shape == (16, 16, 32)
    rng = np.random.default_rng(0)
    rho = torch.tensor(rng.standard_normal((2,) + t.grid_shape)
                       + 1j * rng.standard_normal((2,) + t.grid_shape))
    for a, b in ((t.forward(rho), ft.forward(rho)),
                 (t.inverse(rho), ft.inverse(rho)),
                 (t.forward_and_roundtrip(rho)[1],
                  ft.forward_and_roundtrip(rho)[1])):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-12


def test_bessel_against_scipy():
    from scipy.special import spherical_jn
    z = np.concatenate([np.linspace(0, 600, 4001), [1e-3, np.pi]])
    got = spherical_bessel(127, z)
    for l in (0, 1, 5, 64, 127):
        assert np.abs(got[l] - spherical_jn(l, z)).max() < 1e-13


def setup(precision):
    from xframe_tpu_torch.projects.fxs.reconstruct import ProjectWorker
    from xframe_tpu_torch.settings import load_settings
    cfg = json.loads((REPO / "fxsbench/configs/tutorial.json").read_text())
    over = {"grid": {"n_radial_points": 16, "max_order": 8},
            "projections": {"reciprocal": {"used_order_ids": "all"}}}
    inv = inputs.make_invariants({**cfg["data"], "q_max": 0.05}, 16, 8,
                                 "cpu")
    s = load_settings("reconstruct", "tutorial", overrides=bench.deep_merge(
        over, {"precision": precision}))
    w = ProjectWorker(s, device="cpu")
    mtip, ft, aux = w.setup_mtip(inv)
    return load_settings("reconstruct", "tutorial", overrides=over), inv, \
        mtip, w._build_schedule(ft), aux


def test_steps_match_the_ports_float64_path(tmp_path, monkeypatch):
    """The reference's first iterations and shrink-wrap equal the port's
    float64 (stepwise) MTIP from the same densities to 1e-10."""
    from xframe_tpu_torch.projects.fxs.phasing import Segment
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    settings, inv, mtip, schedule, aux = setup("float64")
    ref = ReferenceMTIP(settings, inv, Precision("float64"), "cpu")
    assert [(p, s, t) for p, s, t in ref.shrink_wraps] == [
        (sum(x.n for x in schedule[:i] if x.method in ("HIO", "ER")),
         pytest.approx(x.sigma), pytest.approx(x.threshold))
        for i, x in enumerate(schedule) if x.method == "SW"]
    its = [(x.method, b, x.ft_stab) for x in schedule if x.method != "SW"
           for b in x.betas]
    assert [(m, pytest.approx(b), f) for m, b, f in ref.iterations] == its
    rho0 = aux["initial_density_batch"](3, 2)
    seg = schedule[0]
    state, errors = mtip.run_batch(rho0, [Segment(
        seg.method, 6, betas=seg.betas[:6], ft_stab=seg.ft_stab)])
    rho, want = rho0, []
    for k in range(6):
        method, beta, stab = ref.iterations[k]
        rho, err, err_rec = ref.step(rho, ref.initial_support[None], method,
                                     beta, stab)
        want.append(torch.stack([err, err_rec], dim=-1))
    gaps = check.rel_gaps(errors[..., :2].numpy(),
                          torch.stack(want, dim=1).numpy())
    assert gaps.max() < 1e-10, gaps
    sw = schedule[-2]
    new, _ = mtip.run_from(state, [sw])
    want = ref.shrink_wrap(state.rho, state.support, sw.sigma, sw.threshold,
                           state.last_err)
    assert torch.equal(new.support, want)


def test_a_tiny_run_of_the_float32_program_is_correct(tiny_root):
    r = bench.run(TINY, 2024, 0.1, False, root=tiny_root, device="cpu")
    assert r["correct"], r["checks"]
    assert r["detail"]["restarts"] == check.MIN_RESTARTS
    assert set(r["checks"]) == {"start_gap", "hio_gap", "er_gap",
                                "best_gap", "sw_gap"}
