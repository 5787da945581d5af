"""Linked ft-stab (`link_to_enforce_initial_support`) in the port (CPU).

Mirrors tests/test_dynamic_ft_stab.py on the port: a linked method applies
the ft-stab correction iff at least `delay` shrink-wraps have run and none
of the last `delay` enforced the initial support. The port carries the
enforce flags per restart (PhasingState.enforce_hist) and scales the
correction by the 0/1 gate they give (MTIP._ft_gate), in the fused
iteration (cf and B5's ρ_in add) and the stepwise one. A linked schedule
must match the same schedule with ft_stab resolved by hand from the
observed flags, within 2e-5 (the JAX tests' tolerance), in eager and replay
best tracking and through the checkpointing runner. Beyond the JAX tests:
the port against the JAX package on one linked schedule (errors 1e-4
relative, the enforce history equal), fused against stepwise, replay
against eager under a link, and a fused iteration at gate 0 against
ft_stab=False, within 1e-5.

The port's MTIP is built from make_demo_problem(12, 6, fused_sht=True) of
the JAX package through convert.mtip_arrays, so both run on the same
tables.
"""
import numpy as np
import pytest
import jax
import torch

from xframe_tpu.projects.fxs.demo import make_demo_problem as jax_demo
from xframe_tpu.projects.fxs import phasing as jph

from xframe_tpu_torch.convert import mtip_arrays, mtip_from_numpy
from xframe_tpu_torch.parallel.mesh import CheckpointingRunner
from xframe_tpu_torch.projects.fxs import phasing as tph
from xframe_tpu_torch.projects.fxs.phasing import Segment, build_schedule

TOL = 2e-5


@pytest.fixture(scope="module")
def demo():
    return jax_demo(12, 6, fused_sht=True)


def _mtip(p, best_mode, enforce_limit=np.inf, fused=True):
    arrays, config = mtip_arrays(p.mtip)
    config = dict(config, best_mode=best_mode, enforce_limit=enforce_limit,
                  fused_pipeline=fused)
    return mtip_from_numpy(arrays, config, device="cpu")


def _linked_schedule(mod, sw_sigma, delay=1):
    return [
        mod.Segment("HIO", 5, betas=np.linspace(0.6, 0.4, 5), ft_stab=True,
                    ft_stab_link_delay=delay),
        mod.Segment("SW", sigma=sw_sigma, threshold=0.1),
        mod.Segment("ER", 4, betas=np.zeros(4), ft_stab=True,
                    ft_stab_link_delay=delay),
        mod.Segment("SW", sigma=sw_sigma, threshold=0.12),
        mod.Segment("HIO", 4, betas=np.full(4, 0.5), ft_stab=True,
                    ft_stab_link_delay=delay),
        mod.Segment("ER", 3, betas=np.zeros(3), ft_stab=True),
    ]


def _resolved_schedule(sched, flags):
    """The link rule resolved into static ft_stab flags from the per-SW
    enforce flags."""
    out, hist = [], []
    for seg in sched:
        if seg.method in ("SW", "SW_center"):
            hist.append(flags[len(hist)])
            out.append(seg)
        elif seg.ft_stab_link_delay:
            d = seg.ft_stab_link_delay
            on = len(hist) >= d and not any(hist[-d:])
            out.append(Segment(seg.method, seg.n, betas=seg.betas,
                               ft_stab=on))
        else:
            out.append(seg)
    return out


def _rho0(p, seed, n=1):
    return torch.as_tensor(np.array(p.initial_density_batch(seed, n)))


def _assert_same(s_a, e_a, s_b, e_b, tol=TOL):
    np.testing.assert_allclose(e_a.numpy(), e_b.numpy(), rtol=tol, atol=1e-7)
    scale = float(s_b.rho.abs().max())
    assert float((s_a.rho - s_b.rho).abs().max()) < tol * scale
    np.testing.assert_allclose(s_a.best_err.numpy(), s_b.best_err.numpy(),
                               rtol=tol)


@pytest.mark.parametrize("mode", ["eager", "replay"])
@pytest.mark.parametrize("limit,flags", [
    (np.inf, [False, False]),     # never enforced: ft-stab on after SW 1
    (-1.0, [True, True]),         # always enforced: ft-stab stays off
])
def test_linked_matches_hand_resolved(demo, mode, limit, flags):
    sched = _linked_schedule(tph, demo.mtip.sw.default_sigma)
    rho0 = _rho0(demo, 5)
    s_dyn, e_dyn = _mtip(demo, mode, limit).run_batch(rho0, sched)
    assert s_dyn.enforce_hist.shape == (1, 1)
    assert bool(s_dyn.enforce_hist[0, -1]) == flags[1]
    s_st, e_st = _mtip(demo, mode, limit).run_batch(
        rho0, _resolved_schedule(sched, flags))
    _assert_same(s_dyn, e_dyn, s_st, e_st)


@pytest.mark.parametrize("mode", ["eager", "replay"])
def test_linked_mixed_enforcement(demo, mode):
    """An enforce limit between the two pre-SW errors: the two shrink-wraps
    record different flags and the gate flips mid-run."""
    sched = _linked_schedule(tph, demo.mtip.sw.default_sigma)
    rho0 = _rho0(demo, 7)
    _, e = _mtip(demo, mode).run_batch(rho0, sched)
    pre_sw = sorted([float(e[0, 4, 0]), float(e[0, 8, 0])])
    assert not np.isclose(pre_sw[0], pre_sw[1], rtol=1e-3)
    limit = float(np.sqrt(pre_sw[0] * pre_sw[1]))
    s_dyn, e_dyn = _mtip(demo, mode, limit).run_batch(rho0, sched)
    flags = [bool(e_dyn[0, 4, 0] > limit), bool(e_dyn[0, 8, 0] > limit)]
    assert flags[0] != flags[1]
    s_st, e_st = _mtip(demo, mode, limit).run_batch(
        rho0, _resolved_schedule(sched, flags))
    _assert_same(s_dyn, e_dyn, s_st, e_st)
    assert bool(s_dyn.enforce_hist[0, -1]) == flags[1]


def test_linked_delay2_gate_stays_off_until_two_events(demo):
    """delay 2: the gate is 0 until two shrink-wraps have run, then 1 iff
    neither enforced."""
    sched = _linked_schedule(tph, demo.mtip.sw.default_sigma, delay=2)
    rho0 = _rho0(demo, 9)
    s_dyn, e_dyn = _mtip(demo, "eager").run_batch(rho0, sched)
    static = _resolved_schedule(sched, [False, False])
    assert [s.ft_stab for s in static if s.method != "SW"] \
        == [False, False, True, True]
    s_st, e_st = _mtip(demo, "eager").run_batch(rho0, static)
    _assert_same(s_dyn, e_dyn, s_st, e_st)


def test_linked_checkpoint_runner_matches(demo, tmp_path):
    """The checkpointing runner carries the link delay and the enforce
    history through its .npz: one chunk, a resume from disk, equal to the
    uninterrupted run."""
    sched = _linked_schedule(tph, demo.mtip.sw.default_sigma)
    rho0s = _rho0(demo, 11, 2)
    s_a, e_a = _mtip(demo, "replay").run_batch(rho0s, sched)
    ckpt = str(tmp_path / "link_ckpt.npz")
    runner = CheckpointingRunner(_mtip(demo, "replay"), sched,
                                 checkpoint_path=ckpt)
    s_1, _ = runner(rho0s, resume=False, max_chunks=1)
    assert s_1.enforce_hist.shape == (2, 1)
    with np.load(ckpt) as d:
        assert d["enforce_hist"].shape == (2, 1)
    runner2 = CheckpointingRunner(_mtip(demo, "replay"), sched,
                                  checkpoint_path=ckpt)
    s_b, e_b = runner2(rho0s, resume=True)
    np.testing.assert_allclose(e_b.numpy(), e_a.numpy(), rtol=TOL,
                               atol=1e-7)
    np.testing.assert_allclose(s_b.best_err.numpy(), s_a.best_err.numpy(),
                               rtol=TOL)
    assert torch.equal(s_b.enforce_hist, s_a.enforce_hist)


def test_build_schedule_parses_link():
    """ft_stab: link_to_enforce_initial_support with a delay lands on
    Segment.ft_stab_link_delay; an unknown mode raises."""
    main_loop = {"order": ["main"], "main": {
        "iterations": 1, "order": ["HIO", "SW", "ER"],
        "methods": {
            "HIO": {"iterations": 3,
                    "ft_stab": "link_to_enforce_initial_support",
                    "link_to_enforce_initial_support": {"delay": 2}},
            "SW": {"iterations": 1},
            "ER": {"iterations": 2, "ft_stab": True},
        }}}
    segs = build_schedule(main_loop, [[0.5, 0.5, -1 / 700, 1600]], [False],
                          [0.1], {}, default_sigma=3.0)
    hio = [s for s in segs if s.method == "HIO"][0]
    er = [s for s in segs if s.method == "ER"][0]
    assert hio.ft_stab is True and hio.ft_stab_link_delay == 2
    assert er.ft_stab is True and er.ft_stab_link_delay == 0
    with pytest.raises(ValueError):
        bad = {"order": ["main"], "main": {
            "iterations": 1, "order": ["HIO"],
            "methods": {"HIO": {"iterations": 1, "ft_stab": "bogus"}}}}
        build_schedule(bad, [[0.5, 0.5, -1 / 700, 1600]], [False], [0.1],
                       {}, default_sigma=3.0)


@pytest.mark.parametrize("fused", [True, False])
def test_linked_matches_jax(demo, fused):
    """The port's linked run against the JAX package's on the same ρ0 and
    tables, fused and stepwise: the first two iterations and the first
    after the first shrink-wrap within 1e-4 relative (the error series is
    chaotic further on), and the same enforce history."""
    sigma = demo.mtip.sw.default_sigma
    limit = 0.05
    jm = jph.MTIP(demo.ft, demo.mtip.rc, demo.mtip.real, demo.mtip.sw,
                  demo.mtip._w_err_host, demo.mtip.initial_support,
                  enforce_initial_support_limit=limit, fused_pipeline=fused)
    rho0 = np.array(demo.initial_density_batch(5, 2))
    s_j, e_j = jax.jit(lambda r: jm.run_batch(
        r, _linked_schedule(jph, sigma)))(rho0)
    tm = _mtip(demo, "eager", limit, fused=fused)
    assert (tm._fi is not None) == fused
    s_t, e_t = tm.run_batch(torch.as_tensor(rho0),
                            _linked_schedule(tph, sigma))
    e_j, e_t = np.asarray(e_j), e_t.numpy()
    for i in (0, 1, 5):
        rel = np.abs(e_t[:, i, :2] - e_j[:, i, :2]) / np.abs(e_j[:, i, :2])
        assert rel.max() < 1e-4, (i, rel)
    assert np.array_equal(s_t.enforce_hist.numpy(),
                          np.asarray(s_j.enforce_hist))


def test_linked_fused_matches_stepwise(demo):
    """Under a link the fused iteration (cf and B5's add gated) and the
    stepwise one (the correction gated) agree on the errors' first
    iteration after each shrink-wrap within 1e-5 relative, and on the
    enforce history."""
    sched = _linked_schedule(tph, demo.mtip.sw.default_sigma)
    rho0 = _rho0(demo, 3, 2)
    s_f, e_f = _mtip(demo, "eager", 0.05).run_batch(rho0, sched)
    s_s, e_s = _mtip(demo, "eager", 0.05, fused=False).run_batch(rho0, sched)
    for i in (0, 5, 9):
        np.testing.assert_allclose(e_f[:, i].numpy(), e_s[:, i].numpy(),
                                   rtol=1e-5)
    assert torch.equal(s_f.enforce_hist, s_s.enforce_hist)


def test_linked_replay_matches_eager(demo):
    """Replay best tracking under a link re-runs the anchor's iterations
    with the gate it recorded: the best equals eager's within 1e-5."""
    sched = _linked_schedule(tph, demo.mtip.sw.default_sigma)
    rho0 = _rho0(demo, 13, 2)
    s_e, e_e = _mtip(demo, "eager").run_batch(rho0, sched)
    s_r, e_r = _mtip(demo, "replay").run_batch(rho0, sched)
    assert torch.equal(e_e, e_r)
    scale = float(s_e.best_rho.abs().max())
    assert float((s_e.best_rho - s_r.best_rho).abs().max()) <= 1e-5 * scale
    assert torch.equal(s_e.best_err, s_r.best_err)


def test_fused_gate_zero_is_ft_stab_off(demo):
    """One fused iteration at gate 0 equals ft_stab=False within 1e-5, gate
    1 equals the ungated ft-stab iteration bitwise, and a mixed gate gives
    each restart its own."""
    tm = _mtip(demo, "eager")
    rho = _rho0(demo, 17, 2)
    sup = tm.initial_support.expand(rho.shape).contiguous()
    z, z2 = tm._anchor_stats(rho)
    args = (rho, sup, 0.6, "HIO")

    def run(ft_stab, gate=None):
        return tm._mtip_iteration_fused(*args, ft_stab, z, z2, gate)
    off, on = run(False), run(True)
    zero = run(True, torch.zeros(2))
    one = run(True, torch.ones(2))
    mixed = run(True, torch.tensor([0.0, 1.0]))
    for a, b in zip(zero, off):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for a, b in zip(one, on):
        assert torch.equal(a, b)
    for a, b0, b1 in zip(mixed, off, on):
        assert float((a[0] - b0[0]).abs().max()) \
            <= 1e-5 * float(b0.abs().max())
        assert float((a[1] - b1[1]).abs().max()) \
            <= 1e-5 * float(b1.abs().max())
