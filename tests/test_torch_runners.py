"""The port's runners (xframe_tpu_torch/parallel/mesh.py) against the JAX
package's and against an uninterrupted run (CPU).

The schedule split and its (structure, args) equal the JAX package's on the
tutorial schedule and on build_schedule outputs; rank_restarts equals the
JAX package's. On the JAX package's make_demo_problem(12, 6, fused_sht=True)
tables (as tests/test_replay_best.py): MultiStartRunner equals run_batch;
CheckpointingRunner run one chunk, then resumed by a fresh runner, equals an
uninterrupted run, eager and replay; an eager checkpoint resumed under
replay ends with the best over both halves; and the port's runner resumed
from the JAX runner's state after one chunk (converted by
convert.state_arrays) finishes as the JAX runner does, within
tests/test_torch_fused_phasing.py's bounds (error series within 0.05
relative, densities within 0.05 of max).
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import torch

from xframe_tpu.parallel import mesh as jmesh
from xframe_tpu.projects.fxs import phasing as jph
from xframe_tpu.projects.fxs.demo import make_demo_problem as jax_demo

from xframe_tpu_torch.convert import mtip_arrays, mtip_from_numpy, \
    state_arrays, state_from_numpy
from xframe_tpu_torch.parallel import mesh as tmesh
from xframe_tpu_torch.projects.fxs import phasing as tph

BUILD_ARGS = (
    {"order": ["a", "b"],
     "a": {"iterations": 2, "order": ["HIO", "SW", "ER"],
           "methods": {"HIO": {"iterations": 3}, "SW": 1,
                       "ER": {"iterations": 2, "ft_stab": False}},
           "best_density_not_in_first_n_iterations": 1},
     "b": {"iterations": 1, "order": ["SW", "RAAR", "ER_non_FXS"],
           "methods": {"SW": 2, "RAAR": 4, "ER_non_FXS": 1}}},
    [[0.9, 0.5, 0.01, 10], [0.7, 0.7, -0.01, 10]],
    [[2.0, [1.0, 3]], False], [0.2, [0.1, [0.05, 2]]],
    {"a": {"HIO": True}, "b": {"RAAR": True}}, 1.5)


def _tutorial(mod, sigma=1.5):
    full = []
    for _ in range(5):
        full += [mod.Segment("HIO", 60, betas=np.full(60, 0.5), ft_stab=True),
                 mod.Segment("SW", sigma=sigma, threshold=0.1),
                 mod.Segment("ER", 40, betas=np.zeros(40), ft_stab=True)]
    return full + [mod.Segment("SW", sigma=sigma, threshold=0.1),
                   mod.Segment("ER", 100, betas=np.zeros(100), ft_stab=True)]


def _schedule(mod, sigma):
    """SNAPSHOT, HIO 7, SW, ER 5, RESET_TO_BEST, HIO 4, SW, ER 4: three
    chunks."""
    return [
        mod.Segment("SNAPSHOT"),
        mod.Segment("HIO", 7, betas=np.linspace(0.6, 0.4, 7), ft_stab=True),
        mod.Segment("SW", sigma=sigma, threshold=0.1),
        mod.Segment("ER", 5, betas=np.zeros(5), ft_stab=True),
        mod.Segment("RESET_TO_BEST"),
        mod.Segment("HIO", 4, betas=np.full(4, 0.5), ft_stab=False),
        mod.Segment("SW", sigma=sigma, threshold=0.1),
        mod.Segment("ER", 4, betas=np.zeros(4), ft_stab=True),
    ]


@pytest.mark.parametrize("which", ["tutorial", "build_schedule"])
def test_schedule_chunks_match_jax(which):
    if which == "tutorial":
        js, ts = _tutorial(jph), _tutorial(tph)
    else:
        js, ts = jph.build_schedule(*BUILD_ARGS), tph.build_schedule(
            *BUILD_ARGS)
    jc, tc = jmesh.split_schedule_chunks(js), tmesh.split_schedule_chunks(ts)
    assert [len(c) for c in tc] == [len(c) for c in jc] and len(jc) > 1
    for a, b in zip(jc, tc):
        (s_j, a_j), (s_t, a_t) = (jmesh._chunk_structure_args(a),
                                  tmesh._chunk_structure_args(b))
        assert s_t == s_j
        assert len(a_t) == len(a_j)
        for x, y in zip(a_t, a_j):
            assert np.array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype


def test_rank_restarts_matches_jax():
    best = np.array([0.3, 0.01, np.inf, 0.2, 0.01], np.float32)
    order, got = tmesh.rank_restarts(SimpleNamespace(
        best_err=torch.as_tensor(best)))
    j_order, j_best = jmesh.rank_restarts(SimpleNamespace(best_err=best))
    assert np.array_equal(order, j_order) and np.array_equal(got, j_best)


@pytest.fixture(scope="module")
def problem():
    p = jax_demo(12, 6, fused_sht=True)
    m = p.mtip
    jm = jph.MTIP(p.ft, m.rc, m.real, m.sw, m._w_err_host, m.initial_support,
                  enforce_initial_support_limit=m.enforce_limit,
                  best_mode="replay")
    arrays, config = mtip_arrays(jm)
    port = {mode: mtip_from_numpy(arrays, dict(config, best_mode=mode),
                                  device="cpu")
            for mode in ("eager", "replay")}
    return p, jm, port, np.array(p.initial_density_batch(5, 2))


def _same(a, b):
    assert torch.equal(a[1], b[1])
    for k in ("best_err", "best_rho", "best_mask", "rho", "support"):
        assert torch.equal(getattr(a[0], k), getattr(b[0], k)), k


@pytest.mark.parametrize("mode", ["eager", "replay"])
def test_multistart_runner_equals_run_batch(problem, mode):
    p, _, port, r0 = problem
    sched = _schedule(tph, p.mtip.sw.default_sigma)
    tm = port[mode]
    _same(tmesh.MultiStartRunner(tm, sched)(torch.as_tensor(r0)),
          tm.run_batch(torch.as_tensor(r0), sched))


@pytest.mark.parametrize("mode", ["eager", "replay"])
def test_checkpoint_resume_equals_uninterrupted(problem, mode, tmp_path):
    p, _, port, r0 = problem
    sched = _schedule(tph, p.mtip.sw.default_sigma)
    tm, rho0 = port[mode], torch.as_tensor(r0)
    full = tmesh.CheckpointingRunner(tm, sched)(rho0, resume=False)
    ck = str(tmp_path / "run" / "ck.npz")
    first = tmesh.CheckpointingRunner(tm, sched, checkpoint_path=ck)
    _, e1 = first(rho0, resume=False, max_chunks=1)
    assert os.path.exists(ck) and not os.path.exists(ck + ".tmp")
    assert e1.shape == (2, 7, 2)
    resumed = tmesh.CheckpointingRunner(tm, sched, checkpoint_path=ck)(
        rho0, resume=True)
    _same(resumed, full)
    assert resumed[1].shape == (2, 20, 2)
    if mode == "replay":
        assert not resumed[0].anchor_len.any()


def test_eager_checkpoint_resumed_under_replay(problem, tmp_path):
    """Fresh anchors at the checkpointed best: the finished run's best is
    the best over both halves (tests/test_replay_best.py:127-151)."""
    p, _, port, r0 = problem
    sched = _schedule(tph, p.mtip.sw.default_sigma)
    ck = str(tmp_path / "eager.npz")
    tmesh.CheckpointingRunner(port["eager"], sched, checkpoint_path=ck)(
        torch.as_tensor(r0), resume=False, max_chunks=1)
    state, errs = tmesh.CheckpointingRunner(port["replay"], sched,
                                            checkpoint_path=ck)(
        torch.as_tensor(r0), resume=True)
    assert errs.shape == (2, 20, 2) and torch.isfinite(errs).all()
    np.testing.assert_allclose(state.best_err.numpy(),
                               errs[:, :, 0].min(dim=1).values.numpy(),
                               rtol=2e-5)
    assert torch.isfinite(torch.view_as_real(state.best_rho)).all()


def test_resume_from_the_jax_runner_state(problem, tmp_path):
    """The JAX runner runs one chunk; the port writes that state (anchors
    included) as its checkpoint and its runner finishes the schedule, as
    the JAX runner does from the same state."""
    p, jm, port, r0 = problem
    j_sched = _schedule(jph, p.mtip.sw.default_sigma)
    j_state, j_err = jmesh.CheckpointingRunner(jm, j_sched)(
        r0, resume=False, max_chunks=1)
    j_full, j_errs = jmesh.CheckpointingRunner(jm, j_sched)(r0, resume=False)
    ck = str(tmp_path / "from_jax.npz")
    runner = tmesh.CheckpointingRunner(
        port["replay"], _schedule(tph, p.mtip.sw.default_sigma),
        checkpoint_path=ck)
    runner._save(state_from_numpy(device="cpu", **state_arrays(j_state)),
                 [torch.as_tensor(np.array(j_err))], 1)
    state, errs = runner(torch.as_tensor(r0), resume=True)
    j_errs = np.asarray(j_errs)
    assert np.array_equal(errs[:, :7].numpy(), j_errs[:, :7])
    rel = np.abs(errs.numpy() - j_errs) / (np.abs(j_errs) + 1e-9)
    assert rel.max() < 0.05
    np.testing.assert_allclose(state.best_err.numpy(),
                               np.asarray(j_full.best_err), rtol=0.05)
    scale = np.abs(np.asarray(j_full.best_rho)).max()
    assert np.abs(state.best_rho.numpy() - np.asarray(j_full.best_rho)).max() \
        < 0.05 * scale
