"""Replay best tracking of the port (MTIP(best_mode="replay")) against
eager tracking and against the JAX package's replay (CPU).

The problem is the JAX package's make_demo_problem(12, 6, fused_sht=True),
as in tests/test_replay_best.py; the port is built from its tables through
xframe_tpu_torch.convert and runs the plain versions of its kernels; the
JAX side runs its Pallas kernels in interpret mode. Bounds:
  * port replay against port eager: the JAX package's own bounds for replay
    against eager (tests/test_replay_best.py:52-60; rtol 2e-5 on errors and
    best_err, best_rho within 2e-5 of max, best_mask equal);
  * port against JAX on the same densities: tests/test_torch_fused_phasing.py's
    bounds (error series within 1e-4 relative on the first iteration and
    0.05 overall; densities within 0.05 of max);
  * a replay from one mid-run state, carried across by convert.state_arrays
    and state_from_numpy: the replayed best of both packages within 1e-4 of
    max (float32 sums in another order over at most 15 iterations).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from xframe_tpu.projects.fxs import phasing as jph
from xframe_tpu.projects.fxs.demo import make_demo_problem as jax_demo

from xframe_tpu_torch.convert import (mtip_arrays, mtip_from_numpy,
                                      state_arrays, state_from_numpy)
from xframe_tpu_torch.projects.fxs import phasing as tph


def _schedule(mod, sigma):
    """tests/test_replay_best.py's schedule: a mid-segment best in HIO, SW,
    ER, a SNAPSHOT/RESET_TO_BEST pair, then HIO and ER."""
    return [
        mod.Segment("SNAPSHOT"),
        mod.Segment("HIO", 7, betas=np.linspace(0.6, 0.4, 7), ft_stab=True),
        mod.Segment("SW", sigma=sigma, threshold=0.1),
        mod.Segment("ER", 5, betas=np.zeros(5), ft_stab=True),
        mod.Segment("RESET_TO_BEST"),
        mod.Segment("HIO", 4, betas=np.full(4, 0.5), ft_stab=False),
        mod.Segment("ER", 4, betas=np.zeros(4), ft_stab=True),
    ]


def _jax_mtip(p, best_mode):
    m = p.mtip
    return jph.MTIP(p.ft, m.rc, m.real, m.sw, m._w_err_host,
                    m.initial_support,
                    enforce_initial_support_limit=m.enforce_limit,
                    best_mode=best_mode)


@pytest.fixture(scope="module")
def problem():
    """The JAX problem, its replay MTIP, the port's replay and eager MTIPs
    on the same tables, and two starting densities."""
    p = jax_demo(12, 6, fused_sht=True)
    jm = _jax_mtip(p, "replay")
    assert jm.best_mode == "replay"
    arrays, config = mtip_arrays(jm)
    assert config["best_mode"] == "replay"
    port = {mode: mtip_from_numpy(arrays, dict(config, best_mode=mode),
                                  device="cpu")
            for mode in ("replay", "eager")}
    assert port["replay"].best_mode == "replay"
    return p, jm, port, np.array(p.initial_density_batch(3, 2))


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_replay_equals_eager(problem):
    p, _, port, r0 = problem
    sched = _schedule(tph, p.mtip.sw.default_sigma)
    s_e, e_e = port["eager"].run_batch(torch.as_tensor(r0), sched)
    s_r, e_r = port["replay"].run_batch(torch.as_tensor(r0), sched)
    assert torch.isfinite(e_e).all()
    np.testing.assert_allclose(e_r.numpy(), e_e.numpy(), rtol=2e-5,
                               atol=1e-7)
    np.testing.assert_allclose(s_r.best_err.numpy(), s_e.best_err.numpy(),
                               rtol=2e-5)
    assert _max_rel(s_r.best_rho, s_e.best_rho) < 2e-5
    assert torch.equal(s_r.best_mask, s_e.best_mask)
    assert _max_rel(s_r.rho, s_e.rho) < 2e-5
    # re-anchored at the materialised best: nothing left to replay
    assert torch.equal(s_r.anchor_rho, s_r.best_rho)
    assert not s_r.anchor_len.any()


def test_replay_matches_jax(problem):
    p, jm, port, r0 = problem
    s_j, e_j = jax.jit(jax.vmap(
        lambda r: jm.run(r, _schedule(jph, p.mtip.sw.default_sigma))))(r0)
    s_t, e_t = port["replay"].run_batch(
        torch.as_tensor(r0), _schedule(tph, p.mtip.sw.default_sigma))
    e_j, e_t = np.asarray(e_j), e_t.numpy()
    rel = np.abs(e_t - e_j) / (np.abs(e_j) + 1e-9)
    assert rel[:, 0].max() < 1e-4 and rel.max() < 0.05
    np.testing.assert_allclose(s_t.best_err.numpy(), np.asarray(s_j.best_err),
                               rtol=0.05)
    assert _max_rel(s_t.best_rho, s_j.best_rho) < 0.05
    assert _max_rel(s_t.rho, s_j.rho) < 0.05


def test_replay_from_a_jax_mid_run_state(problem):
    """JAX runs 12 HIO iterations without ft-stab and does not materialise;
    the port takes its state, anchors included, and both replay to the
    best."""
    p, jm, port, r0 = problem
    j_sched = [jph.Segment("HIO", 12, betas=np.full(12, 0.5), ft_stab=False)]
    jm.set_schedule_tables(j_sched)
    s_j, _ = jax.jit(jax.vmap(
        lambda r: jm.run_from(jm.initial_state(r), j_sched,
                              materialize=False)))(r0)
    assert np.asarray(s_j.anchor_len).max() > 0     # something to replay
    best_j = jax.jit(jax.vmap(jm.materialize_best))(s_j)
    tm = port["replay"]
    tm.set_schedule_tables([tph.Segment("HIO", 12, betas=np.full(12, 0.5),
                                        ft_stab=False)])
    s_t = state_from_numpy(device="cpu", **state_arrays(s_j))
    assert np.array_equal(s_t.anchor_len.numpy(), np.asarray(s_j.anchor_len))
    best_t = tm.materialize_best(s_t)
    assert _max_rel(best_t.best_rho, best_j.best_rho) < 1e-4
    assert np.array_equal(best_t.best_mask.numpy(),
                          np.asarray(best_j.best_mask))
    assert not best_t.anchor_len.any()


def test_anchor_len_zero_for_monotone_tail(problem):
    """When the best is a segment's last iterate (monotone ER) the anchor
    replays nothing (tests/test_replay_best.py:108-124)."""
    p, _, port, r0 = problem
    tm = port["replay"]
    sched = [tph.Segment("HIO", 6, betas=np.full(6, 0.5), ft_stab=True),
             tph.Segment("ER", 8, betas=np.zeros(8), ft_stab=True)]
    tm.set_schedule_tables(sched)
    state, errs = tm.run_from(tm.initial_state_batch(torch.as_tensor(r0)),
                              sched, materialize=False)
    tail = errs[:, 6:, 0].numpy()
    for r in range(len(r0)):
        if tail[r].argmin() == tail.shape[1] - 1:       # ER tail monotone
            assert int(state.anchor_len[r]) == 0
            assert int(state.anchor_start[r]) == 6
        assert int(state.anchor_len[r]) < tm.REPLAY_ANCHOR_CHUNK
    assert (np.diff(tail, axis=1) < 0).all(axis=1).any()


def test_replay_keys_differ_across_restarts(problem):
    """Three restarts anchored at different places of the schedule tables:
    HIO at β[1] for 3 iterations, ER for 2, and nothing to replay. Each
    replay step runs the batch once per distinct (method, ft_stab, β) and
    keeps its rows; the result equals each restart replayed on its own and
    the JAX package's replay of the same state."""
    p, jm, port, r0 = problem
    tm = port["replay"]
    betas = np.linspace(0.6, 0.4, 5)
    t_sched = [tph.Segment("HIO", 5, betas=betas, ft_stab=True),
               tph.Segment("ER", 4, betas=np.zeros(4), ft_stab=True)]
    j_sched = [jph.Segment("HIO", 5, betas=betas, ft_stab=True),
               jph.Segment("ER", 4, betas=np.zeros(4), ft_stab=True)]
    tm.set_schedule_tables(t_sched)
    jm.set_schedule_tables(j_sched)
    rho = torch.as_tensor(np.concatenate([r0, r0[:1] * 0.9]))
    base = tm.initial_state_batch(rho)
    # anchors after two iterations of the batch, so that z, z2 are the
    # kernel's sums
    state, _ = tm.run_from(base, [tph.Segment("HIO", 2, betas=betas[:2],
                                              ft_stab=True)],
                           materialize=False)
    sums = tm._anchor_stats(state.rho)
    anchors = dict(anchor_rho=state.rho.numpy(),
                   anchor_sup=state.support.numpy(),
                   anchor_z=sums[0].numpy(), anchor_z2=sums[1].numpy(),
                   anchor_start=np.array([1, 6, 3], np.int32),
                   anchor_len=np.array([3, 2, 0], np.int32))
    s_t = state_from_numpy(state.rho.numpy(), state.support.numpy(), "cpu",
                           **anchors)
    calls = []
    iterate = tm._mtip_iteration_fused

    def counted(rho, sup, beta, method, *a):
        calls.append((method, beta))
        return iterate(rho, sup, beta, method, *a)
    tm._mtip_iteration_fused = counted
    try:
        best = tm.materialize_best(s_t).best_rho
    finally:
        del tm._mtip_iteration_fused
    # steps 0 and 1: HIO at β[1], β[2] and ER; step 2: HIO at β[3]
    want_calls = [("HIO", np.float32(betas[1])), ("ER", 0.0),
                  ("HIO", np.float32(betas[2])), ("ER", 0.0),
                  ("HIO", np.float32(betas[3]))]
    assert [(m, np.float32(b)) for m, b in calls] == want_calls
    for r, (start, n) in enumerate([(1, 3), (6, 2), (3, 0)]):
        one = state_from_numpy(state.rho[r:r + 1].numpy(),
                               state.support[r:r + 1].numpy(), "cpu")
        seg = tph.Segment(*(("HIO", n, betas[start:start + n])
                            if start < 5 else ("ER", n, np.zeros(n))),
                          ft_stab=True)
        rho_r = port["eager"].run_from(one, [seg])[0].rho if n else one.rho
        assert _max_rel(best[r:r + 1], rho_r) < 1e-5
    js = jph.PhasingState(
        rho=jnp.asarray(anchors["anchor_rho"]),
        support=jnp.asarray(anchors["anchor_sup"]),
        best_rho=jnp.asarray(anchors["anchor_rho"]),
        best_mask=jnp.asarray(anchors["anchor_sup"]),
        best_err=jnp.zeros(3), last_err=jnp.zeros(3),
        anchor_rho=jnp.asarray(anchors["anchor_rho"]),
        anchor_sup=jnp.asarray(anchors["anchor_sup"], jnp.int8),
        anchor_z=jnp.asarray(anchors["anchor_z"]),
        anchor_z2=jnp.asarray(anchors["anchor_z2"]),
        anchor_start=jnp.asarray(anchors["anchor_start"]),
        anchor_len=jnp.asarray(anchors["anchor_len"]),
        anchor_gate=jnp.ones(3))
    jbest = jax.jit(jax.vmap(jm.materialize_best))(js).best_rho
    assert _max_rel(best, jbest) < 1e-4
