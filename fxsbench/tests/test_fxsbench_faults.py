"""`correct` comes out false with the timed path broken underneath, once
for each fault that the cells can have, and for the control. (The cells
run on one chip: there is no exchange between chips to leave out.) On the
tiny cell (conftest.LIMITS) at seed 42 the faults read: a step returning
its state start 2.9; half the batch start 3.0e-2; the error record altered
5e-2 everywhere; the support altered sw 4.5e-2; ER altered er 0.87; β stuck
hio 4.9e-3; the best not replayed best 2.0e-3."""
import pytest
import torch

from conftest import TINY

from fxsbench import bench


def state_unchanged(mp):
    """Every iteration returns its input density (its errors computed)."""
    from xframe_tpu_torch.projects.fxs.phasing import MTIP
    orig = MTIP._mtip_iteration_fused

    def step(self, rho_in, *args, **kw):
        return (rho_in,) + tuple(orig(self, rho_in, *args, **kw)[1:])
    mp.setattr(MTIP, "_mtip_iteration_fused", step)


def half_batch(mp):
    """The runner phases the first half of the batch and hands its results
    out for the second half as well."""
    from xframe_tpu_torch.parallel.mesh import MultiStartRunner
    from xframe_tpu_torch.projects.fxs.phasing import PhasingState

    def call(self, rho0):
        n = rho0.shape[0]
        state, errors = self.mtip.run_batch(rho0[: n // 2], self.schedule)

        def twice(x):
            return None if x is None else torch.cat([x, x])[:n]
        return PhasingState(*(twice(x) for x in state)), twice(errors)
    mp.setattr(MultiStartRunner, "__call__", call)


def errors_altered(mp):
    """The error record is altered where the run produces it."""
    from xframe_tpu_torch.projects.fxs.phasing import MTIP
    orig = MTIP.run_from

    def run_from(self, *args, **kw):
        state, errors = orig(self, *args, **kw)
        return state, errors * 1.05
    mp.setattr(MTIP, "run_from", run_from)


def support_altered(mp):
    """The shrink-wrap's support is altered where it is produced (its
    threshold raised by a tenth)."""
    from xframe_tpu_torch.projects.fxs.projections import ShrinkWrap
    orig = ShrinkWrap.new_support

    def new_support(self, conv, threshold, current_support=None):
        return orig(self, conv, threshold * 1.1, current_support)
    mp.setattr(ShrinkWrap, "new_support", new_support)


def er_altered(mp):
    """ER's update is altered where it is produced: ER steps run HIO's
    update at β 0.5."""
    from xframe_tpu_torch.projects.fxs.phasing import MTIP
    orig = MTIP._mtip_iteration_fused

    def step(self, rho_in, support, beta, method, *args, **kw):
        if method == "ER":
            method, beta = "HIO", 0.5
        return orig(self, rho_in, support, beta, method, *args, **kw)
    mp.setattr(MTIP, "_mtip_iteration_fused", step)


def beta_stuck(mp):
    """HIO's β stays at the first value the run used."""
    from xframe_tpu_torch.projects.fxs.phasing import MTIP
    orig = MTIP._mtip_iteration_fused
    first = []

    def step(self, rho_in, support, beta, method, *args, **kw):
        if method == "HIO":
            first[:] = first or [beta]
            beta = first[0]
        return orig(self, rho_in, support, beta, method, *args, **kw)
    mp.setattr(MTIP, "_mtip_iteration_fused", step)


def best_not_replayed(mp):
    """Replay materialises each restart's anchor, the entry state of the
    chunk that holds the best, without replaying up to the best."""
    from xframe_tpu_torch.projects.fxs.phasing import MTIP

    def materialize_best(self, state):
        if state.anchor_rho is None:
            return state
        return state._replace(best_rho=state.anchor_rho,
                              best_mask=state.anchor_sup,
                              anchor_len=state.anchor_len * 0)
    mp.setattr(MTIP, "materialize_best", materialize_best)


FAULTS = [state_unchanged, half_batch, errors_altered, support_altered,
          er_altered, beta_stuck, best_not_replayed]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_fails_the_check(fault, tiny_root, monkeypatch):
    r = bench.run(TINY, 42, 0.1, False, root=tiny_root, device="cpu")
    assert r["correct"], r["checks"]
    fault(monkeypatch)
    r = bench.run(TINY, 42, 0.1, False, root=tiny_root, device="cpu")
    assert not r["correct"], r["checks"]


def test_the_control_fails_the_check(tiny_root):
    """The reference in TF32 in the program's place comes out not correct
    through the run's own comparison, at seeds whose program runs pass."""
    for seed in (42, 43):
        r = bench.run(TINY, seed, 0.1, False, root=tiny_root, device="cpu")
        assert r["correct"], r["checks"]
        r = bench.run(TINY, seed, 0.1, False, root=tiny_root, device="cpu",
                      control=True)
        assert not r["correct"], r["checks"]
        assert r["checks"]["start_gap"]["value"] \
            > r["checks"]["start_gap"]["limit"]
