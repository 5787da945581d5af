"""The comparison that decides `correct`.

The phasing is chaotic: two float32 runs of HIO part within tens of
iterations, so no reference can follow a whole schedule. The reference
(fxsbench/reference, float64) therefore follows the program step by step
from the program's own states, and judges the program's own record of
each step, over every restart of the judged batches (at least
MIN_RESTARTS in every run, traced or not):

* start_gap: the median over the judged restarts of each one's widest
  relative gap (HELD) between the window's error record and the
  reference's two iterations from the batch's initial densities on the
  initial support: the real and the reciprocal error of the first
  iteration (the forward chain, the projection, ft-stab, the real
  constraint, the error sums) and the reciprocal error of the second (the
  first one's update as well). A median: the float32 Newton–Schulz polar
  cannot resolve the small singular values that some restarts' B_l have,
  and HIO's update jumps where a point's validity flips (the real part of
  ρ_p crossing 0), so a few sound restarts read as far out as the TF32
  control's best ones;
* hio_gap, er_gap: the program's state entering an HIO iteration drawn
  from the seed in the later half of the schedule's HIO iterations, where
  β has ramped, and its state entering an ER iteration drawn from the
  seed. The program reaches each by running the batch again from its
  initial densities in one stretch (bench.program_taps), and runs two more
  iterations from it. The median over the judged restarts of the wider
  relative gap between those iterations' reciprocal errors and the
  reference's two iterations from the same state: the first iteration's,
  and the second's, which the first one's update (HIO's with its β, or
  ER's) moves. Not the real error: deep in the last ER segment it sinks to
  float32's rounding, where its relative gap reads up to 1 on sound
  restarts; nor the new density, whose gap HIO's jumps where a point's
  validity flips hold at 1e-3, as wide as a β stuck at its start moves it;
* best_gap, replay's materialised best: the median over the judged
  restarts of the widest relative gap between the program's real and
  reciprocal error of the iteration after the best, and the reference's
  errors of the best density on the support that iteration ran on: the
  best's own, or where a shrink-wrap comes between, the reference's
  shrink-wrap of the best density. The program's errors are the ones its
  run recorded; where the best is the schedule's last iteration, those of
  one more iteration from its final state (bench.program_finals), which
  the reference's from the best equal only where the best is that state;
* sw_gap, the shrink-wrap by itself: the program's last shrink-wrap of the
  schedule on each judged restart's final state against the reference's
  on the same density, the integration-weighted volume on which the two
  supports differ over the reference support's volume, the largest over
  the restarts.

The control (judge's `control`) puts the reference in TF32 in the
program's place: its own iterations from the initial densities and from
each tap's state, its own errors of each best, its own shrink-wrap of each
final state, judged the same way. Each number is held to the limit in the
configuration's "check" block; a number that is not finite reads
NOT_FINITE.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from fxsbench.reference.mtip import ReferenceMTIP
from fxsbench.reference.transforms import Precision

MIN_RESTARTS = 8
TAPS = ("hio", "er")
HELD = ((0, 0), (0, 1), (1, 1))    # the (iteration, error column)s held
NOT_FINITE = 1e30


@dataclass
class Tap:
    """The program's state entering iteration k of a judged batch, and the
    reciprocal errors (rows, 2) of its iterations k and k + 1 from it."""
    k: int
    rho: torch.Tensor
    support: torch.Tensor
    record: np.ndarray


@dataclass
class Batch:
    """One judged batch, copied to the host after it ran: its initial
    densities, the window's error record (rows, iterations, columns), its
    final densities, supports and last errors, and the best as replay
    materialised it; later the taps, and the program's last shrink-wrap of
    the final state and its errors of one more iteration from it."""
    index: int
    rho0: torch.Tensor
    errors: np.ndarray
    rho: torch.Tensor
    support: torch.Tensor
    last_err: torch.Tensor
    best_rho: torch.Tensor
    best_mask: torch.Tensor
    taps: dict = field(default_factory=dict)
    sw_support: torch.Tensor = None
    after: np.ndarray = None       # (rows, 2): one iteration past the end
    rerun_equal: dict = None

    @classmethod
    def take(cls, index, rho0, states, errors):
        def host(x):
            return x.detach().to("cpu", copy=True)
        return cls(index=index, rho0=host(rho0),
                   errors=errors.detach().double().cpu().numpy(),
                   rho=host(states.rho), support=host(states.support),
                   last_err=host(states.last_err).double(),
                   best_rho=host(states.best_rho),
                   best_mask=host(states.best_mask))


def rel_gaps(got, want):
    """|got − want| / |want| elementwise, NOT_FINITE where either is not
    finite or want is 0."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    ok = np.isfinite(got) & np.isfinite(want) & (want != 0)
    return np.where(ok, np.abs(got - want) / np.where(ok, np.abs(want), 1.0),
                    NOT_FINITE)


def one_step(mtip, rho, support, k):
    """A ReferenceMTIP's iteration k from (rows, grid) densities on their
    supports: → (new densities, real errors, reciprocal errors)."""
    method, beta, stab = mtip.iterations[k]
    return mtip.step(rho.to(mtip.device), support.to(mtip.device), method,
                     beta, stab)


def two_steps(mtip, rho, support, k):
    """A ReferenceMTIP's errors of iterations k and k + 1 from (rows, grid)
    densities on their supports: (rows, 2 iterations, 2 columns: real,
    reciprocal), as the program records them."""
    out = []
    for i in (k, k + 1):
        rho, err, err_rec = one_step(mtip, rho, support, i)
        out.append(torch.stack([err, err_rec], dim=-1))
    return torch.stack(out, dim=1).double().cpu().numpy()


def errors_of(mtip, rho, support, k):
    """A ReferenceMTIP's (real, reciprocal) error of one density."""
    _, err, err_rec = one_step(mtip, rho[None], support[None], k)
    return np.array([float(err[0]), float(err_rec[0])])


def final_shrink_wrap(mtip, batch):
    """A ReferenceMTIP's last shrink-wrap of the schedule on the batch's
    final state: the new supports (rows, grid)."""
    dev = mtip.device
    _, sigma, thr = mtip.shrink_wraps[-1]
    return mtip.shrink_wrap(batch.rho.to(dev), batch.support.to(dev), sigma,
                            thr, batch.last_err.to(dev))


class Recorded:
    """The program's readings: what its runs recorded."""

    def start(self, batch):
        return batch.errors[:, :2, :2]

    def step(self, tap):
        return tap.record

    def after_best(self, batch, row, at, support):
        if at + 1 < batch.errors.shape[1]:
            return batch.errors[row, at + 1, :2]
        return batch.after[row]

    def support(self, batch):
        return batch.sw_support


class StandIn:
    """The control's readings: a ReferenceMTIP in the program's place, its
    own iterations from the program's states."""

    def __init__(self, mtip):
        self.mtip = mtip

    def start(self, batch):
        return two_steps(self.mtip, batch.rho0,
                         self.mtip.initial_support[None], 0)

    def step(self, tap):
        return two_steps(self.mtip, tap.rho, tap.support, tap.k)[..., 1]

    def after_best(self, batch, row, at, support):
        return errors_of(self.mtip, batch.best_rho[row], support,
                         min(at + 1, batch.errors.shape[1] - 1))

    def support(self, batch):
        return final_shrink_wrap(self.mtip, batch)


def best_at(record):
    """The best's iteration in one restart's (iterations, columns) record:
    the first of its smallest real errors."""
    rec = record[:, 0]
    return int(np.argmin(np.where(np.isfinite(rec), rec, np.inf)))


def best_support(ref, batch, row, at):
    """The support that the iteration after the best runs on: the best's,
    or the reference's shrink-wrap of the best density where one comes
    between, or the final one after the schedule's last iteration."""
    if at + 1 >= batch.errors.shape[1]:
        return batch.support[row]
    sup = batch.best_mask[row]
    for pos, sigma, thr in ref.shrink_wraps:
        if pos == at + 1:
            dev = ref.device
            sup = ref.shrink_wrap(
                batch.best_rho[row].to(dev)[None], sup.to(dev)[None], sigma,
                thr, torch.tensor([batch.errors[row, at, 0]], device=dev))[0]
    return sup


def sw_gaps(ref, batch, got):
    """The shrink-wrap's check (module docstring), per restart."""
    dev = ref.device
    want = final_shrink_wrap(ref, batch)
    w = ref.t.integration_weights(ref.t.rs).expand(want.shape)
    dims = tuple(range(1, want.dim()))
    vol = (w * want).sum(dims)
    diff = (w * (want ^ got.to(dev))).sum(dims)
    return [float(d / v) if v > 0 else NOT_FINITE
            for d, v in zip(diff.cpu(), vol.cpu())]


def widest_held(gaps):
    """(rows, 2, 2) gaps → each row's widest HELD entry."""
    return np.stack([gaps[:, k, c] for k, c in HELD], axis=1).max(axis=1)


def judge(settings, inv, cfg, batches, device, control=False):
    """→ (checks {name: {"value", "limit"}}, detail) over the judged
    batches. control: the reference in TF32 in the program's place."""
    ref = ReferenceMTIP(settings, inv, Precision("float64"), device)
    if any(m != "HIO" for m, _, _ in ref.iterations[:2]) or \
            any(pos < 2 for pos, _, _ in ref.shrink_wraps):
        raise ValueError("the schedule does not start with HIO iterations")
    prog = StandIn(ReferenceMTIP(settings, inv, Precision("tf32"), device)) \
        if control else Recorded()
    gaps = {name: [] for name in ("start",) + TAPS}
    best, bests, sw = [], [], []
    for b in batches:
        gaps["start"].extend(widest_held(rel_gaps(prog.start(b), two_steps(
            ref, b.rho0, ref.initial_support[None], 0))))
        for name in TAPS:
            tap = b.taps[name]
            want = two_steps(ref, tap.rho, tap.support, tap.k)[..., 1]
            gaps[name].extend(rel_gaps(prog.step(tap), want).max(axis=1))
        for row in range(len(b.errors)):
            at = best_at(b.errors[row])
            sup = best_support(ref, b, row, at)
            want = errors_of(ref, b.best_rho[row], sup,
                             min(at + 1, b.errors.shape[1] - 1))
            best.append(float(rel_gaps(prog.after_best(b, row, at, sup),
                                       want).max()))
            bests.append(at)
        sw.extend(sw_gaps(ref, b, prog.support(b)))
    values = {f"{name}_gap": float(np.median(v)) for name, v in gaps.items()}
    values.update(best_gap=float(np.median(best)), sw_gap=float(max(sw)))
    limits = cfg["limits"]
    checks = {name: {"value": v if np.isfinite(v) else NOT_FINITE,
                     "limit": limits[name]} for name, v in values.items()}
    detail = {"restarts": len(best), "batches": [b.index for b in batches],
              "taps": {name: b.taps[name].k for name in TAPS},
              "rerun_equal": [b.rerun_equal for b in batches],
              "gaps": {name: [float(x) for x in v]
                       for name, v in gaps.items()},
              "best_gap": best, "best_iteration": bests, "sw_gap": sw}
    return checks, detail
