"""Minimax coefficient schedules for the Newton-Schulz polar iteration.

Copy of `xframe_tpu.ops.polar_schedule` (numpy and scipy, no JAX): each
step's odd quintic p(x) = a x + b x^3 + c x^5 minimises max |1 - p(x)| over
the current singular-value interval [lo, hi] (a linear program over a dense
grid), and the interval advances to [min p, max p].

`DEFAULT_SCHEDULE` is the schedule for sigma_min = 1e-7, target = 1e-6 and
the 0.02 margin band: 14 steps. `default_or_computed_schedule` returns it
for those parameters and runs the linear program (`polar_express_schedule`,
cached per process) for any other sigma_min, as the reconstruct worker's
`ns_sigma_min` asks.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


def _minimax_quintic(lo: float, hi: float, grid: int = 4001):
    """Coefficients (a, b, c) of the odd quintic minimizing
    max_{x in [lo, hi]} |1 - (a x + b x^3 + c x^5)|, via LP on a dense grid.

    Returns (a, b, c, t) with t the attained minimax error. The LP is
    solved in the scaled variable y = x / hi, then rescaled.
    """
    from scipy.optimize import linprog

    y = np.linspace(lo / hi, 1.0, grid)
    V = np.stack([y, y ** 3, y ** 5], axis=1)
    # minimize t  s.t.  -t <= 1 - V@coef <= t
    A_ub = np.block([[-V, -np.ones((grid, 1))],
                     [V, -np.ones((grid, 1))]])
    b_ub = np.concatenate([-np.ones(grid), np.ones(grid)])
    c_obj = np.array([0.0, 0.0, 0.0, 1.0])
    res = linprog(c_obj, A_ub=A_ub, b_ub=b_ub,
                  bounds=[(None, None)] * 3 + [(0, None)],
                  method="highs")
    if not res.success:
        raise RuntimeError(f"minimax LP failed on [{lo}, {hi}]: {res.message}")
    a, b, c = res.x[:3]
    return (float(a / hi), float(b / hi ** 3), float(c / hi ** 5),
            float(res.x[3]))


@lru_cache(maxsize=None)
def polar_express_schedule(sigma_min: float = 1e-7, target: float = 1e-6,
                           max_steps: int = 24, margin: float = 0.02):
    """Greedy minimax quintic schedule ((a, b, c), ...) mapping singular
    values in [sigma_min, 1] to within `target` of 1. Each step's
    polynomial is optimised, and its image interval tracked, over
    [lo, hi·(1 + margin)]: the band keeps a float32 rounding that lifts a
    singular value just above hi inside the controlled region."""
    lo, hi = float(sigma_min), 1.0
    sched = []
    for _ in range(max_steps):
        a, b, c, _t = _minimax_quintic(lo, hi * (1.0 + margin))
        # the attained interval, re-measured on a fine grid over the widened
        # domain (p can peak between the LP's grid points)
        x = np.linspace(lo, hi * (1.0 + margin), 20001)
        p = a * x + b * x ** 3 + c * x ** 5
        lo, hi = float(p.min()), float(p.max())
        sched.append((float(a), float(b), float(c)))
        if max(abs(1.0 - lo), abs(hi - 1.0)) < target:
            break
    else:
        raise RuntimeError(
            f"schedule did not converge from sigma_min={sigma_min}")
    return tuple(sched)


# The schedule for sigma_min = 1e-7, target = 1e-6, margin = 0.02, as a
# literal so that set-up does not pay the linear programs;
# tests/test_torch_host_tables.py holds it equal to the JAX package's.
DEFAULT_SCHEDULE = (
    (8.3473509604470308, -23.823541976554029, 16.998243482319499),
    (4.1736710381989175, -2.9779406568262012, 0.53119511093287242),
    (4.1736505861882556, -2.9779272529311722, 0.53119369407648187),
    (4.1735651103018396, -2.9778711109047031, 0.53118772425811456),
    (4.1732082272683311, -2.9776363981659353, 0.53116268307573211),
    (4.1717196201396032, -2.9766573046212752, 0.53105822116741475),
    (4.1655215821064022, -2.9725796720622202, 0.53062317626592592),
    (4.1398988109007648, -2.9557049392215768, 0.5288228027645826),
    (4.0370935219759208, -2.8877195330642076, 0.52157325781157493),
    (3.6704342986757559, -2.6412034958889161, 0.49535767455635554),
    (2.7937069762789752, -2.0153751781889429, 0.42983058907334448),
    (1.9962693187381422, -1.3509579013524158, 0.36563451104163619),
    (1.8575159970392476, -1.2139399664162491, 0.35645176252774696),
    (1.8565202504357181, -1.2133131895874749, 0.35679235576442675),
)


def default_or_computed_schedule(sigma_min: float = 1e-7,
                                 target: float = 1e-6):
    """DEFAULT_SCHEDULE for the default parameters, else the linear
    programs' schedule (cached per process)."""
    if abs(sigma_min - 1e-7) < 1e-12 and abs(target - 1e-6) < 1e-12:
        return DEFAULT_SCHEDULE
    return polar_express_schedule(sigma_min, target)
