"""The one traffic generator: a mix file's parameters in, requests out.

A mix (``mixes/<name>.json``) names the tenant kinds it sends to, the
shape of its tick budgets, its drive, its pool and its arrival process:

``kinds``           tenant kinds that receive requests (plastic tenants never do)
``pool``            distinct requests made at set-up; the window cycles them
``short_share``     share of the pool that is short; the rest run ``long_ticks``
``short_ticks``     ``[lo, hi]``: short budgets, spread evenly over the range
``long_ticks``      the long requests' budget
``density``         probability that an input fires on a tick
``magnitude``       ``[lo, hi)``: the u8 magnitude of a firing input
``arrival``         ``"backlog"`` (keep ``backlog`` requests waiting beyond the
                    slots) or ``"poisson"`` (an open loop at ``rate_per_s``)
``warmup``          requests served at set-up to warm every path up

The short share of ``short_ticks = [2, 4]`` at 0.75, ``long_ticks`` 32,
``density`` 0.3 and magnitudes ``[80, 255)`` are ``make_serving_mix``'s
(``chip_smoke.py``, itself ``benchmarks/bench_serve.py``'s). Every count is
fixed by the mix, so each seed draws the same multiset of budgets, tenants
and inter-arrival gaps, only in another order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Entry:
    """One distinct request of the pool."""

    tenant: int             # index into the driver's tenant list
    ticks: int              # the tick budget
    ext: np.ndarray         # (ticks, n_in) float32 drive


def budgets(mix: dict) -> np.ndarray:
    """The pool's budgets in a fixed order: the short ones spread evenly over
    ``short_ticks``, then the long ones."""
    pool = int(mix["pool"])
    n_short = int(round(pool * float(mix["short_share"])))
    lo, hi = (int(x) for x in mix["short_ticks"])
    span = np.arange(lo, hi + 1)
    short = span[np.arange(n_short) % len(span)]
    return np.concatenate([short, np.full(pool - n_short, int(mix["long_ticks"]))])


def make_pool(mix: dict, n_in: Sequence[int], seed: int) -> List[Entry]:
    """The pool: budgets and tenants each dealt in a seeded order (every
    tenant in ``n_in``, the input widths of the tenants that receive
    requests, gets the same count to within one), drive drawn from the seed."""
    rng = np.random.default_rng((seed, 1))
    ticks = rng.permutation(budgets(mix))
    tenants = rng.permutation(np.arange(len(ticks)) % len(n_in))
    lo, hi = (int(x) for x in mix["magnitude"])
    dens = float(mix["density"])
    out = []
    for t, k in zip(tenants, ticks):
        shape = (int(k), int(n_in[t]))
        fire = rng.random(shape, dtype=np.float32) < dens
        mag = rng.integers(lo, hi, shape, dtype=np.int16)
        out.append(Entry(tenant=int(t), ticks=int(k), ext=(fire * mag).astype(np.float32)))
    return out


def order(mix: dict, seed: int, n: int) -> np.ndarray:
    """The order in which the window cycles the pool: a seeded permutation."""
    return np.random.default_rng((seed, 2)).permutation(n)


def gaps(mix: dict, seed: int, count: int) -> np.ndarray:
    """``count`` Poisson inter-arrival gaps at ``rate_per_s``: the exponential
    distribution's quantiles at ``(i + 0.5) / count``, in a seeded order, so
    every seed offers the same gaps."""
    rate = float(mix["rate_per_s"])
    q = (np.arange(count) + 0.5) / count
    return np.random.default_rng((seed, 3)).permutation(-np.log1p(-q) / rate)
