"""Sharding rules: no fabric-sized collective inside the tick loop, and one
exchange a tick.

Counterpart of ``repro.analysis.sharding_rules``. The sharded engine's
contract (DESIGN.md §15) is ONE collective per tick, and it moves *spikes*
-- ``B*n`` values, about ``n/D``-fold smaller than any rank's weight slab.
The regression this guards is a change that makes the tick loop gather the
weight matrix itself, replicating ``n x n/D`` values a tick per rank.

The check is on the recorded op trace (:mod:`repro_torch.analysis.op_rules`):
a collective (a mesh collective, or a c10d op outside one) inside the tick
loop whose output holds at least ``n * n / D`` elements is an error; the
spike gather passes by construction (its output is ``(..., n)``), and weight
movement outside the loop (once a rollout) passes too. In a sharded tick
program the loop holds exactly one collective a tick.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.analysis.findings import ERROR, Finding
from repro_torch.analysis.op_rules import OpRecord

__all__ = ["check_no_w_gather_in_loop", "check_one_collective_per_tick"]


def check_no_w_gather_in_loop(records: Sequence[OpRecord], program: str, *, n: int,
                              n_devices: int = 1) -> List[Finding]:
    """ERROR on any collective inside the tick loop whose output is at least
    ``n * n / D`` elements -- a rank's weight slab (or something its size)
    moving every tick."""
    out: List[Finding] = []
    threshold = n * n // max(1, n_devices)
    for r in records:
        if not (r.collective and r.in_loop):
            continue
        if r.numel >= threshold:
            out.append(Finding(
                rule="sharding.w_gather_in_loop", severity=ERROR, program=program,
                location=r.scope.rsplit("/", 1)[-1],
                message=f"collective `{r.name}` inside the tick loop moves {r.numel} "
                        f"elements (>= n*n/D = {threshold}): the weight operand is being "
                        f"replicated per tick; only the (B, n) spike exchange belongs in "
                        f"the tick loop"))
    return out


def check_one_collective_per_tick(records: Sequence[OpRecord], program: str, *,
                                  ticks: int) -> List[Finding]:
    """A sharded tick loop exchanges once a tick: exactly ``ticks``
    collectives inside the loop."""
    got = sum(1 for r in records if r.collective and r.in_loop)
    if got == ticks:
        return []
    return [Finding(
        rule="sharding.collectives_per_tick", severity=ERROR, program=program,
        location=f"{got} collective(s)",
        message=f"{got} collective(s) inside the tick loop over {ticks} ticks: the "
                f"sharded tick exchanges its spikes exactly once a tick")]
