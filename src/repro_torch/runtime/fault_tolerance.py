"""Fault tolerance: bounded-retry step loop with checkpoint restart (a copy of
``repro.runtime.fault_tolerance``).

The controller pattern for 1000+-node runs: the training loop body is
wrapped so that any step failure (preempted host, XLA abort, data node
loss) triggers (1) state restore from the last complete checkpoint,
(2) pipeline rewind to the checkpointed step (exact, since the pipeline is
counter-based), (3) bounded retry with backoff. Heartbeats let an external
watchdog distinguish "slow" from "dead".
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional, Tuple

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Heartbeat:
    """Liveness marker, updated once per step; a watchdog (or test) reads
    ``age()`` to detect a hung worker."""
    last_beat: float = dataclasses.field(default_factory=time.monotonic)

    def beat(self) -> None:
        self.last_beat = time.monotonic()

    def age(self) -> float:
        return time.monotonic() - self.last_beat


@dataclasses.dataclass
class RetryPolicy:
    max_failures: int = 3
    backoff_s: float = 0.0       # 0 in tests; seconds on a real cluster
    failures_seen: int = 0


class StepFailure(RuntimeError):
    pass


def run_resilient_loop(
    *,
    n_steps: int,
    start_step: int,
    step_fn: Callable[[int, Any], Any],       # (step, state) -> state
    state: Any,
    save_fn: Callable[[int, Any], None],      # checkpoint write
    restore_fn: Callable[[], Tuple[int, Any]],  # -> (step, state)
    checkpoint_every: int,
    policy: Optional[RetryPolicy] = None,
    heartbeat: Optional[Heartbeat] = None,
    on_step: Optional[Callable[[int, Any], None]] = None,
) -> Tuple[int, Any]:
    """Run ``step_fn`` for steps [start_step, n_steps) with restart-on-failure.

    Returns (final_step, final_state). Raises once ``policy.max_failures``
    is exhausted (the job-level scheduler takes over from there).
    """
    policy = policy or RetryPolicy()
    heartbeat = heartbeat or Heartbeat()
    step = start_step
    while step < n_steps:
        try:
            state = step_fn(step, state)
            heartbeat.beat()
            if on_step is not None:
                on_step(step, state)
            step += 1
            if step % checkpoint_every == 0 or step == n_steps:
                save_fn(step, state)
        except Exception as e:  # noqa: BLE001 -- any step failure is retryable
            policy.failures_seen += 1
            log.warning("step %d failed (%s); failure %d/%d",
                        step, e, policy.failures_seen, policy.max_failures)
            if policy.failures_seen > policy.max_failures:
                raise StepFailure(
                    f"exceeded {policy.max_failures} failures at step {step}") from e
            if policy.backoff_s:
                time.sleep(policy.backoff_s * policy.failures_seen)
            step, state = restore_fn()
            log.warning("restored to step %d; resuming", step)
    return step, state
