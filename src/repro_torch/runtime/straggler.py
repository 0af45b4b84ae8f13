"""Straggler detection: per-step timing statistics with z-score flagging (a copy
of ``repro.runtime.straggler``).

On a pod, per-host step times are gathered by the controller; a host whose
EWMA step time exceeds mean + ``z_threshold`` * std of the fleet is flagged
and (at the job level) drained/replaced. Here the monitor tracks one
process but the math and interface are fleet-shaped: ``observe(host, dt)``.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class HostStats:
    ewma: Optional[float] = None
    n: int = 0

    def update(self, dt: float, alpha: float = 0.2) -> None:
        self.ewma = dt if self.ewma is None else alpha * dt + (1 - alpha) * self.ewma
        self.n += 1


class StragglerMonitor:
    def __init__(self, z_threshold: float = 3.0, min_steps: int = 5):
        self.z_threshold = z_threshold
        self.min_steps = min_steps
        self.hosts: Dict[str, HostStats] = defaultdict(HostStats)

    def observe(self, host: str, step_time_s: float) -> None:
        self.hosts[host].update(step_time_s)

    def fleet_stats(self) -> Tuple[float, float]:
        vals = [h.ewma for h in self.hosts.values() if h.ewma is not None]
        if not vals:
            return 0.0, 0.0
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / max(1, len(vals) - 1)
        return mean, math.sqrt(var)

    def stragglers(self) -> List[str]:
        mean, std = self.fleet_stats()
        if std == 0.0:
            return []
        out = []
        for host, st in self.hosts.items():
            if st.n >= self.min_steps and st.ewma is not None:
                if (st.ewma - mean) / std > self.z_threshold:
                    out.append(host)
        return sorted(out)

    def exclusion_plan(self) -> Dict[str, str]:
        """host -> action; feeds runtime/elastic.py re-mesh planning."""
        return {h: "drain_and_replace" for h in self.stragglers()}
