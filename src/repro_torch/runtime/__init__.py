"""Fault tolerance and straggler detection (copies of ``repro.runtime``'s
``fault_tolerance`` and ``straggler``; ``elastic`` builds a mesh and waits
for the fleet scaffold, ROADMAP A.7d)."""
from repro_torch.runtime import fault_tolerance, straggler

__all__ = ["fault_tolerance", "straggler"]
