"""Fault tolerance, straggler detection and elastic re-meshing (counterparts
of ``repro.runtime``'s ``fault_tolerance``, ``straggler`` and ``elastic``)."""
from repro_torch.runtime import elastic, fault_tolerance, straggler

__all__ = ["elastic", "fault_tolerance", "straggler"]
