"""Architecture registry: each ``--arch`` id maps to an ArchBundle.

Counterpart of ``repro.configs``, registering only the SNN configs the
port can run so far: ``snn-fused``, ``snn`` and ``snn-event`` (served),
``iris-snn`` and ``mnist-snn`` (the paper's classifiers), ``mnist-stdp``
(the on-device learning workload) and ``snn-64k`` (the sharded fabric).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig  # noqa: F401

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_bundle(name: str) -> ArchBundle:
    if name not in _REGISTRY:
        from repro_torch.configs import (  # noqa: F401 (registers)
            iris_snn, mnist_snn, mnist_stdp, snn_64k, snn_event, snn_fused, snn_serve)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()

