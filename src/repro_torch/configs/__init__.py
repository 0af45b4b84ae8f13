"""Architecture registry: each ``--arch`` id maps to an ArchBundle.

Counterpart of ``repro.configs``, with every id the reference registers:
the SNN configs (``snn-fused``, ``snn`` and ``snn-event`` served,
``iris-snn`` and ``mnist-snn`` the paper's classifiers, ``mnist-stdp`` the
on-device learning workload, ``snn-64k`` the sharded fabric) and the ten
LM configs. Every LM family runs (``repro_torch.models``); the serve CLI
serves all but ``vlm``, whose reference server passes no vision inputs
(``repro_torch.launch.serve``).
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import (  # noqa: F401
    ArchBundle, ModelConfig, ParallelConfig, ShapeConfig, SHAPES, applicable_shapes,
)

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def _register_all() -> None:
    from repro_torch.configs import (  # noqa: F401 (registers)
        llama4_scout_17b_a16e, moonshot_v1_16b_a3b, qwen3_0_6b,
        starcoder2_15b, smollm_135m, smollm_360m, jamba_1_5_large_398b,
        llama_3_2_vision_90b, rwkv6_1_6b, musicgen_large,
        iris_snn, mnist_snn, mnist_stdp, snn_64k, snn_event, snn_fused, snn_serve)


def get_bundle(name: str) -> ArchBundle:
    if name not in _REGISTRY:
        _register_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    _register_all()
    return sorted(_REGISTRY)


ASSIGNED_ARCHS = [
    "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b",
    "qwen3-0.6b",
    "starcoder2-15b",
    "smollm-135m",
    "smollm-360m",
    "jamba-1.5-large-398b",
    "llama-3.2-vision-90b",
    "rwkv6-1.6b",
    "musicgen-large",
]

SNN_ARCHS = ["iris-snn", "mnist-snn", "mnist-stdp", "snn-64k", "snn-event",
             "snn-fused", "snn"]
