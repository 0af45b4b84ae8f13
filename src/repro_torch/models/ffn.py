"""FFN sublayers: SwiGLU and non-gated GELU, dense.

Counterpart of ``repro.models.ffn``'s dense FFN. The top-k MoE FFN arrives
with the moe and hybrid families (ROADMAP A.7b).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Spec, gelu, rms_norm, silu


def dense_ffn_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Spec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = {
        "ln": Spec((d,), ("norm",), "ones"),
        "w_up": Spec((d, f), ("mlp_in", "mlp")),
        "w_down": Spec((f, d), ("mlp", "mlp_in")),
    }
    if cfg.ffn_act == "swiglu":
        s["w_gate"] = Spec((d, f), ("mlp_in", "mlp"))
    return s


def dense_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    h = rms_norm(x, p["ln"])
    u = h @ p["w_up"]
    if "w_gate" in p:  # SwiGLU
        a = silu(h @ p["w_gate"]) * u
    else:              # non-gated GELU (starcoder2)
        a = gelu(u)
    return x + a @ p["w_down"]
