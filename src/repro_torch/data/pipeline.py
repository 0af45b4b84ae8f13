"""Resumable input pipeline.

Counterpart of ``repro.data.pipeline``. The state is one integer step
counter (the generator is counter-based, :mod:`repro_torch.data.synthetic`),
saved with every checkpoint; after a restart the pipeline resumes bit for
bit. ``make_batch`` draws the reference's numpy batch and places it on one
explicit device: the tokens as int32, the vlm's ``vision_embeds`` in the
model dtype (``model.batch_specs``'). Placing each host's shard of a mesh
(the reference's ``shardings=``) waits for the fleet scaffold.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import synthetic
from repro_torch.models.common import torch_dtype


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def as_dict(self):
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d):
        return PipelineState(seed=int(d["seed"]), step=int(d["step"]))


def make_batch(cfg: ModelConfig, shape: ShapeConfig, state: PipelineState, *,
               device=None) -> Dict[str, torch.Tensor]:
    """Next global batch for (cfg, shape) on ``device`` (None: the card);
    advances no state (pure)."""
    dev = _device.resolve(device)
    out = synthetic.token_batch(
        state.seed, state.step,
        global_batch=shape.global_batch, seq_len=shape.seq_len,
        vocab_size=cfg.vocab_size,
        n_codebooks=cfg.n_codebooks if cfg.family == "audio" else 0,
    )
    batch = {k: torch.from_numpy(v).to(dev) for k, v in out.items()}
    if cfg.family == "vlm":
        ve = synthetic.vision_batch(
            state.seed, state.step,
            global_batch=shape.global_batch,
            n_tokens=cfg.n_vision_tokens, d_vision=cfg.d_vision)
        batch["vision_embeds"] = torch.from_numpy(ve).to(dev, torch_dtype(cfg.dtype))
    return batch


def advance(state: PipelineState) -> PipelineState:
    return PipelineState(seed=state.seed, step=state.step + 1)
