"""Resumable input pipeline.

Counterpart of ``repro.data.pipeline``. The state is one integer step
counter (the generator is counter-based, :mod:`repro_torch.data.synthetic`),
saved with every checkpoint; after a restart the pipeline resumes bit for
bit. ``make_batch`` draws the reference's numpy batch and places it on one
explicit device: the tokens as int32, the vlm's ``vision_embeds`` in the
model dtype (``model.batch_specs``'). With ``shardings`` (a dict of
:class:`~repro_torch.parallel.sharding.NamedSharding`, as
``launch.steps.batch_shardings`` gives) each named entry is laid over its
mesh as a DTensor: every rank draws the same global batch and keeps its own
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import synthetic
from repro_torch.models.common import torch_dtype
from repro_torch.parallel.sharding import place


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
               device=None, shardings: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Next global batch for (cfg, shape) on ``device`` (None: the card), an
    entry named in ``shardings`` laid over its mesh; advances no state
    (pure)."""
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
    if shardings:
        batch = {k: place(v, shardings.get(k)) for k, v in batch.items()}
    return batch


def advance(state: PipelineState) -> PipelineState:
    return PipelineState(seed=state.seed, step=state.step + 1)
