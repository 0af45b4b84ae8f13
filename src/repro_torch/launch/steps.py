"""Step functions (train / prefill / decode) and the train state.

Counterpart of ``repro.launch.steps``: the trainer executes these, and the
serving steps wrap the model's. The train step differentiates
:func:`repro_torch.models.model.loss_fn` with autograd (the reference's
``jax.value_and_grad``): a bf16 parameter gets a bf16 gradient, as in JAX.
With ``microbatches > 1`` the batch is split batch-major and the gradients
are summed in ``grad_accum_dtype``, then divided by the count, as the
reference's scan does. Then ``clip_by_global_norm``, the ``warmup_cosine``
rate at the optimizer's step, and AdamW or Adafactor; the step returns a
new :class:`TrainState` and writes none of the old one.

The reference's sharding and struct builders (``param_shardings``,
``opt_shardings``, ``state_shardings``, ``batch_shardings``,
``cache_shardings``, ``state_structs``, ``params_structs``,
``batch_structs``, ``cache_structs``) need the logical-axis rules of
``parallel/sharding.py`` and wait for the fleet scaffold (ROADMAP A.7d).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import model as M
from repro_torch.models.common import torch_dtype
from repro_torch.optim import adafactor, adamw, clip, schedule
from repro_torch.util import tree


class TrainState(NamedTuple):
    params: Any
    opt: Any  # AdamWState | AdafactorState


def _value_and_grad(params, cfg: ModelConfig, batch, remat: str):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``; a leaf the loss
    does not reach gets a zero gradient, as in JAX."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(tree.unflatten(params, leaves), cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(params, list(grads)))


def make_train_step(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    *,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); ``metrics`` holds
    ``nll``, ``router_aux``, ``loss``, ``grad_norm`` and ``lr`` as 0-d
    float32 tensors on the parameters' device."""
    micro = max(1, pcfg.microbatches)
    accum_dtype = torch_dtype(pcfg.grad_accum_dtype)

    def train_step(state: TrainState, batch):
        if micro == 1:
            loss, metrics, grads = _value_and_grad(state.params, cfg, batch, pcfg.remat)
        else:
            split = {k: v.reshape((micro, v.shape[0] // micro) + v.shape[1:])
                     for k, v in batch.items()}
            gsum = tree.map(lambda p: torch.zeros(p.shape, dtype=accum_dtype, device=p.device),
                            state.params)
            dev = tree.leaves(state.params)[0].device
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(micro):
                loss, metrics, g = _value_and_grad(
                    state.params, cfg, {k: v[i] for k, v in split.items()}, pcfg.remat)
                gsum = tree.map(lambda a, b: a + b.to(accum_dtype), gsum, g)
                lsum, aux_sum = lsum + loss, aux_sum + metrics["router_aux"]
            grads = tree.map(lambda g: g / g.new_full((), micro), gsum)
            loss = lsum / lsum.new_full((), micro)
            metrics = {"nll": loss, "router_aux": aux_sum / aux_sum.new_full((), micro)}

        with torch.no_grad():
            grads, gnorm = clip.clip_by_global_norm(grads, max_grad_norm)
            lr = schedule.warmup_cosine(state.opt.step, peak_lr=peak_lr,
                                        warmup_steps=warmup_steps, total_steps=total_steps)
            if pcfg.optimizer == "adamw":
                new_params, new_opt = adamw.update(grads, state.opt, state.params, lr=lr)
            else:
                new_params, new_opt = adafactor.update(grads, state.opt, state.params, lr=lr)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch, caches):
        return M.prefill_fn(params, cfg, batch, caches)
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, batch, caches):
        return M.decode_fn(params, cfg, batch, caches)
    return decode_step


def init_train_state(cfg: ModelConfig, pcfg: ParallelConfig, gen: torch.Generator,
                     device=None) -> TrainState:
    """Parameters drawn from ``gen`` on ``device`` (None: the card), and the
    optimizer's zero state beside them."""
    params = M.init(cfg, gen, device)
    if pcfg.optimizer == "adamw":
        opt = adamw.init(params, torch_dtype(pcfg.opt_state_dtype))
    else:
        opt = adafactor.init(params)
    return TrainState(params=params, opt=opt)
