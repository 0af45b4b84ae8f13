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

The sharding trees (``param_shardings`` ... ``cache_shardings``) map every
leaf to its :class:`~repro_torch.parallel.sharding.NamedSharding` under a
rules table (None without a mesh), and the struct builders
(``state_structs`` ... ``cache_structs``) describe the trees with
:class:`~repro_torch.models.common.ShapeDtypeStruct`s, allocating nothing.
Where the reference hands its shardings to ``jax.jit(in_shardings=)`` and
GSPMD lays the step out, :func:`place_state` lays a train state over its
mesh as DTensors (``distribute_tensor`` of each leaf) and the same step
runs on them, DTensor propagating the layouts op by op (ROADMAP §C).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.common import ShapeDtypeStruct, map_specs, shape_structs, torch_dtype
from repro_torch.optim import adafactor, adamw, clip, schedule
from repro_torch.parallel.sharding import (
    AxisRules, even_placements, gather, is_dtensor, place,
)
from repro_torch.util import tree, trips


class TrainState(NamedTuple):
    params: Any
    opt: Any  # AdamWState | AdafactorState


# ---------------------------------------------------------------------------
# sharding trees


def param_shardings(cfg: ModelConfig, rules: AxisRules):
    return map_specs(lambda s: rules.sharding(s.axes), M.specs(cfg))


def opt_shardings(cfg: ModelConfig, rules: AxisRules, optimizer: str):
    specs = M.specs(cfg)
    rep = rules.sharding(())
    if optimizer == "adamw":
        mom = param_shardings(cfg, rules)
        return adamw.AdamWState(step=rep, m=mom, v=mom)
    if optimizer == "adafactor":
        vr = map_specs(lambda s: rules.sharding(s.axes[:-1]), specs)
        vc = map_specs(lambda s: rules.sharding(s.axes[:-2] + s.axes[-1:])
                       if len(s.axes) >= 2 else rep, specs)
        return adafactor.AdafactorState(step=rep, vr=vr, vc=vc)
    raise ValueError(optimizer)


def state_shardings(cfg: ModelConfig, rules: AxisRules, pcfg: ParallelConfig):
    return TrainState(
        params=param_shardings(cfg, rules),
        opt=opt_shardings(cfg, rules, pcfg.optimizer),
    )


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, rules: AxisRules):
    return map_specs(lambda s: rules.sharding(s.axes), M.batch_specs(cfg, shape))


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, rules: AxisRules):
    specs = M.make_cache_specs(cfg, shape.global_batch, shape.seq_len)
    return map_specs(lambda s: rules.sharding(s.axes), specs)


def place_state(state, shardings):
    """``state`` (a train state, or any tree) with each leaf laid over its
    sharding's mesh as a DTensor (:func:`repro_torch.parallel.sharding.place`);
    a ``None`` sharding leaves its leaf as it is. Every rank passes the same
    global state; ``shardings=None`` returns ``state``. This stands in for the
    reference's ``jax.jit(in_shardings=)``."""
    return state if shardings is None else tree.map(place, state, shardings)


# ---------------------------------------------------------------------------
# struct builders (stand-ins that allocate nothing)


def state_structs(cfg: ModelConfig, pcfg: ParallelConfig, rules: Optional[AxisRules]):
    specs = M.specs(cfg)
    p = shape_structs(specs, M.dtype_of(cfg), rules)
    shard = (lambda axes: rules.sharding(axes)) if rules else (lambda axes: None)
    step = ShapeDtypeStruct((), torch.int32, shard(()))
    if pcfg.optimizer == "adamw":
        sd = torch_dtype(pcfg.opt_state_dtype)
        m = map_specs(lambda s: ShapeDtypeStruct(tuple(s.shape), sd, shard(s.axes)), specs)
        return TrainState(params=p, opt=adamw.AdamWState(step=step, m=m, v=m))

    def vr_struct(s):
        return ShapeDtypeStruct(tuple(s.shape[:-1]), torch.float32, shard(s.axes[:-1]))

    def vc_struct(s):
        if len(s.shape) >= 2:
            return ShapeDtypeStruct(tuple(s.shape[:-2] + s.shape[-1:]), torch.float32,
                                    shard(s.axes[:-2] + s.axes[-1:]))
        return ShapeDtypeStruct((), torch.float32, shard(()))

    return TrainState(params=p, opt=adafactor.AdafactorState(
        step=step, vr=map_specs(vr_struct, specs), vc=map_specs(vc_struct, specs)))


def params_structs(cfg: ModelConfig, rules: Optional[AxisRules] = None):
    return shape_structs(M.specs(cfg), M.dtype_of(cfg), rules)


def batch_structs(cfg: ModelConfig, shape: ShapeConfig, rules: Optional[AxisRules]):
    return shape_structs(M.batch_specs(cfg, shape), M.dtype_of(cfg), rules)


def cache_structs(cfg: ModelConfig, shape: ShapeConfig, rules: Optional[AxisRules]):
    return shape_structs(
        M.make_cache_specs(cfg, shape.global_batch, shape.seq_len),
        M.dtype_of(cfg), rules)


def _value_and_grad(params, cfg: ModelConfig, batch, remat: str):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``; a leaf the loss
    does not reach gets a zero gradient, as in JAX."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(tree.unflatten(params, leaves), cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    # A DTensor parameter's gradient may come back partial or laid out
    # otherwise; it is reduced onto the parameter's own placements, so the
    # optimizer works shard by shard and the new state keeps its layout.
    grads = [g.redistribute(p.device_mesh, p.placements) if is_dtensor(p) else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(params, grads))


def _split_rows(v: torch.Tensor, micro: int):
    """``v``'s rows split batch-major into ``micro`` microbatches: microbatch
    ``i`` holds rows ``[i*n, (i+1)*n)``, ``n = rows / micro``, the
    reference's ``reshape((micro, n) + ...)``. A DTensor's row dim is
    gathered once and each microbatch laid out again as ``v`` was (its rows
    split over the mesh dims that divide them): the reshape would unflatten
    the sharded row dim, which DTensor refuses."""
    n = v.shape[0] // micro
    if not is_dtensor(v):
        return v.reshape((micro, n) + v.shape[1:])
    from torch.distributed.tensor import Replicate

    whole = v.redistribute(v.device_mesh, [Replicate() if p.is_shard(0) else p
                                           for p in v.placements])
    out = []
    for i in range(micro):
        part = whole[i * n:(i + 1) * n]
        out.append(part.redistribute(v.device_mesh, even_placements(
            v.device_mesh, v.placements, part.shape)))
    return out


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
        if not is_dtensor(tree.leaves(state.params)[0]):
            return step(state, batch)
        # On a mesh: the plain tensors the step makes (positions, masks,
        # constants) are taken as replicated, and the metrics come back whole.
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            new, metrics = step(state, batch)
        return new, {k: gather(v) for k, v in metrics.items()}

    def step(state: TrainState, batch):
        if micro == 1:
            loss, metrics, grads = _value_and_grad(state.params, cfg, batch, pcfg.remat)
        else:
            split = {k: _split_rows(v, micro) for k, v in batch.items()}
            # zeros laid out as each parameter (a DTensor's shard, not its global shape)
            gsum = tree.map(lambda p: torch.zeros_like(p, dtype=accum_dtype), state.params)
            dev = tree.leaves(state.params)[0].device
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            aux_sum = torch.zeros((), dtype=torch.float32, device=dev)

            def accumulate(carry, i):
                gsum, lsum, aux_sum = carry
                loss, metrics, g = _value_and_grad(
                    state.params, cfg, {k: v[i] for k, v in split.items()}, pcfg.remat)
                gsum = tree.map(lambda a, b: a + b.to(accum_dtype), gsum, g)
                return (gsum, lsum + loss, aux_sum + metrics["router_aux"]), None

            # the reference's scan over microbatches (a cost recording runs three)
            (gsum, lsum, aux_sum), _ = trips.scan(accumulate, (gsum, lsum, aux_sum), micro)
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
