"""Elastic re-meshing: rebuild the mesh from surviving hosts and reshard.

Counterpart of ``repro.runtime.elastic``. Protocol on host loss (paired
with :mod:`repro_torch.checkpoint` for state):

  1. the controller computes the largest valid mesh from surviving chips
     (``plan_remesh``) -- the model axis is preserved (TP degree is a
     property of the model's sharding), the data axis shrinks;
  2. global batch is preserved by raising gradient-accumulation steps
     (``microbatch_multiplier``);
  3. parameters/optimizer state are restored from the checkpoint with the
     *new* mesh's shardings (``checkpoint.restore(..., shardings=new)``):
     every rank reads the whole leaf and keeps its slice, no custom gather.

``build_mesh`` gives the new mesh as a ``DeviceMesh`` over the world the
surviving ranks joined (:func:`repro_torch.launch.mesh.make_mesh`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    microbatch_multiplier: int   # grad-accum factor to preserve global batch


def plan_remesh(
    *,
    old_shape: Tuple[int, ...],
    axis_names: Tuple[str, ...],
    n_lost_chips: int,
    model_axis: str = "model",
) -> RemeshPlan:
    """Shrink the data(-most) axis to the largest power-of-two fit.

    The model axis never shrinks (parameter sharding would change); lost
    capacity comes out of data parallelism, compensated by gradient
    accumulation so the global batch (and thus optimization trajectory)
    is unchanged.
    """
    sizes = dict(zip(axis_names, old_shape))
    total = 1
    for s in old_shape:
        total *= s
    survivors = total - n_lost_chips
    model = sizes[model_axis]
    if survivors < model:
        raise ValueError(f"cannot keep model axis {model} with {survivors} chips")
    # data capacity = largest power-of-two divisor fit of survivors // model
    data_cap = survivors // model
    new_data = 1
    while new_data * 2 <= data_cap:
        new_data *= 2
    data_axes = [a for a in axis_names if a != model_axis]
    old_data = 1
    for a in data_axes:
        old_data *= sizes[a]
    # collapse all data axes into one logical data axis of new_data
    new_shape = []
    remaining = new_data
    for a in axis_names:
        if a == model_axis:
            new_shape.append(model)
        else:
            take = min(sizes[a], remaining)
            # keep axis if it still divides, else fold to 1
            while take > 1 and remaining % take:
                take -= 1
            new_shape.append(take)
            remaining //= take
    mult = max(1, old_data // max(1, new_data))
    return RemeshPlan(
        old_shape=tuple(old_shape),
        new_shape=tuple(new_shape),
        axis_names=tuple(axis_names),
        microbatch_multiplier=mult,
    )


def build_mesh(plan: RemeshPlan, *, device=None):
    """The plan's new mesh on the current world (which must have
    ``prod(new_shape)`` ranks), on ``device``'s type (None: the card)."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(plan.new_shape, plan.axis_names, device=device)
