"""New-plan hazards: what keys the port's launch plans must stay hashable,
immutable and stable.

Counterpart of ``repro.analysis.static_rules``. The reference's
zero-recompile guarantee rests on its jit statics; the port has no tracer,
and its counterpart is "no new launch plan after warm-up": every planner a
kernel wrapper calls (``_plan.plan``, ``_stream.spike_matmul_plan``,
``_stream.stdp_plan``, ``_event_plan.event_plan``) and every launch descriptor function
is an ``lru_cache`` keyed on its arguments, so an argument that is mutable,
hashes by identity or varies between equal calls makes a new plan on every
call (a deliberate difference from the reference's ``check_static_argnames``,
which has no counterpart without ``static_argnames``). The engine's
:class:`~repro_torch.core.engine.EngineOptions` keys the server's programs
and must be hashable, deeply immutable and hash-stable across independent
builds, its mesh included; a :class:`~repro_torch.core.dispatch_policy.
DispatchPlan` carries neighbour lists and must stay unhashable, with only
its ``engine_kwargs()`` crossing into the options.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, List, Sequence

import torch

from repro_torch.analysis.findings import ERROR, Finding

__all__ = [
    "is_deeply_immutable", "check_hashable_static", "check_hash_stability",
    "check_planner", "check_dispatch_plan",
]

_ATOMS = (str, int, float, bool, bytes, type(None), torch.device, torch.dtype)


def _mesh_types() -> tuple:
    """The port's static-intended mesh type."""
    from repro_torch.parallel.mesh import SNNMesh

    return (SNNMesh,)


def is_deeply_immutable(value: Any) -> bool:
    """True when ``value`` is built purely from immutable parts (the only
    things safe to key a plan or a program on)."""
    if isinstance(value, _ATOMS) or isinstance(value, enum.Enum):
        return True
    if isinstance(value, _mesh_types()):
        # An SNNMesh compares and hashes on (rank, size, device, backend,
        # axis); its process-group handle is left out of both, and nothing
        # reachable from it changes the world it describes. EngineOptions
        # carries one for the sharded engine (DESIGN.md §15).
        return True
    if isinstance(value, (tuple, frozenset)):
        return all(is_deeply_immutable(v) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        params = getattr(value, "__dataclass_params__", None)
        if params is None or not params.frozen:
            return False
        return all(is_deeply_immutable(getattr(value, f.name))
                   for f in dataclasses.fields(value))
    return False


def check_hashable_static(value: Any, program: str, *, name: str = "") -> List[Finding]:
    """``value`` keys a plan or a program: it must hash, and every reachable
    field must be immutable."""
    label = name or type(value).__name__
    out: List[Finding] = []
    try:
        hash(value)
    except TypeError as e:
        out.append(Finding(rule="static.unhashable", severity=ERROR, program=program,
                           location=label, message=f"static `{label}` is unhashable: {e}"))
        return out
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            v = getattr(value, f.name)
            if not is_deeply_immutable(v):
                out.append(Finding(
                    rule="static.mutable_field", severity=ERROR, program=program,
                    location=f"{label}.{f.name}",
                    message=f"static field `{f.name}` holds mutable {type(v).__name__}: "
                            f"hash may drift or collide across calls"))
    elif not is_deeply_immutable(value):
        out.append(Finding(rule="static.mutable_field", severity=ERROR, program=program,
                           location=label,
                           message=f"static `{label}` ({type(value).__name__}) is not deeply "
                                   f"immutable"))
    return out


def check_hash_stability(make: Callable[[], Any], program: str, *,
                         name: str = "") -> List[Finding]:
    """Two fresh instances of the same configuration must be ``==`` and
    hash-equal -- otherwise every independently built request makes a new
    plan."""
    a, b = make(), make()
    label = name or type(a).__name__
    out: List[Finding] = []
    try:
        if a != b:
            out.append(Finding(rule="static.unstable_eq", severity=ERROR, program=program,
                               location=label,
                               message=f"two fresh `{label}` instances compare unequal: a "
                                       f"new plan per call"))
        elif hash(a) != hash(b):
            out.append(Finding(rule="static.unstable_hash", severity=ERROR, program=program,
                               location=label,
                               message=f"equal `{label}` instances hash differently "
                                       f"(identity-based __hash__?): a new plan per call"))
    except TypeError as e:
        out.append(Finding(rule="static.unhashable", severity=ERROR, program=program,
                           location=label, message=f"`{label}` is unhashable: {e}"))
    return out


def check_planner(fn: Callable, args: Sequence[Any], kwargs: dict, program: str, *,
                  name: str = "") -> List[Finding]:
    """A planner a kernel wrapper calls: cached (``lru_cache``), given only
    hashable, immutable arguments, and an equal call served from the cache
    -- no new plan after the first."""
    label = name or getattr(fn, "__name__", repr(fn))
    out: List[Finding] = []
    for i, v in enumerate(tuple(args) + tuple(kwargs.values())):
        if not is_deeply_immutable(v):
            out.append(Finding(rule="static.mutable_field", severity=ERROR, program=program,
                               location=f"{label}(arg {i})",
                               message=f"planner argument of type {type(v).__name__} is not "
                                       f"a hashable atom: the plan cache keys on it"))
    if out:
        return out
    info = getattr(fn, "cache_info", None)
    if info is None:
        return [Finding(rule="static.uncached_planner", severity=ERROR, program=program,
                        location=label,
                        message=f"`{label}` is not cached: every call makes a new plan")]
    fn(*args, **kwargs)
    before = fn.cache_info().misses
    fn(*tuple(args), **dict(kwargs))
    if fn.cache_info().misses != before:
        out.append(Finding(rule="static.new_plan", severity=ERROR, program=program,
                           location=label,
                           message=f"an equal call of `{label}` missed the plan cache"))
    return out


def check_dispatch_plan(plan: Any, program: str) -> List[Finding]:
    """A :class:`~repro_torch.core.dispatch_policy.DispatchPlan` carries
    neighbour lists next to its statics -- the plan object itself must never
    key a program; only ``plan.engine_kwargs()`` may cross into
    :class:`~repro_torch.core.engine.EngineOptions`, and every value it
    exposes must be a stable static."""
    out: List[Finding] = []
    try:
        hash(plan)
        out.append(Finding(
            rule="static.plan_hashable", severity=ERROR, program=program,
            location=type(plan).__name__,
            message="DispatchPlan hashes -- someone could key a program on the whole plan "
                    "(neighbour lists included), keying the cache on tensor identity"))
    except TypeError:
        pass   # unhashable is the contract: tensors never key a program
    for k, v in plan.engine_kwargs().items():
        out.extend(check_hashable_static(v, program, name=f"engine_kwargs[{k}]"))
    return out
