"""Kernel launch descriptors: ONE structure drives both the CUDA launch and
the static lint.

Counterpart of ``repro.kernels.launch_spec``. Every hand-written kernel of
the port has a module-level descriptor function (``lif_launch``, ``tick_launch``,
``event_launch``, ``event_db_launch``, ``stdp_launch``, ``matmul_launch``,
``telemetry_launch``) that turns the plan its wrapper already makes into a
:class:`KernelLaunch`: the grid, block and cluster the C side launches with,
the dynamic and static shared memory, the operands, and for every operand a
plain Python function from a block index (and cluster rank) to the element
ranges that block touches. The wrapper passes the C entry its plan ints from
the descriptor (:attr:`KernelLaunch.plan_args`) and keeps it as
``last_launch``; :mod:`repro_torch.analysis.launch_rules` lints the same
object, evaluating the footprints at every block. The lint can therefore
never drift from what the kernel is launched with, and the C entry's own
refusal (``cudaErrorInvalidValue``) is no longer the only check of a grid.

A footprint returns boxes: one ``((lo, hi), ...)`` half-open range per dim
of the operand, or an ``(m, ndim, 2)`` integer array of ``m`` such boxes.
Ranges describe the tile a block addresses before its own bounds checks:
the dims the kernel bounds-checks itself are listed in
:attr:`Operand.checked`, and only there may a range run past the operand.
Data-dependent ranges (the ring's read plane, the spike lists, which slots
learn) are evaluated at the descriptor's :attr:`KernelLaunch.examples`, the
counterpart of the reference's ``prefetch_example``.

Nothing here touches a device: the descriptor functions are pure host Python on shapes and
plans, and cached, so a wrapper pays one cache lookup per launch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np

__all__ = ["Operand", "Alias", "KernelLaunch", "ring_schedule", "box_array"]

# Roles of an operand in one launch: read, written (each element by exactly
# one block), or a scratch buffer the launch both writes and reads.
IN, OUT, SCRATCH = "in", "out", "scratch"
# The shared-memory budget of an H100 SM (kernels/_stream.py SM_SMEM and
# friends are the planners' copies of these).
MAX_DYNAMIC_SMEM = 232_448   # dynamic shared memory a block may opt into
SM_SMEM = 233_472            # shared memory of one SM
BLOCK_RESERVE = 1024         # what the runtime keeps per resident block
MAX_THREADS = 1024
MAX_CLUSTER = 8              # the portable cluster size
MAX_GRID_YZ = 65_535


@dataclasses.dataclass(frozen=True)
class Operand:
    """One kernel operand: its full shape and dtype, how the launch uses it,
    and which elements each block touches.

    ``footprint(block, rank, example)`` takes the block index ``(x, y, z)``,
    the block's rank in its cluster (0 without one) and one of the
    launch's examples, and returns the boxes the block reads (role ``in``),
    writes (``out``) or uses as scratch. ``checked`` lists the dims the
    kernel bounds-checks, where a box may run past ``shape``. An operand
    updated in place appears twice, as an input and an output of one
    buffer, paired by an :class:`Alias`."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    role: str = IN
    footprint: Optional[Callable[..., Any]] = None
    checked: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class Alias:
    """An in-place pair: ``source`` (read) and ``target`` (written) must agree
    on shape and dtype. ``shared`` marks two views of one buffer in the same
    launch (a ring written in place, ``w`` updated where it is read), where no
    block may write an element another block reads."""

    source: str
    target: str
    shared: bool = False


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """Everything the C entry and the lint both need to know of one launch.

    ``symbol`` is the kernel's function name as the profiler's trace shows it
    (a substring of the demangled name). ``blocks_per_sm`` is how many blocks
    the plan assumes share an SM. ``plan_args`` are the ints the C entry
    takes as its plan. ``sums(block, rank, example)``, for a product, gives
    the ``(output box, (k0, k1))`` ranges of the reduction axis each block
    adds into the output operand ``sums_of`` (``sums_extent`` rows in all).
    ``stage_schedule(block, rank, example)`` is the twin of the kernel's
    copy ring: ``(ops, tiles)`` with ``ops`` a list of ``(kind, stage,
    tile, payload)`` (kinds ``issue``, ``wait``, ``consume``, ``release``)
    and ``tiles`` the number of tiles the block must consume, each once.
    ``quiet_schedule()`` is the ring of a launch with nothing to add (an
    empty K range, a silent spike list): it may issue only copies whose
    payload is in ``quiet_allows``."""

    name: str
    symbol: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    cluster: Tuple[int, int, int] = (1, 1, 1)
    smem_dynamic: int = 0
    smem_static: int = 0
    blocks_per_sm: int = 1
    operands: Tuple[Operand, ...] = ()
    aliases: Tuple[Alias, ...] = ()
    examples: Tuple[Any, ...] = (None,)
    sums: Optional[Callable[..., Any]] = None
    sums_of: str = ""
    sums_extent: int = 0
    stage_schedule: Optional[Callable[..., Any]] = None
    quiet_schedule: Optional[Callable[[], Any]] = None
    quiet_allows: frozenset = frozenset()
    plan_args: Tuple[int, ...] = ()
    plan: Any = None

    @property
    def threads(self) -> int:
        return math.prod(self.block)

    def operand(self, name: str) -> Operand:
        for op in self.operands:
            if op.name == name:
                return op
        raise KeyError(f"{self.name}: no operand {name!r}")

    def rank_of(self, block: Tuple[int, int, int]) -> int:
        """The block's rank in its cluster (clusters run along x)."""
        return block[0] % self.cluster[0]

    def grid_points(self):
        """Every block index, x fastest."""
        gx, gy, gz = self.grid
        for z in range(gz):
            for y in range(gy):
                for x in range(gx):
                    yield (x, y, z)

    def smem_per_block(self) -> int:
        """What one resident block takes of its SM: static plus dynamic shared
        memory plus the runtime's reserve."""
        return self.smem_static + self.smem_dynamic + BLOCK_RESERVE


def box_array(boxes, ndim: int) -> np.ndarray:
    """Footprint boxes as an ``(m, ndim, 2)`` int64 array."""
    if isinstance(boxes, np.ndarray):
        return boxes.reshape(-1, ndim, 2).astype(np.int64, copy=False)
    if not boxes or ndim == 0:
        return np.zeros((len(boxes), ndim, 2), np.int64)
    return np.asarray(boxes, np.int64).reshape(-1, ndim, 2)


def slot_dim(slotted: bool, z: int) -> tuple:
    """The leading slot range of a per-slot operand, or nothing for a shared one."""
    return ((z, z + 1),) if slotted else ()


@functools.lru_cache(maxsize=256)
def ring_schedule(n_tiles: int, stages: int) -> tuple:
    """The copy ring of B1/B2 (``csrc/masked_product.cuh``) and B6
    (``csrc/spike_matmul.cu``): tiles ``0 .. stages-1`` requested up front;
    then per tile: wait on its stage's barrier, add it, release the stage
    (the block's barrier after the add) and request tile ``t + stages`` into
    it."""
    ops = [("issue", t % stages, t, t) for t in range(min(stages, n_tiles))]
    for t in range(n_tiles):
        s = t % stages
        ops += [("wait", s, t, None), ("consume", s, t, None), ("release", s, t, None)]
        if t + stages < n_tiles:
            ops.append(("issue", s, t + stages, t + stages))
    return tuple(ops)


def flat_boxes(lo: int, hi: int, cols: int) -> list:
    """The flat element range ``[lo, hi)`` of a ``(rows, cols)`` view as
    row-aligned ``((r0, r1), (c0, c1))`` boxes (at most three)."""
    out = []
    while lo < hi:
        r, c = divmod(lo, cols)
        if c == 0 and hi - lo >= cols:
            rows = (hi - lo) // cols
            out.append(((r, r + rows), (0, cols)))
            lo += rows * cols
        else:
            end = min(hi, (r + 1) * cols)
            out.append(((r, r + 1), (c, c + end - lo)))
            lo = end
    return out
