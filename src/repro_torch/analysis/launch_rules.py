"""The kernel lint, driven by the kernels' own launch descriptors.

Counterpart of ``repro.analysis.pallas_rules``. Every CUDA kernel of the
port is launched from a :class:`~repro_torch.kernels.launch_spec.KernelLaunch`
its module's descriptor function makes from the wrapper's plan; this module lints that
same descriptor, evaluating each operand's footprint function at every block
of the grid (and every example of its data-dependent ranges), so the checks
can never drift from what the C side launches.

Rules (the reference's ``pallas.*`` family, for CUDA launches):

* ``launch.oob``    -- a block addresses elements outside an operand on a
  dim the kernel does not bounds-check (an out-of-bounds load or store).
* ``launch.cover``  -- an output element written by no block or by two (a
  hole or a race); for a product, a row of the reduction axis added into an
  output element other than exactly once (B1/B2's K split, B6's stream-K
  runs).
* ``launch.smem``   -- dynamic shared memory past the 232,448 bytes a block
  may opt into, or the blocks the plan keeps resident on an SM past its
  233,472 bytes (with the runtime's 1 KiB a block); a WARNING within 25 %
  of that budget, as ``pallas.vmem`` warns.
* ``launch.shape``  -- more than 1024 threads a block, a cluster past the
  portable 8 or not dividing ``grid.x``, ``grid.y`` or ``grid.z`` past
  65,535.
* ``launch.alias``  -- an in-place pair that disagrees on shape or dtype,
  or, for two views of one buffer, an element one block writes and another
  reads in the same launch (B2's ring read and written on one plane).
* ``launch.stage.*`` -- the copy ring's twin (``stage_schedule``, the
  counterpart of ``dma_schedule``) run through a stage state machine: an
  issue into a stage not yet released, a consume before the wait, a wait
  with nothing issued, a copy never waited for, a tile not consumed exactly
  once, and a launch with nothing to add that still issues copies (the
  port of ``quiet_row``).
"""
from __future__ import annotations

import collections
import itertools
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.findings import ERROR, WARNING, Finding
from repro_torch.kernels import launch_spec
from repro_torch.kernels.launch_spec import OUT, KernelLaunch, Operand, box_array

__all__ = [
    "check_oob", "check_cover", "check_smem", "check_shape", "check_aliasing",
    "simulate_stage_schedule", "check_stage_schedule", "check_k_split", "check_launch",
    "footprints",
]


# ---------------------------------------------------------------------------
# Footprints at every block
# ---------------------------------------------------------------------------

def footprints(launch: KernelLaunch, op: Operand, example) -> Tuple[np.ndarray, np.ndarray]:
    """``(boxes (m, ndim, 2), block ids (m,))``: the operand's boxes at every
    block of the grid, for one example."""
    nd = len(op.shape)
    boxes, ids = [], []
    for i, block in enumerate(launch.grid_points()):
        b = box_array(op.footprint(block, launch.rank_of(block), example), nd)
        if len(b):
            boxes.append(b)
            ids.append(np.full(len(b), i, np.int64))
    if not boxes:
        return np.zeros((0, nd, 2), np.int64), np.zeros((0,), np.int64)
    return np.concatenate(boxes), np.concatenate(ids)


def _block_at(launch: KernelLaunch, i: int) -> tuple:
    gx, gy, _ = launch.grid
    return (i % gx, (i // gx) % gy, i // (gx * gy))


def _clip(boxes: np.ndarray, shape: Sequence[int], ids=None):
    """Boxes cut to the operand (what a bounds-checked dim keeps), empty
    ones dropped (with their block ids, when given)."""
    if not len(boxes) or not len(shape):
        return boxes if ids is None else (boxes, ids)
    ext = np.asarray(shape, np.int64)
    lo = np.clip(boxes[..., 0], 0, ext)
    hi = np.clip(boxes[..., 1], 0, ext)
    keep = (hi > lo).all(1)
    boxes = np.stack([lo, hi], -1)[keep]
    return boxes if ids is None else (boxes, ids[keep])


def grid_counts(box_sets: Sequence[np.ndarray], shape: Sequence[int]):
    """How many boxes of each set cover each cell of the grid their edges cut
    ``shape`` into: ``(counts per set, edges per dim)``. Boxes must already
    lie inside ``shape``."""
    nd = len(shape)
    if nd == 0:
        return [np.asarray(len(b)) for b in box_sets], []
    edges = [np.unique(np.concatenate(
        [np.asarray([0, shape[d]], np.int64)]
        + [b[:, d, k] for b in box_sets for k in (0, 1)])) for d in range(nd)]
    cells = tuple(len(e) - 1 for e in edges)
    size = int(np.prod([c + 1 for c in cells]))
    out = []
    for boxes in box_sets:
        diff = np.zeros(size, np.int64)
        lo = [np.searchsorted(edges[d], boxes[:, d, 0]) for d in range(nd)]
        hi = [np.searchsorted(edges[d], boxes[:, d, 1]) for d in range(nd)]
        for corner in itertools.product((0, 1), repeat=nd):
            at = np.ravel_multi_index(
                tuple(hi[d] if corner[d] else lo[d] for d in range(nd)),
                tuple(c + 1 for c in cells))
            diff += (-1) ** sum(corner) * np.bincount(at, minlength=size)
        counts = diff.reshape(tuple(c + 1 for c in cells))
        for d in range(nd):
            counts = np.cumsum(counts, axis=d)
        out.append(counts[tuple(slice(0, c) for c in cells)])
    return out, edges


def _cell(edges, index) -> tuple:
    return tuple(int(edges[d][i]) for d, i in enumerate(index))


# ---------------------------------------------------------------------------
# launch.oob / launch.cover
# ---------------------------------------------------------------------------

def check_oob(launch: KernelLaunch, program: str) -> List[Finding]:
    """Every box every block addresses lies inside its operand, except on the
    dims the kernel bounds-checks itself."""
    out: List[Finding] = []
    for op in launch.operands:
        if op.footprint is None:
            continue
        shape = np.asarray(op.shape, np.int64)
        free = np.asarray([d not in op.checked for d in range(len(op.shape))], bool)
        for ex in launch.examples:
            boxes, ids = footprints(launch, op, ex)
            if not len(boxes) or not len(op.shape):
                continue
            lo, hi = boxes[..., 0], boxes[..., 1]
            bad = ((lo < 0) | (hi > shape)) & free & (hi > lo).all(1, keepdims=True)
            rows = np.nonzero(bad.any(1))[0]
            if len(rows):
                i = rows[0]
                out.append(Finding(
                    rule="launch.oob", severity=ERROR, program=program,
                    location=f"{launch.name}:{op.name}",
                    message=f"block {_block_at(launch, int(ids[i]))} addresses "
                            f"{[tuple(map(int, r)) for r in boxes[i]]} outside shape "
                            f"{op.shape} on an unchecked dim ({len(rows)} box(es))"))
                break
    return out


def _exactly_once(boxes: np.ndarray, shape, what: str, *, whole: bool = True) -> Optional[str]:
    """None when the boxes cover every element once (``whole=False``: at most
    once), else what is wrong."""
    (counts,), edges = grid_counts([boxes], shape)
    wrong = np.argwhere((counts != 1) if whole else (counts > 1))
    if not len(wrong):
        return None
    first = tuple(wrong[0])
    return (f"{len(wrong)} region(s) of {what} not covered "
            f"{'exactly' if whole else 'at most'} once: the region at "
            f"{_cell(edges, first)} {int(counts[first])} times")


def check_cover(launch: KernelLaunch, program: str) -> List[Finding]:
    """Every output element is written by exactly one block (an output updated
    in place, the target of a shared alias, by at most one: a ring writes
    one plane); with ``sums``, every row of the reduction axis is added into
    every output element exactly once."""
    out: List[Finding] = []
    in_place = {al.target for al in launch.aliases if al.shared}
    for ex in launch.examples:
        for op in launch.operands:
            if op.role != OUT or op.footprint is None:
                continue
            boxes, _ = footprints(launch, op, ex)
            msg = _exactly_once(_clip(boxes, op.shape), op.shape, f"{op.name} {op.shape}",
                                whole=op.name not in in_place)
            if msg:
                out.append(Finding(rule="launch.cover", severity=ERROR, program=program,
                                   location=f"{launch.name}:{op.name}", message=msg))
        if launch.sums is not None:
            target = launch.operand(launch.sums_of)
            space = tuple(target.shape) + (launch.sums_extent,)
            boxes = []
            for block in launch.grid_points():
                for box, k in launch.sums(block, launch.rank_of(block), ex):
                    boxes.append(tuple(box) + (tuple(k),))
            msg = _exactly_once(_clip(box_array(boxes, len(space)), space), space,
                                f"{target.name} x the {launch.sums_extent} reduced rows")
            if msg:
                out.append(Finding(rule="launch.cover", severity=ERROR, program=program,
                                   location=f"{launch.name}:sums", message=msg))
    return out


# ---------------------------------------------------------------------------
# launch.smem / launch.shape
# ---------------------------------------------------------------------------

def check_smem(launch: KernelLaunch, program: str) -> List[Finding]:
    """Dynamic shared memory within what a block may opt into, and the blocks
    the plan keeps resident within one SM (static + dynamic + the reserve,
    times ``blocks_per_sm``)."""
    out: List[Finding] = []
    per_sm = launch.smem_per_block() * launch.blocks_per_sm
    if launch.smem_dynamic > launch_spec.MAX_DYNAMIC_SMEM:
        out.append(Finding(
            rule="launch.smem", severity=ERROR, program=program, location=launch.name,
            message=f"{launch.smem_dynamic} bytes of dynamic shared memory exceed the "
                    f"{launch_spec.MAX_DYNAMIC_SMEM} a block may opt into"))
    if per_sm > launch_spec.SM_SMEM:
        out.append(Finding(
            rule="launch.smem", severity=ERROR, program=program, location=launch.name,
            message=f"{launch.blocks_per_sm} block(s) of {launch.smem_per_block()} bytes "
                    f"(static + dynamic + reserve) exceed the SM's {launch_spec.SM_SMEM}"))
    elif per_sm > 0.75 * launch_spec.SM_SMEM:
        out.append(Finding(
            rule="launch.smem", severity=WARNING, program=program, location=launch.name,
            message=f"{launch.blocks_per_sm} block(s) of {launch.smem_per_block()} bytes "
                    f"take {per_sm / launch_spec.SM_SMEM:.0%} of the SM's "
                    f"{launch_spec.SM_SMEM} bytes: within 25 % of the budget"))
    return out


def check_shape(launch: KernelLaunch, program: str) -> List[Finding]:
    """At most 1024 threads a block; a cluster of at most 8 that divides
    ``grid.x``; ``grid.y`` and ``grid.z`` at most 65,535."""
    bad = []
    if launch.threads > launch_spec.MAX_THREADS or min(launch.block) < 1:
        bad.append(f"block {launch.block} has {launch.threads} threads "
                   f"(1..{launch_spec.MAX_THREADS})")
    cx = launch.cluster[0]
    if (launch.cluster[1:] != (1, 1) or not 1 <= cx <= launch_spec.MAX_CLUSTER
            or launch.grid[0] % cx):
        bad.append(f"cluster {launch.cluster} must be (c, 1, 1) with 1 <= c <= "
                   f"{launch_spec.MAX_CLUSTER} dividing grid.x = {launch.grid[0]}")
    if min(launch.grid) < 1 or max(launch.grid[1:]) > launch_spec.MAX_GRID_YZ \
            or launch.grid[0] > 2 ** 31 - 1:
        bad.append(f"grid {launch.grid} outside (2^31 - 1, 65535, 65535)")
    return [Finding(rule="launch.shape", severity=ERROR, program=program,
                    location=launch.name, message=m) for m in bad]


# ---------------------------------------------------------------------------
# launch.alias
# ---------------------------------------------------------------------------

def check_aliasing(launch: KernelLaunch, program: str) -> List[Finding]:
    """In-place pairs agree on shape and dtype; two views of one buffer are
    never written by one block where another reads them."""
    out: List[Finding] = []
    names = {op.name: op for op in launch.operands}
    for al in launch.aliases:
        loc = f"{launch.name}:alias {al.source}->{al.target}"
        a, b = names.get(al.source), names.get(al.target)
        if a is None or b is None:
            out.append(Finding(rule="launch.alias", severity=ERROR, program=program,
                               location=loc, message="alias names a missing operand"))
            continue
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            out.append(Finding(
                rule="launch.alias", severity=ERROR, program=program, location=loc,
                message=f"aliased operands disagree: {a.name} {a.shape}/{a.dtype} vs "
                        f"{b.name} {b.shape}/{b.dtype}"))
            continue
        if not al.shared:
            continue
        for ex in launch.examples:
            race = _race(launch, a, b, ex)
            if race:
                out.append(Finding(rule="launch.alias", severity=ERROR, program=program,
                                   location=loc, message=f"{race} (example {ex})"))
                break
    return out


def _race(launch: KernelLaunch, read: Operand, write: Operand, ex) -> Optional[str]:
    """Where one block writes an element of a buffer that another block also
    reads or writes in the same launch."""
    shape = write.shape
    if read.footprint is write.footprint:
        return None   # every block reads exactly what it writes: the cover rule's case
    rb, ri = footprints(launch, read, ex)
    wb, wi = footprints(launch, write, ex)
    rb, ri = _clip(rb, shape, ri)
    wb, wi = _clip(wb, shape, wi)
    if not len(wb):
        return None
    # each block's accesses once: a block reading and writing the same box is
    # one access (a read-modify-write by the thread that owns the element)
    rows = np.concatenate([np.concatenate([ri, wi])[:, None],
                           np.concatenate([rb, wb]).reshape(len(rb) + len(wb), -1)], 1)
    access = np.unique(rows, axis=0)[:, 1:].reshape(-1, len(shape), 2)
    (writes, accesses), edges = grid_counts([wb, access], shape)
    hot = np.argwhere((writes > 0) & (accesses > 1))
    if not len(hot):
        return None
    first = tuple(hot[0])
    return (f"{write.name} is written where another block reads {read.name} (one buffer): "
            f"{len(hot)} region(s), the first at {_cell(edges, first)}")


# ---------------------------------------------------------------------------
# launch.stage.*
# ---------------------------------------------------------------------------

def simulate_stage_schedule(ops: Iterable[tuple], tiles: Optional[int] = None):
    """Run one copy-ring op list through the stage state machine; returns the
    ``(rule, message)`` violations.

    Model: each stage holds at most one tile. ``issue`` puts a copy in flight
    into a released stage (illegal while the stage still holds a tile: the
    copy would overwrite data not yet added, or land twice); ``wait``
    completes the in-flight copy of that tile (illegal with none in flight:
    a deadlock); ``consume`` adds the tile and must find it landed;
    ``release`` frees the stage. With ``tiles``, tiles ``0 .. tiles-1``
    must each be consumed exactly once."""
    held = {}                      # stage -> [state, tile]
    consumed = collections.Counter()
    bad = []
    for kind, stage, tile, _ in ops:
        cur = held.get(stage)
        if kind == "issue":
            if cur is not None:
                bad.append(("launch.stage.issue_unreleased",
                            f"issue(tile {tile}) into stage {stage} while it holds tile "
                            f"{cur[1]} ({cur[0]})"))
            held[stage] = ["in flight", tile]
        elif kind == "wait":
            if cur is None or cur[1] != tile or cur[0] != "in flight":
                bad.append(("launch.stage.wait_without_issue",
                            f"wait(tile {tile}) on stage {stage} with no copy of it in "
                            f"flight"))
            else:
                cur[0] = "landed"
        elif kind == "consume":
            if cur is None or cur[1] != tile or cur[0] != "landed":
                have = "nothing" if cur is None else f"tile {cur[1]} ({cur[0]})"
                bad.append(("launch.stage.consume_before_wait",
                            f"consume(tile {tile}) from stage {stage}, which holds {have}"))
            consumed[tile] += 1
        elif kind == "release":
            if cur is None or cur[1] != tile:
                bad.append(("launch.stage.bad_release",
                            f"release(tile {tile}) of stage {stage}, which does not hold it"))
            else:
                del held[stage]
        else:
            bad.append(("launch.stage.bad_op", f"unknown op {kind!r}"))
    for stage, (state, tile) in held.items():
        if state == "in flight":
            bad.append(("launch.stage.dangling",
                        f"copy of tile {tile} into stage {stage} never waited for"))
    if tiles is not None:
        wrong = sorted(t for t in set(range(tiles)) | set(consumed) if consumed[t] != 1)
        if wrong:
            bad.append(("launch.stage.tile_count",
                        f"tiles {wrong[:8]} consumed {[consumed[t] for t in wrong[:8]]} "
                        f"times, not exactly once"))
    return bad


def check_stage_schedule(launch: KernelLaunch, program: str) -> List[Finding]:
    """Simulate the kernel's copy ring at every block and example, and the
    ring of a launch with nothing to add."""
    if launch.stage_schedule is None:
        return []
    out: List[Finding] = []
    seen = {}
    for ex in launch.examples:
        for block in launch.grid_points():
            ops, tiles = launch.stage_schedule(block, launch.rank_of(block), ex)
            key = (id(ops), tiles)
            if key in seen:
                continue
            seen[key] = ops            # keeps the list alive, so its id stays unique
            for rule, msg in simulate_stage_schedule(ops, tiles):
                out.append(Finding(rule=rule, severity=ERROR, program=program,
                                   location=f"{launch.name}:block {block}", message=msg))
            if out:
                return out
    if launch.quiet_schedule is not None:
        ops = launch.quiet_schedule()
        copied = [op for op in ops if op[0] == "issue"
                  and not set(np.atleast_1d(op[3]).tolist()) <= launch.quiet_allows]
        if copied:
            out.append(Finding(
                rule="launch.stage.quiet_row", severity=ERROR, program=program,
                location=f"{launch.name}:quiet",
                message=f"a launch with nothing to add issues {len(copied)} copies "
                        f"(first {copied[0][3]!r}): silence is no longer free"))
        for rule, msg in simulate_stage_schedule(ops):
            out.append(Finding(rule=rule, severity=ERROR, program=program,
                               location=f"{launch.name}:quiet", message=msg))
    return out


def check_k_split(launches: Sequence[KernelLaunch], program: str, *,
                  severity: str = ERROR) -> List[Finding]:
    """B1 at ``N = n/D`` for each D of a sharded fabric: every rank must split
    K as one device does (the same cluster size and rows per rank), or the
    ranks' sums differ from the single-device run's in the last bit off the
    u8 grid."""
    splits = [(launch.plan.ks, launch.plan.k_chunk) for launch in launches]
    if len(set(splits)) <= 1:
        return []
    widths = [launch.plan.N for launch in launches]
    return [Finding(
        rule="launch.k_split", severity=severity, program=program,
        location=launches[0].name,
        message=f"the K split changes with N: (ks, rows) {splits} at N = {widths}; a rank's "
                f"sums are not the single-device run's order")]


# ---------------------------------------------------------------------------

def check_launch(launch: KernelLaunch, program: str) -> List[Finding]:
    """All kernel-lint rules on one launch descriptor."""
    out = check_shape(launch, program)
    out += check_smem(launch, program)
    out += check_oob(launch, program)
    out += check_cover(launch, program)
    out += check_aliasing(launch, program)
    out += check_stage_schedule(launch, program)
    return out
