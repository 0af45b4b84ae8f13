"""Launch plan of kernel B4 (``event_dispatch``): the all-slot spike-list
gather, one read of each distinct row shared by a group of batch rows.

A block owns one slot, one group of ``rows`` batch rows (one warp each) and
a column tile of 32 columns (one per lane). It walks the spike lists in
passes of ``chunk`` slots; in a pass, and in each window of ``window`` row
ids, it builds the ascending union of the distinct ids its rows list there
(a bitmap, then a prefix compaction), streams those rows' column segments
through a double buffer of two stages of ``stage_rows`` rows each, and
every warp adds the rows its own list names, in its slot order, from the
stage that holds them. A row whose list is not ascending in a pass
takes that pass's slots one by one from device memory instead.

The fill of a stage is 16-byte ``cp.async`` copies when every row segment
starts on a 16-byte boundary (``N % 4 == 0``, an aligned base and slot
stride), else 4-byte ones; the C entry takes the plan's fill and refuses
one that disagrees with the operands. Nothing here touches a device: the
CPU tests hold the plans to their contract and walk them against the plain
twin.
"""
from __future__ import annotations

import dataclasses
import functools
import math

WARP = 32
MAX_ROWS = 16            # batch rows per block: one warp each
TILE_N = WARP            # columns per block: one per lane
STAGE_BYTES = 56 * 1024  # one stage of the ring: 448 row segments of 128 bytes
STAGES = 2               # the ring (the C entry's kStages): one stage in flight
                         # while the other is added
LIST_BYTES = 128 * 1024  # a pass's lists: ids, run starts, runs, the union
MAX_WINDOW = 65536       # row ids one bitmap covers
SCAN_INTS = WARP + 1     # the block scan's warp sums and the union's size
MAX_SMEM = 232_448       # dynamic shared memory a block may opt into on Hopper


def b4_fill(N: int, w_slot: int, is_aligned: bool) -> str:
    """``"cp.async"`` (16-byte copies) when every row segment of ``w``
    starts on a 16-byte boundary, else ``"element"`` (4-byte copies)."""
    return "cp.async" if is_aligned and N % 4 == 0 and w_slot % 4 == 0 else "element"


def smem_bytes(rows: int, chunk: int, window: int, stage_rows: int) -> int:
    """The block's dynamic shared memory, in the C entry's layout: the ring;
    each warp's ids, run starts (one more), runs, bitmap of runs of more than
    one slot and the end of its runs in each stage (one more); the window's bitmap and word offsets; the union; the
    scan; the epilogue's operands (the block's columns of the six
    per-neuron rows, and of v, r and drive per batch row)."""
    ring = STAGES * stage_rows * TILE_N * 4
    union = min(window, rows * chunk)
    ints = (3 * rows * chunk + rows * (2 + (chunk + WARP) // WARP + math.ceil(union / WARP))
            + 2 * (window // WARP) + union + SCAN_INTS + (6 + 3 * rows) * TILE_N)
    return ring + 4 * ints


@dataclasses.dataclass(frozen=True)
class EventPlan:
    """One B4 launch."""

    S: int
    B: int
    k: int
    N: int
    Kw: int
    rows: int          # batch rows per block, one warp each
    chunk: int         # list slots per pass
    window: int        # row ids per bitmap window, a multiple of 32
    stage_rows: int    # union rows per stage
    fill: str          # "cp.async" (16-byte copies) or "element" (4-byte)
    smem: int          # dynamic shared memory per block, bytes

    @property
    def threads(self) -> int:
        return self.rows * WARP

    @property
    def col_tiles(self) -> int:
        return math.ceil(self.N / TILE_N)

    @property
    def groups(self) -> int:
        return math.ceil(self.B / self.rows)

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.groups * self.S

    @property
    def grid(self) -> tuple:
        return (self.col_tiles, self.groups, self.S)

    def passes(self) -> list:
        """``(first slot, end slot)`` of each pass over the lists."""
        return [(j, min(self.k, j + self.chunk)) for j in range(0, self.k, self.chunk)]

    def windows(self) -> list:
        """``(first id, end id)`` of each bitmap window of a pass."""
        return [(lo, min(self.Kw, lo + self.window)) for lo in range(0, self.Kw, self.window)]

    def stage_bounds(self, union: int) -> list:
        """``(first rank, end rank)`` of the union rows each stage holds."""
        return [(r, min(union, r + self.stage_rows))
                for r in range(0, union, self.stage_rows)]

    def args(self) -> tuple:
        """The ints the C entry takes, in its order."""
        return (self.rows, self.chunk, self.window, self.stage_rows,
                int(self.fill == "cp.async"), self.smem)

    def __str__(self) -> str:
        return (f"{self.blocks} blocks ({self.col_tiles} column tiles of {TILE_N} x "
                f"{self.groups} groups of {self.rows} rows x {self.S} slots) of "
                f"{self.threads} threads, {len(self.passes())} pass(es) of {self.chunk} slots, "
                f"{len(self.windows())} window(s) of {self.window} ids, {STAGES} stages "
                f"of {self.stage_rows} rows, {self.smem / 1024:.1f} KiB shared, {self.fill}")


@functools.lru_cache(maxsize=512)
def event_plan(S: int, B: int, k: int, N: int, Kw: int, *, w_slot: int = 0,
               is_aligned: bool = True) -> EventPlan:
    """The launch of one B4 call: batch rows in as few groups of at most
    ``MAX_ROWS`` as cover ``B``, each ``ceil(B / groups)`` rows (the last
    may be short); a double buffer of two stages of ``STAGE_BYTES``; and as
    many list slots per pass as ``LIST_BYTES`` holds, fewer where the shared
    memory would not fit."""
    if min(S, B, N, Kw) < 1 or k < 0:
        raise ValueError(f"bad B4 shape S={S} B={B} k={k} N={N} Kw={Kw}")
    groups = math.ceil(B / MAX_ROWS)
    rows = math.ceil(B / groups)
    stage_rows = STAGE_BYTES // (TILE_N * 4)
    window = min(math.ceil(Kw / WARP) * WARP, MAX_WINDOW)
    # per slot of each row: its id, its run start, its run, its union entry
    # and each warp's stage end over that entry; fewer where a wide window's
    # bitmap leaves less room
    chunk = max(1, min(k, LIST_BYTES // (rows * (16 + math.ceil(rows / 8)))))
    smem = smem_bytes(rows, chunk, window, stage_rows)
    while smem > MAX_SMEM and chunk > 1:
        chunk = chunk * 7 // 8
        smem = smem_bytes(rows, chunk, window, stage_rows)
    if smem > MAX_SMEM:
        raise ValueError(f"B4 at S={S} B={B} k={k} N={N} Kw={Kw} needs {smem} bytes of "
                         f"shared memory; a block may take {MAX_SMEM}")
    return EventPlan(S=S, B=B, k=k, N=N, Kw=Kw, rows=rows, chunk=chunk, window=window,
                     stage_rows=stage_rows, fill=b4_fill(N, w_slot, is_aligned), smem=smem)
