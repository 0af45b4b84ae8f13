"""Launch plans of kernels B6 (``spike_matmul``) and B5 (``stdp_update``):
persistent grids of about one or two blocks per SM that stream their weight
tiles through shared memory.

**B6, a stream-K split.** The product ``s @ (w * c)`` is cut into units: a
row group of ``ROWS`` batch rows, a column tile of ``BLOCK_N`` columns and a
K tile of ``kt`` rows, numbered with the K tile fastest, then the column
tile, then the row group. Each of ``blocks`` blocks takes the contiguous run
of units ``[p * U // blocks, (p + 1) * U // blocks)``, so every block streams
the same bytes whatever the shape. A block sums each output tile's run of K
tiles in registers; a tile that one block covers whole is written straight
to the output, and a tile that two or more blocks share leaves each block's
partial sums in an f32 workspace (two slots per block: its first and its
last tile), where the last block to arrive on the tile's counter adds them
in K order and resets the counter. Where the units would not fill the card
(or the tiles already do), the plan is the tile path: one block per output
tile over all of K, with no workspace and no counters. At most ``B6_SMALL``
weights (``predict_int``'s products) take the small path: ``w * c`` and
each block's spike rows staged whole in shared memory, then one thread per
output, K in order.

**B5, a persistent walk.** A tile is ``STDP_TK`` rows by ``BLOCK_N`` columns
of one slot. Every block walks the slots in order; for each slot whose gate
is open it takes the tiles ``p, p + blocks, ...``, and it skips every tile
of a closed slot in one branch (copying its share of that slot's traces
through instead). Its ring holds ``c`` (and ``elig``) ``stages - 1`` tiles
ahead; ``w`` waits one tile ahead in registers.

The fill of a stage is derived by the C entries from the operands by the
rule of :func:`b6_fill` / :func:`b5_fill`: asynchronous when every copied
row starts on a 16-byte boundary (B6: ``"tma"``, one thread's 2-D
tensor-map tile copies; B5: ``"cp.async"``, every thread's own 16-byte
chunks), else ``"element"`` (bounds-checked loads, one stage). Nothing here touches a device: the CPU tests hold the plans to
their contract.
"""
from __future__ import annotations

import dataclasses
import functools
import math

BLOCK_N = 128            # output columns per tile, 4 per lane
THREADS = 256            # 8 warps per block, both kernels
WARPS = THREADS // 32
ROWS = 8                 # B6: batch rows per row group
B6_STAGES = 2            # B6: stages of the ring on an asynchronous fill
B6_STAGE_BYTES = 64 * 1024   # B6: the weight tiles of one stage (w and c)
B6_PART_BYTES = WARPS * ROWS * BLOCK_N * 4   # B6: the warps' partial tiles, in a stage
B6_SMALL = 8192          # B6: K * N at most on the small path (w * c in 32 KiB)
B6_SMALL_SPIKES = 4096   # B6: spike values a small-path block stages (16 KiB)
BARRIER_BYTES = 128      # B6: the stages' mbarriers, ahead of the stages
STDP_TK = 32             # B5: rows per tile, 4 per warp
STDP_STAGES = 3          # B5: ring stages, c (and elig) two tiles ahead
STDP_CHUNK_B = 8         # B5: batch rows of traces staged at a time
MAX_SMEM = 232_448       # dynamic shared memory a block may opt into on Hopper
SM_SMEM = 233_472        # shared memory of one SM
BLOCK_RESERVE = 1024     # shared memory the runtime keeps per resident block
MAX_BLOCKS_PER_SM = 2
SMS = 132                # an H100 SXM's SM count, when no card is asked


def aligned16(addresses) -> bool:
    """True when every (non-null) address is 16-byte aligned."""
    return all(a % 16 == 0 for a in addresses if a)


# -- B6 ---------------------------------------------------------------------


def b6_fill(K: int, N: int, s_bytes: int, w_bytes: int, is_aligned: bool) -> str:
    """``"tma"`` (2-D tensor-map tiles) when every row of ``s`` (K elements)
    and of ``w`` and ``c`` (N elements) starts on a 16-byte boundary, else
    ``"element"``."""
    ok = is_aligned and (K * s_bytes) % 16 == 0 and (N * w_bytes) % 16 == 0
    return "tma" if ok else "element"


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """One B6 launch."""

    B: int
    K: int
    N: int
    s_bytes: int       # element size of s: 4 (f32) or 2 (bf16)
    w_bytes: int       # element size of w and c
    kt: int            # K rows per unit (one stage)
    stages: int        # shared-memory stages
    blocks: int        # the grid
    path: str          # "stream-k", "tile" or "small"
    fill: str          # "tma" or "element"
    smem: int          # dynamic shared memory per block, bytes

    @property
    def groups(self) -> int:
        return math.ceil(self.B / ROWS)

    @property
    def col_tiles(self) -> int:
        return math.ceil(self.N / BLOCK_N)

    @property
    def k_tiles(self) -> int:
        return math.ceil(self.K / self.kt)

    @property
    def tiles(self) -> int:
        """Output tiles: row groups x column tiles."""
        return self.groups * self.col_tiles

    @property
    def units(self) -> int:
        return self.tiles * self.k_tiles

    @property
    def ws_floats(self) -> int:
        """The f32 workspace of partial sums: two tiles per block on the
        stream-K path."""
        return self.blocks * 2 * ROWS * BLOCK_N if self.path == "stream-k" else 0

    @property
    def counters(self) -> int:
        """The int32 arrival counters, one per output tile on the stream-K
        path."""
        return self.tiles if self.path == "stream-k" else 0

    def begin(self, p: int) -> int:
        """The first unit of block ``p`` (``begin(blocks) == units``)."""
        return p * self.units // self.blocks

    def owner(self, u: int) -> int:
        """The block whose run holds unit ``u``."""
        return ((u + 1) * self.blocks + self.units - 1) // self.units - 1

    def segments(self, p: int) -> list:
        """Block ``p``'s ``(tile, first K tile, end K tile)`` runs, in order."""
        out = []
        u, end = self.begin(p), self.begin(p + 1)
        while u < end:
            tile, kk = divmod(u, self.k_tiles)
            stop = min(end, (tile + 1) * self.k_tiles)
            out.append((tile, kk, kk + stop - u))
            u = stop
        return out

    def contributors(self, tile: int) -> range:
        """The blocks that add to ``tile``, in K order."""
        first = tile * self.k_tiles
        return range(self.owner(first), self.owner(first + self.k_tiles - 1) + 1)

    def args(self) -> tuple:
        """The ints the C entry takes, in its order."""
        return (self.kt, self.stages, self.blocks, self.smem)

    def __str__(self) -> str:
        if self.path == "small":
            return (f"small: {self.blocks} blocks of {THREADS} threads, one thread per "
                    f"output of {self.B} x {self.N}, K = {self.K} in order")
        return (f"{self.path}: {self.blocks} blocks of {THREADS} threads over {self.units} "
                f"units ({self.groups} x {self.col_tiles} tiles x {self.k_tiles} K tiles of "
                f"{self.kt} rows), {self.stages} stages, {self.smem / 1024:.1f} KiB shared, "
                f"{self.fill}; workspace {self.ws_floats * 4 / 1024:.0f} KiB, "
                f"{self.counters} counters")


def small_rows(B: int, N: int) -> int:
    """The spike rows a small-path block of ``THREADS`` outputs reads, at most."""
    return min(B, math.ceil(THREADS / N) + 1)


def b6_stage_bytes(kt: int, s_bytes: int, w_bytes: int) -> int:
    """One stage: the ``s`` tile, then the ``w`` and ``c`` tiles."""
    return ROWS * kt * s_bytes + 2 * kt * BLOCK_N * w_bytes


def b6_smem(kt: int, stages: int, s_bytes: int, w_bytes: int) -> int:
    """The barriers, then the stages; at the end of a tile's run the stage
    just read holds the warps' partial sums, so a stage is at least
    ``B6_PART_BYTES``."""
    return BARRIER_BYTES + stages * b6_stage_bytes(kt, s_bytes, w_bytes)


@functools.lru_cache(maxsize=512)
def spike_matmul_plan(B: int, K: int, N: int, *, s_bytes: int = 4, w_bytes: int = 4,
                      is_aligned: bool = True, sms: int = SMS) -> MatmulPlan:
    """The launch of one B6 call: the small path for at most ``B6_SMALL``
    weights; else the stream-K split, as many blocks as fit an SM (one: two
    64 KiB stages) on every SM, when there are more units than blocks and
    fewer output tiles than blocks; else the tile path."""
    if min(B, K, N, sms) < 1 or s_bytes not in (2, 4) or w_bytes not in (2, 4):
        raise ValueError(f"bad B6 shape B={B} K={K} N={N} s_bytes={s_bytes} "
                         f"w_bytes={w_bytes}")
    fill = b6_fill(K, N, s_bytes, w_bytes, is_aligned)
    kt = B6_STAGE_BYTES // (2 * BLOCK_N * w_bytes)        # 64 rows f32, 128 bf16
    stages = 1 if fill == "element" else B6_STAGES       # the element fill: one stage
    smem = b6_smem(kt, stages, s_bytes, w_bytes)
    if K * N <= B6_SMALL and small_rows(B, N) * K <= B6_SMALL_SPIKES:
        return MatmulPlan(B=B, K=K, N=N, s_bytes=s_bytes, w_bytes=w_bytes, kt=kt,
                          stages=stages, blocks=math.ceil(B * N / THREADS), path="small",
                          fill=fill, smem=0)
    per_sm = max(1, min(MAX_BLOCKS_PER_SM, SM_SMEM // (smem + BLOCK_RESERVE)))
    tiles = math.ceil(B / ROWS) * math.ceil(N / BLOCK_N)
    units = tiles * math.ceil(K / kt)
    blocks = per_sm * sms
    stream = units > blocks and tiles < blocks
    return MatmulPlan(B=B, K=K, N=N, s_bytes=s_bytes, w_bytes=w_bytes, kt=kt,
                      stages=stages, blocks=blocks if stream else tiles,
                      path="stream-k" if stream else "tile", fill=fill, smem=smem)


# -- B5 ---------------------------------------------------------------------


def b5_fill(N: int, strides, is_aligned: bool) -> str:
    """``"cp.async"`` when every 4-column chunk of ``c``, ``w`` and ``elig``
    starts on a 16-byte boundary: ``N % 4 == 0``, aligned bases and slot
    strides (in elements) that are multiples of 4."""
    ok = is_aligned and N % 4 == 0 and all(s % 4 == 0 for s in strides)
    return "cp.async" if ok else "element"


@dataclasses.dataclass(frozen=True)
class StdpPlan:
    """One B5 launch."""

    S: int
    B: int
    K: int
    N: int
    rstdp: bool
    fill: str
    blocks: int
    stages: int        # ring stages: c (and elig) stages - 1 tiles ahead
    smem: int          # dynamic shared memory per block (the ring), bytes

    @property
    def k_tiles(self) -> int:
        return math.ceil(self.K / STDP_TK)

    @property
    def n_tiles(self) -> int:
        return math.ceil(self.N / BLOCK_N)

    @property
    def tiles(self) -> int:
        """Tiles per slot."""
        return self.k_tiles * self.n_tiles

    def walk(self, p: int, open_slots) -> list:
        """Block ``p``'s ``(slot, tile)`` units in the kernel's order: the
        slots in order, skipping closed ones, and tiles ``p, p + blocks, ...``
        of each."""
        return [(s, t) for s in range(self.S) if open_slots[s]
                for t in range(p, self.tiles, self.blocks)]

    def tile_box(self, t: int) -> tuple:
        """``(k0, k1, n0, n1)``: the rows and columns of tile ``t``."""
        kt, nt = divmod(t, self.n_tiles)
        return (kt * STDP_TK, min(self.K, (kt + 1) * STDP_TK),
                nt * BLOCK_N, min(self.N, (nt + 1) * BLOCK_N))

    def args(self) -> tuple:
        return (self.blocks, self.stages, self.smem)

    def __str__(self) -> str:
        return (f"{self.blocks} blocks of {THREADS} threads walking {self.S} slots x "
                f"{self.tiles} tiles of {STDP_TK} x {BLOCK_N}, {self.fill}, "
                f"{self.stages} stages, {self.smem / 1024:.1f} KiB ring")


def b5_smem(rstdp: bool, fill: str, stages: int) -> int:
    """The ring: ``stages`` stages of the ``c`` (and ``elig``) tiles on the
    cp.async fill (``w`` waits in registers); none on the element fill."""
    planes = 2 if rstdp else 1
    return stages * planes * STDP_TK * BLOCK_N * 4 if fill == "cp.async" else 0


def b5_static_smem() -> int:
    """The staged traces and spikes (static shared memory)."""
    return STDP_CHUNK_B * 2 * (STDP_TK + BLOCK_N) * 4


@functools.lru_cache(maxsize=512)
def stdp_plan(S: int, B: int, K: int, N: int, *, rstdp: bool, strides=(0, 0, 0),
              is_aligned: bool = True, sms: int = SMS) -> StdpPlan:
    """The launch of one B5 call: at most as many blocks as fit
    ``MAX_BLOCKS_PER_SM`` per SM by shared memory, no more than one slot's
    tiles, and as few as give every block the same number of tiles."""
    if min(S, B, K, N, sms) < 1:
        raise ValueError(f"bad B5 shape S={S} B={B} K={K} N={N}")
    fill = b5_fill(N, strides, is_aligned)
    stages = STDP_STAGES
    smem = b5_smem(rstdp, fill, stages)
    per_block = smem + b5_static_smem() + BLOCK_RESERVE
    per_sm = max(1, min(MAX_BLOCKS_PER_SM, SM_SMEM // per_block))
    tiles = math.ceil(K / STDP_TK) * math.ceil(N / BLOCK_N)
    # As few blocks as take each slot in the same number of tiles per block:
    # 4096 tiles on 264 resident blocks is 16 tiles each on 256 blocks.
    rounds = math.ceil(tiles / (per_sm * sms))
    return StdpPlan(S=S, B=B, K=K, N=N, rstdp=rstdp, fill=fill,
                    blocks=math.ceil(tiles / rounds), stages=stages, smem=smem)
