"""Launch plans of kernels B1 (``lif_step``) and B2 (``tick_fused``).

Both kernels compute their synaptic sums with the product in
``csrc/masked_product.cuh``: a block owns one slot, ``bb`` batch rows and
``BLOCK_N`` output columns over one contiguous range of K, and streams its
weight tiles (``kt`` rows by ``BLOCK_N`` columns of ``w``, and of ``c`` and
the delays where present, with the matching spike columns) through a ring of
``stages`` shared-memory buffers. A cluster of ``ks`` blocks splits K and
reduces in rank order.

The plan is chosen here, on the host, from the shapes and the card's SM
count, and passed to the C entry as ints (:meth:`Plan.args`), which checks
it again. Two fills of a stage (``Plan.path``), which the C entry derives
from the operands by the same rule:

* ``"cp.async"``, the asynchronous ring: tiles requested ``stages - 1``
  ahead (double buffering) by every thread's 16-byte ``cp.async`` copies,
  each stage completing on an ``mbarrier``. Every copied row must start on
  a 16-byte boundary: ``N % 4 == 0``, ``K % 4 == 0``, the operands' base
  addresses 16-byte aligned and their slot and row strides multiples of 4
  elements (:func:`aligned`).
* ``"element"``: bounds-checked loads by every thread into one stage, for
  any other shape (ragged ``N``, odd ``K``), with no padding copies.

Nothing here touches a device: the CPU tests hold the planner to its
contract.
"""
from __future__ import annotations

import dataclasses
import functools
import math

BLOCK_N = 128          # output columns per block (csrc/masked_product.cuh kBlockN)
WARPS = 4              # warps per block; they split each stage's rows
ROWS = (1, 2, 4, 8, 16)   # batch rows per block the kernels are built for
MAX_SPLIT = 8          # the portable cluster size
MAX_STAGES = 8         # what the C entries accept
MAX_KT = 64            # weight rows per stage
MIN_RANGE = 32         # no split leaves a block fewer K rows than this
BARRIER_BYTES = 128    # the stages' mbarriers, ahead of the stages
MAX_SMEM = 232_448     # dynamic shared memory a block may opt into on Hopper
# Two stages (double buffering), each as deep as fits STAGE_BYTES: on an
# H100, more and shallower stages were slower at the main path's shapes
# (PERF.md section 6).
STAGES = 2
STAGE_BYTES = 40 * 1024
SMS = 132              # an H100 SXM's SM count, when no card is asked


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: shapes, the tile, the pipeline and the split."""

    S: int
    B: int
    K: int
    N: int
    bb: int        # batch rows per block
    kt: int        # weight rows per stage
    stages: int    # shared-memory stages in the ring
    ks: int        # blocks of a cluster splitting K
    k_chunk: int   # K rows per block of the cluster (the last may have fewer)
    smem: int      # dynamic shared memory per block, bytes
    path: str      # the fill: "cp.async" or "element"
    has_c: bool = True   # w and c streamed; False: w is the premasked W*C

    @property
    def grid(self) -> tuple:
        return (math.ceil(self.N / BLOCK_N) * self.ks, math.ceil(self.B / self.bb), self.S)

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    def k_ranges(self) -> list:
        """Each cluster rank's ``[begin, end)`` range of K, in rank order."""
        return [(min(self.K, r * self.k_chunk), min(self.K, (r + 1) * self.k_chunk))
                for r in range(self.ks)]

    def args(self) -> tuple:
        """The ints the C entries take, in their order."""
        return (self.bb, self.kt, self.stages, self.ks, self.k_chunk, self.smem)

    def __str__(self) -> str:
        x, y, z = self.grid
        return (f"grid ({x}, {y}, {z}) = {self.blocks} blocks of {WARPS * 32} threads, "
                f"{self.bb} rows x {BLOCK_N} columns, K split {self.ks} ways "
                f"({self.k_chunk} rows each), {self.stages} stages of {self.kt} rows, "
                f"{self.smem / 1024:.1f} KiB shared, {self.path}")


def stage_bytes(bb: int, kt: int, planes: int, n_planes: int) -> int:
    """One stage: ``bb x n_planes x kt`` spike floats, then ``planes`` tiles
    of ``kt x BLOCK_N`` (``w``; ``c``; the int32 delays)."""
    return 4 * (bb * n_planes * kt + planes * kt * BLOCK_N)


def smem_bytes(bb: int, kt: int, stages: int, planes: int, n_planes: int) -> int:
    """The barriers, then the stages; the warps' partial sums reuse the
    stages after the last tile, so the larger of the two."""
    return BARRIER_BYTES + max(stages * stage_bytes(bb, kt, planes, n_planes),
                               WARPS * bb * BLOCK_N * 4)


def aligned(addresses, strides) -> bool:
    """True when every address is 16-byte aligned and every stride (in
    4-byte elements) is a multiple of 4: each row a ``cp.async`` copy reads
    then starts on a 16-byte boundary."""
    return all(a % 16 == 0 for a in addresses) and all(s % 4 == 0 for s in strides)


@functools.lru_cache(maxsize=512)
def plan(S: int, B: int, K: int, N: int, *, has_c: bool, delays: bool = False,
         n_read: int = 1, is_aligned: bool = True, sms: int = SMS) -> Plan:
    """The launch of one B1/B2 call.

    ``has_c``: ``w`` and ``c`` are streamed (else ``w`` is the premasked
    ``W*C``); ``delays``: the int32 delay plane is streamed and all
    ``n_read`` ring planes of the spike history are staged; ``is_aligned``:
    :func:`aligned` of the operands. Raises ``ValueError`` when not even one
    stage of four rows fits in shared memory (a ring too deep to stage).
    """
    if min(S, B, N, n_read, sms) < 1 or K < 0:
        raise ValueError(f"bad shape S={S} B={B} K={K} N={N} n_read={n_read}")
    bb = next((r for r in ROWS if r >= B), ROWS[-1])
    path = "cp.async" if is_aligned and N % 4 == 0 and K % 4 == 0 else "element"
    planes = 1 + int(has_c) + int(delays)
    n_planes = n_read if delays else 1

    base = math.ceil(N / BLOCK_N) * math.ceil(B / bb) * S
    ks = 1
    while ks < MAX_SPLIT and base * ks < sms and K // (2 * ks) >= MIN_RANGE:
        ks *= 2
    k_chunk = max(4, 4 * math.ceil(K / ks / 4))
    ks = max(1, math.ceil(K / k_chunk))   # no empty range

    kt, stages = _pipeline(bb, planes, n_planes, path)
    return Plan(S=S, B=B, K=K, N=N, bb=bb, kt=kt, stages=stages, ks=ks, k_chunk=k_chunk,
                smem=smem_bytes(bb, kt, stages, planes, n_planes), path=path, has_c=has_c)


def _pipeline(bb: int, planes: int, n_planes: int, path: str) -> tuple:
    """``(kt, stages)``: ``STAGES`` stages (one on the element path) of the
    deepest tile that fits ``STAGE_BYTES``; shallower where the staged
    history is large (per-synapse delays stage every ring plane); past that,
    whatever one block can hold."""
    stages = 1 if path == "element" else STAGES
    kts = [MAX_KT >> i for i in range(5)]   # 64, 32, 16, 8, 4
    for kt in kts:
        if stage_bytes(bb, kt, planes, n_planes) <= STAGE_BYTES:
            return kt, stages
    for kt in kts:
        for n in range(stages, 0, -1):
            if smem_bytes(bb, kt, n, planes, n_planes) <= MAX_SMEM:
                return kt, n
    raise ValueError(f"cannot stage {n_planes} ring planes of {bb} rows: even one stage "
                     f"of 4 rows needs {BARRIER_BYTES + stage_bytes(bb, 4, planes, n_planes)} "
                     f"bytes of shared memory, more than {MAX_SMEM}")


def block_tile(p: Plan, block) -> tuple:
    """``(slot, b0, n0, k0, k1, rank)`` of one block: its slot, first batch
    row and first column, the ``[k0, k1)`` range of K its cluster rank sums
    (``masked_product.cuh`` ``block_range``) and that rank."""
    x, y, z = block
    rank = x % p.ks
    k0 = min(p.K, rank * p.k_chunk)
    return z, y * p.bb, (x // p.ks) * BLOCK_N, k0, min(p.K, k0 + p.k_chunk), rank
