"""The launch planner of kernels B1 (``lif_step``) and B2 (``tick_fused``).

``repro_torch.kernels._plan.plan`` picks the tile, the shared-memory ring and
the split over K that the CUDA product (``csrc/masked_product.cuh``) runs
with. The kernels run only on an NVIDIA GPU; the plan is plain Python, so
these tests hold it to its contract on the CPU: every output covered once,
K covered once in rank order, the portable cluster size, Hopper's
shared-memory limit, the asynchronous path only for 16-byte-aligned rows,
and at least one full wave of blocks at the main path's two shapes.
"""
import math

import pytest

from repro_torch.kernels import _plan

VARIANTS = {
    "premasked": {"has_c": False},
    "masked": {"has_c": True},
    "delays": {"has_c": True, "delays": True},
    "run_if": {"has_c": False},   # the event arm's gated launch: premasked W*C
}
SIZES = (37, 128, 4096)


def _cases(S, B, variant):
    for K in SIZES:
        for N in SIZES:
            for D in (1, 4):
                if D > 1 and variant != "delays":
                    continue
                kw = dict(VARIANTS[variant])
                if kw.get("delays"):
                    kw["n_read"] = D
                yield K, N, D, kw


def _check_cover(p, S, B, K, N):
    gx, gy, gz = p.grid
    assert gz == S
    assert gx % p.ks == 0
    cols = [c for t in range(gx // p.ks)
            for c in range(t * _plan.BLOCK_N, min(N, (t + 1) * _plan.BLOCK_N))]
    assert cols == list(range(N)), "every column once, no tile past N"
    rows = [r for t in range(gy) for r in range(t * p.bb, min(B, (t + 1) * p.bb))]
    assert rows == list(range(B)), "every batch row once, no row tile past B"
    ranges = p.k_ranges()
    assert len(ranges) == p.ks
    ks = [k for lo, hi in ranges for k in range(lo, hi)]
    assert ks == list(range(K)), "K covered once, in rank order"
    assert all(hi > lo for lo, hi in ranges) or K == 0, "no empty range"


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("B", [1, 4, 8, 16])
@pytest.mark.parametrize("S", [1, 3, 8])
def test_plan_contract(S, B, variant):
    for K, N, D, kw in _cases(S, B, variant):
        for is_aligned in (True, False):
            p = _plan.plan(S, B, K, N, is_aligned=is_aligned, sms=132, **kw)
            _check_cover(p, S, B, K, N)
            assert 1 <= p.ks <= _plan.MAX_SPLIT
            assert p.bb in _plan.ROWS and p.bb >= min(B, _plan.ROWS[-1])
            assert p.kt % 4 == 0 and 4 <= p.kt <= _plan.MAX_KT
            assert 1 <= p.stages <= _plan.MAX_STAGES
            planes = 1 + int(kw["has_c"]) + int(kw.get("delays", False))
            n_planes = kw.get("n_read", 1)
            assert p.smem == _plan.smem_bytes(p.bb, p.kt, p.stages, planes, n_planes)
            assert p.smem <= 232_448
            aligned_rows = is_aligned and N % 4 == 0 and K % 4 == 0
            assert (p.path != "element") == aligned_rows
            if p.path != "element":
                assert p.k_chunk % 4 == 0 and p.stages >= 2
            else:
                assert p.stages == 1
            assert len(p.args()) == 6


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("S,B", [(8, 1), (1, 8)])
def test_main_path_shapes_fill_the_card(S, B, variant):
    """The served wave (8 slots of one row) and the rollouts (one network of
    8 rows) at 4096 neurons: at least one wave of blocks on an H100's 132
    SMs, on the asynchronous path, with the split only where the grid is thin."""
    kw = dict(VARIANTS[variant])
    if kw.get("delays"):
        kw["n_read"] = 4
    p = _plan.plan(S, B, 4096, 4096, sms=132, **kw)
    assert p.blocks >= 132
    assert p.path == "cp.async"
    assert p.ks == (1 if S == 8 else 8)
    # double-buffered stages small enough for two blocks to share an SM
    assert p.stages == _plan.STAGES
    assert p.smem <= _plan.STAGES * _plan.STAGE_BYTES + _plan.BARRIER_BYTES


def test_event_dense_arm_reads_the_weights_once():
    """The event arm's dense launch (16 rows, premasked) takes all 16 rows in
    one block row, so each weight is read once per launch."""
    p = _plan.plan(1, 16, 4096, 4096, has_c=False, sms=132)
    assert p.bb == 16 and p.grid[1] == 1 and p.blocks >= 132


@pytest.mark.parametrize("addresses,strides,want", [
    ((0, 16, 4096), (4096, 4, 0), True),
    ((0, 8), (4096,), False),
    ((0, 16), (4094,), False),
    ((), (), True),
])
def test_alignment_rule(addresses, strides, want):
    assert _plan.aligned(addresses, strides) is want


def test_deep_ring_shrinks_the_stage_then_raises():
    """Per-synapse delays stage every ring plane: a deep ring gets shallower
    tiles and fewer stages; one that cannot fit a 4-row stage raises."""
    shallow = _plan.plan(1, 16, 4096, 4096, has_c=True, delays=True, n_read=4)
    deep = _plan.plan(1, 16, 4096, 4096, has_c=True, delays=True, n_read=64)
    assert deep.kt < shallow.kt or deep.stages < shallow.stages
    assert deep.smem <= 232_448
    with pytest.raises(ValueError, match="cannot stage"):
        _plan.plan(1, 16, 4096, 4096, has_c=True, delays=True, n_read=1000)


def test_plan_is_cached_and_printable():
    a = _plan.plan(8, 1, 4096, 4096, has_c=False)
    assert a is _plan.plan(8, 1, 4096, 4096, has_c=False)
    text = str(a)
    assert "cp.async" in text and "256 blocks" in text
    assert a.blocks == math.prod(a.grid)
