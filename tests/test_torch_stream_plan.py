"""The launch plans of kernels B6 (``spike_matmul``, a stream-K split) and
B5 (``stdp_update``, a persistent walk over slots and tiles).

``repro_torch.kernels._stream`` picks each launch's grid, tile and fill; the
CUDA kernels run only on an NVIDIA GPU, so these tests hold the plans to
their contract on the CPU: every output element covered exactly once, the
workspace and counter sizes, Hopper's shared-memory limit, the tile path at
``predict_int``'s shapes, ragged K and N, and closed slots never walked.
"""
import math

import pytest

from repro_torch.kernels import _stream

# (B, K, N): the smoke shape, predict_int's Iris and MNIST products, the
# reference's sweep and ragged edges on both paths
B6_SHAPES = [(8, 4096, 4096), (45, 4, 3), (80, 64, 10), (1, 8, 8), (4, 74, 74),
             (17, 300, 139), (32, 512, 128), (8, 1024, 256), (8, 4100, 4096),
             (3, 4097, 1000), (8, 2048, 4100), (20, 1000, 777), (1, 1, 1), (9, 513, 33)]
DTYPE_BYTES = [(4, 4), (2, 2), (4, 2), (2, 4)]


def _units_of_tile(p, tile):
    first = tile * p.k_tiles
    return range(first, first + p.k_tiles)


@pytest.mark.parametrize("s_bytes,w_bytes", DTYPE_BYTES)
@pytest.mark.parametrize("B,K,N", B6_SHAPES)
def test_b6_plan_covers_every_output_once(B, K, N, s_bytes, w_bytes):
    """Every (row, k, column) of the product lies in exactly one unit of one
    block's run; a tile's contributors are the owners of its units, in K
    order; the runs are equal to within one unit and never empty."""
    for aligned in (True, False):
        p = _stream.spike_matmul_plan(B, K, N, s_bytes=s_bytes, w_bytes=w_bytes,
                                      is_aligned=aligned, sms=132)
        if p.path == "small":   # one thread per output
            assert K * N <= _stream.B6_SMALL and p.ws_floats == p.counters == p.smem == 0
            assert p.blocks * _stream.THREADS >= B * N > (p.blocks - 1) * _stream.THREADS
            for q in range(p.blocks):   # the spike rows each block stages fit
                lo, hi = q * _stream.THREADS, min(B * N, (q + 1) * _stream.THREADS) - 1
                rows = hi // N - lo // N + 1
                assert rows <= _stream.small_rows(B, N)
                assert rows * K <= _stream.B6_SMALL_SPIKES
            continue
        assert 1 <= p.blocks <= p.units
        sizes = [p.begin(q + 1) - p.begin(q) for q in range(p.blocks)]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        assert p.begin(0) == 0 and p.begin(p.blocks) == p.units
        seen = {}
        for q in range(p.blocks):
            for tile, lo, hi in p.segments(q):
                assert 0 <= lo < hi <= p.k_tiles
                for kk in range(lo, hi):
                    u = tile * p.k_tiles + kk
                    assert u not in seen
                    seen[u] = q
                    assert p.owner(u) == q
        assert sorted(seen) == list(range(p.units))
        for tile in range(p.tiles):
            owners = [seen[u] for u in _units_of_tile(p, tile)]
            assert owners == sorted(owners)
            assert list(p.contributors(tile)) == sorted(set(owners))
        # rows, columns and K behind the units: each once
        rows = [r for g in range(p.groups) for r in range(g * _stream.ROWS,
                                                          min(B, (g + 1) * _stream.ROWS))]
        cols = [c for j in range(p.col_tiles) for c in range(j * _stream.BLOCK_N,
                                                             min(N, (j + 1) * _stream.BLOCK_N))]
        ks = [k for kk in range(p.k_tiles) for k in range(kk * p.kt, min(K, (kk + 1) * p.kt))]
        assert rows == list(range(B)) and cols == list(range(N)) and ks == list(range(K))


@pytest.mark.parametrize("s_bytes,w_bytes", DTYPE_BYTES)
@pytest.mark.parametrize("B,K,N", B6_SHAPES)
def test_b6_plan_workspace_counters_and_budget(B, K, N, s_bytes, w_bytes):
    """Two partial tiles per block in the workspace and one counter per
    output tile on the stream-K path, none on the tile path; a block holds
    at most one tile of its first run and one of its last in the workspace;
    shared memory within Hopper's 232,448-byte budget."""
    for aligned in (True, False):
        p = _stream.spike_matmul_plan(B, K, N, s_bytes=s_bytes, w_bytes=w_bytes,
                                      is_aligned=aligned, sms=132)
        if p.path == "small":
            continue
        assert p.smem <= _stream.MAX_SMEM
        assert p.smem == _stream.b6_smem(p.kt, p.stages, s_bytes, w_bytes)
        assert _stream.b6_stage_bytes(p.kt, s_bytes, w_bytes) >= _stream.B6_PART_BYTES
        if p.path == "tile":
            assert p.blocks == p.tiles and p.ws_floats == 0 and p.counters == 0
            assert all(len(p.segments(q)) == 1 and p.segments(q)[0][1:] == (0, p.k_tiles)
                       for q in range(p.blocks))
        else:
            per_sm = 2 if 2 * (p.smem + _stream.BLOCK_RESERVE) <= _stream.SM_SMEM else 1
            assert p.blocks == 132 * per_sm and p.units > p.blocks > p.tiles
            assert p.ws_floats == p.blocks * 2 * _stream.ROWS * _stream.BLOCK_N
            assert p.counters == p.tiles
            for q in range(p.blocks):
                shared = [seg for seg in p.segments(q)
                          if len(p.contributors(seg[0])) > 1]
                assert len(shared) <= 2
                assert all(seg in (p.segments(q)[0], p.segments(q)[-1]) for seg in shared)


def test_b6_plan_paths_at_the_main_shapes():
    """Stream-K at the smoke shape, one block on each SM, in f32 (64-row K
    tiles, two 64 KiB stages) and bf16 (128-row tiles); the small path at
    predict_int's Iris and MNIST shapes, where one launch is the cost."""
    f32 = _stream.spike_matmul_plan(8, 4096, 4096, sms=132)
    assert (f32.path, f32.fill, f32.kt, f32.stages) == ("stream-k", "tma", 64, 2)
    assert f32.units == 32 * 64 and f32.blocks == 132
    bf16 = _stream.spike_matmul_plan(8, 4096, 4096, s_bytes=2, w_bytes=2, sms=132)
    assert (bf16.path, bf16.kt, bf16.blocks) == ("stream-k", 128, 132)
    for B, K, N in ((45, 4, 3), (80, 64, 10)):
        p = _stream.spike_matmul_plan(B, K, N, sms=132)
        assert p.path == "small" and p.ws_floats == 0 and p.smem == 0
        assert p.blocks == math.ceil(B * N / _stream.THREADS)
    assert _stream.spike_matmul_plan(8, 1024, 256, sms=132).path == "tile"
    assert _stream.spike_matmul_plan(8, 4096, 4096, is_aligned=False).fill == "element"
    assert _stream.spike_matmul_plan(8, 4097, 4096).fill == "element"
    assert _stream.spike_matmul_plan(8, 4096, 4097).fill == "element"
    assert _stream.spike_matmul_plan(8, 4096, 4100, w_bytes=2).fill == "element"
    assert _stream.spike_matmul_plan(8, 4096, 4104, w_bytes=2).fill == "tma"
    with pytest.raises(ValueError):
        _stream.spike_matmul_plan(0, 4, 4)


B5_SHAPES = [(8, 1, 4096, 4096), (1, 8, 4096, 4096), (1, 16, 4096, 4096), (3, 1, 37, 37),
             (2, 3, 100, 260), (1, 1, 33, 129)]


@pytest.mark.parametrize("rstdp", [False, True])
@pytest.mark.parametrize("S,B,K,N", B5_SHAPES)
def test_b5_walk_covers_open_slots_once(S, B, K, N, rstdp):
    """Every synapse of every open slot lies in exactly one tile of one
    block's walk, and no tile of a closed slot is walked; blocks fit the
    SM's shared memory, two per SM on the cp.async fill, whose ring holds
    ``c`` (and ``elig`` for R-STDP)."""
    for aligned in (True, False):
        p = _stream.stdp_plan(S, B, K, N, rstdp=rstdp, is_aligned=aligned, sms=132)
        assert 1 <= p.blocks <= p.tiles
        per_block = p.smem + _stream.b5_static_smem() + _stream.BLOCK_RESERVE
        assert p.smem + _stream.b5_static_smem() <= _stream.MAX_SMEM
        assert p.blocks <= 132 * max(1, _stream.SM_SMEM // per_block)
        rounds = math.ceil(p.tiles / p.blocks)
        assert math.ceil(p.tiles / (p.blocks - 1)) > rounds if p.blocks > 1 else True
        if p.fill == "cp.async" and p.tiles >= 264:
            assert p.blocks <= 264 and p.stages == _stream.STDP_STAGES
            assert p.smem == p.stages * (2 if rstdp else 1) * _stream.STDP_TK * \
                _stream.BLOCK_N * 4
        for open_slots in ([True] * S, [s % 2 == 1 for s in range(S)]):
            seen = set()
            for q in range(p.blocks):
                for slot, t in p.walk(q, open_slots):
                    assert open_slots[slot] and (slot, t) not in seen
                    seen.add((slot, t))
            want = {(s, t) for s in range(S) if open_slots[s] for t in range(p.tiles)}
            assert seen == want
        boxes = [p.tile_box(t) for t in range(p.tiles)]
        assert all(0 < k1 - k0 <= _stream.STDP_TK and 0 < n1 - n0 <= _stream.BLOCK_N
                   for k0, k1, n0, n1 in boxes)
        # tile t = row tile * n_tiles + column tile: the boxes tile K x N once
        assert sorted({(k0, k1) for k0, k1, _, _ in boxes}) == \
            [(k, min(K, k + _stream.STDP_TK)) for k in range(0, K, _stream.STDP_TK)]
        assert sorted({(n0, n1) for _, _, n0, n1 in boxes}) == \
            [(n, min(N, n + _stream.BLOCK_N)) for n in range(0, N, _stream.BLOCK_N)]
        assert len(set(boxes)) == p.tiles == p.k_tiles * p.n_tiles


def test_b5_blocks_balance_the_served_slot():
    """At 4096 x 4096 a slot is 4096 tiles: 256 blocks of 16 tiles each, not
    264 resident blocks of which some take one tile more."""
    p = _stream.stdp_plan(8, 1, 4096, 4096, rstdp=False, sms=132)
    assert p.tiles == 4096 and p.blocks == 256
    assert len(p.walk(0, [False] * 7 + [True])) == 16


def test_b5_fill_rule():
    """cp.async only where every 4-column chunk starts on a 16-byte
    boundary: N % 4 == 0, aligned bases and slot strides."""
    assert _stream.stdp_plan(8, 1, 4096, 4096, rstdp=False).fill == "cp.async"
    assert _stream.stdp_plan(3, 1, 37, 37, rstdp=False).fill == "element"
    assert _stream.stdp_plan(2, 1, 64, 64, rstdp=True, strides=(64 * 64, 2, 0)).fill == \
        "element"
    assert _stream.stdp_plan(1, 1, 64, 64, rstdp=False, is_aligned=False).fill == "element"
    assert _stream.stdp_plan(1, 1, 64, 64, rstdp=False, is_aligned=False).smem == 0
    with pytest.raises(ValueError):
        _stream.stdp_plan(1, 0, 4, 4, rstdp=False)
