"""The launch plan of kernel B4 (``event_dispatch``) and the order of its adds.

``repro_torch.kernels._event_plan.event_plan`` picks the batch rows, the
column tile, the passes over the spike lists, the windows of row ids and
the ring that the CUDA kernel (``csrc/event_dispatch.cu``) streams the
distinct listed rows through. The kernel runs only on an NVIDIA GPU; the
plan is plain Python, so these tests hold it to its contract on the CPU
(every row, column, slot and row id covered once, Hopper's shared-memory
limit, a grid that fills the card at snn-event FULL), and walk a CPU
emulation of the kernel's staged adds, built from the plan's passes,
windows and stage boundaries, against the plain twin
``ref.event_gather_sum(walk="all")``: bitwise on float weights, with
sentinel tails, empty rows, duplicate ids and lists that do not ascend.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _event_plan, ops, ref

# (S, B, k, N, Kw): snn-event FULL, its slot axis, ragged N, B below, at and
# above a group, k = 0, k past one pass, a second window of row ids
SHAPES = [(1, 16, 409, 4096, 4097), (8, 16, 409, 4096, 4097), (3, 4, 40, 300, 301),
          (1, 4, 409, 37, 4097), (1, 16, 409, 4097, 4097), (1, 1, 5, 64, 65),
          (1, 17, 409, 4096, 4097), (1, 40, 409, 4096, 4097), (2, 5, 0, 128, 129),
          (1, 16, 4096, 4096, 4097), (1, 1, 20000, 64, 4097), (1, 8, 300, 64, 70001),
          (1, 3, 100, 33, 200_001)]


def _plans(S, B, k, N, Kw):
    for aligned in (True, False):
        for w_slot in (0, N * Kw):
            yield _event_plan.event_plan(S, B, k, N, Kw, w_slot=w_slot, is_aligned=aligned)


@pytest.mark.parametrize("S,B,k,N,Kw", SHAPES)
def test_plan_covers_every_row_column_slot_and_id_once(S, B, k, N, Kw):
    for p in _plans(S, B, k, N, Kw):
        gx, gy, gz = p.grid
        assert gz == S and p.blocks == gx * gy * gz
        tile = _event_plan.TILE_N
        cols = [c for t in range(gx) for c in range(t * tile, min(N, (t + 1) * tile))]
        assert cols == list(range(N)), "every column once, no tile past N"
        rows = [r for g in range(gy) for r in range(g * p.rows, min(B, (g + 1) * p.rows))]
        assert rows == list(range(B)), "every batch row once, no empty group"
        assert [j for lo, hi in p.passes() for j in range(lo, hi)] == list(range(k))
        assert all(hi > lo for lo, hi in p.passes())
        assert [i for lo, hi in p.windows() for i in range(lo, hi)] == list(range(Kw))
        for union in (0, 1, p.stage_rows, 5 * p.stage_rows + 3):
            bounds = p.stage_bounds(union)
            assert [r for lo, hi in bounds for r in range(lo, hi)] == list(range(union))
            assert all(0 < hi - lo <= p.stage_rows for lo, hi in bounds)


@pytest.mark.parametrize("S,B,k,N,Kw", SHAPES)
def test_plan_fits_the_card_and_the_c_entry(S, B, k, N, Kw):
    """The limits ``repro_event_dispatch`` checks again: at most 16 rows (one
    warp each), windows in whole 32s, stages of at least 32 rows, the fill
    as an int, and the layout's shared memory within what a block may opt
    into on Hopper."""
    for p in _plans(S, B, k, N, Kw):
        assert 1 <= p.rows <= _event_plan.MAX_ROWS and p.threads == 32 * p.rows
        assert p.groups == math.ceil(B / _event_plan.MAX_ROWS), "as few groups as cover B"
        assert p.rows == math.ceil(B / p.groups), "and no wider than they need"
        assert p.chunk >= 1
        assert p.window % 32 == 0 and 32 <= p.window <= _event_plan.MAX_WINDOW
        assert p.window >= min(Kw, _event_plan.MAX_WINDOW)
        assert p.stage_rows >= 32 and p.stage_rows * 32 * 4 == _event_plan.STAGE_BYTES
        assert p.smem == _event_plan.smem_bytes(p.rows, p.chunk, p.window, p.stage_rows)
        assert p.smem <= _event_plan.MAX_SMEM
        assert p.args() == (p.rows, p.chunk, p.window, p.stage_rows,
                            1 if p.fill == "cp.async" else 0, p.smem)
        assert min(max(1, k), 256) <= p.chunk <= max(1, k), "a pass holds 256 slots or all"


def test_plan_at_snn_event_full():
    """One pass, one window and every SM but four busy at 16 rows, K = N =
    4096, k = 409; a slot axis adds a block per column tile and slot."""
    p = _event_plan.event_plan(1, 16, 409, 4096, 4097)
    assert (p.rows, p.groups, p.blocks) == (16, 1, 128)
    assert len(p.passes()) == 1 and len(p.windows()) == 1 and p.fill == "cp.async"
    assert (p.stage_rows, p.smem) == (448, 227_020)
    q = _event_plan.event_plan(8, 16, 409, 4096, 4097)
    assert q.grid == (128, 1, 8) and q.stage_rows == p.stage_rows
    r = _event_plan.event_plan(1, 40, 409, 4096, 4097)
    assert (r.rows, r.groups) == (14, 3)


def test_fill_rule():
    """16-byte copies only where every row segment starts on a 16-byte
    boundary."""
    assert _event_plan.b4_fill(4096, 0, True) == "cp.async"
    assert _event_plan.b4_fill(4096, 4097 * 4096, True) == "cp.async"
    assert _event_plan.b4_fill(4097, 0, True) == "element"
    assert _event_plan.b4_fill(4096, 4097 * 4097, True) == "element"
    assert _event_plan.b4_fill(4096, 0, False) == "element"
    # the C entry takes the fill as its fifth plan int
    assert _event_plan.event_plan(1, 4, 9, 4096, 4097).args()[4] == 1
    assert _event_plan.event_plan(1, 4, 9, 4097, 4098).args()[4] == 0
    assert _event_plan.event_plan(1, 4, 9, 4096, 4097, is_aligned=False).args()[4] == 0


def test_bad_shapes_raise():
    for args in ((0, 1, 1, 1, 1), (1, 0, 1, 1, 1), (1, 1, -1, 1, 1), (1, 1, 1, 0, 1),
                 (1, 1, 1, 1, 0)):
        with pytest.raises(ValueError):
            _event_plan.event_plan(*args)


# -- the staged walk ---------------------------------------------------------


def _walk(plan, idx, wc):
    """A CPU emulation of kernel B4's sum, built from the plan: per slot and
    group, per pass, the ascending rows' runs of one id; per window the union
    of the marked ids (every row's first-window ids, the ascending rows'
    ids in later windows), streamed stage by stage; each ascending row adds
    the staged value of each of its runs in slot order, once and then,
    where the value is not zero, once per further slot of the run; a row
    that does not ascend adds its slots one by one after the pass's windows.
    Row ids outside ``wc`` add nothing."""
    S, B, k = idx.shape
    Kw, N = wc.shape[-2:]
    out = torch.zeros(S, B, N, dtype=torch.float32)
    for s in range(S):
        w = wc[s] if wc.dim() == 3 else wc
        for g in range(plan.groups):
            rows = range(g * plan.rows, min(B, (g + 1) * plan.rows))
            acc = {b: torch.zeros(N, dtype=torch.float32) for b in rows}
            for j0, j1 in plan.passes():
                lists = {b: [int(x) for x in idx[s, b, j0:j1]] for b in rows}
                ascend = {b: all(x <= y for x, y in zip(l, l[1:])) for b, l in lists.items()}
                runs = {}
                for b, l in lists.items():
                    runs[b] = []
                    for j, x in enumerate(l):
                        if j and x == l[j - 1]:
                            runs[b][-1][1] += 1
                        else:
                            runs[b].append([x, 1])
                for wi, (lo, hi) in enumerate(plan.windows()):
                    marked = {x for b in rows for x, _ in runs[b]
                              if lo <= x < hi and (ascend[b] or wi == 0)}
                    union = sorted(marked)
                    rank = {x: i for i, x in enumerate(union)}
                    for r0, r1 in plan.stage_bounds(len(union)):
                        staged = w[union[r0:r1]].to(torch.float32)
                        for b in rows:
                            if not ascend[b]:
                                continue
                            for x, times in runs[b]:
                                if lo <= x < hi and r0 <= rank[x] < r1:
                                    v = staged[rank[x] - r0]
                                    acc[b] = acc[b] + v
                                    for _ in range(times - 1):
                                        acc[b] = torch.where(v != 0, acc[b] + v, acc[b])
                for b in rows:
                    if not ascend[b]:
                        for x in lists[b]:
                            if 0 <= x < Kw:
                                acc[b] = acc[b] + w[x].to(torch.float32)
            for b in rows:
                out[s, b] = acc[b]
    return out


def _lists(rng, S, B, K, k, rate, empty=(), unsorted=(), dup=()):
    """Spike lists of a raster (``ops.spike_list``: ascending, sentinel K),
    with some rows empty, some shuffled and some with repeated ids."""
    s = torch.from_numpy((rng.random((S, B, K)) < rate).astype(np.float32))
    for b in empty:
        s[:, b] = 0
    idx, _, _ = ops.spike_list(s, k)
    idx = idx.clone()
    for b in unsorted:
        idx[:, b] = idx[:, b, torch.from_numpy(rng.permutation(k))]
    for b in dup:
        live = idx[:, b][idx[:, b] < K]
        if live.numel():
            rep = torch.sort(torch.cat([live, live[: max(1, live.numel() // 3)]])).values
            rep = rep[:k]
            idx[:, b, : rep.numel()] = rep
            idx[:, b, rep.numel():] = K
    return idx.contiguous()


def _weights(rng, lead, K, N, *, grid):
    """``W*C`` with its sentinel row: u8-grid weights, or signed floats (so
    the masked entries include -0.0), on a 20 % mask."""
    mask = rng.random(lead + (K, N)) < 0.2
    w = rng.integers(0, 256, lead + (K, N)).astype(np.float32) if grid else \
        rng.standard_normal(lead + (K, N)).astype(np.float32)
    return ops.sentinel_rows(torch.from_numpy(w * mask))


WALK_CASES = {
    "one group, float weights": dict(S=1, B=6, K=300, N=40, k=40, rate=0.08),
    "u8 grid": dict(S=1, B=6, K=300, N=40, k=40, rate=0.08, grid=True),
    "empty, unsorted and duplicate rows": dict(S=1, B=8, K=300, N=33, k=50, rate=0.1,
                                               empty=(1,), unsorted=(2, 5), dup=(3, 6)),
    "two groups and a slot axis": dict(S=2, B=20, K=200, N=37, k=30, rate=0.1, dup=(17,),
                                       unsorted=(4,)),
    "counts == k and past k": dict(S=1, B=5, K=120, N=8, k=12, rate=0.5),
    "k past one pass": dict(S=1, B=16, K=600, N=8, k=500, rate=0.9, dup=(0,),
                            unsorted=(15,)),
    "a second window of row ids": dict(S=1, B=3, K=70_000, N=4, k=30, rate=2e-4,
                                       unsorted=(1,), dup=(2,)),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_staged_walk_is_bitwise_the_twin(case):
    kw = dict(WALK_CASES[case])
    S, B, K, N, k, rate = (kw.pop(x) for x in ("S", "B", "K", "N", "k", "rate"))
    grid = kw.pop("grid", False)
    rng = np.random.default_rng(sum(map(ord, case)))
    idx = _lists(rng, S, B, K, k, rate, **kw)
    wc = _weights(rng, (S,) if S > 1 else (), K, N, grid=grid)
    plan = _event_plan.event_plan(S, B, k, N, K + 1)
    if case == "k past one pass":
        assert len(plan.passes()) > 1
    if case == "a second window of row ids":
        assert len(plan.windows()) > 1
    counts = torch.full((S, B), k, dtype=torch.int32)
    want = ref.event_gather_sum(idx, counts, wc, walk="all")
    got = _walk(plan, idx, wc)
    assert torch.equal(got, want)
    assert not got.signbit().logical_and(got == 0).any(), "a sum is never -0"


def test_staged_walk_with_small_passes_and_stages(monkeypatch):
    """More passes and stages than the defaults give at a small shape: the
    adds keep the twin's order across every boundary."""
    monkeypatch.setattr(_event_plan, "LIST_BYTES", 16 * 7 * 17)
    _event_plan.event_plan.cache_clear()
    try:
        rng = np.random.default_rng(3)
        idx = _lists(rng, 1, 7, 500, 60, 0.1, unsorted=(3,), dup=(0, 5))
        wc = _weights(rng, (), 500, 32, grid=False)
        plan = _event_plan.event_plan(1, 7, 60, 32, 501)
        assert len(plan.passes()) >= 3
        counts = torch.full((1, 7), 60, dtype=torch.int32)
        want = ref.event_gather_sum(idx, counts, wc, walk="all")
        assert torch.equal(_walk(plan, idx, wc), want)
    finally:
        _event_plan.event_plan.cache_clear()


def test_skipping_a_zero_is_exact():
    """The kernel skips a run's further adds where its staged value is zero:
    a sum that starts at +0 is never -0, and x + 0 and x + (-0) are x."""
    vals = torch.tensor([0.0, -0.0, 1.5, -2.25, 3e-39, -3e-39, float("inf"), 7e30],
                        dtype=torch.float32)
    for x in vals:
        if x == 0 and math.copysign(1.0, float(x)) < 0:
            continue   # a running sum from +0 is never -0
        for z in (torch.tensor(0.0), torch.tensor(-0.0)):
            assert torch.equal(x + z, x)
    acc = torch.zeros((), dtype=torch.float32)
    for v in (-0.0, 0.0, -0.0):
        acc = acc + v
    assert not acc.signbit()
