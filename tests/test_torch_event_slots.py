"""Event decisions per slot: the port's slot axis against the reference's
``vmap``, one network at a time.

With slot-stacked parameters (the server's layout) each network takes its
own overflow fallback and its own adaptive-knee decision, and carries its
own hysteresis bit, as the reference does per network under ``vmap``
(``repro.core.engine`` ``tick_body``, ``repro.kernels.ops.event_synaptic_input``).
The fabrics here put one slot over the knee (or over ``k_active``) and its
neighbour under it, on u8-grid weights (every arm exact, so rasters and
``v`` are bitwise) and on uniform float weights (the event arm's slot-order
row sum and the dense product round differently: ``v`` is held to
``FLOAT_ATOL``, rasters exactly).

The kernels' per-slot gates run only on an NVIDIA GPU:
``test_cuda_gates_per_slot`` is marked ``cuda`` and skips here.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as j_net
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import TickCarry as JCarry
from repro.core.engine import TickEngine as JEngine
from repro.core.lif import LIFParams as JLIFParams
from repro.kernels import ops as j_ops
from repro_torch import interop
from repro_torch.core import network as t_net
from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
from repro_torch.kernels import event_dispatch as t_ev
from repro_torch.kernels import lif_step as t_b1
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

ROWS = ("v_th", "leak", "r_ref", "gain", "i_bias", "v_reset")
N, B, K_ACTIVE, KNEE = 64, 2, 16, 8
FLOAT_ATOL = 1e-5   # |v| stays below ~2 here: a few f32 ulps of the row sums
# Spikes driven per tick: slot 0 crosses the knee up and down and once passes
# K_ACTIVE; slot 1 never reaches the knee's lower band.
BUSY = [2, 12, 6, 6, 3, 10, 20, 5, 2, 9, 7, 4, 1]
QUIET = [1, 2, 3, 0, 2, 3, 1, 2, 3, 1, 0, 2, 3]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(seed, *, grid):
    """One network as numpy leaves: weak 5 % recurrence, no refractory
    period, thresholds the drive clears in one tick. ``grid``: integer
    weights in [0, 3] and integer thresholds; else uniform float weights."""
    rng = np.random.default_rng(seed)
    c = (rng.random((N, N)) < 0.05).astype(np.float32)
    if grid:
        w = rng.integers(0, 4, (N, N)).astype(np.float32)
        v_th, leak = np.full(N, 100.0), np.full(N, 8.0)
    else:
        w = rng.uniform(0, 0.1, (N, N)).astype(np.float32)
        v_th, leak = np.full(N, 0.8), np.full(N, 0.2)
    return {"w": w, "c": c, "w_in": np.eye(N, dtype=np.float32),
            "lif.v_th": v_th.astype(np.float32), "lif.leak": leak.astype(np.float32),
            "lif.r_ref": np.zeros(N, np.int32), "lif.gain": np.ones(N, np.float32),
            "lif.i_bias": np.zeros(N, np.float32), "lif.v_reset": np.zeros(N, np.float32)}


def _drive(schedules, *, grid):
    """``(T, S, B, N)`` drive: slot ``i`` drives its first ``schedules[i][t]``
    neurons hard enough to spike at tick ``t``."""
    T = len(schedules[0])
    ext = np.zeros((T, len(schedules), B, N), np.float32)
    for i, sched in enumerate(schedules):
        for t, m in enumerate(sched):
            ext[t, i, :, :m] = 200.0 if grid else 1.0
    return ext


def _jax_params(t):
    return j_net.SNNParams(
        w=jnp.asarray(t["w"]), c=jnp.asarray(t["c"]), w_in=jnp.asarray(t["w_in"]),
        lif=JLIFParams(**{k: jnp.asarray(t[f"lif.{k}"]) for k in ROWS}))


def _slots(grid):
    trees = [_tree(70 + i, grid=grid) for i in range(2)]
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    return trees, interop.params_from_numpy(stacked, "cpu"), _drive([BUSY, QUIET], grid=grid)


def _assert_v(got, want, grid):
    if grid:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("grid", [True, False])
def test_knee_bit_per_slot_matches_reference_tick_by_tick(grid):
    """The knee armed on two slots, one crossing it and one never near it:
    each slot's hysteresis bit, raster and ``v`` equal the reference's for
    that network alone, tick by tick; the busy slot takes both arms and the
    quiet one only the event arm."""
    trees, tp, ext = _slots(grid)
    opts = dict(backend="event", event_k_active=K_ACTIVE, event_knee=KNEE,
                event_hysteresis=0.5)
    j_eng, t_eng = JEngine(JOptions(**opts)), TickEngine(EngineOptions(**opts))
    jps = [_jax_params(t) for t in trees]
    jcs = [JCarry(state=j_net.SNNState.zeros((B,), N), policy=jnp.zeros((), jnp.bool_))
           for _ in trees]
    tc = TickCarry(state=t_net.SNNState.zeros((2, B), N, device="cpu"),
                   policy=torch.zeros(2, dtype=torch.bool))
    bits = []
    for t in range(len(BUSY)):
        tc, ty = t_eng.tick_body(tc, (torch.as_tensor(ext[t]), None), params=tp)
        assert tc.policy.shape == (2,) and tc.policy.dtype == torch.bool
        for i, jp in enumerate(jps):
            jcs[i], jy = j_eng.tick_body(jcs[i], (jnp.asarray(ext[t, i]), None), params=jp,
                                         wc=jp.w * jp.c)
            np.testing.assert_array_equal(ty[i].numpy(), np.asarray(jy),
                                          err_msg=f"slot {i} tick {t}")
            assert bool(tc.policy[i]) == bool(jcs[i].policy), f"slot {i} tick {t}"
            _assert_v(tc.state.lif.v[i].numpy(), np.asarray(jcs[i].state.lif.v), grid)
        bits.append(tc.policy.tolist())
    busy, quiet = zip(*bits)
    assert any(busy) and not all(busy) and not any(quiet)


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("knee", [KNEE, None])
def test_slot_rollouts_match_reference_per_network(grid, knee):
    """Whole rollouts on the slot axis, with the knee or with the overflow
    fallback at a small ``k_active``: each slot's raster and final state
    equal the reference's event rollout of that network alone."""
    trees, tp, ext = _slots(grid)
    opts = dict(backend="event", event_k_active=K_ACTIVE if knee else 8)
    if knee:
        opts.update(event_knee=knee, event_hysteresis=0.5)
    T = ext.shape[0]
    tf, tr = TickEngine(EngineOptions(**opts)).rollout(
        tp, t_net.SNNState.zeros((2, B), N, device="cpu"), torch.as_tensor(ext), T)
    for i, tree in enumerate(trees):
        jf, jr = JEngine(JOptions(**opts)).rollout(
            _jax_params(tree), j_net.SNNState.zeros((B,), N), jnp.asarray(ext[:, i]), T)
        np.testing.assert_array_equal(tr[:, i].numpy(), np.asarray(jr), err_msg=f"slot {i}")
        _assert_v(tf.lif.v[i].numpy(), np.asarray(jf.lif.v), grid)
        np.testing.assert_array_equal(tf.lif.r[i].numpy(), np.asarray(jf.lif.r))
    assert 0 < float(tr[:, 1].mean()) < float(tr[:, 0].mean())


@pytest.mark.parametrize("knee", [KNEE, None])
def test_arm_tally_per_slot(knee):
    """Per-slot telemetry counts each slot's own arm: the quiet slot stays on
    the event arm every tick while the busy one goes dense (by the knee, or
    on overflow at ``k_active = 8``), and each slot's ``overflow`` and
    ``policy_dense`` equal the reference's telemetry for that network alone
    (exactly: integer counters)."""
    trees, tp, ext = _slots(True)
    T = ext.shape[0]
    opts = dict(backend="event", event_k_active=K_ACTIVE if knee else 8, telemetry=True)
    if knee:
        opts.update(event_knee=knee, event_hysteresis=0.5)
    st0 = t_net.SNNState.zeros((2, B), N, device="cpu")
    _, _, tel = TickEngine(EngineOptions(**opts)).rollout(tp, st0, torch.as_tensor(ext), T)
    assert tuple(tel.overflow.shape) == (2, B)
    over, policy = tel.overflow[:, 0].tolist(), tel.policy_dense[:, 0].tolist()
    busy = [T - over[0] - policy[0], over[0], policy[0]]
    assert [T - over[1] - policy[1], over[1], policy[1]] == [T, 0, 0]
    assert busy[0] > 0 and busy[1] > 0 and (busy[2] > 0) == bool(knee)
    for i, tree in enumerate(trees):
        _, _, jtel = JEngine(JOptions(**opts)).rollout(
            _jax_params(tree), j_net.SNNState.zeros((B,), N), jnp.asarray(ext[:, i]), T)
        np.testing.assert_array_equal(tel.overflow[i].numpy(), np.asarray(jtel.overflow))
        np.testing.assert_array_equal(tel.policy_dense[i].numpy(),
                                      np.asarray(jtel.policy_dense))
        np.testing.assert_array_equal(tel.ticks[i].numpy(), np.asarray(jtel.ticks))


def test_plain_event_input_decides_per_slot():
    """The plain path (:func:`ops.event_synaptic_input`) on a slot axis: the
    slot whose rows overflow ``k_active`` takes the dense product and its
    neighbour the spike-list gather, as the reference decides for each
    network alone; a per-slot ``take_dense`` under ``"unchecked"`` sends one
    slot dense and leaves its neighbour's truncated gather (float weights,
    bitwise each); ``strict`` raises on any slot's overflow."""
    rng = np.random.default_rng(80)
    S, b, n, k = 2, 3, 256, 64
    wc = torch.as_tensor(rng.uniform(0, 1, (S, n, n)).astype(np.float32))
    s = np.zeros((S, b, n), np.float32)
    s[0] = rng.random((b, n)) < 0.5          # every row past k
    for row in range(b):                     # k spikes per row
        s[1, row, rng.choice(n, k, replace=False)] = 1.0
    s = torch.as_tensor(s)
    dense = s @ wc
    idx, counts, _ = t_ops.spike_list(s, k)
    gather = t_ref.event_gather_sum(idx, counts, wc, walk="live")
    got = t_ops.event_synaptic_input(s, wc, k_active=k, overflow="fallback")
    assert torch.equal(got[0], dense[0]) and torch.equal(got[1], gather[1])
    for i in range(S):
        j_got = j_ops.event_synaptic_input(jnp.asarray(s[i].numpy()), jnp.asarray(wc[i].numpy()),
                                           k_active=k, overflow="fallback")
        np.testing.assert_allclose(got[i].numpy(), np.asarray(j_got), rtol=0, atol=1e-4)
    both = s.clone()
    both[1] = s[0]                           # both slots past k
    idx, counts, _ = t_ops.spike_list(both, k)
    truncated = t_ref.event_gather_sum(idx, counts, wc, walk="live")
    full = both @ wc
    assert not torch.equal(truncated[0], full[0])
    forced = t_ops.event_synaptic_input(both, wc, k_active=k, overflow="unchecked",
                                        take_dense=torch.tensor([True, False]))
    assert torch.equal(forced[0], full[0]) and torch.equal(forced[1], truncated[1])
    with pytest.raises(t_ops.EventOverflowError):
        t_ops.event_synaptic_input(s, wc, k_active=k, overflow="strict")


def _gate_case(dev):
    rng = np.random.default_rng(81)
    S, b, n, k = 3, 2, 40, 12
    tree = _tree(82, grid=True)
    lead = lambda a: torch.as_tensor(np.stack([a[:n] if a.ndim == 1 else a[:n, :n]] * S)).to(dev)
    wc = lead(tree["w"] * tree["c"])
    rows = [lead(tree[f"lif.{r}"]) for r in ROWS]
    s = torch.as_tensor((rng.random((S, b, n)) < 0.2).astype(np.float32)).to(dev)
    v = torch.as_tensor(rng.integers(-20, 90, (S, b, n)).astype(np.float32)).to(dev)
    r = torch.zeros((S, b, n), dtype=torch.int32, device=dev)
    return s, wc, v, r, rows, k


def _check_gates(dev):
    """B1 (``run_if``) and B3/B4 (``skip``) on one per-slot flag: each slot
    is written by exactly the arm its own flag picks."""
    s, wc, v, r, rows, k = _gate_case(dev)
    flag = torch.tensor([True, False, True], device=dev)
    idx, counts, _ = t_ops.spike_list(s, k)
    dense = t_ref.fused_lif_step_ref(s, wc, None, v, r, None, *rows)
    event = t_ref.event_lif_dispatch_ref(idx, counts, wc, v, r, None, *rows)
    out = t_ref.LIFStepOut(torch.full_like(v, -7.0), torch.full_like(r, 9),
                           torch.full_like(v, 3.0))
    t_b1.fused_lif_step(s, wc, None, v, r, None, *rows, run_if=flag, out=out)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    assert torch.equal(out.v[1], torch.full_like(v[1], -7.0))
    for got, want in zip(out, dense):
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    t_ev.event_lif_dispatch_db(idx, wc, v, r, None, *rows, counts=counts, skip=flag, out=out)
    t_ev.event_lif_dispatch(idx, t_ops.sentinel_rows(wc), v, r, None, *rows, skip=flag,
                            out=out)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    for got, d, e in zip(out, dense, event):
        assert torch.equal(got[0], d[0]) and torch.equal(got[2], d[2])
        assert torch.equal(got[1], e[1])


def test_gates_per_slot():
    """The wrappers' per-slot gates on CPU tensors (the twins)."""
    _check_gates(torch.device("cpu"))


@pytest.mark.cuda
def test_cuda_gates_per_slot():
    """The same per-slot gates through the CUDA kernels B1, B3 and B4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernels B1, B3 and B4 are CUDA for sm_90a and "
                    "have no CPU mode (their twins are tested above)")
    _check_gates(torch.device("cuda"))
