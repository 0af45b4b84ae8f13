"""The port's observability layer against the JAX package's.

The same numpy inputs go to the reference (``repro.obs``, ``repro.core``,
``repro.launch.serve``) and to the port. Tolerances, stated per test:

* telemetry on changes no bit of any raster, final state or learned weight
  (exact, every backend);
* the telemetry leaves against the reference's: ``ticks``, ``spikes``,
  ``v_max``, ``overflow`` and ``policy_dense`` exact; ``v_sum`` and
  ``ref_sum`` to ``rtol=1e-6`` (sums over the neuron axis in another order;
  on these integer-valued fabrics they come out equal anyway), and after
  learning moves the weights off the u8 grid ``v_max`` and ``v_sum`` to
  ``rtol=atol=1e-5`` as the potentials themselves; ``dw_l1`` and
  ``dw_sq`` to ``rtol=1e-5``, the reference's own tolerance between its
  learning backends (sums of float deltas over the whole matrix);
* the server's registry and ``tenant_report`` against the reference's after
  the same serve: counts exact, float fields to ``rel=1e-6`` and ``dw_l1`` to
  ``rel=1e-5``; histogram counts exact, their values (wall times) not
  compared.

On the CPU the kernel backends run their kernels' plain twins, the telemetry
kernel included (:meth:`TickTelemetry.accumulate`). The telemetry kernel and
kernel B5's dw statistics run only on an NVIDIA GPU:
``test_cuda_telemetry_kernel_and_b5_stats`` is marked ``cuda`` and skips
here.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectivity
from repro.core import network as j_net
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import TickEngine as JEngine
from repro.core.lif import LIFParams as JLIFParams
from repro.kernels import ops as j_ops
from repro.launch import serve as j_serve
from repro.plasticity import PlasticityParams as JPP
from repro.plasticity import PlasticityState as JPS
from repro_torch import interop
from repro_torch.core import network as t_net
from repro_torch.core.engine import EngineOptions, TickEngine
from repro_torch.core.lif import LIFState
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import stdp_update
from repro_torch.kernels import telemetry as t_telemetry
from repro_torch.kernels.ref import fused_stdp_step_ref
from repro_torch.launch import serve as t_serve
from repro_torch.obs import (
    EventLog, MetricsRegistry, TickTelemetry, span, trace_scope,
)
from repro_torch.obs import tracing
from repro_torch.plasticity import PlasticityParams, PlasticityState

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ("jnp", "pallas", "pallas_fused", "event")
ROWS = ("v_th", "leak", "r_ref", "gain", "i_bias", "v_reset")
EXACT = ("ticks", "spikes", "v_max", "overflow", "policy_dense")
N, T, D = 24, 12, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(n, seed, *, density=0.5, v_th=(6, 12), leak=1.0, r_ref=1, w_hi=4):
    """A fabric on the u8 grid: integer weights in [0, w_hi), integer
    thresholds and leak, so every potential is an integer and every sum
    exact."""
    rng = np.random.default_rng(seed)
    c = (rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(c, 0.0)
    return {"w": rng.integers(0, w_hi, (n, n)).astype(np.float32), "c": c,
            "w_in": np.eye(n, dtype=np.float32) * 2.0,
            "lif.v_th": rng.integers(*v_th, n).astype(np.float32),
            "lif.leak": np.full(n, leak, np.float32), "lif.r_ref": np.full(n, r_ref, np.int32),
            "lif.gain": np.ones(n, np.float32), "lif.i_bias": np.zeros(n, np.float32),
            "lif.v_reset": np.zeros(n, np.float32)}


def _jax(tree):
    return j_net.SNNParams(w=jnp.asarray(tree["w"]), c=jnp.asarray(tree["c"]),
                           w_in=jnp.asarray(tree["w_in"]),
                           lif=JLIFParams(**{k: jnp.asarray(tree[f"lif.{k}"]) for k in ROWS}))


def _ext(n, ticks, batch=(), *, seed, p=0.35, mag=4.0):
    rng = np.random.default_rng(seed)
    return ((rng.random((ticks,) + tuple(batch) + (n,)) < p) * mag).astype(np.float32)


def _assert_leaves(tel, jtel, *, dw=False):
    """The port's telemetry against the reference's, at the stated tolerances.
    With ``dw`` (a learning rollout, whose weights leave the u8 grid) the
    potentials themselves agree only to ``rtol=atol=1e-5``
    (``tests/test_torch_learning.py``), and so do ``v_max`` and ``v_sum``."""
    for f in EXACT:
        if dw and f == "v_max":
            continue
        np.testing.assert_array_equal(getattr(tel, f).numpy(), np.asarray(getattr(jtel, f)),
                                      err_msg=f)
    for f in ("v_sum", "ref_sum") + (("v_max",) if dw else ()):
        tol = dict(rtol=1e-5, atol=1e-5) if dw and f != "ref_sum" else dict(rtol=1e-6)
        np.testing.assert_allclose(getattr(tel, f).numpy(), np.asarray(getattr(jtel, f)),
                                   err_msg=f, **tol)
    for f in ("dw_l1", "dw_sq"):
        np.testing.assert_allclose(getattr(tel, f).numpy(), np.asarray(getattr(jtel, f)),
                                   rtol=1e-5, err_msg=f)
    assert getattr(tel, "dw_l1").abs().sum() > 0 if dw else True
    for f in ("ticks", "overflow", "policy_dense"):
        assert getattr(tel, f).dtype == torch.int32, f
    for f in ("spikes", "v_sum", "v_max", "ref_sum", "dw_l1", "dw_sq"):
        assert getattr(tel, f).dtype == torch.float32, f


def _assert_same_state(a, b):
    for f in ("v", "r", "y"):
        assert torch.equal(getattr(a.lif, f), getattr(b.lif, f)), f
    assert torch.equal(a.delay_buf, b.delay_buf) and torch.equal(a.tick, b.tick)


# -- the tick loop's telemetry -----------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_on_off_bit_exact_and_leaves_match_reference(backend):
    """Per backend (``tests/test_obs.py``'s sizes, N=24, T=12, D=4): telemetry
    on leaves the raster and final state bitwise as off, ``spikes`` equals the
    raster's sum, a frozen rollout reports no dw, and every leaf equals the
    reference's telemetry of the same rollout."""
    tree = _tree(N, seed=0)
    tp = interop.params_from_numpy(tree, "cpu")
    ext = _ext(N, T, seed=3)
    st0 = t_net.SNNState.zeros((), N, max_delay=D, device="cpu")
    f_off, r_off = t_net.rollout(tp, st0, torch.as_tensor(ext), T, backend=backend)
    f_on, r_on, tel = t_net.rollout(tp, st0, torch.as_tensor(ext), T, backend=backend,
                                    telemetry=True)
    assert torch.equal(r_on, r_off) and r_on.sum() > 0, "a dead network proves nothing"
    _assert_same_state(f_on, f_off)
    assert int(tel.ticks) == T and float(tel.spikes) == float(r_on.sum())
    assert float(tel.dw_l1) == 0.0 and float(tel.dw_sq) == 0.0
    assert tel.ticks.shape == () and (int(tel.overflow) > 0) == (backend == "event")
    _, jr, jtel = j_net.rollout(_jax(tree), j_net.SNNState.zeros((), N, max_delay=D),
                                jnp.asarray(ext), T, backend=backend, telemetry=True)
    np.testing.assert_array_equal(r_on.numpy(), np.asarray(jr))
    _assert_leaves(tel, jtel)


def test_batched_leaves_per_row_match_reference():
    """A batch of three rows: per-row leaves equal the reference's batched
    telemetry, and per-row ``spikes`` are the rows' raster sums."""
    tree = _tree(N, seed=1)
    ext = _ext(N, T, (3,), seed=5)
    _, r, tel = t_net.rollout(interop.params_from_numpy(tree, "cpu"),
                              t_net.SNNState.zeros((3,), N, max_delay=D, device="cpu"),
                              torch.as_tensor(ext), T, telemetry=True)
    assert tel.spikes.shape == (3,)
    assert torch.equal(tel.spikes, r.sum((0, 2)))
    _, _, jtel = j_net.rollout(_jax(tree), j_net.SNNState.zeros((3,), N, max_delay=D),
                               jnp.asarray(ext), T, telemetry=True)
    _assert_leaves(tel, jtel)


def test_summary_key_for_key():
    """``summary`` has the reference's keys, exact counts and equal floats."""
    tree = _tree(N, seed=2)
    ext = _ext(N, T, (2,), seed=3)
    _, raster, tel = t_net.rollout(interop.params_from_numpy(tree, "cpu"),
                                   t_net.SNNState.zeros((2,), N, max_delay=D, device="cpu"),
                                   torch.as_tensor(ext), T, backend="event", telemetry=True)
    _, _, jtel = j_net.rollout(_jax(tree), j_net.SNNState.zeros((2,), N, max_delay=D),
                               jnp.asarray(ext), T, backend="event", telemetry=True)
    got, want = tel.summary(N), jtel.summary(N)
    assert list(got) == list(want)
    for k in ("ticks", "spikes", "overflow_ticks", "policy_dense_ticks", "dw_l1", "dw_l2"):
        assert got[k] == want[k], k
    for k in ("spike_rate", "v_mean", "v_max", "refractory_occupancy"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert got["spike_rate"] == pytest.approx(float(raster.mean()))
    assert got["overflow_ticks"] > 0


def _learning_net(n, seed):
    """``tests/test_torch_learning.py``'s fabric: a two-layer mask, weights in
    [1, 3), a doubling input, unit thresholds."""
    rng = np.random.default_rng(seed)
    c = connectivity.layered([n // 2, n - n // 2]).astype(np.float32)
    tree = {"w": rng.uniform(1.0, 3.0, (n, n)).astype(np.float32), "c": c,
            "w_in": np.eye(n, dtype=np.float32) * 2.0,
            "lif.v_th": np.ones(n, np.float32), "lif.leak": np.zeros(n, np.float32),
            "lif.r_ref": np.zeros(n, np.int32), "lif.gain": np.ones(n, np.float32),
            "lif.i_bias": np.zeros(n, np.float32), "lif.v_reset": np.zeros(n, np.float32)}
    ext = np.tile((rng.random((2, n)) < 0.7) * (np.arange(n) < n // 2),
                  (9, 1, 1)).astype(np.float32)
    return tree, ext


@pytest.mark.parametrize("backend,rule", [("jnp", "stdp"), ("pallas", "rstdp"),
                                          ("pallas_fused", "stdp"), ("event", "rstdp")])
def test_learning_dw_matches_reference(backend, rule):
    """A learning rollout with telemetry: the learned weights, traces and
    raster bitwise as with it off; ``dw_l1``/``dw_sq`` (kernel B5's statistics
    through its twin on the kernel backends, ``w' - w`` on ``jnp``) equal the
    reference's to ``rtol=1e-5``, and the other leaves as above."""
    n, ticks, b = 12, 9, 2
    tree, ext = _learning_net(n, seed=len(backend))
    rewards = np.random.default_rng(3).uniform(-1, 1, ticks).astype(np.float32)
    kw = dict(a_plus=0.5, a_minus=0.2, lr_reward=0.8)
    tp = interop.params_from_numpy(tree, "cpu")

    def run(telemetry):
        eng = TickEngine(EngineOptions(backend=backend, telemetry=telemetry,
                                       plasticity=PlasticityParams.make(rule, **kw)))
        return eng.learning_rollout(tp, t_net.SNNState.zeros((b,), n, device="cpu"),
                                    PlasticityState.zeros((b,), n, device="cpu"),
                                    torch.as_tensor(ext), ticks,
                                    rewards=torch.as_tensor(rewards))

    (f0, p0, w0), r0 = run(False)
    (f1, p1, w1), r1, tel = run(True)
    assert torch.equal(r0, r1) and torch.equal(w0, w1) and torch.equal(p0.elig, p1.elig)
    assert torch.equal(p0.x_pre, p1.x_pre) and torch.equal(f0.lif.v, f1.lif.v)
    assert torch.equal(tel.spikes, r1.sum((0, 2)))
    j_eng = JEngine(JOptions(backend=backend, telemetry=True,
                             plasticity=JPP.make(rule, **kw)))
    _, jr, jtel = j_eng.learning_rollout(_jax(tree), j_net.SNNState.zeros((b,), n),
                                         JPS.zeros((b,), n), jnp.asarray(ext), ticks,
                                         rewards=jnp.asarray(rewards))
    np.testing.assert_array_equal(r1.numpy(), np.asarray(jr))
    _assert_leaves(tel, jtel, dw=True)


def test_chunks_carry_telemetry():
    """Two chunks of a learning carry accumulate what one rollout does, and
    the caller's carry is never written."""
    n, b = 12, 2
    tree, ext = _learning_net(n, seed=4)
    tp = interop.params_from_numpy(tree, "cpu")
    eng = TickEngine(EngineOptions(backend="pallas_fused", telemetry=True,
                                   plasticity=PlasticityParams.make("stdp", a_plus=0.5,
                                                                    a_minus=0.2)))
    st0 = t_net.SNNState.zeros((b,), n, device="cpu")
    pst0 = PlasticityState.zeros((b,), n, device="cpu")
    _, _, tel = eng.learning_rollout(tp, st0, pst0, torch.as_tensor(ext), 9)
    carry = eng.init_learning_carry(tp, st0, pst0)
    half, _ = eng.chunk(tp, carry, torch.as_tensor(ext[:4]), 4)
    assert carry.telem is None and int(half.telem.ticks[0]) == 4
    seen = half.telem.clone()
    full, _ = eng.chunk(tp, half, torch.as_tensor(ext[4:]), 5)
    for f in ("ticks", "spikes", "v_max", "overflow", "dw_l1", "dw_sq", "v_sum", "ref_sum"):
        assert torch.equal(getattr(half.telem, f), getattr(seen, f)), f
        np.testing.assert_allclose(getattr(full.telem, f).numpy(), getattr(tel, f).numpy(),
                                   rtol=1e-6, err_msg=f)


# -- the event arm's counters on a slot axis ---------------------------------

SLOT_N, SLOT_B = 64, 2
BUSY = [2, 12, 6, 6, 3, 10, 20, 5, 2, 9, 7, 4, 1]
QUIET = [1, 2, 3, 0, 2, 3, 1, 2, 3, 1, 0, 2, 3]
SLOT_CASES = {
    # name: (engine options, fan-in lists?)
    "overflow": (dict(event_k_active=8), False),
    "knee": (dict(event_k_active=16, event_knee=8, event_hysteresis=0.5), False),
    "fan_in": (dict(event_dispatch="fan_in"), True),
}


def _slot_tree(seed):
    rng = np.random.default_rng(seed)
    c = (rng.random((SLOT_N, SLOT_N)) < 0.05).astype(np.float32)
    return {"w": rng.integers(0, 4, (SLOT_N, SLOT_N)).astype(np.float32), "c": c,
            "w_in": np.eye(SLOT_N, dtype=np.float32),
            "lif.v_th": np.full(SLOT_N, 100.0, np.float32),
            "lif.leak": np.full(SLOT_N, 8.0, np.float32),
            "lif.r_ref": np.zeros(SLOT_N, np.int32), "lif.gain": np.ones(SLOT_N, np.float32),
            "lif.i_bias": np.zeros(SLOT_N, np.float32),
            "lif.v_reset": np.zeros(SLOT_N, np.float32)}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_event_counts_per_slot_match_reference(case):
    """Two networks on a slot axis, one busy and one quiet: each slot's
    ``overflow`` and ``policy_dense`` (and every other leaf) equal the
    reference's telemetry of that network alone; the fan-in gather counts
    nothing."""
    opts, fan = SLOT_CASES[case]
    trees = [_slot_tree(70 + i) for i in range(2)]
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    ext = np.zeros((len(BUSY), 2, SLOT_B, SLOT_N), np.float32)
    for i, sched in enumerate((BUSY, QUIET)):
        for t, m in enumerate(sched):
            ext[t, i, :, :m] = 200.0
    kw = {}
    if fan:
        cap = int(max(t["c"].sum(0).max() for t in trees))
        lists = [t_ops.EventFanIn.from_dense(t["c"], cap=cap, device="cpu") for t in trees]
        kw["neighbors"] = t_ops.EventFanIn(idx=torch.stack([f.idx for f in lists]),
                                           mask=torch.stack([f.mask for f in lists]))
    eng = TickEngine(EngineOptions(backend="event", telemetry=True, **opts))
    _, _, tel = eng.rollout(interop.params_from_numpy(stacked, "cpu"),
                            t_net.SNNState.zeros((2, SLOT_B), SLOT_N, device="cpu"),
                            torch.as_tensor(ext), len(BUSY), **kw)
    assert tel.overflow.shape == (2, SLOT_B)
    for i, tree in enumerate(trees):
        jkw = {}
        if fan:
            jkw["neighbors"] = j_ops.EventFanIn.from_dense(tree["c"], cap)
        _, _, jtel = JEngine(JOptions(backend="event", telemetry=True, **opts)).rollout(
            _jax(tree), j_net.SNNState.zeros((SLOT_B,), SLOT_N), jnp.asarray(ext[:, i]),
            len(BUSY), **jkw)
        _assert_leaves(TickTelemetry(**{f: getattr(tel, f)[i] for f in
                                        ("ticks", "spikes", "v_sum", "v_max", "ref_sum",
                                         "overflow", "policy_dense", "dw_l1", "dw_sq")}),
                       jtel)
    dense = (tel.overflow + tel.policy_dense)[:, 0].tolist()
    assert dense[1] == 0 and (dense[0] > 0) == (case != "fan_in")
    assert (int(tel.policy_dense.sum()) > 0) == (case == "knee")


# -- the telemetry kernel's wrapper ------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("on", [True, False])
def test_wrapper_runs_once_per_tick(monkeypatch, backend, on):
    """The engine folds each tick in through the telemetry wrapper: exactly T
    calls a rollout with the flag on, none with it off."""
    calls = []
    real = t_telemetry.tick_telemetry

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(t_telemetry, "tick_telemetry", counted)
    tp = interop.params_from_numpy(_tree(N, seed=0), "cpu")
    out = t_net.rollout(tp, t_net.SNNState.zeros((2,), N, max_delay=D, device="cpu"),
                        torch.as_tensor(_ext(N, T, (2,), seed=1)), T, backend=backend,
                        telemetry=on)
    assert len(out) == (3 if on else 2) and len(calls) == (T if on else 0)


def _case(rng, S, B, n, *, grid):
    """A post-tick state on a slot axis, flags and dw partials."""
    if grid:
        v = rng.integers(-300, 3000, (S, B, n)).astype(np.float32)
    else:
        v = rng.normal(0, 50, (S, B, n)).astype(np.float32)
    return dict(y=(rng.random((S, B, n)) < 0.3).astype(np.float32), v=v,
                r=rng.integers(0, 3, (S, B, n)).astype(np.int32),
                over=rng.random(S) < 0.5, take_dense=rng.random(S) < 0.5,
                dw=rng.uniform(0, 10, (S, 5, 2)).astype(np.float32))


def _check_kernel_case(dev, case, S, B, n, *, bitwise_v):
    """The wrapper on ``dev`` against :meth:`TickTelemetry.accumulate` (the
    twin) on the same device, three ticks from a random start."""
    t = {k: torch.as_tensor(a, device=dev) for k, a in case.items()}
    rng = np.random.default_rng(9)
    start = TickTelemetry.zeros((S, B), dev).copy_(TickTelemetry(
        ticks=torch.as_tensor(rng.integers(0, 9, (S, B)), dtype=torch.int32, device=dev),
        spikes=torch.as_tensor(rng.integers(0, 99, (S, B)), dtype=torch.float32, device=dev),
        v_sum=torch.as_tensor(rng.normal(size=(S, B)), dtype=torch.float32, device=dev),
        v_max=torch.zeros((S, B), device=dev),
        ref_sum=torch.as_tensor(rng.uniform(size=(S, B)), dtype=torch.float32, device=dev),
        overflow=torch.zeros((S, B), dtype=torch.int32, device=dev),
        policy_dense=torch.zeros((S, B), dtype=torch.int32, device=dev),
        dw_l1=torch.zeros((S, B), device=dev), dw_sq=torch.zeros((S, B), device=dev)))
    got, want = start.clone(), start.clone()
    for _ in range(3):
        t_telemetry.tick_telemetry(got, t["y"], t["v"], t["r"], over=t["over"],
                                   take_dense=t["take_dense"], dw_stats=t["dw"])
        want = want.accumulate(LIFState(v=t["v"], r=t["r"], y=t["y"]),
                               overflow_inc=t["over"].to(torch.int32),
                               policy_inc=(t["take_dense"] & ~t["over"]).to(torch.int32),
                               dw_stats=t["dw"])
    for f in ("ticks", "spikes", "v_max", "ref_sum", "overflow", "policy_dense"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("dw_l1", "dw_sq"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=1e-6, atol=0)
    if bitwise_v:
        assert torch.equal(got.v_sum, want.v_sum)
    else:
        # A reordered f32 sum over the neurons: 1e-6 of the magnitudes summed.
        scale = want.v_sum.abs() + 3 * t["v"].abs().mean(-1)
        assert bool(((got.v_sum - want.v_sum).abs() <= 1e-6 * scale).all())
    return got


def test_wrapper_twin_per_slot_flags():
    """The wrapper's CPU path: per-slot flags and dw partials go to their own
    slot's rows only, and the counts match a hand count."""
    rng = np.random.default_rng(0)
    S, B, n = 3, 2, 37
    case = _case(rng, S, B, n, grid=True)
    got = _check_kernel_case(torch.device("cpu"), case, S, B, n, bitwise_v=True)
    over, dense = case["over"], case["take_dense"]
    np.testing.assert_array_equal(got.overflow[:, 0].numpy(), 3 * over)
    np.testing.assert_array_equal(got.policy_dense[:, 1].numpy(), 3 * (dense & ~over))
    np.testing.assert_allclose(got.dw_l1[:, 1].numpy(), 3 * case["dw"][:, :, 0].sum(1),
                               rtol=1e-6)


def test_b5_twin_dw_stats():
    """Kernel B5's twin (through its wrapper on CPU tensors) returns per
    matrix ``sum |w' - w|`` and ``sum (w' - w)^2`` of the committed update:
    zero in a slot whose gate is closed, and the learned tensors equal the
    call without statistics."""
    rng = np.random.default_rng(1)
    S, B, K, Nn = 2, 2, 9, 7
    f = lambda *shape: torch.as_tensor(rng.random(shape).astype(np.float32))
    args = (torch.as_tensor((rng.random((S, B, K)) < 0.5).astype(np.float32)), f(S, B, K),
            torch.as_tensor((rng.random((S, B, Nn)) < 0.5).astype(np.float32)), f(S, B, Nn),
            f(S, K, Nn) * 100, (f(S, K, Nn) < 0.6).float(), f(S, K, Nn), torch.tensor(0.5))
    hyper = dict(rule="rstdp", a_plus=0.5, a_minus=0.25, decay_pre=0.9, decay_post=0.8,
                 decay_elig=0.7, lr_reward=2.0, w_min=0.0, w_max=100.0,
                 tick=torch.tensor(3, dtype=torch.int32),
                 learn_until=torch.tensor([5, 0], dtype=torch.int32))
    plain = stdp_update.fused_stdp_step(*args, **hyper)
    out, stats = stdp_update.fused_stdp_step(*args, dw_stats=True, **hyper)
    assert all(torch.equal(a, b) for a, b in zip(plain, out))
    dw = out.w - args[4]
    assert stats.shape == (S, 1, 2)
    torch.testing.assert_close(stats[:, 0, 0], dw.abs().sum((1, 2)), rtol=1e-6, atol=0)
    torch.testing.assert_close(stats[:, 0, 1], (dw * dw).sum((1, 2)), rtol=1e-6, atol=0)
    assert float(stats[0, 0, 0]) > 0 and stats[1].abs().sum() == 0
    _, twin = fused_stdp_step_ref(*args, dw_stats=True, **hyper)
    assert torch.equal(twin, stats)


@pytest.mark.cuda
def test_cuda_telemetry_kernel_and_b5_stats():
    """On the card: the telemetry kernel against its twin at 8 slots x 4096
    and at a ragged width (37), bitwise (``v_sum`` bitwise on the integer
    grid, on normal floats to 1e-6 of the magnitudes summed); kernel B5's dw
    statistics against the twin's to ``rtol=1e-5``, two launches bitwise
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the telemetry kernel and kernel B5 are CUDA for "
                    "sm_90a and have no CPU mode (their twins are tested above)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for S, B, n in ((8, 1, 4096), (3, 2, 37)):
        for grid in (True, False):
            _check_kernel_case(dev, _case(rng, S, B, n, grid=grid), S, B, n, bitwise_v=grid)
    g = torch.Generator(device=dev).manual_seed(0)
    S, B, K, Nn = 8, 1, 4096, 4096
    r = lambda *shape: torch.rand(shape, generator=g, device=dev)
    args = ((r(S, B, K) < 0.2).float(), r(S, B, K), (r(S, B, Nn) < 0.2).float(), r(S, B, Nn),
            r(S, K, Nn) * 255, (r(S, K, Nn) < 0.5).float(), r(S, K, Nn),
            torch.tensor(0.5, device=dev))
    hyper = dict(rule="stdp", a_plus=0.5, a_minus=0.25, decay_pre=0.9, decay_post=0.8,
                 decay_elig=0.7, lr_reward=2.0, w_min=0.0, w_max=255.0)
    _, stats = stdp_update.fused_stdp_step(*args, dw_stats=True, **hyper)
    _, again = stdp_update.fused_stdp_step(*args, dw_stats=True, **hyper)
    _, twin = fused_stdp_step_ref(*args, dw_stats=True, **hyper)
    assert torch.equal(stats, again)
    torch.testing.assert_close(stats.sum(1), twin.sum(1), rtol=1e-5, atol=0)


# -- host side: the copies, tracing, the server ---------------------------------


@pytest.mark.parametrize("name", ["log.py", "metrics.py"])
def test_host_modules_are_byte_for_byte_copies(name):
    """``obs/log.py`` and ``obs/metrics.py`` import no JAX in the reference:
    the port carries them byte for byte."""
    ref = (ROOT / "src" / "repro" / "obs" / name).read_bytes()
    assert (ROOT / "src" / "repro_torch" / "obs" / name).read_bytes() == ref


def test_span_observes_into_histogram_and_scope_toggles():
    reg = MetricsRegistry()
    h = reg.histogram("t_seconds", "a span", ("what",))
    with span("unit/span", histogram=h, what="x"):
        pass
    with span("unit/span"):
        pass
    assert h.count(what="x") == 1 and h.sum(what="x") >= 0.0
    assert not tracing.profiling()
    with trace_scope("unit/off", enabled=False):
        pass


def test_event_log_mirrors_json_lines():
    import io

    buf = io.StringIO()
    ev = EventLog(stream=buf)
    ev.emit("x", a=1)
    assert json.loads(buf.getvalue())["a"] == 1 and ev.events("x")[0]["event"] == "x"


SERVE = dict(n_max=32, slots=4, max_ticks=10)


@pytest.fixture(scope="module")
def served():
    """The demo tenants and requests through the reference's server and the
    port's (``jnp``, the event program for sparse tenants), with one request
    for an unknown tenant."""
    out = []
    for mod, kw in ((j_serve, {}), (t_serve, {"device": "cpu"})):
        server = mod.SNNServer(backend="jnp", event_density=0.2, **SERVE, **kw)
        names = mod.make_demo_tenants(server, 8, seed=0)
        reqs = mod.make_demo_requests(server, names, 12, seed=1)
        reqs.append(mod.ServeRequest(rid=99, tenant="nobody", ext=np.zeros((2, 2), np.float32),
                                     n_ticks=2))
        stats = server.serve(reqs)
        out.append((server, stats))
    return out


def test_server_registry_matches_reference(served):
    """Every instrument the reference registers, under its name, help string,
    labels and kind; counters and gauges at equal values (the weight-delta
    counter to ``rel=1e-5``; the goodput gauges, wall-time rates, only
    present), histogram counts equal."""
    (js, jstats), (ts, tstats) = served
    jd, td = js.registry.to_dict(), ts.registry.to_dict()
    assert sorted(jd) == sorted(td)
    for name, want in jd.items():
        got = td[name]
        assert {k: v for k, v in got.items() if k != "values"} == {
            k: v for k, v in want.items() if k != "values"}, name
        assert list(got["values"]) == list(want["values"]), name
        for labels, w in want["values"].items():
            g = got["values"][labels]
            if want["type"] == "histogram":
                assert g["count"] == w["count"], (name, labels)
            elif name not in ("snn_slot_ticks_per_s", "snn_goodput_slot_ticks_per_s"):
                assert g == pytest.approx(w, rel=1e-5), (name, labels)
    assert td["snn_requests_total"]["values"][""] == 12
    assert td["snn_requests_rejected_total"]["values"][""] == 1
    assert td["snn_weight_delta_l1_total"]["values"][""] > 0
    assert tstats["preds"] == jstats["preds"]
    prom = ts.registry.to_prometheus()
    assert "# TYPE snn_wave_seconds histogram" in prom and 'backend="event"' in prom


def test_tenant_report_matches_reference(served):
    """``tenant_report`` field for field: counts exact, floats to ``rel=1e-6``,
    ``dw_l1`` to ``rel=1e-5``."""
    (js, _), (ts, _) = served
    want, got = js.tenant_report(), ts.tenant_report()
    assert list(got) == list(want) and got
    for name, row in want.items():
        assert list(got[name]) == list(row), name
        for k, v in row.items():
            if isinstance(v, float):
                tol = 1e-5 if k == "dw_l1" else 1e-6
                assert got[name][k] == pytest.approx(v, rel=tol, abs=1e-9), (name, k)
            else:
                assert got[name][k] == v, (name, k)
    assert any(r["plastic"] and r["dw_l1"] > 0 for r in got.values())
    assert {r["backend"] for r in got.values()} == {"jnp", "event"}


def test_cli_prints_report_and_writes_metrics(tmp_path, capsys):
    out = tmp_path / "metrics.json"
    stats = t_serve.main(["--arch", "snn", "--smoke", "--device", "cpu", "--requests", "9",
                          "--slots", "8", "--metrics-out", str(out)])
    text = capsys.readouterr().out
    assert "per-tenant activity (wave telemetry):" in text
    assert "# TYPE snn_requests_total counter" in text and "telemetry=" in text
    dumped = json.loads(out.read_text())
    assert dumped["snn_requests_total"]["values"][""] == stats["n_requests"]
