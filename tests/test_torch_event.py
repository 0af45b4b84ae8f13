"""The port's event backend against the JAX package's.

The same numpy inputs go to the reference and to the port: the twin of
kernels B3 / B4 (``ref.event_lif_dispatch_ref``, which the kernel wrappers
run on CPU tensors), the event bridges in ``kernels/ops.py``, the engine's
event arm in every strategy (``topk`` with overflow fallback / strict /
unchecked, the adaptive knee, ``fan_in``, ``dense``), the diagonal drive,
per-synapse delays, learning, and ``network.rollout(dispatch=...)``.

Tolerances, stated per test:

* u8-grid inputs (integer weights, 0/1 spikes, integer state, drive and
  thresholds, dyadic Euler leak): every f32 sum is exact in any order, so
  the port equals the reference **bitwise**;
* uniform-random f32 weights: the twin sums its rows in ascending slot
  order, as the reference's kernels do, but the reference is itself one ulp
  off its own jnp event path there (its interpreted double-buffered kernel
  against ``use_kernel=False``), so the twin is held to ``atol=1e-6,
  rtol=0`` on ``v`` and exactly on ``r`` and ``y``;
* learning: rasters equal, weights within ``rtol=atol=1e-5`` (the
  reference's own tolerance between its learning backends).

The CUDA kernels themselves run only on an NVIDIA GPU: ``test_cuda_*`` are
marked ``cuda`` and skip here; ``chip_smoke.py`` holds them against the
twin on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectivity as j_conn
from repro.core import network as j_net
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import TickCarry as JCarry
from repro.core.engine import TickEngine as JEngine
from repro.core.lif import LIFParams as JLIFParams
from repro.core.lif import LIFState as JLIFState
from repro.kernels import event_dispatch as j_ev
from repro.kernels import ops as j_ops
from repro.plasticity import PlasticityParams as JPlast
from repro.plasticity import PlasticityState as JPlastState
from repro_torch import interop
from repro_torch.core import network as t_net
from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
from repro_torch.core.lif import LIFState
from repro_torch.kernels import event_dispatch as t_ev
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.plasticity import PlasticityParams, PlasticityState

ROWS = ("v_th", "leak", "r_ref", "gain", "i_bias", "v_reset")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(n, seed, *, density=0.15, grid=True, euler=False, v_th=(150, 700)):
    """Network leaves as numpy: u8-grid (integer weights and thresholds,
    dyadic leak) or the reference's float case (uniform weights)."""
    rng = np.random.default_rng(seed)
    c = (rng.random((n, n)) < density).astype(np.float32)
    if grid:
        w = rng.integers(0, 256, (n, n)).astype(np.float32)
        v_th_row = rng.integers(*v_th, n).astype(np.float32)
        leak = np.full(n, 0.25) if euler else rng.integers(0, 9, n)
    else:
        w = rng.uniform(0, 1, (n, n)).astype(np.float32)
        v_th_row = np.full(n, 0.8, np.float32)
        leak = np.full(n, 0.2)
    return {
        "w": w, "c": c, "w_in": np.eye(n, dtype=np.float32),
        "lif.v_th": v_th_row, "lif.leak": np.asarray(leak, np.float32),
        "lif.r_ref": rng.integers(0, 3, n).astype(np.int32),
        "lif.gain": np.ones(n, np.float32), "lif.i_bias": np.zeros(n, np.float32),
        "lif.v_reset": np.zeros(n, np.float32),
    }


def _jax_params(t):
    return j_net.SNNParams(
        w=jnp.asarray(t["w"]), c=jnp.asarray(t["c"]), w_in=jnp.asarray(t["w_in"]),
        lif=JLIFParams(**{k: jnp.asarray(t[f"lif.{k}"]) for k in ROWS}))


def _state(b, n, seed, *, grid=True):
    rng = np.random.default_rng(seed)
    v = (rng.integers(-20, 400, (b, n)) if grid else rng.normal(size=(b, n))).astype(np.float32)
    return v, rng.integers(0, 3, (b, n)).astype(np.int32)


def _spikes(b, n, rate, seed):
    return (np.random.default_rng(seed).random((b, n)) < rate).astype(np.float32)


def _drive(ticks, batch, n, seed, p=0.3, lo=60, hi=256):
    rng = np.random.default_rng(seed)
    shape = (ticks,) + tuple(batch) + (n,)
    return ((rng.random(shape) < p) * rng.integers(lo, hi, shape)).astype(np.float32)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _assert_lif(got, want, *, atol=0.0):
    """``got`` (torch) against ``want`` (jax): ``r`` and ``y`` exactly, ``v``
    bitwise (``atol=0``) or to ``atol`` with ``rtol=0``."""
    if atol:
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    np.testing.assert_array_equal(got.r.numpy(), np.asarray(want.r))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))


def _twin(tree, s, v, r, drive, k, *, walk, mode):
    """The port's twin of B3 / B4 on the spike list the port's bridge builds."""
    wc = _t(tree["w"] * tree["c"])
    if walk == "all":
        wc = t_ops.sentinel_rows(wc)
    idx, counts, _ = t_ops.spike_list(_t(s), k)
    rows = [_t(tree[f"lif.{k_}"]) for k_ in ROWS]
    return t_ref.event_lif_dispatch_ref(idx, counts, wc, _t(v), _t(r),
                                        None if drive is None else _t(drive), *rows,
                                        mode=mode, walk=walk)


# -- the twin of kernels B3 / B4 ----------------------------------------------------


@pytest.mark.parametrize("walk", ["live", "all"])
@pytest.mark.parametrize("mode", ["fixed_leak", "euler"])
@pytest.mark.parametrize("grid,with_drive", [(True, True), (True, False), (False, True)])
def test_twin_matches_reference_jnp_event_path(walk, mode, grid, with_drive):
    """Twin vs the reference's ``ops.event_lif_step(use_kernel=False)``
    (jitted, as its own tests run it): bitwise on the u8 grid, ``atol=1e-6``
    on uniform floats."""
    b, n, k = 5, 70, 24
    tree = _tree(n, seed=1, grid=grid, euler=mode == "euler")
    s = _spikes(b, n, 0.15, seed=2)
    v, r = _state(b, n, seed=3, grid=grid)
    drive = _drive(1, (b,), n, seed=4)[0] if with_drive else None
    jp = _jax_params(tree)
    want = jax.jit(lambda l, sp, e: j_ops.event_lif_step(
        l, sp, jp, e, jp.w * jp.c, k_active=k, mode=mode, use_kernel=False))(
        JLIFState(v=jnp.asarray(v), r=jnp.asarray(r), y=jnp.zeros((b, n))),
        jnp.asarray(s), None if drive is None else jnp.asarray(drive))
    got = _twin(tree, s, v, r, drive, k, walk=walk, mode=mode)
    assert s.sum(-1).max() <= k and float(got.y.sum()) > 0
    _assert_lif(got, want, atol=0.0 if grid else 1e-6)


@pytest.mark.parametrize("kernel", ["grid", "db"])
@pytest.mark.parametrize("grid", [True, False])
def test_twin_matches_reference_interpreted_kernels(kernel, grid):
    """Twin vs the reference's Pallas kernels in interpret mode (B4 ``grid``,
    B3 ``db``) on the same spike list, with zero-spike rows, ragged counts
    and a row at exactly ``k``: bitwise on the u8 grid, ``atol=1e-6`` on
    uniform floats."""
    b, n, k = 4, 128, 12
    tree = _tree(n, seed=5, grid=grid)
    s = _spikes(b, n, 0.06, seed=6)
    s[0] = 0.0                                  # a silent row
    s[1] = 0.0
    s[1, np.random.default_rng(7).choice(n, size=k, replace=False)] = 1.0   # exactly k
    v, r = _state(b, n, seed=8, grid=grid)
    drive = _drive(1, (b,), n, seed=9)[0]
    idx, counts, _ = t_ops.spike_list(_t(s), k)
    assert counts.tolist()[:2] == [0, k] and len(set(counts.tolist())) > 2
    wc_s = np.concatenate([tree["w"] * tree["c"], np.zeros((1, n), np.float32)])
    rows = [jnp.asarray(tree[f"lif.{k_}"]) for k_ in ROWS]
    args = (jnp.asarray(idx.numpy()), jnp.asarray(wc_s), jnp.asarray(v), jnp.asarray(r),
            jnp.asarray(drive), *rows)
    if kernel == "grid":
        out = j_ev.event_lif_dispatch(*args, interpret=True)
    else:
        out = j_ev.event_lif_dispatch_db(*args, counts=jnp.asarray(counts.numpy()),
                                         interpret=True)
    want = JLIFState(v=out[0], r=out[1], y=out[2])
    got = _twin(tree, s, v, r, drive, k, walk="all" if kernel == "grid" else "live",
                mode="fixed_leak")
    _assert_lif(got, want, atol=0.0 if grid else 1e-6)


def test_spike_list_is_the_reference_top_k():
    """The stable compaction gives the reference bridge's spike list: the
    first ``k`` spiking ids ascending, then the sentinel ``K``; counts
    truncated at ``k``."""
    b, n, k = 6, 40, 7
    s = _spikes(b, n, 0.2, seed=10)
    s[0] = 1.0                                  # overflows k
    s[1] = 0.0
    vals, top = jax.lax.top_k(jnp.asarray(s), k)
    want_idx = np.where(np.asarray(vals) > 0, np.asarray(top), n)
    idx, counts, n_spiking = t_ops.spike_list(_t(s), k)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(counts.numpy(), (np.asarray(vals) > 0).sum(-1))
    np.testing.assert_array_equal(n_spiking.numpy(), s.sum(-1).astype(np.int32))
    assert idx.dtype == counts.dtype == torch.int32


def test_wrappers_gate_and_write_into_out():
    """On CPU tensors the wrappers run the twin; the device gate leaves
    ``out`` as it was where closed, B1's ``run_if`` opens where B3's ``skip``
    closes, and the premasked B1 (``c=None``) equals the masked one."""
    from repro_torch.kernels import lif_step as t_b1

    b, n, k = 3, 50, 16
    tree = _tree(n, seed=11)
    s, (v, r) = _spikes(b, n, 0.2, seed=12), _state(b, n, seed=13)
    rows = [_t(tree[f"lif.{k_}"]) for k_ in ROWS]
    wc = _t(tree["w"] * tree["c"])
    idx, counts, _ = t_ops.spike_list(_t(s), k)
    want = t_ref.event_lif_dispatch_ref(idx, counts, wc, _t(v), _t(r), None, *rows)
    dense = t_b1.fused_lif_step(_t(s), _t(tree["w"]), _t(tree["c"]), _t(v), _t(r), None,
                                *rows)
    for flag in (False, True):
        gate = torch.tensor(flag)
        out = t_ref.LIFStepOut(torch.full((b, n), -7.0), torch.full((b, n), 9, dtype=torch.int32),
                               torch.full((b, n), 3.0))
        t_ev.event_lif_dispatch_db(idx, wc, _t(v), _t(r), None, *rows, counts=counts,
                                   skip=gate, out=out)
        expect = torch.full((b, n), -7.0) if flag else want.v
        assert torch.equal(out.v, expect)
        t_b1.fused_lif_step(_t(s), wc, None, _t(v), _t(r), None, *rows, run_if=gate, out=out)
        for got, ref_ in zip(out, dense if flag else want):
            assert torch.equal(got, ref_)
    with pytest.raises(ValueError, match="needs out"):
        t_ev.event_lif_dispatch(idx, wc, _t(v), _t(r), None, *rows, skip=torch.tensor(True))
    with pytest.raises(ValueError, match="kernels support"):
        t_ev.event_lif_dispatch_db(idx, wc, _t(v), _t(r), None, *rows, counts=counts,
                                   mode="int")


# -- the bridges ---------------------------------------------------------------------


@pytest.mark.parametrize("overflow", ["fallback", "unchecked"])
def test_event_synaptic_input_overflow_modes(overflow):
    """Fallback is exact past ``k_active``; unchecked reproduces the
    reference's truncation (bitwise, u8 grid)."""
    b, n, k = 4, 48, 5
    tree = _tree(n, seed=14)
    s = _spikes(b, n, 0.4, seed=15)
    wc = tree["w"] * tree["c"]
    want = j_ops.event_synaptic_input(jnp.asarray(s), jnp.asarray(wc), k_active=k,
                                      overflow=overflow)
    got = t_ops.event_synaptic_input(_t(s), _t(wc), k_active=k, overflow=overflow)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dense = s @ wc
    assert np.array_equal(got.numpy(), dense) == (overflow == "fallback")


@pytest.mark.parametrize("grid", [True, False])
def test_event_spike_matmul_equals_its_oracle(grid):
    """Below the spike budget the gathered product equals the event oracle
    (the dense masked product) and the reference's oracle: bitwise on the u8
    grid, ``atol=1e-6`` (rtol 0) on uniform floats."""
    from repro.kernels import ref as j_ref

    b, n, k = 5, 48, 12
    tree = _tree(n, seed=17, grid=grid)
    w, c = tree["w"], tree["c"]
    s = _spikes(b, n, 0.15, seed=18)
    s[:, k:] = 0.0                              # no row past k_active
    s[0] = 0.0
    got = t_ops.event_spike_matmul(_t(s), _t(w), _t(c), k_active=k)
    oracle = t_ref.event_spike_matmul_ref(_t(s), _t(w), _t(c), k)
    want = j_ref.event_spike_matmul_ref(jnp.asarray(s), jnp.asarray(w), jnp.asarray(c), k)
    atol = 0.0 if grid else 1e-6
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_strict_overflow_raises_as_the_reference_does():
    """``strict``: the reference fails under checkify, the port raises
    ``EventOverflowError``; below the budget both return the product."""
    from jax.experimental import checkify

    b, n, k = 2, 32, 4
    tree = _tree(n, seed=16)
    w, c = tree["w"], tree["c"]
    fn = checkify.checkify(lambda s: j_ops.event_spike_matmul(
        s, jnp.asarray(w), jnp.asarray(c), k_active=k, overflow="strict"))
    ok = np.zeros((b, n), np.float32)
    ok[:, :k] = 1.0
    err, want = fn(jnp.asarray(ok))
    err.throw()
    got = t_ops.event_spike_matmul(_t(ok), _t(w), _t(c), k_active=k, overflow="strict")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    err, _ = fn(jnp.ones((b, n)))
    with pytest.raises(Exception, match="event dispatch overflow"):
        err.throw()
    with pytest.raises(t_ops.EventOverflowError, match="event dispatch overflow"):
        t_ops.event_spike_matmul(torch.ones((b, n)), _t(w), _t(c), k_active=k,
                                 overflow="strict")
    with pytest.raises(ValueError, match="overflow"):
        t_ops.event_synaptic_input(torch.ones((1, 8)), torch.ones((8, 8)), overflow="typo")


@pytest.mark.parametrize("slotted", [False, True])
def test_fan_in_gather_matches_reference(slotted):
    """The fan-in gather (shared lists, or per-slot lists with a slot axis)
    equals the reference's per network, bitwise on the u8 grid."""
    n, b = 40, 3
    trees = [_tree(n, seed=17 + i, density=0.12) for i in range(2)]
    spikes = [_spikes(b, n, 0.3, seed=20 + i) for i in range(2)]
    wants, fans = [], []
    for tree, s in zip(trees, spikes):
        fan = j_ops.EventFanIn.from_dense(tree["c"])
        fans.append(fan)
        wants.append(np.asarray(j_ops.event_synaptic_input(
            jnp.asarray(s), jnp.asarray(tree["w"] * tree["c"]), fan_in=fan)))
    if not slotted:
        fan = interop.fan_in_from_numpy(fans[0].idx, fans[0].mask, "cpu")
        got = t_ops.event_synaptic_input(_t(spikes[0]), _t(trees[0]["w"] * trees[0]["c"]),
                                         fan_in=fan)
        np.testing.assert_array_equal(got.numpy(), wants[0])
        ports = t_ops.EventFanIn.from_dense(_t(trees[0]["c"]))
        assert interop.fan_in_to_numpy(ports)[0].tolist() == np.asarray(fans[0].idx).tolist()
        return
    cap = max(int(f.idx.shape[1]) for f in fans)
    pad = lambda a: np.pad(np.asarray(a), ((0, 0), (0, cap - a.shape[1])))
    fan = interop.fan_in_from_numpy(np.stack([pad(f.idx) for f in fans]),
                                    np.stack([pad(f.mask) for f in fans]), "cpu")
    wc = _t(np.stack([t["w"] * t["c"] for t in trees]))
    got = t_ops.event_synaptic_input(_t(np.stack(spikes)), wc, fan_in=fan)
    np.testing.assert_array_equal(got.numpy(), np.stack(wants))


def test_event_lif_step_options():
    """``ext_diag`` equals the full drive product on a diagonal ``w_in``; the
    kernel path is inference-only and knows two variants, as the reference's."""
    b, n = 2, 16
    tree = _tree(n, seed=23)
    tree["w_in"] = np.diag(np.arange(1, n + 1)).astype(np.float32)
    p = interop.params_from_numpy(tree, "cpu")
    v, r = _state(b, n, seed=24)
    st = LIFState(v=_t(v), r=_t(r), y=torch.zeros((b, n)))
    s, ext = _t(_spikes(b, n, 0.3, seed=25)), _t(_drive(1, (b,), n, seed=26)[0])
    wc = p.w * p.c
    full = t_ops.event_lif_step(st, s, p, ext, wc)
    diag = t_ops.event_lif_step(st, s, p, ext, wc, ext_diag=True, kernel="grid")
    for a, b_ in zip((full.v, full.r, full.y), (diag.v, diag.r, diag.y)):
        assert torch.equal(a, b_)
    with pytest.raises(ValueError, match="inference-only"):
        t_ops.event_lif_step(st, s, p, None, wc, surrogate=True, use_kernel=True)
    with pytest.raises(ValueError, match="'db' or 'grid'"):
        t_ops.event_lif_step(st, s, p, None, wc, kernel="typo")
    assert t_ops.default_k_active(4096) == 512 and t_ops.default_k_active(20) == 8


# -- the engine's event arm ------------------------------------------------------------


def _rollouts(tree, ext, ticks, batch, j_opts, t_opts, *, max_delay=1, delays=None,
              neighbors=None):
    n = tree["w"].shape[0]
    jp = _jax_params(tree)
    jf, jr = JEngine(JOptions(**j_opts)).rollout(
        jp, j_net.SNNState.zeros(batch, n, max_delay=max_delay), jnp.asarray(ext), ticks,
        delays=None if delays is None else jnp.asarray(delays), neighbors=neighbors)
    tp = interop.params_from_numpy(tree, "cpu")
    t_nb = None if neighbors is None else interop.fan_in_from_numpy(
        neighbors.idx, neighbors.mask, "cpu")
    st0 = t_net.SNNState.zeros(batch, n, max_delay=max_delay, device="cpu")
    tf, tr = TickEngine(EngineOptions(**t_opts)).rollout(
        tp, st0, _t(ext), ticks, delays=None if delays is None else _t(delays),
        neighbors=t_nb)
    return (tf, tr), (jf, jr)


def _assert_rollout(t_out, j_out):
    (tf, tr), (jf, jr) = t_out, j_out
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    _assert_lif(tf.lif, jf.lif)
    np.testing.assert_array_equal(tf.delay_buf.numpy(), np.asarray(jf.delay_buf))
    assert int(tf.tick) == int(jf.tick)


@pytest.mark.parametrize("strategy,extra", [
    ("topk", {}), ("topk", {"event_kernel": "grid"}), ("topk", {"event_ext_diag": True}),
    ("auto", {}), ("dense", {}), ("dense", {"event_ext_diag": True}),
    ("fan_in", {}), ("fan_in", {"event_ext_diag": True}),
    ("topk", {"event_k_active": 3}),
])
@pytest.mark.parametrize("mode", ["fixed_leak", "euler"])
def test_engine_event_strategies_match_reference(strategy, extra, mode):
    """Every strategy of the event arm, rolled out at batch 2 over a depth-2
    ring, equals the reference's event engine bitwise (u8 grid, dyadic Euler
    leak). ``event_k_active=3`` overflows on most ticks (fallback);
    ``event_kernel="grid"`` is the port's own option (kernel B4)."""
    n, ticks = 48, 10
    tree = _tree(n, seed=27, euler=mode == "euler")
    ext = _drive(ticks, (2,), n, seed=28)
    opts = dict(backend="event", event_dispatch=strategy, mode=mode, **extra)
    j_opts = {k: v for k, v in opts.items() if k != "event_kernel"}
    nbrs = j_ops.EventFanIn.from_dense(tree["c"]) if strategy == "fan_in" else None
    t_out, j_out = _rollouts(tree, ext, ticks, (2,), j_opts, opts, max_delay=2,
                             neighbors=nbrs)
    _assert_rollout(t_out, j_out)
    assert 0 < float(t_out[1].mean()) < 0.9


@pytest.mark.parametrize("overflow", ["fallback", "unchecked"])
def test_engine_overflow_modes(overflow):
    """At a budget of 2 spikes per row the fallback ticks go dense and equal
    the jnp backend; ``unchecked`` truncates exactly as the reference does."""
    n, ticks = 40, 8
    tree = _tree(n, seed=29)
    ext = _drive(ticks, (3,), n, seed=30, p=0.5)
    opts = dict(backend="event", event_k_active=2, event_overflow=overflow)
    t_out, j_out = _rollouts(tree, ext, ticks, (3,), opts, opts)
    _assert_rollout(t_out, j_out)
    dense = _rollouts(tree, ext, ticks, (3,), dict(backend="jnp"), dict(backend="jnp"))[0]
    assert torch.equal(t_out[1], dense[1]) == (overflow == "fallback")


def test_engine_strict_overflow_raises_after_the_rollout():
    """``strict`` accumulates a device flag and raises once the loop is done;
    a rollout that never overflows returns the reference's raster."""
    n, ticks = 40, 6
    tree = _tree(n, seed=31)
    eng = TickEngine(EngineOptions(backend="event", event_k_active=2,
                                   event_overflow="strict"))
    p = interop.params_from_numpy(tree, "cpu")
    st0 = t_net.SNNState.zeros((2,), n, device="cpu")
    with pytest.raises(t_ops.EventOverflowError, match="k_active=2"):
        eng.rollout(p, st0, _t(_drive(ticks, (2,), n, seed=32, p=0.5)), ticks)
    quiet = np.zeros((ticks, 2, n), np.float32)
    quiet[:, :, 0] = 255.0
    _, raster = eng.rollout(p, st0, _t(quiet), ticks)
    jf, jr = j_net.rollout(_jax_params(tree), j_net.SNNState.zeros((2,), n),
                           jnp.asarray(quiet), ticks)
    np.testing.assert_array_equal(raster.numpy(), np.asarray(jr))
    with pytest.raises(ValueError, match="event_knee requires"):
        EngineOptions(backend="event", event_knee=3, event_overflow="strict")


def _knee_case():
    """A 64-neuron fabric driven so that its spike counts cross a knee of 8
    up and down and once pass ``k_active = 16``."""
    n, b, k, knee = 64, 2, 16, 8
    tree = _tree(n, seed=33, density=0.05, v_th=(100, 101))
    tree["w"] = np.minimum(tree["w"], 3.0).astype(np.float32)
    tree["lif.r_ref"][:] = 0
    tree["lif.leak"][:] = 8.0
    schedule = [2, 12, 6, 6, 3, 10, 20, 5, 2, 9, 7, 4, 1]
    ext = np.zeros((len(schedule), b, n), np.float32)
    for t, m in enumerate(schedule):
        ext[t, :, :m] = 200.0
    return tree, ext, schedule, k, knee


def test_knee_policy_bit_matches_reference_tick_by_tick():
    """The adaptive knee with hysteresis: driven spike counts cross the knee
    up and down, and the port's hysteresis bit and spikes equal the
    reference's on every tick; both arms (and an overflow) are taken."""
    tree, ext, schedule, k, knee = _knee_case()
    n, b = ext.shape[-1], ext.shape[1]
    opts = dict(backend="event", event_k_active=k, event_knee=knee, event_hysteresis=0.5)
    j_eng, t_eng = JEngine(JOptions(**opts)), TickEngine(EngineOptions(**opts))
    jp, tp = _jax_params(tree), interop.params_from_numpy(tree, "cpu")
    jc = JCarry(state=j_net.SNNState.zeros((b,), n), policy=jnp.zeros((), jnp.bool_))
    tc = TickCarry(state=t_net.SNNState.zeros((b,), n, device="cpu"),
                   policy=torch.zeros((), dtype=torch.bool))
    bits = []
    for t in range(len(schedule)):
        jc, jy = j_eng.tick_body(jc, (jnp.asarray(ext[t]), None), params=jp,
                                 wc=jp.w * jp.c)
        tc, ty = t_eng.tick_body(tc, (_t(ext[t]), None), params=tp)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy), err_msg=f"tick {t}")
        assert bool(tc.policy) == bool(jc.policy), f"tick {t}"
        assert tc.policy.dtype == torch.bool and tc.policy.dim() == 0
        bits.append(bool(tc.policy))
    arriving = [0] + schedule[:-1]
    assert bits[2] and arriving[3] == 6 and bits[3], "the band between lo and hi held dense"
    assert not all(bits) and any(bits) and max(arriving) > k
    final, _ = t_eng.rollout(tp, t_net.SNNState.zeros((b,), n, device="cpu"), _t(ext),
                             len(schedule))
    np.testing.assert_array_equal(final.lif.v.numpy(), np.asarray(jc.state.lif.v))


def _arms(tel):
    """Each row's arms from its telemetry: (event, dense on overflow, dense
    by the knee) = (ticks - overflow - policy_dense, overflow, policy_dense)."""
    ticks, over, policy = (np.asarray(tel.ticks), np.asarray(tel.overflow),
                           np.asarray(tel.policy_dense))
    return np.stack([ticks - over - policy, over, policy], axis=-1)


def test_arm_tally_reads_the_device_choice():
    """The telemetry's ``overflow`` and ``policy_dense`` counters count, per
    tick, the arm the kernels' flag chose: dense on overflow when a row passed
    ``k_active``, dense by the knee when the hysteresis bit is set, else event;
    a rollout's totals are the tick-by-tick sums and equal the reference's
    telemetry (exactly: integer counters), and without a knee only overflow
    goes dense."""
    from repro_torch.obs import TickTelemetry

    tree, ext, schedule, k, knee = _knee_case()
    n, b, T = ext.shape[-1], ext.shape[1], len(schedule)
    opts = dict(backend="event", event_k_active=k, event_knee=knee, event_hysteresis=0.5,
                telemetry=True)
    eng = TickEngine(EngineOptions(**opts))
    tp, jp = interop.params_from_numpy(tree, "cpu"), _jax_params(tree)
    tc = TickCarry(state=t_net.SNNState.zeros((b,), n, device="cpu"),
                   telem=TickTelemetry.zeros((b,), device="cpu"),
                   policy=torch.zeros((), dtype=torch.bool))
    want = np.zeros(3, np.int64)
    for t in range(T):
        m = int(tc.state.lif.y.sum(-1).max())
        tc, _ = eng.tick_body(tc, (_t(ext[t]), None), params=tp)
        want[1 if m > k else 2 if bool(tc.policy) else 0] += 1
        np.testing.assert_array_equal(_arms(tc.telem), np.tile(want, (b, 1)),
                                      err_msg=f"tick {t}")
    assert want.sum() == T and want.min() > 0, want
    _, _, tel = eng.rollout(tp, t_net.SNNState.zeros((b,), n, device="cpu"), _t(ext), T)
    np.testing.assert_array_equal(_arms(tel), np.tile(want, (b, 1)))
    _, _, jtel = JEngine(JOptions(**opts)).rollout(jp, j_net.SNNState.zeros((b,), n),
                                                   jnp.asarray(ext), T)
    np.testing.assert_array_equal(_arms(tel), _arms(jtel))
    opts = dict(backend="event", event_k_active=k, telemetry=True)
    _, _, tel = TickEngine(EngineOptions(**opts)).rollout(
        tp, t_net.SNNState.zeros((b,), n, device="cpu"), _t(ext), T)
    np.testing.assert_array_equal(_arms(tel), np.tile([want[0] + want[2], want[1], 0], (b, 1)))
    _, _, jtel = JEngine(JOptions(**opts)).rollout(jp, j_net.SNNState.zeros((b,), n),
                                                   jnp.asarray(ext), T)
    np.testing.assert_array_equal(_arms(tel), _arms(jtel))


def test_event_with_per_synapse_delays_matches_reference():
    """Per-synapse delays run the reference einsum on the event backend too."""
    n, ticks, D = 36, 9, 3
    tree = _tree(n, seed=34, density=0.2)
    delays = np.random.default_rng(35).integers(1, D + 1, (n, n)).astype(np.int32)
    ext = _drive(ticks, (2,), n, seed=36)
    opts = dict(backend="event")
    _assert_rollout(*_rollouts(tree, ext, ticks, (2,), opts, opts, max_delay=D,
                               delays=delays))


@pytest.mark.parametrize("strategy", ["topk", "fan_in"])
@pytest.mark.parametrize("rule", ["stdp", "rstdp"])
def test_event_learning_rollout_matches_reference(strategy, rule):
    """``learning_rollout`` on the event backend: the port's plasticity pass
    is kernel B5's twin, the reference's its jnp pass; rasters equal, weights
    and eligibility within ``rtol=atol=1e-5``."""
    n, ticks, b = 32, 10, 2
    tree = _tree(n, seed=37, density=0.2)
    tree["w"] = (tree["w"] * tree["c"]).astype(np.float32)
    ext = _drive(ticks, (b,), n, seed=38)
    rewards = np.where(np.arange(ticks) % 3 == 2, 1.0, -0.25).astype(np.float32)
    hyper = dict(a_plus=0.5, a_minus=0.25, lr_reward=0.5)
    jp = _jax_params(tree)
    j_nb = j_ops.EventFanIn.from_dense(tree["c"]) if strategy == "fan_in" else None
    (jfs, jpl, jw), jr = j_net.learning_rollout(
        jp, j_net.SNNState.zeros((b,), n), JPlastState.zeros((b,), n), jnp.asarray(ext),
        ticks, plasticity=JPlast.make(rule, **hyper), rewards=jnp.asarray(rewards),
        backend="event", neighbors=j_nb)
    tp = interop.params_from_numpy(tree, "cpu")
    t_nb = None if j_nb is None else interop.fan_in_from_numpy(j_nb.idx, j_nb.mask, "cpu")
    (tfs, tpl, tw), tr = t_net.learning_rollout(
        tp, t_net.SNNState.zeros((b,), n, device="cpu"),
        PlasticityState.zeros((b,), n, device="cpu"), _t(ext), ticks,
        plasticity=PlasticityParams.make(rule, **hyper), rewards=_t(rewards),
        backend="event", neighbors=t_nb)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tpl.elig.numpy(), np.asarray(jpl.elig), rtol=1e-5, atol=1e-5)
    assert np.abs(tw.numpy() - tree["w"]).max() > 0 and float(tr.mean()) > 0
    assert torch.equal(tp.w, _t(tree["w"]))


def test_network_dispatch_forms_match_reference():
    """``network.rollout`` and ``network.step`` take ``dispatch=`` as the
    reference's do: ``"auto"`` plans here, a plan carried across from the
    reference is used as it is, a strategy string picks the arm."""
    from repro.core import dispatch_policy as j_policy

    n, ticks, b = 48, 8, 2
    tree = _tree(n, seed=39, density=0.05)
    ext = _drive(ticks, (b,), n, seed=40)
    jp, tp = _jax_params(tree), interop.params_from_numpy(tree, "cpu")
    j0, t0 = j_net.SNNState.zeros((b,), n), t_net.SNNState.zeros((b,), n, device="cpu")
    j_plan = j_policy.plan(tree["c"], w_in=tree["w_in"], batch=b, platform="tpu")
    assert j_plan.strategy == "fan_in" and j_plan.ext_diag
    t_plan = interop.plan_from_numpy(interop.plan_to_numpy(j_plan), "cpu")
    for dispatch_j, dispatch_t in (("auto", "auto"), (j_plan, t_plan), ("topk", "topk"),
                                   ("dense", "dense")):
        jf, jr = j_net.rollout(jp, j0, jnp.asarray(ext), ticks, dispatch=dispatch_j)
        tf, tr = t_net.rollout(tp, t0, _t(ext), ticks, dispatch=dispatch_t)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        _assert_lif(tf.lif, jf.lif)
    js = j_net.step(j0, jp, jnp.asarray(ext[0]), dispatch="topk")
    ts = t_net.step(t0, tp, _t(ext[0]), dispatch="topk")
    _assert_lif(ts.lif, js.lif)
    with pytest.raises(ValueError, match="neighbor lists"):
        t_net.rollout(tp, t0, _t(ext), ticks, dispatch="fan_in")


def test_slot_axis_equals_per_slot_reference():
    """Slot-stacked params (the server's layout) on the spike-list arm equal
    the reference per slot."""
    n, ticks, S = 32, 6, 3
    trees = [_tree(n, seed=41 + i) for i in range(S)]
    ext = _drive(ticks, (S,), n, seed=44)
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    tp = interop.params_from_numpy(stacked, "cpu")
    st0 = t_net.SNNState.zeros((S,), n, device="cpu")
    for kernel in ("db", "grid"):
        _, tr = TickEngine(EngineOptions(backend="event", event_kernel=kernel)).rollout(
            tp, st0, _t(ext), ticks)
        for i, tree in enumerate(trees):
            _, jr = j_net.rollout(_jax_params(tree), j_net.SNNState.zeros((), n),
                                  jnp.asarray(ext[:, i]), ticks, backend="event")
            np.testing.assert_array_equal(tr[:, i].numpy(), np.asarray(jr))


# -- on the card ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernels B3/B4 are CUDA for sm_90a and have "
                    "no CPU mode (their plain twin is tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("slotted", [False, True])
def test_cuda_event_kernels_match_twin(slotted):
    """B3 and B4 against the twin on the card, bitwise on the u8 grid, with
    the gate open and closed; B4 also on float weights, on lists out of
    order and with repeated ids, and on more rows than one group holds."""
    dev = _cuda_or_skip()
    S, b, n, k = (3 if slotted else 1), 4, 300, 40
    trees = [_tree(n, seed=45 + i) for i in range(S)]
    lead = (lambda a: a) if slotted else (lambda a: a[0])
    wc = _t(lead(np.stack([t["w"] * t["c"] for t in trees]))).to(dev)
    rows = [_t(lead(np.stack([t[f"lif.{k_}"] for t in trees]))).to(dev) for k_ in ROWS]
    s = _t(lead(np.stack([_spikes(b, n, 0.1, seed=50 + i) for i in range(S)]))).to(dev)
    v, r = (_t(lead(np.stack([a] * S))).to(dev) for a in _state(b, n, seed=55))
    idx, counts, _ = t_ops.spike_list(s, k)
    for walk, fn, w in (("live", t_ev.event_lif_dispatch_db, wc),
                        ("all", t_ev.event_lif_dispatch, t_ops.sentinel_rows(wc))):
        kw = {"counts": counts} if walk == "live" else {}
        want = t_ref.event_lif_dispatch_ref(idx, counts, w, v, r, None, *rows, walk=walk)
        got = fn(idx, w, v, r, None, *rows, **kw)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert torch.equal(g, x)
        out = t_ref.LIFStepOut(torch.zeros_like(v), torch.zeros_like(r), torch.zeros_like(v))
        fn(idx, w, v, r, None, *rows, skip=torch.ones((), dtype=torch.bool, device=dev),
           out=out, **kw)
        torch.cuda.synchronize()
        assert not out.v.any() and not out.y.any()
    # B4 on what its redesign must still take: lists out of order and with
    # repeated ids, float weights with signed zeros, more rows than a group,
    # a width that is no multiple of 4, two launches bitwise equal.
    rng = np.random.default_rng(57)
    b4, n4, k4 = 20, 301, 60   # a ragged width: the 4-byte fill
    wf = rng.standard_normal((S, n4, n4)).astype(np.float32)
    wf = wf * (rng.random((S, n4, n4)) < 0.15)
    wcf = t_ops.sentinel_rows(_t(lead(wf))).to(dev)
    rows4 = [_t(lead(np.stack([_tree(n4, seed=45)[f"lif.{k_}"]] * S))).to(dev) for k_ in ROWS]
    s4 = _t(lead(np.stack([_spikes(b4, n4, 0.15, seed=58 + i) for i in range(S)]))).to(dev)
    v4, r4 = (_t(lead(np.stack([a] * S))).to(dev) for a in _state(b4, n4, seed=59, grid=False))
    idx4, _, _ = t_ops.spike_list(s4, k4)
    idx4 = idx4.clone()
    idx4[..., 1, :] = idx4[..., 1, torch.from_numpy(rng.permutation(k4)).to(dev)]
    live = idx4[..., 2, :][idx4[..., 2, :] < n4].reshape(-1)[: k4 // 2]
    rep = torch.sort(torch.cat([live, live[: live.numel() // 2]])).values[:k4]
    idx4[..., 2, :] = n4
    idx4[..., 2, : rep.numel()] = rep
    idx4 = idx4.contiguous()
    counts4 = torch.full(idx4.shape[:-1], k4, dtype=torch.int32, device=dev)
    want = t_ref.event_lif_dispatch_ref(idx4, counts4, wcf, v4, r4, None, *rows4, walk="all")
    got = t_ev.event_lif_dispatch(idx4, wcf, v4, r4, None, *rows4)
    again = t_ev.event_lif_dispatch(idx4, wcf, v4, r4, None, *rows4)
    torch.cuda.synchronize()
    assert t_ev.last_plan.groups == 2
    for g, x, y in zip(got, want, again):
        assert torch.equal(g, x) and torch.equal(g, y)


@pytest.mark.cuda
def test_cuda_event_rollout_matches_jnp_without_host_sync():
    """The spike-list rollout on the card equals the jnp backend, with no
    host sync inside the tick loop."""
    dev = _cuda_or_skip()
    n, ticks, b = 512, 8, 4
    tree = _tree(n, seed=60, density=0.05)
    p = interop.params_from_numpy(tree, dev)
    st0 = t_net.SNNState.zeros((b,), n, device=dev)
    ext = _t(_drive(ticks, (b,), n, seed=61)).to(dev)
    _, want = t_net.rollout(p, st0, ext, ticks)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, got = t_net.rollout(p, st0, ext, ticks, dispatch="topk")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
