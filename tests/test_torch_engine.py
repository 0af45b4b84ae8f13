"""The port's tick engine and network wrappers against the JAX package.

Every port backend (``jnp``; ``pallas`` and ``pallas_fused``, which run
their kernels' plain twins on the CPU) is held against the reference's
``backend="jnp"`` rollout. Tolerance: bitwise on the u8 grid (integer
weights, drive, thresholds and leaks, so every f32 sum is exact);
Euler with a dyadic leak: rasters and refractory counters exact, membrane
within ``rtol=1e-6, atol=1e-4``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectivity as j_conn
from repro.core import network as j_net
from repro.core.lif import LIFParams as JLIFParams
from repro.core.registers import RegisterBank, WeightLayout
from repro_torch import interop
from repro_torch.core import network as t_net
from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
from repro_torch.plasticity import PlasticityParams

ROWS = ("v_th", "leak", "r_ref", "gain", "i_bias", "v_reset")
BACKENDS = ("jnp", "pallas", "pallas_fused")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(n, seed, *, density=0.4, r_ref=(0, 4), euler=False, c_none=False):
    rng = np.random.default_rng(seed)
    c = (rng.random((n, n)) < density).astype(np.float32)
    tree = {
        "w": rng.integers(0, 256, (n, n)).astype(np.float32),
        "c": None if c_none else c,
        "w_in": np.eye(n, dtype=np.float32),
        "lif.v_th": rng.integers(150, 1200, n).astype(np.float32),
        "lif.leak": (np.full(n, 0.25) if euler else rng.integers(0, 9, n)).astype(np.float32),
        "lif.r_ref": rng.integers(*r_ref, n).astype(np.int32),
        "lif.gain": np.ones(n, np.float32),
        "lif.i_bias": np.zeros(n, np.float32),
        "lif.v_reset": np.zeros(n, np.float32),
    }
    if c_none:
        tree["w"] = (tree["w"] * c).astype(np.float32)
    return tree


def _jax_params(t):
    c = t.get("c")
    return j_net.SNNParams(
        w=jnp.asarray(t["w"]), c=None if c is None else jnp.asarray(c),
        w_in=jnp.asarray(t["w_in"]),
        lif=JLIFParams(**{k: jnp.asarray(t[f"lif.{k}"]) for k in ROWS}))


def _drive(ticks, batch, n, seed, p=0.3):
    rng = np.random.default_rng(seed)
    shape = (ticks,) + tuple(batch) + (n,)
    return ((rng.random(shape) < p) * rng.integers(60, 256, shape)).astype(np.float32)


def _assert_rollout_equal(t_out, j_out, *, euler=False):
    (tf, tr), (jf, jr) = t_out, j_out
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    if euler:
        np.testing.assert_allclose(tf.lif.v.numpy(), np.asarray(jf.lif.v), rtol=1e-6, atol=1e-4)
    else:
        np.testing.assert_array_equal(tf.lif.v.numpy(), np.asarray(jf.lif.v))
    np.testing.assert_array_equal(tf.lif.r.numpy(), np.asarray(jf.lif.r))
    np.testing.assert_array_equal(tf.lif.y.numpy(), np.asarray(jf.lif.y))
    np.testing.assert_array_equal(tf.delay_buf.numpy(), np.asarray(jf.delay_buf))
    assert int(tf.tick) == int(jf.tick) and tf.tick.dtype == torch.int32


CASES = {
    # name: (n, batch, D, per-synapse delays, tree kwargs, mode)
    "refractory": (37, (3,), 1, False, {"r_ref": (1, 4)}, "fixed_leak"),
    "ring_D3": (29, (2,), 3, False, {}, "fixed_leak"),
    "delays_D3": (31, (2,), 3, True, {}, "fixed_leak"),
    "batch_2x3": (23, (2, 3), 2, False, {}, "fixed_leak"),
    "euler": (33, (2,), 1, False, {"euler": True}, "euler"),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_matches_reference(case, backend):
    n, batch, D, with_delays, kw, mode = CASES[case]
    ticks = 14
    tree = _tree(n, seed=len(case), **kw)
    ext = _drive(ticks, batch, n, seed=len(case) + 1)
    rng = np.random.default_rng(len(case) + 2)
    delays = rng.integers(1, D + 1, (n, n)).astype(np.int32) if with_delays else None
    j_out = j_net.rollout(_jax_params(tree), j_net.SNNState.zeros(batch, n, max_delay=D),
                          jnp.asarray(ext), ticks, mode=mode,
                          delays=None if delays is None else jnp.asarray(delays))
    st0 = t_net.SNNState.zeros(batch, n, max_delay=D, device="cpu")
    ring0 = st0.delay_buf.clone()
    t_out = t_net.rollout(interop.params_from_numpy(tree, "cpu"), st0, torch.as_tensor(ext),
                          ticks, mode=mode, backend=backend,
                          delays=None if delays is None else torch.as_tensor(delays))
    _assert_rollout_equal(t_out, j_out, euler=mode == "euler")
    assert t_out[1].abs().sum() > 0, "the case should spike"
    assert torch.equal(st0.delay_buf, ring0), "the caller's state must not be written"


def test_implicit_all_to_all_c_none():
    n, ticks = 27, 10
    tree = _tree(n, seed=5, c_none=True)
    ext = _drive(ticks, (2,), n, seed=6)
    j_out = j_net.rollout(_jax_params(tree), j_net.SNNState.zeros((2,), n),
                          jnp.asarray(ext), ticks)
    params = interop.params_from_numpy(tree, "cpu")
    assert params.c is None
    st0 = t_net.SNNState.zeros((2,), n, device="cpu")
    _assert_rollout_equal(t_net.rollout(params, st0, torch.as_tensor(ext), ticks), j_out)
    # Deliberate difference (ROADMAP §C): the reference's Pallas kernels
    # refuse c=None; the port's B1 and B2 run on W alone.
    for backend in ("pallas", "pallas_fused"):
        with pytest.raises(ValueError, match="c=None"):
            j_net.rollout(_jax_params(tree), j_net.SNNState.zeros((2,), n),
                          jnp.asarray(ext), ticks, backend=backend)
        _assert_rollout_equal(t_net.rollout(params, st0, torch.as_tensor(ext), ticks,
                                            backend=backend), j_out)


@pytest.mark.parametrize("backend", BACKENDS)
def test_step_matches_reference(backend):
    n = 19
    tree = _tree(n, seed=8)
    ext = _drive(1, (2,), n, seed=9)[0]
    jst = j_net.SNNState.zeros((2,), n, max_delay=2)
    tst = t_net.SNNState.zeros((2,), n, max_delay=2, device="cpu")
    jp, tp = _jax_params(tree), interop.params_from_numpy(tree, "cpu")
    for _ in range(3):
        jst = j_net.step(jst, jp, jnp.asarray(ext))
        tst = t_net.step(tst, tp, torch.as_tensor(ext), backend=backend)
    np.testing.assert_array_equal(tst.lif.v.numpy(), np.asarray(jst.lif.v))
    np.testing.assert_array_equal(tst.delay_buf.numpy(), np.asarray(jst.delay_buf))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("time_major", [False, True])
def test_forward_layered(backend, time_major):
    sizes = [5, 6, 4]
    n = sum(sizes)
    rng = np.random.default_rng(11)
    c = j_conn.layered(sizes).astype(np.float32)
    tree = _tree(n, seed=12)
    tree["w"] = (rng.integers(100, 256, (n, n)) * c).astype(np.float32)
    tree["c"] = c
    tree["lif.v_th"] = np.full(n, 150, np.float32)
    ticks = 6
    if time_major:
        x = _drive(ticks, (3,), n, seed=13, p=0.6)
        x[..., sizes[0]:] = 0
    else:
        x = np.zeros((3, n), np.float32)
        x[:, :sizes[0]] = rng.integers(0, 2, (3, sizes[0])) * 200
    jr, jf = j_net.forward_layered(_jax_params(tree), jnp.asarray(x), sizes, ticks,
                                   time_major=time_major)
    tr, tf = t_net.forward_layered(interop.params_from_numpy(tree, "cpu"), torch.as_tensor(x),
                                   sizes, ticks, backend=backend, time_major=time_major)
    assert tr.shape == (ticks, 3, sizes[-1])
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tf.lif.v.numpy(), np.asarray(jf.lif.v))
    assert tr.sum() > 0


@pytest.mark.parametrize("layout", ["per_neuron", "per_synapse"])
def test_params_from_registers(layout):
    from repro_torch.core.registers import RegisterBank as TBank, WeightLayout as TLayout

    n = 21
    rng = np.random.default_rng(14)
    c = rng.random((n, n)) < 0.3
    wshape = (n,) if layout == "per_neuron" else (n, n)
    w = rng.integers(0, 256, wshape).astype(np.uint8)
    banks = []
    for Bank, Layout in ((RegisterBank, WeightLayout), (TBank, TLayout)):
        b = Bank(n, weight_layout=Layout(layout))
        b.set_connection_list(c)
        b.set_weights(w)
        b.set_thresholds(rng.integers(0, 256, n).astype(np.uint8))
        b.set_leak(3)
        b.set_refractory(2)
        banks.append(b)
    banks[1].thresholds = banks[0].thresholds.copy()
    jp = j_net.params_from_registers(banks[0])
    tp = t_net.params_from_registers(banks[1], device="cpu")
    got = interop.params_to_numpy(tp)
    for key in ("w", "c", "w_in"):
        np.testing.assert_array_equal(got[key], np.asarray(getattr(jp, key)))
    for k in ROWS:
        np.testing.assert_array_equal(got[f"lif.{k}"], np.asarray(getattr(jp.lif, k)))
        assert got[f"lif.{k}"].dtype == np.asarray(getattr(jp.lif, k)).dtype


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("chunk", [1, 4])
def test_chunks_equal_one_rollout(backend, chunk):
    n, k_chunks, D = 25, 3, 3
    tree = _tree(n, seed=15)
    ext = _drive(chunk * k_chunks, (2,), n, seed=16)
    p = interop.params_from_numpy(tree, "cpu")
    eng = TickEngine(EngineOptions(backend=backend))
    st0 = t_net.SNNState.zeros((2,), n, max_delay=D, device="cpu")
    one_state, one_raster = eng.rollout(p, st0, torch.as_tensor(ext), chunk * k_chunks)
    carry, rasters = TickCarry(state=st0), []
    for i in range(k_chunks):
        carry, r = eng.chunk(p, carry, torch.as_tensor(ext[i * chunk:(i + 1) * chunk]), chunk)
        rasters.append(r)
    assert torch.equal(torch.cat(rasters), one_raster)
    for f in ("v", "r", "y"):
        assert torch.equal(getattr(carry.state.lif, f), getattr(one_state.lif, f))
    assert torch.equal(carry.state.delay_buf, one_state.delay_buf)
    assert int(carry.state.tick) == chunk * k_chunks


def test_interop_round_trip_is_exact():
    tree = _tree(13, seed=17)
    back = interop.params_to_numpy(interop.params_from_numpy(tree, "cpu"))
    assert set(back) == set(tree)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    rng = np.random.default_rng(18)
    st = {"lif.v": rng.normal(size=(2, 13)).astype(np.float32),
          "lif.r": rng.integers(0, 3, (2, 13)).astype(np.int32),
          "lif.y": (rng.random((2, 13)) < 0.5).astype(np.float32),
          "delay_buf": rng.random((2, 4, 13)).astype(np.float32),
          "tick": np.asarray(7, np.int32)}
    back = interop.state_to_numpy(interop.state_from_numpy(st, "cpu"))
    for k, v in st.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


_EVENT_BAD = {"backend": "events", "plasticity_backend": "events", "event_k_active": 0}


@pytest.mark.parametrize("field,value", [
    ("telemetry", True), ("mesh", object()),
    ("backend", "event"), ("plasticity_backend", "event"), ("event_k_active", 4),
    ("surrogate", True),
])
def test_later_slices_raise(field, value):
    """Every option of a later slice is ported now. The mesh (the sharding
    slice) must be a ``SNNMesh``: anything else raises the reference's
    ``ValueError``, and a one-rank mesh runs the plain engine. The event
    slice's options validate, and a bad value raises the reference's
    ``ValueError``. The surrogate (ported with the classifier
    slice) is accepted and trains on ``jnp``; the kernel backends raise the
    reference's ``ValueError`` ("inference-only") when the tick runs.
    Telemetry (ported with the observability slice) is accepted as the
    reference accepts it, and a rollout then returns its accumulators."""
    if field == "telemetry":
        assert EngineOptions(telemetry=value).telemetry and j_net.EngineOptions(
            telemetry=value).telemetry
        p = interop.params_from_numpy(_tree(6, 3), "cpu")
        st = t_net.SNNState.zeros((2,), 6, device="cpu")
        ext = torch.from_numpy(_drive(3, (2,), 6, 4))
        final, raster, tel = TickEngine(EngineOptions(telemetry=value)).rollout(p, st, ext, 3)
        assert tel.ticks.tolist() == [3, 3] and torch.equal(tel.spikes, raster.sum((0, 2)))
        assert torch.equal(final.lif.v, TickEngine().rollout(p, st, ext, 3)[0].lif.v)
        return
    if field == "surrogate":
        assert EngineOptions(surrogate=value).surrogate and j_net.EngineOptions(
            surrogate=value).surrogate
        p = interop.params_from_numpy(_tree(6, 3), "cpu")
        st = t_net.SNNState.zeros((2,), 6, device="cpu")
        ext = torch.from_numpy(_drive(1, (2,), 6, 4)[0])
        soft = TickEngine(EngineOptions(surrogate=value)).tick(st, p, ext)
        hard = TickEngine(EngineOptions()).tick(st, p, ext)
        assert torch.equal(soft.lif.y, hard.lif.y) and torch.equal(soft.lif.v, hard.lif.v)
        for backend in ("pallas", "pallas_fused"):
            eng = TickEngine(EngineOptions(backend=backend, surrogate=value))
            with pytest.raises(ValueError, match="inference-only"):
                eng.tick(st, p, ext)
        return
    if field == "mesh":
        for opts in (EngineOptions, j_net.EngineOptions):
            with pytest.raises(ValueError, match="mesh must be"):
                opts(mesh=value)
        from repro_torch.launch.mesh import make_snn_mesh

        p = interop.params_from_numpy(_tree(6, 3), "cpu")
        st = t_net.SNNState.zeros((2,), 6, device="cpu")
        ext = torch.from_numpy(_drive(3, (2,), 6, 4))
        sharded = TickEngine(EngineOptions(mesh=make_snn_mesh(1, device="cpu")))
        got, want = sharded.rollout(p, st, ext, 3), TickEngine().rollout(p, st, ext, 3)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0].lif.v, want[0].lif.v)
        return
    opts = EngineOptions(**{field: value})
    assert getattr(opts, field) == value
    with pytest.raises(ValueError, match=field):
        EngineOptions(**{field: _EVENT_BAD[field]})
    j_opts = j_net.EngineOptions(**{field: value})
    assert getattr(j_opts, field) == value
    with pytest.raises(ValueError, match=field):
        j_net.EngineOptions(**{field: _EVENT_BAD[field]})


def test_options_validate_and_learning_raises():
    """Invalid options fail at construction; a learning rollout without a
    learning rule, or a fan-in dispatch without fan-in lists, raises the
    reference's ``ValueError``."""
    with pytest.raises(ValueError):
        EngineOptions(backend="cuda")
    with pytest.raises(ValueError):
        EngineOptions(mode="bogus")
    with pytest.raises(ValueError, match="plasticity_backend"):
        EngineOptions(plasticity_backend="cuda")
    assert EngineOptions(backend="pallas_fused").plasticity_pass() == "pallas"
    assert EngineOptions(plasticity_backend="pallas_fused").plasticity_pass() == "pallas"
    assert EngineOptions(backend="pallas", plasticity_backend="jnp").plasticity_pass() == "jnp"
    p = interop.params_from_numpy(_tree(5, seed=3), "cpu")
    st = t_net.SNNState.zeros((1,), 5, device="cpu")
    with pytest.raises(ValueError, match="plasticity set"):
        TickEngine().learning_rollout(p, st, None, None, 2)
    assert EngineOptions(backend="event").plasticity_pass() == "pallas"
    with pytest.raises(ValueError, match="neighbor lists"):
        t_net.learning_rollout(p, st, None, None, 2, dispatch="fan_in",
                               plasticity=PlasticityParams.make("stdp"))
    with pytest.raises(ValueError, match="event_dispatch"):
        EngineOptions(backend="event", event_dispatch="sparse")


def test_int_mode_runs_on_jnp_and_kernels_refuse_it():
    """The integer datapath rolls out on the port's ``jnp`` backend, tick for
    tick equal to the reference's ``lif_step(mode="int")`` fed the same
    synaptic sums (the reference's own rollout cannot carry int32 state
    through its scan). The kernel backends refuse ``int`` instead of
    running fixed_leak in its place, as the reference's Pallas epilogue does."""
    from repro.core import lif as j_lif
    from repro.core.network_types import synaptic_input

    n, ticks = 17, 8
    tree = _tree(n, seed=19, r_ref=(1, 3))
    ext = _drive(ticks, (2,), n, seed=20)
    jp = _jax_params(tree)
    st = j_lif.LIFState.zeros((2,), n)
    raster = []
    for t in range(ticks):
        syn = synaptic_input(st.y.astype(jnp.float32), jp, jnp.asarray(ext[t]))
        st = j_lif.lif_step(st, syn, jp.lif, mode="int")
        raster.append(np.asarray(st.y))
    params = interop.params_from_numpy(tree, "cpu")
    st0 = t_net.SNNState.zeros((2,), n, device="cpu")
    final, t_raster = t_net.rollout(params, st0, torch.as_tensor(ext), ticks, mode="int")
    np.testing.assert_array_equal(t_raster.numpy(), np.stack(raster))
    np.testing.assert_array_equal(final.lif.v.numpy(), np.asarray(st.v))
    assert t_raster.sum() > 0
    for backend in ("pallas", "pallas_fused"):
        with pytest.raises(ValueError, match="supports"):
            t_net.rollout(params, st0, torch.as_tensor(ext), ticks, mode="int", backend=backend)
