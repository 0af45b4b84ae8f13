"""The port's learning tick (engine, ``network.learning_rollout``, chunks,
carries) against the JAX package's single-device learning rollout.

Every port backend (``jnp``; ``pallas`` and ``pallas_fused``, whose kernels
B1/B2 and B5 run their plain twins on the CPU) is held against the
reference's ``backend="jnp"`` learning rollout at the small sizes of
``tests/test_plasticity.py``. Tolerance: rasters exact; ``w``, ``elig`` and
the traces to ``rtol=atol=1e-5``, the reference's own tolerance between its
learning backends (once learning moves the weights off the u8 grid, a sum's
order decides its last bit).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectivity
from repro.core import network as j_net
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import TickEngine as JEngine
from repro.core.lif import LIFParams as JLIFParams
from repro.plasticity import PlasticityParams as JPP
from repro.plasticity import PlasticityState as JPS
from repro_torch import interop
from repro_torch.core import network as t_net
from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
from repro_torch.core.lif import LIFParams
from repro_torch.core.registers import RegisterBank, WeightLayout
from repro_torch.plasticity import PlasticityParams, PlasticityState, weights_to_bank

BACKENDS = ("jnp", "pallas", "pallas_fused")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _net(n, seed, *, v_th=1.0, w_lo=1.0, w_hi=3.0):
    """The reference test's network: a two-layer mask, weights in [1, 3),
    a doubling input, unit thresholds; as (reference params, port params)."""
    rng = np.random.default_rng(seed)
    c = connectivity.layered([n // 2, n - n // 2]).astype(np.float32)
    w = rng.uniform(w_lo, w_hi, (n, n)).astype(np.float32)
    jp = j_net.SNNParams(w=jnp.asarray(w), c=jnp.asarray(c),
                         w_in=jnp.eye(n, dtype=jnp.float32) * 2.0,
                         lif=JLIFParams.make(n, v_th=v_th))
    tp = t_net.SNNParams(w=torch.as_tensor(w), c=torch.as_tensor(c),
                         w_in=torch.eye(n) * 2.0, lif=LIFParams.make(n, v_th=v_th, device="cpu"))
    return jp, tp


def _drive(n, ticks, b, seed, p=0.7):
    rng = np.random.default_rng(seed)
    return np.tile((rng.random((b, n)) < p) * (np.arange(n) < n // 2),
                   (ticks, 1, 1)).astype(np.float32)


def _assert_learned(t_out, j_out):
    (tf, tps, tw), tr = t_out
    (jf, jps, jw), jr = j_out
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tf.lif.y.numpy(), np.asarray(jf.lif.y))
    np.testing.assert_allclose(tf.lif.v.numpy(), np.asarray(jf.lif.v), **TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    for k in ("x_pre", "x_post", "elig"):
        np.testing.assert_allclose(getattr(tps, k).numpy(), np.asarray(getattr(jps, k)),
                                   **TOL, err_msg=k)
    assert int(tf.tick) == int(jf.tick)


CASES = {
    # name: (rule, rewards?, plastic sub-mask?, learn_until)
    "stdp": ("stdp", False, False, None),
    "rstdp_reward": ("rstdp", True, False, None),
    "stdp_submask": ("stdp", False, True, None),
    "rstdp_learn_until": ("rstdp", True, True, 5),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_learning_rollout_matches_reference(case, backend):
    rule, with_rewards, submask, learn_until = CASES[case]
    n, ticks, b = 12, 9, 2
    jp, tp = _net(n, seed=len(case))
    ext = _drive(n, ticks, b, seed=len(case) + 1)
    rng = np.random.default_rng(len(case) + 2)
    rewards = rng.uniform(-1, 1, ticks).astype(np.float32) if with_rewards else None
    pc = None
    if submask:
        pc = (np.asarray(jp.c) * (rng.random((n, n)) < 0.5)).astype(np.float32)
    kw = dict(a_plus=0.5, a_minus=0.2, lr_reward=0.8)
    j_eng = JEngine(JOptions(plasticity=JPP.make(rule, **kw)))
    j_out = j_eng.learning_rollout(
        jp, j_net.SNNState.zeros((b,), n), JPS.zeros((b,), n), jnp.asarray(ext), ticks,
        rewards=None if rewards is None else jnp.asarray(rewards),
        plastic_c=None if pc is None else jnp.asarray(pc),
        learn_until=None if learn_until is None else jnp.asarray(learn_until))
    t_eng = TickEngine(EngineOptions(backend=backend, plasticity=PlasticityParams.make(rule, **kw)))
    w0 = tp.w.clone()
    pst0 = PlasticityState.zeros((b,), n, device="cpu")
    t_out = t_eng.learning_rollout(
        tp, t_net.SNNState.zeros((b,), n, device="cpu"), pst0, torch.as_tensor(ext), ticks,
        rewards=None if rewards is None else torch.as_tensor(rewards),
        plastic_c=None if pc is None else torch.as_tensor(pc),
        learn_until=None if learn_until is None else torch.tensor(learn_until))
    _assert_learned(t_out, j_out)
    tw = t_out[0][2]
    assert (tw - w0).abs().max() > 0, "the case should learn"
    assert torch.equal(tp.w, w0) and not pst0.elig.any(), "the caller's tensors stay as they were"
    if pc is not None:
        frozen = pc == 0
        np.testing.assert_array_equal(tw.numpy()[frozen], w0.numpy()[frozen])


@pytest.mark.parametrize("backend", BACKENDS)
def test_network_learning_rollout_matches_reference(backend):
    """The public wrapper, with the plasticity backend chosen explicitly."""
    n, ticks, b = 10, 6, 2
    jp, tp = _net(n, seed=6)
    ext = _drive(n, ticks, b, seed=7)
    j_out = j_net.learning_rollout(jp, j_net.SNNState.zeros((b,), n), JPS.zeros((b,), n),
                                   jnp.asarray(ext), ticks,
                                   plasticity=JPP.make(a_plus=0.5, a_minus=0.2))
    for pb in ("jnp", "pallas"):
        t_out = t_net.learning_rollout(
            tp, t_net.SNNState.zeros((b,), n, device="cpu"),
            PlasticityState.zeros((b,), n, device="cpu"), torch.as_tensor(ext), ticks,
            plasticity=PlasticityParams.make(a_plus=0.5, a_minus=0.2), backend=backend,
            plasticity_backend=pb)
        _assert_learned(t_out, j_out)
    opts = EngineOptions(backend=backend)
    t_out = t_net.learning_rollout(
        tp, t_net.SNNState.zeros((b,), n, device="cpu"),
        PlasticityState.zeros((b,), n, device="cpu"), torch.as_tensor(ext), ticks,
        plasticity=PlasticityParams.make(a_plus=0.5, a_minus=0.2), options=opts)
    _assert_learned(t_out, j_out)


def test_zero_amplitude_degenerates_to_rollout():
    n, ticks, b = 12, 6, 2
    _, tp = _net(n, seed=4, v_th=1.5)
    ext = torch.as_tensor(_drive(n, ticks, b, seed=5, p=0.5))
    st = t_net.SNNState.zeros((b,), n, device="cpu")
    (fin, _, w_fin), raster_l = t_net.learning_rollout(
        tp, st, PlasticityState.zeros((b,), n, device="cpu"), ext, ticks,
        plasticity=PlasticityParams.make(a_plus=0.0, a_minus=0.0), backend="pallas_fused")
    fin_ref, raster = t_net.rollout(tp, st, ext, ticks, backend="pallas_fused")
    assert torch.equal(raster_l, raster) and torch.equal(w_fin, tp.w)
    assert torch.equal(fin.lif.v, fin_ref.lif.v)


def test_slot_axis_equals_per_slot_reference():
    """Slot-stacked networks with per-slot rewards and learn_until equal S
    separate reference learning rollouts (the server's wave shape)."""
    S, n, ticks = 3, 10, 7
    nets = [_net(n, seed=20 + s) for s in range(S)]
    rng = np.random.default_rng(23)
    ext = (rng.random((ticks, S, n)) < 0.6).astype(np.float32) * (np.arange(n) < n // 2)
    rewards = rng.uniform(-1, 1, (ticks, S)).astype(np.float32)
    until = np.array([7, 3, 0], np.int32)
    pp = dict(a_plus=0.4, a_minus=0.3)
    stack = lambda leaves: torch.stack(leaves)
    tp = t_net.SNNParams(
        w=stack([p.w for _, p in nets]), c=stack([p.c for _, p in nets]),
        w_in=stack([p.w_in for _, p in nets]),
        lif=LIFParams(**{f.name: stack([getattr(p.lif, f.name) for _, p in nets])
                         for f in dataclasses.fields(LIFParams)}))
    for backend in BACKENDS:
        eng = TickEngine(EngineOptions(backend=backend,
                                       plasticity=PlasticityParams.make("rstdp", **pp)))
        (tf, tps, tw), tr = eng.learning_rollout(
            tp, t_net.SNNState.zeros((S,), n, device="cpu"),
            PlasticityState.zeros((), n, device="cpu", slots=S), torch.as_tensor(ext), ticks,
            rewards=torch.as_tensor(rewards), learn_until=torch.as_tensor(until))
        for s, (jp, _) in enumerate(nets):
            j_eng = JEngine(JOptions(plasticity=JPP.make("rstdp", **pp)))
            (jf, jps, jw), jr = j_eng.learning_rollout(
                jp, j_net.SNNState.zeros((), n), JPS.zeros((), n), jnp.asarray(ext[:, s]),
                ticks, rewards=jnp.asarray(rewards[:, s]), learn_until=jnp.asarray(until[s]))
            np.testing.assert_array_equal(tr[:, s].numpy(), np.asarray(jr))
            np.testing.assert_allclose(tw[s].numpy(), np.asarray(jw), **TOL)
            np.testing.assert_allclose(tps.elig[s].numpy(), np.asarray(jps.elig), **TOL)
            np.testing.assert_allclose(tps.x_post[s].numpy(), np.asarray(jps.x_post), **TOL)
        assert torch.equal(tw[2], tp.w[2]), "learn_until = 0 learns nothing"


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("chunk", [1, 3])
def test_learning_chunks_equal_one_rollout(backend, chunk):
    n, k_chunks, b = 12, 3, 2
    _, tp = _net(n, seed=9)
    ext = torch.as_tensor(_drive(n, chunk * k_chunks, b, seed=10))
    rewards = torch.linspace(-1, 1, chunk * k_chunks)
    eng = TickEngine(EngineOptions(backend=backend, plasticity=PlasticityParams.make(
        "rstdp", a_plus=0.5, a_minus=0.2)))
    st0 = t_net.SNNState.zeros((b,), n, device="cpu")
    pst0 = PlasticityState.zeros((b,), n, device="cpu")
    (fs, fp, fw), one = eng.learning_rollout(tp, st0, pst0, ext, chunk * k_chunks,
                                             rewards=rewards, learn_until=torch.tensor(5))
    carry, rasters = eng.init_learning_carry(tp, st0, pst0), []
    for i in range(k_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        carry, r = eng.chunk(tp, carry, ext[sl], chunk, rewards=rewards[sl],
                             learn_until=torch.tensor(5))
        rasters.append(r)
    assert torch.equal(torch.cat(rasters), one)
    assert torch.equal(carry.w, fw) and torch.equal(carry.state.lif.v, fs.lif.v)
    for k in ("x_pre", "x_post", "elig"):
        assert torch.equal(getattr(carry.plast, k), getattr(fp, k)), k
    assert int(carry.state.tick) == chunk * k_chunks


def test_learning_errors_match_reference():
    n = 8
    jp, tp = _net(n, seed=7)
    pp = PlasticityParams.make()
    with pytest.raises(ValueError, match="max_delay"):
        j_net.learning_rollout(jp, j_net.SNNState.zeros((), n, max_delay=3), JPS.zeros((), n),
                               None, 4, plasticity=JPP.make())
    with pytest.raises(ValueError, match="max_delay"):
        t_net.learning_rollout(tp, t_net.SNNState.zeros((), n, max_delay=3, device="cpu"),
                               PlasticityState.zeros((), n, device="cpu"), None, 4,
                               plasticity=pp)
    tp_none = dataclasses.replace(tp, c=None)
    st = t_net.SNNState.zeros((), n, device="cpu")
    pst = PlasticityState.zeros((), n, device="cpu")
    with pytest.raises(ValueError, match="plastic_c"):
        t_net.learning_rollout(tp_none, st, pst, None, 4, plasticity=pp)
    eng = TickEngine(EngineOptions(plasticity=pp))
    with pytest.raises(ValueError, match="plastic_c"):
        eng.chunk(tp_none, eng.init_learning_carry(tp_none, st, pst), None, 2)
    # Deliberate difference (ROADMAP §C): the reference's Pallas kernels
    # refuse c=None; the port's B1 and B2 learn on W alone, as on an
    # explicit all-ones mask.
    ones = torch.ones(n, n)
    for backend in ("pallas", "pallas_fused"):
        with pytest.raises(ValueError, match="c=None"):
            j_net.learning_rollout(dataclasses.replace(jp, c=None), j_net.SNNState.zeros((), n),
                                   JPS.zeros((), n), None, 2, plasticity=JPP.make(),
                                   backend=backend, plastic_c=jnp.ones((n, n)))
        got = t_net.learning_rollout(tp_none, st, pst, None, 2, plasticity=pp,
                                     backend=backend, plastic_c=ones)
        want = t_net.learning_rollout(dataclasses.replace(tp, c=ones), st, pst, None, 2,
                                      plasticity=pp, backend=backend, plastic_c=ones)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0][2], want[0][2])
        assert torch.equal(got[0][0].lif.v, want[0][0].lif.v)


def test_implicit_all_to_all_learns_with_explicit_mask():
    """c=None (the implicit all-to-all) learns with an explicit plastic_c, as
    in the reference."""
    n, ticks, b = 10, 6, 2
    jp, tp = _net(n, seed=12)
    jp = dataclasses.replace(jp, w=jp.w * jp.c, c=None)
    tp = dataclasses.replace(tp, w=tp.w * tp.c, c=None)
    ext = _drive(n, ticks, b, seed=13)
    ones = np.ones((n, n), np.float32)
    j_out = j_net.learning_rollout(jp, j_net.SNNState.zeros((b,), n), JPS.zeros((b,), n),
                                   jnp.asarray(ext), ticks, plasticity=JPP.make(),
                                   plastic_c=jnp.asarray(ones))
    t_out = t_net.learning_rollout(tp, t_net.SNNState.zeros((b,), n, device="cpu"),
                                   PlasticityState.zeros((b,), n, device="cpu"),
                                   torch.as_tensor(ext), ticks, plasticity=PlasticityParams.make(),
                                   plastic_c=torch.as_tensor(ones))
    _assert_learned(t_out, j_out)


def test_learned_weights_round_trip_through_the_bank():
    """STDP-learned weights -> u8 bank -> bytes -> bank: identical registers
    and identical inference spikes, as the reference pins."""
    n, ticks, b = 16, 8, 3
    rng = np.random.default_rng(8)
    c = connectivity.layered([8, 8]).astype(np.float32)
    tp = t_net.SNNParams(w=torch.as_tensor(rng.uniform(0, 64, (n, n)).astype(np.float32)),
                         c=torch.as_tensor(c), w_in=torch.eye(n) * 2.0,
                         lif=LIFParams.make(n, v_th=40.0, device="cpu"))
    ext = torch.as_tensor(_drive(n, ticks, b, seed=9))
    (_, _, w_learned), _ = t_net.learning_rollout(
        tp, t_net.SNNState.zeros((b,), n, device="cpu"),
        PlasticityState.zeros((b,), n, device="cpu"), ext, ticks,
        plasticity=PlasticityParams.make(a_plus=3.0, a_minus=1.0), backend="pallas_fused")
    bank = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
    bank.set_connection_list(c.astype(bool))
    bank.set_thresholds(np.full((n,), 40, np.uint8))
    w_u8 = weights_to_bank(bank, w_learned)
    dev = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
    dev.load_bytes(bank.serialize())
    assert dev.serialize() == bank.serialize()
    np.testing.assert_array_equal(dev.weights, w_u8)

    def spikes(bk):
        p = dataclasses.replace(t_net.params_from_registers(bk, device="cpu"),
                                w_in=torch.eye(n) * 2.0)
        return t_net.rollout(p, t_net.SNNState.zeros((b,), n, device="cpu"), ext, ticks)[1]

    assert torch.equal(spikes(bank), spikes(dev))


@pytest.mark.parametrize("learning", [False, True])
def test_interop_round_trip_of_carries(learning):
    n, b = 9, 2
    rng = np.random.default_rng(14)
    tree = {"state.lif.v": rng.normal(size=(b, n)).astype(np.float32),
            "state.lif.r": rng.integers(0, 3, (b, n)).astype(np.int32),
            "state.lif.y": (rng.random((b, n)) < 0.5).astype(np.float32),
            "state.delay_buf": rng.random((b, 1, n)).astype(np.float32),
            "state.tick": np.asarray(3, np.int32)}
    if learning:
        tree.update({"plast.x_pre": rng.random((b, n)).astype(np.float32),
                     "plast.x_post": rng.random((b, n)).astype(np.float32),
                     "plast.elig": rng.normal(size=(n, n)).astype(np.float32),
                     "w": rng.uniform(0, 255, (n, n)).astype(np.float32)})
    carry = interop.carry_from_numpy(tree, "cpu")
    assert isinstance(carry, TickCarry) and (carry.w is not None) == learning
    back = interop.carry_to_numpy(carry)
    assert set(back) == set(tree)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
