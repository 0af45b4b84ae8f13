"""The port's plasticity package and kernel B5 (``stdp_update``) against the
JAX package.

The same inputs, made with numpy from a seed, go through the reference's
``repro.plasticity`` / ``repro.kernels`` functions and the port's. The CUDA
kernel itself runs only on an NVIDIA GPU: ``test_cuda_*`` launches it against
its twin there and skips elsewhere.

Tolerances:

* The twin against the reference's jnp oracle (``fused_stdp_step_ref``):
  bitwise at B = 1, where every batch sum is a single product; at B > 1
  ``rtol=atol=1e-6``, the reference's own kernel-vs-oracle tolerance
  (``tests/test_plasticity.py``), because the batch sum's order may differ.
* The twin against the reference's Pallas kernel in interpret mode:
  ``rtol=atol=1e-6`` at every B. XLA contracts the interpreted kernel's
  trace update ``decay * x + s`` into a fused multiply-add, which rounds once
  where the reference's oracle and the port round twice (1 ulp).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.registers import RegisterBank, WeightLayout
from repro.kernels import ops as j_ops
from repro.kernels.ref import fused_stdp_step_ref as j_stdp_ref
from repro.plasticity import (
    PlasticityParams as JPP, PlasticityState as JPS, apply_reward as j_apply_reward,
    plasticity_step as j_plasticity_step, quantize_weights as j_quantize,
)
from repro.plasticity import traces as j_traces
from repro_torch import interop
from repro_torch.core.registers import RegisterBank as TBank
from repro_torch.core.registers import WeightLayout as TLayout
from repro_torch.kernels import ref, stdp_update
from repro_torch.plasticity import (
    PlasticityParams, PlasticityState, apply_reward, plasticity_step, quantize_weights,
    weights_from_bank, weights_to_bank,
)
from repro_torch.plasticity import traces
from repro_torch.plasticity.stdp import stdp_step_ref

SHAPES = [(1, 8, 8), (4, 74, 74), (3, 130, 70), (8, 128, 128), (1, 130, 70)]
HYPERS = dict(a_plus=0.8, a_minus=0.3, decay_pre=0.7, decay_post=0.6,
              decay_elig=0.9, lr_reward=0.4, w_min=0.0, w_max=255.0)
NAMES = ("s_pre", "x_pre", "s_post", "x_post", "w", "c", "elig")
OUTS = ("w", "elig", "x_pre", "x_post")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(seed, b, k, n, lead=()):
    """The reference test's inputs: 0/1 spikes, traces in [0, 1), weights in
    [0, 255), a half-dense mask, normal eligibility."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    return dict(
        s_pre=f(rng.random(lead + (b, k)) < 0.3), x_pre=f(rng.random(lead + (b, k))),
        s_post=f(rng.random(lead + (b, n)) < 0.3), x_post=f(rng.random(lead + (b, n))),
        w=f(rng.uniform(0, 255, lead + (k, n))), c=f(rng.random(lead + (k, n)) < 0.5),
        elig=f(rng.normal(size=lead + (k, n))))


def _torch(case):
    return [torch.as_tensor(case[k]) for k in NAMES]


def _assert_out(got, want, *, exact, what=""):
    for name, g, w in zip(OUTS, got, want):
        g, w = np.asarray(g), np.asarray(w)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}/{name}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f"{what}/{name}")


# -- traces and parameters ---------------------------------------------------


@pytest.mark.parametrize("tau", [0.5, 2.0, 3.0, 10.0, 40.0])
def test_traces_match_reference(tau):
    d = traces.decay_from_tau(tau)
    assert d == j_traces.decay_from_tau(tau)
    assert traces.trace_steady_state(0.3, d) == j_traces.trace_steady_state(0.3, d)
    rng = np.random.default_rng(int(tau * 10))
    x = rng.random((3, 17)).astype(np.float32)
    s = (rng.random((3, 17)) < 0.4).astype(np.float32)
    got = traces.trace_step(torch.as_tensor(x), torch.as_tensor(s), d)
    want = j_traces.trace_step(jnp.asarray(x), jnp.asarray(s), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="positive"):
        traces.decay_from_tau(0.0)


@pytest.mark.parametrize("rule", ["stdp", "rstdp"])
def test_params_make_and_validation(rule):
    kw = dict(tau_pre=2.0, tau_post=5.0, tau_elig=7.0, a_plus=0.5, a_minus=0.25,
              lr_reward=0.3, w_min=1.0, w_max=200.0)
    got = dataclasses.asdict(PlasticityParams.make(rule, **kw))
    assert got == dataclasses.asdict(JPP.make(rule, **kw))
    assert dataclasses.asdict(PlasticityParams()) == dataclasses.asdict(JPP())
    for bad in (dict(rule="hebbian"), dict(w_min=-1.0), dict(w_max=300.0),
                dict(w_min=9.0, w_max=9.0)):
        with pytest.raises(ValueError):
            JPP(**bad)
        with pytest.raises(ValueError):
            PlasticityParams(**bad)
    hash(PlasticityParams.make(rule))


def test_state_zeros_shapes():
    st = PlasticityState.zeros((2, 3), 5, 7, device="cpu")
    ref_st = JPS.zeros((2, 3), 5, 7)
    for k in ("x_pre", "x_post", "elig"):
        assert tuple(getattr(st, k).shape) == getattr(ref_st, k).shape
        assert not getattr(st, k).any()
    slotted = PlasticityState.zeros((), 6, device="cpu", slots=4)
    assert slotted.x_pre.shape == (4, 6) and slotted.elig.shape == (4, 6, 6)


# -- the twin and the kernel wrapper against the reference -------------------


@pytest.mark.parametrize("rule", ["stdp", "rstdp"])
@pytest.mark.parametrize("b,k,n", SHAPES)
def test_twin_matches_reference_oracle(b, k, n, rule):
    case = _case(b * 1000 + k + n, b, k, n)
    want = j_stdp_ref(*[jnp.asarray(case[x]) for x in NAMES], jnp.asarray(0.5),
                      rule=rule, **HYPERS)
    got = ref.fused_stdp_step_ref(*_torch(case), torch.tensor(0.5), rule=rule, **HYPERS)
    _assert_out(got, want, exact=b == 1, what=f"{rule} {b}x{k}x{n}")


@pytest.mark.parametrize("rule", ["stdp", "rstdp"])
@pytest.mark.parametrize("b,k,n", SHAPES)
def test_twin_matches_pallas_interpret(b, k, n, rule):
    case = _case(b * 7 + k + n, b, k, n)
    want = j_ops.fused_stdp_step(*[jnp.asarray(case[x]) for x in NAMES],
                                 jnp.asarray(-0.75), rule=rule, **HYPERS)
    got = stdp_update.fused_stdp_step(*_torch(case), torch.tensor(-0.75), rule=rule,
                                      **HYPERS)
    _assert_out(got, want, exact=False, what=f"{rule} {b}x{k}x{n}")


@pytest.mark.parametrize("rule", ["stdp", "rstdp"])
def test_slot_axis_equals_per_slot_reference(rule):
    """(S, B, .) traces with (S, K, N) weights and a per-slot reward equal S
    separate reference calls; a shared (K, N) mask broadcasts."""
    S, b, k, n = 3, 1, 29, 37
    case = _case(11, b, k, n, lead=(S,))
    case["c"] = case["c"][0]
    rewards = np.array([0.5, -1.0, 2.0], np.float32)
    got = stdp_update.fused_stdp_step(*_torch(case), torch.as_tensor(rewards), rule=rule,
                                      **HYPERS)
    for s in range(S):
        args = [jnp.asarray(case[x] if x == "c" else case[x][s]) for x in NAMES]
        want = j_stdp_ref(*args, jnp.asarray(rewards[s]), rule=rule, **HYPERS)
        _assert_out([g[s] for g in got], want, exact=True, what=f"slot {s}")


@pytest.mark.parametrize("rule", ["stdp", "rstdp"])
def test_unmasked_synapses_bit_identical(rule):
    """Where c == 0 the weight comes back bit for bit -- not even clipped."""
    case = _case(0, 4, 74, 74)
    case["w"][case["c"] == 0] = -127.0
    state = PlasticityState(*(torch.as_tensor(case[k]) for k in ("x_pre", "x_post", "elig")))
    pp = PlasticityParams(rule=rule, **HYPERS)
    mask = case["c"] == 0
    for backend in ("jnp", "pallas"):
        _, w2 = plasticity_step(state, torch.as_tensor(case["s_pre"]),
                                torch.as_tensor(case["s_post"]), torch.as_tensor(case["w"]),
                                torch.as_tensor(case["c"]), pp, 0.5, backend=backend)
        w2 = w2.numpy()
        np.testing.assert_array_equal(w2[mask], case["w"][mask])
        assert w2[~mask].min() >= HYPERS["w_min"] and w2[~mask].max() <= HYPERS["w_max"]


@pytest.mark.parametrize("rule", ["stdp", "rstdp"])
def test_learn_until_gates_every_output(rule):
    """Closed gate: w, elig and both traces come back unchanged; open gate:
    the ungated result; per slot, each slot follows its own bound."""
    S = 2
    case = _case(3, 1, 20, 24, lead=(S,))
    args = _torch(case)
    r = torch.tensor([1.5, -0.5])
    free = ref.fused_stdp_step_ref(*args, r, rule=rule, **HYPERS)
    tick = torch.tensor(5, dtype=torch.int32)
    until = torch.tensor([6, 5], dtype=torch.int32)   # slot 0 open, slot 1 closed
    for fn in (ref.fused_stdp_step_ref, stdp_update.fused_stdp_step):
        got = fn(*args, r, rule=rule, tick=tick, learn_until=until, **HYPERS)
        for name, g, f, x in zip(OUTS, got, free, (args[4], args[6], args[1], args[3])):
            assert torch.equal(g[0], f[0]), name
            assert torch.equal(g[1], x[1]), name
    with pytest.raises(ValueError, match="both or neither"):
        stdp_update.fused_stdp_step(*args, r, rule=rule, tick=tick, **HYPERS)


@pytest.mark.parametrize("rule", ["stdp", "rstdp"])
def test_wrapper_in_place_contract(rule):
    case = _case(4, 2, 16, 18)
    args = _torch(case)
    want = ref.fused_stdp_step_ref(*args, torch.tensor(0.25), rule=rule, **HYPERS)
    w0, e0 = args[4].clone(), args[6].clone()
    got = stdp_update.fused_stdp_step(*args, torch.tensor(0.25), rule=rule, **HYPERS)
    assert torch.equal(args[4], w0) and torch.equal(args[6], e0)
    got = stdp_update.fused_stdp_step(*args, torch.tensor(0.25), rule=rule, in_place=True,
                                      **HYPERS)
    assert got.w is args[4] and got.elig is args[6]
    _assert_out(got, want, exact=True)
    if rule == "stdp":
        assert torch.equal(args[6], e0), "stdp leaves the eligibility untouched"
    with pytest.raises(ValueError, match="rule"):
        stdp_update.fused_stdp_step(*args, torch.tensor(0.0), rule="hebbian", **HYPERS)


# -- the state bridge ----------------------------------------------------------


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("rule", ["stdp", "rstdp"])
def test_plasticity_step_matches_reference(rule, backend):
    """Batch dims (2, 3) flatten to B = 6 and come back; a None reward is 0."""
    rng = np.random.default_rng(5)
    f = lambda a: np.asarray(a, np.float32)
    s_pre, s_post = f(rng.random((2, 3, 21)) < 0.4), f(rng.random((2, 3, 21)) < 0.4)
    x_pre, x_post = f(rng.random((2, 3, 21))), f(rng.random((2, 3, 21)))
    w, c = f(rng.uniform(0, 255, (21, 21))), f(rng.random((21, 21)) < 0.6)
    elig = f(rng.normal(size=(21, 21)))
    pp = PlasticityParams.make(rule, tau_pre=2.0, a_plus=0.6, a_minus=0.35)
    jpp = JPP.make(rule, tau_pre=2.0, a_plus=0.6, a_minus=0.35)
    for reward in (None, -1.25):
        jst, jw = j_plasticity_step(
            JPS(jnp.asarray(x_pre), jnp.asarray(x_post), jnp.asarray(elig)),
            jnp.asarray(s_pre), jnp.asarray(s_post), jnp.asarray(w), jnp.asarray(c), jpp,
            None if reward is None else jnp.asarray(reward))
        tst, tw = plasticity_step(
            PlasticityState(torch.as_tensor(x_pre), torch.as_tensor(x_post),
                            torch.as_tensor(elig)),
            torch.as_tensor(s_pre), torch.as_tensor(s_post), torch.as_tensor(w),
            torch.as_tensor(c), pp, reward, backend=backend)
        assert tst.x_pre.shape == (2, 3, 21)
        for g, want in ((tw, jw), (tst.elig, jst.elig), (tst.x_pre, jst.x_pre),
                        (tst.x_post, jst.x_post)):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    st2, w2 = stdp_step_ref(tst, torch.as_tensor(s_pre), torch.as_tensor(s_post), tw,
                            torch.as_tensor(c), pp)
    st3, w3 = plasticity_step(tst, torch.as_tensor(s_pre), torch.as_tensor(s_post), tw,
                              torch.as_tensor(c), pp, backend="jnp")
    assert torch.equal(w2, w3) and torch.equal(st2.elig, st3.elig)
    with pytest.raises(ValueError, match="backend"):
        plasticity_step(tst, torch.as_tensor(s_pre), torch.as_tensor(s_post), tw,
                        torch.as_tensor(c), pp, backend="event")


def test_rstdp_zero_reward_banks_eligibility():
    case = _case(2, 2, 16, 16)
    pp = PlasticityParams.make("rstdp", a_plus=1.0, a_minus=0.25)
    st2, w2 = plasticity_step(PlasticityState.zeros((2,), 16, device="cpu"),
                              torch.as_tensor(case["s_pre"]), torch.as_tensor(case["s_post"]),
                              torch.as_tensor(case["w"]), torch.as_tensor(case["c"]), pp)
    np.testing.assert_array_equal(w2.numpy(), case["w"])
    assert st2.elig.abs().max() > 0


# -- reward, quantisation and the register bank --------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_apply_reward_matches_reference(masked):
    rng = np.random.default_rng(6)
    w = rng.uniform(0, 255, (9, 11)).astype(np.float32)
    elig = (rng.normal(size=(9, 11)) * 40).astype(np.float32)
    c = (rng.random((9, 11)) < 0.5).astype(np.float32) if masked else None
    pp, jpp = PlasticityParams.make("rstdp", lr_reward=0.7), JPP.make("rstdp", lr_reward=0.7)
    for r in (1.0, -2.5):
        got = apply_reward(torch.as_tensor(w), torch.as_tensor(elig), r, pp,
                           None if c is None else torch.as_tensor(c))
        want = j_apply_reward(jnp.asarray(w), jnp.asarray(elig), r, jpp,
                              None if c is None else jnp.asarray(c))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_and_bank_round_trip_byte_exact():
    rng = np.random.default_rng(7)
    n = 16
    w = np.clip(rng.normal(128, 60, (n, n)), 0, 255).astype(np.float32)
    w[0, :4] = [0.5, 1.5, 254.5, 2.4999]
    np.testing.assert_array_equal(quantize_weights(torch.as_tensor(w)), j_quantize(w))
    for bad in (-3.0, 300.0):
        with pytest.raises(ValueError, match="u8"):
            quantize_weights(torch.tensor([[bad]]))
    c = rng.random((n, n)) < 0.5
    banks = []
    for Bank, Layout in ((RegisterBank, WeightLayout), (TBank, TLayout)):
        bank = Bank(n, weight_layout=Layout.PER_SYNAPSE)
        bank.set_connection_list(c)
        bank.set_thresholds(np.full((n,), 40, np.uint8))
        banks.append(bank)
    stored = weights_to_bank(banks[1], torch.as_tensor(w))
    from repro.plasticity import weights_to_bank as j_weights_to_bank

    np.testing.assert_array_equal(stored, j_weights_to_bank(banks[0], jnp.asarray(w)))
    assert banks[1].serialize() == banks[0].serialize()
    dev_bank = TBank(n, weight_layout=TLayout.PER_SYNAPSE)
    dev_bank.load_bytes(banks[1].serialize())
    assert dev_bank.serialize() == banks[1].serialize()
    np.testing.assert_array_equal(weights_from_bank(dev_bank, device="cpu").numpy(),
                                  stored.astype(np.float32))
    with pytest.raises(ValueError, match="PER_SYNAPSE"):
        weights_to_bank(TBank(n), torch.as_tensor(w))


def test_interop_round_trip_of_plasticity_state():
    case = _case(8, 3, 10, 12)
    tree = {"x_pre": case["x_pre"], "x_post": case["x_post"], "elig": case["elig"]}
    st = interop.plast_from_numpy(tree, "cpu")
    back = interop.plast_to_numpy(st)
    assert set(back) == set(tree)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    ref_st = JPS(**{k: jnp.asarray(v) for k, v in tree.items()})
    for k in tree:
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(ref_st, k)))


# -- on the card ---------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the hand-written kernels have "
                    "no CPU mode (their plain twins are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["stdp", "rstdp"])
def test_cuda_stdp_kernel_matches_twin(rule):
    """On the card: B5 against its twin, bitwise at B = 1 (slot axis, ragged
    width, gate open and closed, in place), to 1e-6 at B = 8."""
    dev = _cuda_or_skip()
    S, n = 3, 37
    case = _case(9, 1, n, n, lead=(S,))
    args = [t.to(dev) for t in _torch(case)]
    r = torch.tensor([0.5, -1.0, 2.0], device=dev)
    tick = torch.tensor(4, dtype=torch.int32, device=dev)
    until = torch.tensor([9, 4, 5], dtype=torch.int32, device=dev)
    for gate in ({}, {"tick": tick, "learn_until": until}):
        want = ref.fused_stdp_step_ref(*args, r, rule=rule, **gate, **HYPERS)
        w, e = args[4].clone(), args[6].clone()
        got = stdp_update.fused_stdp_step(*args[:4], w, args[5], e, r, rule=rule,
                                          in_place=True, **gate, **HYPERS)
        torch.cuda.synchronize()
        assert all(torch.equal(g, x) for g, x in zip(got, want))
    case = _case(10, 8, 70, 130)
    args = [t.to(dev) for t in _torch(case)]
    want = ref.fused_stdp_step_ref(*args, torch.tensor(0.3, device=dev), rule=rule, **HYPERS)
    got = stdp_update.fused_stdp_step(*args, torch.tensor(0.3, device=dev), rule=rule,
                                      **HYPERS)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, rtol=1e-6, atol=1e-6)
