"""Parity of the port's LIF step and spike encoders/decoders with the JAX package.

Tolerances: bitwise for ``fixed_leak`` and ``int`` on the u8 grid (integer
state, drive and registers: every f32 operation is exact) and for every
encoder and decoder (deterministic); Euler with a non-dyadic float leak is
held to ``rtol=1e-6, atol=1e-5`` on the membrane (one f32 rounding of
difference allowed) and exactly on spikes and refractory counters.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as j_enc
from repro.core import lif as j_lif
from repro_torch.core import encoding as t_enc
from repro_torch.core import lif as t_lif


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _lif_inputs(mode, seed, shape=(3, 29)):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    if mode == "euler":
        v = rng.normal(0, 40, shape).astype(np.float32)
        leak = rng.uniform(0.05, 0.3, n).astype(np.float32)
        gain = rng.uniform(0.5, 1.5, n).astype(np.float32)
    else:
        v = rng.integers(-30, 200, shape).astype(np.float32)
        leak = rng.integers(0, 9, n).astype(np.float32)
        gain = np.ones(n, np.float32)
    return {
        "v": v, "r": rng.integers(0, 3, shape).astype(np.int32),
        "y": (rng.random(shape) < 0.2).astype(np.float32),
        "syn": rng.integers(0, 255, shape).astype(np.float32),
        "v_th": rng.integers(20, 160, n).astype(np.float32), "leak": leak,
        "r_ref": rng.integers(0, 4, n).astype(np.int32), "gain": gain,
        "i_bias": rng.integers(0, 5, n).astype(np.float32),
        "v_reset": rng.integers(-3, 3, n).astype(np.float32),
    }


def _run_both(mode, reset, x):
    names = ("v_th", "leak", "r_ref", "gain", "i_bias", "v_reset")
    jp = j_lif.LIFParams(**{k: jnp.asarray(x[k]) for k in names})
    tp = t_lif.LIFParams(**{k: torch.as_tensor(x[k]) for k in names})
    js = j_lif.LIFState(v=jnp.asarray(x["v"]), r=jnp.asarray(x["r"]), y=jnp.asarray(x["y"]))
    ts = t_lif.LIFState(v=torch.as_tensor(x["v"]), r=torch.as_tensor(x["r"]),
                        y=torch.as_tensor(x["y"]))
    jo = j_lif.lif_step(js, jnp.asarray(x["syn"]), jp, mode=mode, reset=reset)
    to = t_lif.lif_step(ts, torch.as_tensor(x["syn"]), tp, mode=mode, reset=reset)
    return jo, to


@pytest.mark.parametrize("reset", ["zero", "subtract"])
@pytest.mark.parametrize("mode", ["fixed_leak", "int", "euler"])
def test_lif_step_matches_reference(mode, reset):
    x = _lif_inputs(mode, seed=len(mode) + len(reset))
    state = x
    for _ in range(4):   # several ticks, so refractory counters cycle
        jo, to = _run_both(mode, reset, state)
        for f in ("r", "y"):
            np.testing.assert_array_equal(to.__dict__[f].numpy(), np.asarray(jo.__dict__[f]))
        if mode == "euler":
            np.testing.assert_allclose(to.v.numpy(), np.asarray(jo.v), rtol=1e-6, atol=1e-5)
        else:
            np.testing.assert_array_equal(to.v.numpy(), np.asarray(jo.v))
        state = dict(state, v=np.array(jo.v, np.float32), r=np.array(jo.r),
                     y=np.array(jo.y, np.float32))


def test_lif_make_zeros_and_surrogate():
    p = t_lif.LIFParams.make(5, v_th=2.0, leak=0.5, r_ref=3, device="cpu")
    q = j_lif.LIFParams.make(5, v_th=2.0, leak=0.5, r_ref=3)
    for f in ("v_th", "leak", "r_ref", "gain", "i_bias", "v_reset"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(q, f)))
    assert p.r_ref.dtype == torch.int32
    z = t_lif.LIFState.zeros((2, 3), 5, device="cpu")
    assert z.v.shape == (2, 3, 5) and z.r.dtype == torch.int32
    # The surrogate spike (the classifier slice): the same forward step as the
    # hard spike and as the reference's surrogate step, bitwise.
    syn = np.random.default_rng(2).uniform(0, 4, (2, 3, 5)).astype(np.float32)
    for mode in ("fixed_leak", "euler"):
        soft = t_lif.lif_step(z, torch.from_numpy(syn), p, mode=mode, surrogate=True)
        hard = t_lif.lif_step(z, torch.from_numpy(syn), p, mode=mode)
        ref = j_lif.lif_step(j_lif.LIFState.zeros((2, 3), 5), jnp.asarray(syn), q, mode=mode,
                             surrogate=True)
        for f in ("v", "r", "y"):
            assert torch.equal(getattr(soft, f), getattr(hard, f))
            np.testing.assert_array_equal(getattr(soft, f).numpy(), np.asarray(getattr(ref, f)))
    with pytest.raises(ValueError):
        t_lif.lif_step(z, torch.zeros(2, 3, 5), p, mode="bogus")


def _feat(seed, shape=(4, 6)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 1.3, shape).astype(np.float32)
    x[0, :3] = [0.0, 0.5, 1.0]   # exact edges: silence, a rounding tie, saturation
    return x


@pytest.mark.parametrize("name,kw", [
    ("binarize", {}), ("binarize", {"threshold": 0.3}),
    ("level_encode", {}), ("level_encode", {"levels": 7, "x_max": 1.2}),
    ("rate_encode", {"n_ticks": 9}), ("rate_encode", {"n_ticks": 16, "x_max": 0.8}),
    ("latency_encode", {"n_ticks": 8}), ("latency_encode", {"n_ticks": 5, "x_max": 2.0}),
])
def test_encoders_bitwise(name, kw):
    x = _feat(len(name) + len(kw))
    got = getattr(t_enc, name)(torch.as_tensor(x), **kw)
    want = getattr(j_enc, name)(jnp.asarray(x), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _raster(seed, shape=(7, 3, 5), p=0.15):
    rng = np.random.default_rng(seed)
    r = (rng.random(shape) < p).astype(np.float32)
    r[:, 1, :] = 0.0              # one all-silent batch row
    r[2, 0, 1] = r[2, 0, 3] = 1   # a first-spike tie
    return r


def test_decoders_bitwise_incl_silent_sentinel_and_fallback():
    r = _raster(3)
    rng = np.random.default_rng(4)
    v = rng.normal(0, 1, r.shape[1:]).astype(np.float32)
    tr, jr = torch.as_tensor(r), jnp.asarray(r)
    np.testing.assert_array_equal(t_enc.decode_spike_count(tr).numpy(),
                                  np.asarray(j_enc.decode_spike_count(jr)))
    np.testing.assert_array_equal(t_enc.decode_spike_count(tr, axis=0).numpy(),
                                  np.asarray(j_enc.decode_spike_count(jr, axis=0)))
    first = t_enc.decode_first_spike(tr).numpy()
    np.testing.assert_array_equal(first, np.asarray(j_enc.decode_first_spike(jr)))
    assert first[1] == -1         # the all-silent row gets the sentinel, not class 0
    np.testing.assert_array_equal(
        t_enc.decode_first_spike(tr, torch.as_tensor(v)).numpy(),
        np.asarray(j_enc.decode_first_spike(jr, jnp.asarray(v))))
    np.testing.assert_array_equal(
        t_enc.decode_first_spike(tr, silent=9).numpy(),
        np.asarray(j_enc.decode_first_spike(jr, silent=9)))
    np.testing.assert_array_equal(t_enc.decode_potential(torch.as_tensor(v)).numpy(),
                                  np.asarray(j_enc.decode_potential(jnp.asarray(v))))
    silent = torch.zeros(4, 3)
    assert int(t_enc.decode_first_spike(silent)) == int(
        j_enc.decode_first_spike(jnp.zeros((4, 3)))) == -1
