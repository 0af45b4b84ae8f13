"""Kernels B1 (``lif_step``) and B2 (``tick_fused``): the port's plain twins
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

The CUDA kernels themselves run only on an NVIDIA GPU: ``test_cuda_*``
launches them against their twins there and skips elsewhere.

Tolerances: bitwise for ``fixed_leak`` on the u8 grid (integer weights,
0/1 spikes, integer state, drive and registers: every f32 sum and update
is exact in any order). Euler with a float leak: membrane within
``rtol=1e-6, atol=1e-4`` (the products are exact; the epilogue may round
once differently where XLA contracts a multiply-add), spikes and
refractory counters exact.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lif import LIFParams as JLIFParams
from repro.core.lif import LIFState as JLIFState
from repro.core.network_types import SNNParams as JSNNParams
from repro.core.network_types import SNNState as JSNNState
from repro.kernels import ops as j_ops
from repro_torch import interop
from repro_torch.core.lif import LIFState
from repro_torch.kernels import lif_step, ops, ref, tick_fused

N = 37   # ragged: not a multiple of any block size
B = 3
ROWS = ("v_th", "leak", "r_ref", "gain", "i_bias", "v_reset")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(mode, seed, n=N):
    """Register-grid parameters as the interop dict (u8 weights, 0/1 mask)."""
    rng = np.random.default_rng(seed)
    c = (rng.random((n, n)) < 0.5).astype(np.float32)
    leak = (rng.uniform(0.05, 0.4, n) if mode == "euler" else rng.integers(0, 9, n))
    return {
        "w": rng.integers(0, 256, (n, n)).astype(np.float32), "c": c,
        "w_in": np.eye(n, dtype=np.float32),
        "lif.v_th": rng.integers(100, 2500, n).astype(np.float32),
        "lif.leak": leak.astype(np.float32),
        "lif.r_ref": rng.integers(0, 4, n).astype(np.int32),
        "lif.gain": np.ones(n, np.float32),
        "lif.i_bias": rng.integers(0, 4, n).astype(np.float32),
        "lif.v_reset": np.zeros(n, np.float32),
    }


def _state(seed, D, n=N, b=B):
    rng = np.random.default_rng(seed)
    return {
        "lif.v": rng.integers(-5, 1500, (b, n)).astype(np.float32),
        "lif.r": rng.integers(0, 3, (b, n)).astype(np.int32),
        "lif.y": (rng.random((b, n)) < 0.3).astype(np.float32),
        "delay_buf": (rng.random((b, D, n)) < 0.3).astype(np.float32),
        "tick": np.asarray(5, np.int32),
    }


def _jax_params(t):
    return JSNNParams(w=jnp.asarray(t["w"]), c=jnp.asarray(t["c"]), w_in=jnp.asarray(t["w_in"]),
                      lif=JLIFParams(**{k: jnp.asarray(t[f"lif.{k}"]) for k in ROWS}))


def _jax_state(s):
    return JSNNState(lif=JLIFState(v=jnp.asarray(s["lif.v"]), r=jnp.asarray(s["lif.r"]),
                                   y=jnp.asarray(s["lif.y"])),
                     delay_buf=jnp.asarray(s["delay_buf"]), tick=jnp.asarray(s["tick"]))


def _check(mode, got, want):
    """``got``/``want``: sequences of (name, port tensor, reference array)."""
    for name, g, w in zip(("v", "r", "y", "ring"), got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        if name == "v" and mode == "euler":
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("ring", ["D1", "D3", "delays_D3"])
@pytest.mark.parametrize("premasked", [True, False], ids=["premasked", "w+c"])
@pytest.mark.parametrize("drive", [True, False], ids=["drive", "nodrive"])
@pytest.mark.parametrize("mode", ["fixed_leak", "euler"])
def test_fused_tick_twin_matches_pallas(mode, drive, premasked, ring):
    D = 1 if ring == "D1" else 3
    seed = zlib.crc32(repr((mode, drive, premasked, ring)).encode()) % 1000
    tree, st = _tree(mode, seed), _state(seed + 1, D)
    rng = np.random.default_rng(seed + 2)
    ext = (rng.integers(0, 256, (B, N)) * (rng.random((B, N)) < 0.3)).astype(np.float32)
    delays = rng.integers(1, D + 1, (N, N)).astype(np.int32) if ring == "delays_D3" else None

    jp = _jax_params(tree)
    jwc = jp.w * jp.c if premasked else None
    j_lif, j_ring = j_ops.fused_tick(
        _jax_state(st), jp, jnp.asarray(ext) if drive else None, wc=jwc,
        delays=None if delays is None else jnp.asarray(delays), mode=mode)

    tp = interop.params_from_numpy(tree, "cpu")
    t_lif, t_ring = ops.fused_tick(
        interop.state_from_numpy(st, "cpu"), tp, torch.as_tensor(ext) if drive else None,
        wc=tp.w * tp.c if premasked else None,
        delays=None if delays is None else torch.as_tensor(delays), mode=mode)
    _check(mode, (t_lif.v, t_lif.r, t_lif.y, t_ring),
           (j_lif.v, j_lif.r, j_lif.y, j_ring))


@pytest.mark.parametrize("drive", [True, False], ids=["drive", "nodrive"])
@pytest.mark.parametrize("mode", ["fixed_leak", "euler"])
def test_fused_lif_step_twin_matches_pallas(mode, drive):
    seed = 7 + len(mode) + drive
    tree, st = _tree(mode, seed), _state(seed + 1, 1)
    rng = np.random.default_rng(seed)
    s = (rng.random((B, N)) < 0.4).astype(np.float32)
    drv = rng.integers(0, 256, (B, N)).astype(np.float32) if drive else None
    rows = [tree[f"lif.{k}"] for k in ROWS]
    want = j_ops.fused_lif_step_arrays(
        jnp.asarray(s), jnp.asarray(tree["w"]), jnp.asarray(tree["c"]),
        jnp.asarray(st["lif.v"]), jnp.asarray(st["lif.r"]),
        None if drv is None else jnp.asarray(drv), *map(jnp.asarray, rows), mode=mode)
    args = (torch.as_tensor(s), torch.as_tensor(tree["w"]), torch.as_tensor(tree["c"]),
            torch.as_tensor(st["lif.v"]), torch.as_tensor(st["lif.r"]),
            None if drv is None else torch.as_tensor(drv), *map(torch.as_tensor, rows))
    _check(mode, ref.fused_lif_step_ref(*args, mode=mode), want)
    # The wrapper takes the twin for CPU tensors.
    _check(mode, lif_step.fused_lif_step(*args, mode=mode), want)


def _slot_tree(seed, S):
    trees = [_tree("fixed_leak", seed + i) for i in range(S)]
    return trees, {k: np.stack([t[k] for t in trees]) for k in trees[0]}


@pytest.mark.parametrize("D", [1, 3])
def test_slot_axis_equals_per_slot_reference(D):
    """A leading slot axis on every leaf (the server's layout) equals the
    reference run slot by slot."""
    S = 2
    trees, stacked = _slot_tree(40 + D, S)
    states = [_state(50 + D + i, D, b=1) for i in range(S)]
    st = {k: np.stack([s[k] for s in states]) if k != "tick" else states[0]["tick"]
          for k in states[0]}
    rng = np.random.default_rng(D)
    ext = rng.integers(0, 256, (S, 1, N)).astype(np.float32)
    tp = interop.params_from_numpy(stacked, "cpu")
    t_lif, t_ring = ops.fused_tick(interop.state_from_numpy(st, "cpu"), tp,
                                   torch.as_tensor(ext), wc=tp.w * tp.c)
    spikes = (rng.random((S, 1, N)) < 0.4).astype(np.float32)
    t_b1 = ops.fused_lif_step_slots(
        LIFState(v=torch.as_tensor(st["lif.v"]), r=torch.as_tensor(st["lif.r"]),
                 y=torch.as_tensor(st["lif.y"])),
        torch.as_tensor(spikes), tp, torch.as_tensor(ext))
    for i in range(S):
        jp = _jax_params(trees[i])
        j_lif, j_ring = j_ops.fused_tick(_jax_state(states[i]), jp, jnp.asarray(ext[i]),
                                         wc=jp.w * jp.c)
        _check("fixed_leak", (t_lif.v[i], t_lif.r[i], t_lif.y[i], t_ring[i]),
               (j_lif.v, j_lif.r, j_lif.y, j_ring))
        j_b1 = j_ops.fused_lif_step(_jax_state(states[i]).lif, jnp.asarray(spikes[i]), jp,
                                    jnp.asarray(ext[i]))
        _check("fixed_leak", (t_b1.v[i], t_b1.r[i], t_b1.y[i]), (j_b1.v, j_b1.r, j_b1.y))


def test_ring_contract_and_modes():
    """In-place ring writes are refused where they would race, and the
    kernels take fixed_leak and euler only (int runs on the jnp path)."""
    tree, st = _tree("fixed_leak", 3), _state(4, 3)
    p = interop.params_from_numpy(tree, "cpu")
    s = interop.state_from_numpy(st, "cpu")
    ring = s.delay_buf
    slots = torch.tensor([2, 0], dtype=torch.int32)
    rows = [getattr(p.lif, k) for k in ROWS]
    delays = torch.ones((N, N), dtype=torch.int32)
    base = (slots, ring, p.w, p.c)
    rest = (s.lif.v, s.lif.r, None, ring, *rows)
    with pytest.raises(ValueError, match="separate buffer"):
        tick_fused.fused_tick(*base, delays, *rest, dly_out=ring)
    with pytest.raises(ValueError, match="fused tick supports"):
        tick_fused.fused_tick(*base, None, *rest, mode="int")
    with pytest.raises(ValueError, match="lif_step kernel supports"):
        lif_step.fused_lif_step(s.lif.y, p.w, p.c, s.lif.v, s.lif.r, None, *rows, mode="int")
    # In place without per-synapse delays: the write slot changes, the rest stay.
    before = ring.clone()
    v, r, y, out = tick_fused.fused_tick(*base, None, *rest, dly_out=ring)
    assert out.data_ptr() == ring.data_ptr()
    torch.testing.assert_close(out[:, 0], y, rtol=0, atol=0)
    torch.testing.assert_close(out[:, 1:], before[:, 1:], rtol=0, atol=0)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the hand-written kernels have "
                    "no CPU mode (their plain twins are tested above)")
    return torch.device("cuda")


def _rect_inputs(rng, S, b, n, k, D, dev):
    """u8-grid inputs with K != N: (S?, K, N) weights, a (S, b, D, K) history."""
    t = lambda a: torch.as_tensor(a).to(dev)
    return {
        "w": t(rng.integers(0, 256, (k, n)).astype(np.float32)),
        "c": t((rng.random((k, n)) < 0.5).astype(np.float32)),
        "delays": t(rng.integers(1, D + 1, (k, n)).astype(np.int32)),
        "rows": [t(rng.integers(100, 2500, n).astype(np.float32)),
                 t(rng.integers(0, 9, n).astype(np.float32)),
                 t(rng.integers(0, 4, n).astype(np.int32)), t(np.ones(n, np.float32)),
                 t(rng.integers(0, 4, n).astype(np.float32)), t(np.zeros(n, np.float32))],
        "hist": t((rng.random((S, b, D, k)) < 0.3).astype(np.float32)),
        "v": t(rng.integers(-5, 1500, (S, b, n)).astype(np.float32)),
        "r": t(rng.integers(0, 3, (S, b, n)).astype(np.int32)),
        "drive": t(rng.integers(0, 256, (S, b, n)).astype(np.float32)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("S,slotted,b,n,k", [
    (1, False, 4, N, N), (3, True, 4, N, N),
    # one network of 8 and 16 rows (a K split across a cluster), with a K that
    # is not a multiple of the stage rows times the split: async and element
    (1, False, 8, 256, 1060), (1, False, 16, 256, 1060), (1, False, 16, 256, 1061)])
def test_cuda_kernels_match_twins(S, slotted, b, n, k):
    """On the card: B1 and B2 in every variant against their plain twins,
    bitwise (u8 grid), at a ragged width with a slot axis, and at one network
    of 8 and 16 rows with K split across a cluster."""
    dev = _cuda_or_skip()
    if n != k:
        rng = np.random.default_rng(63)
        D = 3
        x = _rect_inputs(rng, S, b, n, k, D, dev)
        wc = x["w"] * x["c"]
        s = x["hist"][:, :, 0].contiguous()
        slots = torch.tensor([5 % D, 6 % D], dtype=torch.int32, device=dev)
        for w, c in ((wc, None), (x["w"], x["c"])):
            a = (s, w, c, x["v"], x["r"], x["drive"], *x["rows"])
            got = lif_step.fused_lif_step(*a)
            want = ref.fused_lif_step_ref(*a)
            torch.cuda.synchronize()
            assert all(torch.equal(g, e) for g, e in zip(got, want))
            for dl in (None, x["delays"]):
                args = (slots, x["hist"], w, c, dl, x["v"], x["r"], x["drive"], None,
                        *x["rows"])
                got = tick_fused.fused_tick(*args)
                want = ref.fused_tick_ref(*args)
                torch.cuda.synchronize()
                assert all(torch.equal(g, e) for g, e in zip(got[:3], want[:3]))
                assert got[3] is None and want[3] is None
        assert lif_step.last_plan.ks > 1 and tick_fused.last_plan.ks > 1
        assert (tick_fused.last_plan.path != "element") == (k % 4 == 0)
        return
    trees, stacked = _slot_tree(60, S)
    tree = stacked if slotted else trees[0]
    p = interop.params_from_numpy(tree, dev)
    rows = [getattr(p.lif, k) for k in ROWS]
    rng = np.random.default_rng(61)
    t = lambda a: torch.as_tensor(a).to(dev)
    for D in (1, 3):
        st = _state(62 + D, D, b=b)
        v, r = t(np.stack([st["lif.v"]] * S)), t(np.stack([st["lif.r"]] * S))
        ring = t(np.stack([st["delay_buf"]] * S))
        y = t(np.stack([st["lif.y"]] * S))
        drive = t(rng.integers(0, 256, (S, b, N)).astype(np.float32))
        slots = t(np.array([5 % D, 6 % D], np.int32))
        delays = t(rng.integers(1, D + 1, (N, N)).astype(np.int32))
        for premasked in (True, False):
            w, c = (p.w * p.c, None) if premasked else (p.w, p.c)
            for dl in (None, delays):
                read = ring if (D > 1 or dl is not None) else y.unsqueeze(-2)
                full = ring if D > 1 else None
                args = (slots, read, w, c, dl, v, r, drive, full, *rows)
                want = ref.fused_tick_ref(*args)
                got = tick_fused.fused_tick(*args)
                torch.cuda.synchronize()
                for g, e in zip(got, want):
                    assert (g is None) == (e is None)
                    if g is not None:
                        assert torch.equal(g, e)
        want = ref.fused_lif_step_ref(y, p.w, p.c, v, r, drive, *rows)
        got = lif_step.fused_lif_step(y, p.w, p.c, v, r, drive, *rows)
        torch.cuda.synchronize()
        assert all(torch.equal(g, e) for g, e in zip(got, want))
