"""The port's optimizers, schedules, clipping and gradient compression
(``repro_torch.optim``) against the reference's (``repro.optim``) on the
CPU: the reference's ``tests/test_optim.py`` cases, each run on both, and
updates from the same inputs compared.

Tolerances, stated per test: AdamW (float32 and bfloat16 state), the
global norm, the clip and the compression are bitwise (the same float32
operations in the same order), ``warmup_cosine`` bitwise through the warmup
and within ``rtol=1e-6`` on the cosine (``torch.cos`` and ``jnp.cos`` round
differently); Adafactor within
``atol=1e-6`` (its row and column means sum in another order than XLA's:
measured 2.4e-7 on parameters of order 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import clip as j_clip
from repro.optim import compression as j_compression
from repro.optim import schedule as j_schedule
from repro_torch.optim import adafactor, adamw, clip, compression, schedule
from repro_torch.util import tree

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _trees(seed=0, scale=1.0):
    """A nested tree (dict keys out of sorted order, a list, a vector) of
    float32 numpy leaves."""
    rng = np.random.default_rng(seed)
    draw = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"w": draw(8, 5), "b": draw(5), "stages": [{"z": draw(3, 4, 6), "a": draw(4)}]}


def _j(t, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), t)


def _t(t, dtype=torch.float32):
    return tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype), t)


def _pairs(jt, tt):
    """(reference leaf, port leaf) as float32 numpy arrays, in JAX's order."""
    jl = [np.asarray(a, np.float32) for a in jax.tree.leaves(jt)]
    tl = [t.float().numpy() for t in tree.leaves(tt)]
    assert len(jl) == len(tl)
    return list(zip(jl, tl))


def _equal(jt, tt):
    for a, b in _pairs(jt, tt):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# AdamW


def test_adamw_matches_reference_formula():
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    st = adamw.init(p)
    lr, b1, b2, eps, wd = 0.1, 0.9, 0.95, 1e-8, 0.0
    newp, st2 = adamw.update(g, st, p, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=wd)
    m, v = (1 - b1) * 0.5, (1 - b2) * 0.25
    want = np.asarray([1.0, -2.0]) - lr * (m / (1 - b1)) / (np.sqrt(v / (1 - b2)) + eps)
    np.testing.assert_allclose(newp["w"].numpy(), want, rtol=1e-6)
    assert int(st2.step) == 1 and st2.step.dtype == torch.int32
    jw = _j({"w": np.float32([1, -2])})
    jp, _ = j_adamw.update(_j({"w": np.float32([0.5, 0.5])}), j_adamw.init(jw), jw, lr=lr,
                           weight_decay=wd)
    _equal(jp, newp)


def test_adamw_weight_decay_direction():
    p = {"w": torch.tensor([10.0])}
    newp, _ = adamw.update({"w": torch.tensor([0.0])}, adamw.init(p), p, lr=0.1, weight_decay=0.1)
    assert float(newp["w"][0]) < 10.0


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_updates_are_bitwise_the_reference(param_dtype, state_dtype):
    """Five updates under the reference's schedule, tiny and ordinary
    gradients: parameters, ``m``, ``v`` and ``step`` bitwise."""
    jd, td = DTYPES[param_dtype]
    js, ts = DTYPES[state_dtype]
    p = _trees(0)
    jp, tp = _j(p, jd), _t(p, td)
    jst, tst = j_adamw.init(jp, js), adamw.init(tp, ts)
    assert all(t.dtype == ts for t in tree.leaves(tst.m) + tree.leaves(tst.v))
    for i in range(5):
        g = _trees(10 + i, scale=1e-3 if i % 2 else 1.0)
        jlr = j_schedule.warmup_cosine(jst.step, peak_lr=1e-2, warmup_steps=2, total_steps=5)
        tlr = schedule.warmup_cosine(tst.step, peak_lr=1e-2, warmup_steps=2, total_steps=5)
        assert float(tlr) == float(jlr)
        jp, jst = j_adamw.update(_j(g, jd), jst, jp, lr=jlr)
        tp, tst = adamw.update(_t(g, td), tst, tp, lr=tlr)
        for jt, tt in ((jp, tp), (jst.m, tst.m), (jst.v, tst.v)):
            _equal(jt, tt)
        assert all(t.dtype == td for t in tree.leaves(tp))
        assert int(tst.step) == int(jst.step) == i + 1


def test_adamw_bf16_state():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = adamw.init(p, torch.bfloat16)
    assert st.m["w"].dtype == torch.bfloat16
    newp, _ = adamw.update({"w": torch.full((4, 4), 0.1, dtype=torch.bfloat16)}, st, p, lr=0.01)
    assert newp["w"].dtype == torch.bfloat16
    assert torch.isfinite(newp["w"].float()).all()


def test_adamw_converges_on_quadratic():
    p = {"w": torch.tensor([5.0, -3.0])}
    st = adamw.init(p)
    for _ in range(300):
        p, st = adamw.update({"w": 2 * p["w"]}, st, p, lr=0.05, weight_decay=0.0)
    assert float(p["w"].abs().max()) < 0.1


def test_adamw_writes_none_of_its_inputs():
    p = _t(_trees(0))
    g = _t(_trees(1))
    st = adamw.init(p)
    before = [t.clone() for t in tree.leaves((p, g, st))]
    adamw.update(g, st, p, lr=0.1)
    assert all(torch.equal(a, b) for a, b in zip(before, tree.leaves((p, g, st))))


# ---------------------------------------------------------------------------
# Adafactor


def test_adafactor_factored_state_shapes():
    st = adafactor.init({"w": torch.ones((8, 4)), "b": torch.ones((4,)),
                         "s": torch.ones((2, 8, 4))})
    assert st.vr["w"].shape == (8,) and st.vc["w"].shape == (4,)
    assert st.vr["b"].shape == (4,) and st.vc["b"].shape == ()
    assert st.vr["s"].shape == (2, 8) and st.vc["s"].shape == (2, 4)
    ref = j_adafactor.init(_j({"w": np.ones((8, 4)), "b": np.ones(4), "s": np.ones((2, 8, 4))}))
    assert [t.shape for t in tree.leaves(st)] == [a.shape for a in jax.tree.leaves(ref)]


def test_adafactor_updates_match_the_reference():
    p = _trees(0)
    jp, tp = _j(p), _t(p)
    jst, tst = j_adafactor.init(jp), adafactor.init(tp)
    for i in range(4):
        g = _trees(20 + i, scale=1e-2 if i % 2 else 1.0)
        jp, jst = j_adafactor.update(_j(g), jst, jp, lr=0.05, weight_decay=0.01)
        tp, tst = adafactor.update(_t(g), tst, tp, lr=0.05, weight_decay=0.01)
        for jt, tt in ((jp, tp), (jst.vr, tst.vr), (jst.vc, tst.vc)):
            for a, b in _pairs(jt, tt):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
        assert int(tst.step) == i + 1


def test_adafactor_converges_on_quadratic():
    p = {"w": torch.full((4, 4), 3.0)}
    st = adafactor.init(p)
    for _ in range(200):
        p, st = adafactor.update({"w": 2 * p["w"]}, st, p, lr=0.05)
    assert float(p["w"].abs().max()) < 0.3


# ---------------------------------------------------------------------------
# clipping and schedules


def test_clip_reduces_norm():
    clipped, norm = clip.clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert float(norm) > 1.0
    assert float(clip.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_clip_noop_below_threshold():
    clipped, _ = clip.clip_by_global_norm({"a": torch.tensor([0.1])}, 1.0)
    np.testing.assert_allclose(clipped["a"].numpy(), [0.1], rtol=1e-6)


def test_global_norm_sums_in_jaxs_leaf_order():
    """Sums of squares 3, 3 and 2^24 under keys "a", "c", "b": JAX adds a,
    b, c (sorted keys), each addition rounding to even above 2^24, and gets
    2^24 + 8, whose square root is 4096 + 2 ulps; the dict's own order (a,
    c, b) would add exactly to 2^24 + 6, 4096 + 1 ulp."""
    g = {"a": np.ones(3, np.float32), "c": np.ones(3, np.float32),
         "b": np.float32([4096.0])}
    want = j_clip.global_norm(_j(g))
    got = clip.global_norm(_t(g))
    assert float(want) == float(got) == 4096.0 + 2 * 2.0 ** -11
    insertion = torch.sqrt(sum(torch.sum(t ** 2) for t in _t(g).values()))
    assert float(insertion) == 4096.0 + 2.0 ** -11


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_is_bitwise_the_reference(dtype):
    jd, td = DTYPES[dtype]
    g = _trees(3, scale=3.0)
    jc, jn = j_clip.clip_by_global_norm(_j(g, jd), 1.0)
    tc, tn = clip.clip_by_global_norm(_t(g, td), 1.0)
    assert float(tn) == float(jn)
    _equal(jc, tc)
    assert all(t.dtype == td for t in tree.leaves(tc))


def test_warmup_cosine():
    lr = lambda s: schedule.warmup_cosine(torch.tensor(s, dtype=torch.int32), peak_lr=1.0,
                                          warmup_steps=10, total_steps=100)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0)
    assert float(lr(100)) == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("warmup,total", [(10, 100), (13, 60), (1, 1), (0, 30)])
def test_warmup_cosine_matches_the_reference(warmup, total):
    """Bitwise through the warmup; within ``rtol=1e-6`` on the cosine
    (``jnp.cos`` and ``torch.cos`` each round a few arguments the other way
    from the correctly rounded cosine, and ``1 + cos`` near the end of the
    schedule makes that one ulp up to three)."""
    steps = np.arange(total + 5, dtype=np.int32)
    want = np.float32([j_schedule.warmup_cosine(jnp.asarray(s), peak_lr=3e-4,
                                                warmup_steps=warmup, total_steps=total)
                       for s in steps])
    got = np.float32([schedule.warmup_cosine(torch.tensor(s), peak_lr=3e-4,
                                             warmup_steps=warmup, total_steps=total)
                      for s in steps])
    np.testing.assert_array_equal(got[:warmup], want[:warmup])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    const = schedule.constant(torch.tensor(7, dtype=torch.int32), peak_lr=3e-4)
    assert float(const) == float(j_schedule.constant(jnp.asarray(7), peak_lr=3e-4))


# ---------------------------------------------------------------------------
# gradient compression


def test_compression_roundtrip_within_scale():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(64,)).astype(np.float32))}
    (q, scales), _ = compression.compress(g, compression.init(g))
    assert q["w"].dtype == torch.int8
    back = compression.decompress((q, scales))
    assert float((back["w"] - g["w"]).abs().max()) <= float(scales["w"]) * 0.5 + 1e-7


def test_compression_error_feedback_corrects_bias():
    g = {"w": torch.tensor([0.301, -0.299, 0.003])}
    st = compression.init(g)
    applied = torch.zeros(3)
    for _ in range(50):
        qs, st = compression.compress(g, st)
        applied += compression.decompress(qs)["w"]
    np.testing.assert_allclose(applied.numpy(), 50 * g["w"].numpy(), rtol=0.02, atol=1e-3)


def test_compression_is_bitwise_the_reference():
    g = _trees(5)
    jst, tst = j_compression.init(_j(g)), compression.init(_t(g))
    for _ in range(3):
        (jq, js), jst = j_compression.compress(_j(g), jst)
        (tq, ts), tst = compression.compress(_t(g), tst)
        for jt, tt in ((jq, tq), (js, ts), (jst.residual, tst.residual),
                       (j_compression.decompress((jq, js)), compression.decompress((tq, ts)))):
            _equal(jt, tt)
