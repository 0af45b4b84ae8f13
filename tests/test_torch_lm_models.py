"""The port's LM models (``repro_torch.models``) and LM configs against the
reference (``repro.models``, ``repro.configs``) on the CPU.

The reference's parameters are carried across with
``interop.lm_params_from_numpy`` (the port's own draws differ by design), and
the same seeded tokens go through both. Tolerances, stated per test:

* f32 SMOKE configs: logits and caches ``rtol = atol = 1e-5`` (the sums'
  orders differ between XLA and torch by a few f32 ulps);
* the port against itself, prefill + decode against the teacher-forced
  forward: ``2e-3``, the reference's own test's tolerance;
* bf16: ``rtol = atol = 2^-4``. bf16 keeps 8 significant bits; XLA and
  torch round the elementwise intermediates (SiLU times up, the residual
  adds) at different points, which moves logits of magnitude 2-4 by a few
  bf16 ulps (measured up to 0.037 at smoke width);
* the numerics helpers: ``1e-6``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import base as j_base
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import model as JM
from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch import interop
from repro_torch.configs import base as t_base
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import model as TM
from repro_torch.models import transformer as t_tf

LM_ARCHS = ["smollm-135m", "smollm-360m", "qwen3-0.6b", "starcoder2-15b", "musicgen-large"]
FAMILY_ARCHS = ["llama4-scout-17b-a16e", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
               "llama-3.2-vision-90b", "rwkv6-1.6b"]
FULL_PARAMS = {"smollm-135m": 178_309_440, "smollm-360m": 412_939_200,
               "qwen3-0.6b": 596_049_920, "starcoder2-15b": 15_955_630_080,
               "musicgen-large": 3_254_978_560,
               "llama4-scout-17b-a16e": 108_273_177_600,
               "moonshot-v1-16b-a3b": 28_386_592_768,
               "jamba-1.5-large-398b": 398_555_111_424,
               "llama-3.2-vision-90b": 87_677_280_256,
               "rwkv6-1.6b": 1_599_768_576}
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -4, atol=2.0 ** -4)
KEY = jax.random.PRNGKey(0)


def _smoke(arch, **kw):
    return dataclasses.replace(j_configs.get_bundle(arch).smoke, **kw)


def _carry(cfg):
    """The reference's params from ``KEY`` and the port's copy of them."""
    jp = JM.init(cfg, KEY)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, interop.lm_params_from_numpy(tree, cfg, "cpu")


def _tokens(cfg, B, S, seed=0):
    shape = (B, S, cfg.n_codebooks) if cfg.family == "audio" else (B, S)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _spec_rows(tree, dtype, path=""):
    """(path, shape, axes, init, scale, resolved dtype) of every leaf of a
    spec tree of either package."""
    if isinstance(tree, dict):
        return [r for k in sorted(tree) for r in _spec_rows(tree[k], dtype, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [r for i, v in enumerate(tree) for r in _spec_rows(v, dtype, f"{path}[{i}]")]
    return [(path, tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale,
             tree.dtype or dtype)]


# ---------------------------------------------------------------------------
# configs and the registry


def test_registry_lists_the_references_archs():
    assert t_configs.list_archs() == j_configs.list_archs()
    assert t_configs.ASSIGNED_ARCHS == j_configs.ASSIGNED_ARCHS
    assert t_configs.SNN_ARCHS == j_configs.SNN_ARCHS
    assert set(LM_ARCHS + FAMILY_ARCHS) == set(t_configs.ASSIGNED_ARCHS)


@pytest.mark.parametrize("arch", LM_ARCHS + FAMILY_ARCHS)
def test_lm_configs_equal_the_reference_field_for_field(arch):
    ref, port = j_configs.get_bundle(arch), t_configs.get_bundle(arch)
    for which in ("model", "smoke"):
        assert dataclasses.asdict(getattr(port, which)) == \
            dataclasses.asdict(getattr(ref, which))
        r, p = getattr(ref, which), getattr(port, which)
        assert (p.d_q, p.d_kv, p.d_inner, p.full_attention) == \
            (r.d_q, r.d_kv, r.d_inner, r.full_attention)
        assert [p.is_moe_layer(i) for i in range(p.n_layers)] == \
            [r.is_moe_layer(i) for i in range(r.n_layers)]
        assert t_base.applicable_shapes(p) == j_base.applicable_shapes(r)
    assert {k: dataclasses.asdict(v) for k, v in port.parallel.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.parallel.items()}


def test_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in t_base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_base.SHAPES.items()}
    assert t_base.applicable_shapes(t_configs.get_bundle("snn").model) == ()


@pytest.mark.parametrize("arch", LM_ARCHS + FAMILY_ARCHS)
def test_stage_plans_equal_the_reference(arch):
    for cfg in (t_configs.get_bundle(arch).model, t_configs.get_bundle(arch).smoke):
        got = [dataclasses.asdict(s) for s in t_tf.stage_plans(cfg)]
        assert got == [dataclasses.asdict(s) for s in j_tf.stage_plans(cfg)]


# ---------------------------------------------------------------------------
# parameter and cache specs at FULL width, without materialising them


@pytest.mark.parametrize("arch", LM_ARCHS + FAMILY_ARCHS)
def test_full_specs_and_n_params_equal_the_reference(arch):
    cfg = t_configs.get_bundle(arch).model
    assert TM.n_params(cfg) == JM.n_params(cfg) == FULL_PARAMS[arch]
    assert _spec_rows(TM.specs(cfg), cfg.dtype) == _spec_rows(JM.specs(cfg), cfg.dtype)
    assert _spec_rows(TM.make_cache_specs(cfg, 4, 64), cfg.dtype) == \
        _spec_rows(JM.make_cache_specs(cfg, 4, 64), cfg.dtype)
    if cfg.n_heads:   # rwkv6 has no attention heads
        to_kv, mask = t_attn.head_maps(cfg)
        want = j_attn.head_maps(cfg)
        np.testing.assert_array_equal(to_kv, want[0])
        np.testing.assert_array_equal(mask, want[1])


def test_smollm_135m_keeps_the_dead_heads():
    """``head_pad=16`` pads the 9 q-heads to 16: ``wq`` is (576, 1024) and 7
    heads are masked to zero, as in the reference (so the params carry)."""
    cfg = t_configs.get_bundle("smollm-135m").model
    assert t_attn.padded_q_heads(cfg) == 16
    wq = TM.specs(cfg)["stages"][0]["layer0"]["mixer"]["wq"]
    assert wq.shape == (30, 576, 1024)
    assert t_attn.head_maps(cfg)[1].sum() == 9


# ---------------------------------------------------------------------------
# init


def test_init_follows_the_references_std_rule_shapes_and_dtypes():
    cfg = _smoke("smollm-135m", n_layers=4, d_model=128, d_ff=256)
    specs = TM.specs(cfg)
    p = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rows = sorted(_spec_rows(specs, cfg.dtype))
    leaves = [t for _, t in sorted(_named_leaves(p))]
    assert len(rows) == len(leaves)
    for (path, shape, _, init, scale, dtype), t in zip(rows, leaves):
        assert tuple(t.shape) == shape and t.dtype == t_common.torch_dtype(dtype), path
        if init == "ones":
            assert bool((t == 1).all()), path
        elif init == "zeros":
            assert bool((t == 0).all()), path
        else:
            fan_in = math.prod(shape[:-1])
            want = scale * 0.02 if init == "small" else scale / math.sqrt(fan_in)
            assert abs(float(t.float().std()) / want - 1) < 0.05, path
            assert abs(float(t.float().mean())) < 0.05 * want, path
    again = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    other = TM.init(cfg, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(again["embed"], p["embed"])
    assert not torch.equal(other["embed"], p["embed"])
    bf = TM.init(dataclasses.replace(cfg, dtype="bfloat16"), torch.Generator().manual_seed(0),
                 "cpu")
    assert bf["embed"].dtype == torch.bfloat16
    assert torch.equal(bf["embed"], p["embed"].to(torch.bfloat16))


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [r for k in tree for r in _named_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [r for i, v in enumerate(tree) for r in _named_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def test_init_draws_a_stacked_leaf_slab_by_slab(monkeypatch):
    """No draw is larger than one slab of a stacked leaf (starcoder2-15b's
    40 x 6144 x 24576 would be 24 GB of f32 drawn at once)."""
    cfg = _smoke("starcoder2-15b", n_layers=6)
    drawn = []
    randn = torch.randn

    def recording(*args, **kwargs):
        out = randn(*args, **kwargs)
        drawn.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "randn", recording)
    p = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    w_up = p["stages"][0]["layer0"]["ffn"]["w_up"]
    assert w_up.shape == (6, cfg.d_model, cfg.d_ff)
    assert (cfg.d_model, cfg.d_ff) in drawn and w_up.shape not in drawn
    assert max(math.prod(s) for s in drawn) == cfg.vocab_size * cfg.d_model  # the embed
    assert all(len(s) < 3 or s[0] != 6 for s in drawn)


# ---------------------------------------------------------------------------
# numerics


def test_numerics_helpers_match_the_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1)) + 7
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_common.rms_norm(torch.from_numpy(x), torch.from_numpy(g)),
                               j_common.rms_norm(jnp.asarray(x), jnp.asarray(g)), **tol)
    np.testing.assert_allclose(
        t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
        j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), **tol)
    np.testing.assert_allclose(t_common.rope_freqs(16, 1e6), j_common.rope_freqs(16, 1e6),
                               **tol)
    np.testing.assert_allclose(
        t_common.sinusoidal_pos_embed(torch.from_numpy(pos), 32),
        j_common.sinusoidal_pos_embed(jnp.asarray(pos), 32), rtol=1e-6, atol=2e-6)
    np.testing.assert_allclose(t_common.gelu(torch.from_numpy(x)),
                               j_common.gelu(jnp.asarray(x)), **tol)
    np.testing.assert_allclose(t_common.silu(torch.from_numpy(x)),
                               j_common.silu(jnp.asarray(x)), **tol)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(t_common.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(j_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), **tol)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert t_common.rms_norm(xb, torch.from_numpy(g)).dtype == torch.bfloat16
    assert t_common.apply_rope(xb, torch.from_numpy(pos), 1e4).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# forward, prefill and decode against the reference


def _serving_step(fns, params, cfg, toks, B, S, s_max, to_in, cache_init):
    """Teacher-forced logits, prefill over ``toks[:, :S-1]`` (last logits and
    cache), then one decode step of ``toks[:, S-1]`` at ``S-1``."""
    forward, prefill, decode = fns
    full = forward(params, cfg, to_in(toks), mode="train")[0]
    caches = cache_init(cfg, B, s_max)
    last, caches = prefill(params, cfg, {"inputs": to_in(toks[:, :S - 1])}, caches)
    pre_caches = jax.tree.map(_np, caches) if isinstance(caches[0]["layer0"]["kv"]["k"],
                                                         jax.Array) \
        else interop.lm_cache_to_numpy(caches)
    dec, caches = decode(params, cfg, {"token": to_in(toks[:, S - 1:S]), "pos": S - 1},
                         caches)
    return full, last, pre_caches, dec, caches


def _ref_step(jp, cfg, toks, B, S, s_max):
    return _serving_step(
        (lambda p, c, t, mode: JM.forward(p, c, t, mode=mode, remat="none"),
         JM.prefill_fn,
         lambda p, c, b, k: JM.decode_fn(p, c, {**b, "pos": jnp.asarray(b["pos"], jnp.int32)},
                                         k)),
        jp, cfg, toks, B, S, s_max, jnp.asarray, JM.init_cache)


def _port_step(tp, cfg, toks, B, S, s_max):
    return _serving_step(
        (lambda p, c, t, mode: TM.forward(p, c, t, mode=mode), TM.prefill_fn, TM.decode_fn),
        tp, cfg, toks, B, S, s_max, torch.from_numpy,
        lambda c, b, s: TM.init_cache(c, b, s, "cpu"))


def _hold(ref, port, tol):
    names = ("forward", "prefill", "prefill cache", "decode", "decode cache")
    for name, r, p in zip(names, ref, port):
        if "cache" in name:
            r = jax.tree.map(_np, r) if name == "decode cache" else r
            p = interop.lm_cache_to_numpy(p) if name == "decode cache" else p
            for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(r)):
                np.testing.assert_allclose(a, b, err_msg=name, **tol)
        else:
            np.testing.assert_allclose(_np(p), _np(r), err_msg=name, **tol)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_forward_prefill_decode_match_the_reference(arch):
    cfg = _smoke(arch)
    assert cfg.dtype == "float32"
    jp, tp = _carry(cfg)
    B, S, s_max = 2, 12, 16
    toks = _tokens(cfg, B, S)
    ref = _ref_step(jp, cfg, toks, B, S, s_max)
    port = _port_step(tp, cfg, toks, B, S, s_max)
    want = (B, S, cfg.n_codebooks, cfg.vocab_size) if cfg.family == "audio" \
        else (B, S, cfg.vocab_size)
    assert tuple(port[0].shape) == want
    _hold(ref, port, F32)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-0.6b", "musicgen-large"])
def test_bf16_smoke_matches_the_reference_at_bf16_tolerance(arch):
    cfg = _smoke(arch, dtype="bfloat16")
    jp, tp = _carry(cfg)
    assert tp["embed"].dtype == torch.bfloat16
    B, S, s_max = 2, 12, 16
    toks = _tokens(cfg, B, S, seed=1)
    port = _port_step(tp, cfg, toks, B, S, s_max)
    assert port[0].dtype == torch.bfloat16
    _hold(_ref_step(jp, cfg, toks, B, S, s_max), port, BF16)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_decode_consistency(arch):
    """Serving path (prefill + decode with caches) == teacher-forced forward,
    the reference's test carried over to the port."""
    cfg = _smoke(arch)
    params = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2))
    logits_full, _, _ = TM.forward(params, cfg, toks, mode="train")
    caches = TM.init_cache(cfg, B, S, "cpu")
    last_pre, caches = TM.prefill_fn(params, cfg, {"inputs": toks[:, :S - 1]}, caches)
    np.testing.assert_allclose(last_pre, logits_full[:, S - 2], rtol=2e-3, atol=2e-3)
    dlog, _ = TM.decode_fn(params, cfg, {"token": toks[:, S - 1:S], "pos": S - 1}, caches)
    np.testing.assert_allclose(dlog, logits_full[:, S - 1], rtol=2e-3, atol=2e-3)


def test_chunked_attention_matches_direct_and_the_reference(monkeypatch):
    cfg = _smoke("qwen3-0.6b")
    jp, tp = _carry(cfg)
    toks = _tokens(cfg, 2, 64, seed=4)
    want = np.asarray(JM.forward(jp, cfg, jnp.asarray(toks), mode="train", remat="none")[0])
    direct = TM.forward(tp, cfg, torch.from_numpy(toks), mode="train")[0]
    calls = []
    sdpa = t_attn._sdpa

    def counting(*a, **kw):
        calls.append(kw["q_offset"])
        return sdpa(*a, **kw)

    monkeypatch.setattr(t_attn, "Q_CHUNK", 16)   # force the chunked path
    monkeypatch.setattr(t_attn, "_sdpa", counting)
    got = TM.forward(tp, cfg, torch.from_numpy(toks), mode="train")[0]
    assert calls == [0, 16, 32, 48] * cfg.n_layers
    np.testing.assert_allclose(got, direct, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want, **F32)
    monkeypatch.setattr(j_attn, "Q_CHUNK", 16)
    np.testing.assert_allclose(
        got, JM.forward(jp, cfg, jnp.asarray(toks), mode="train", remat="none")[0], **F32)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_fn_matches_the_reference(arch):
    cfg = _smoke(arch)
    jp, tp = _carry(cfg)
    toks = _tokens(cfg, 2, 8, seed=5)
    targets = np.roll(toks, -1, axis=1)
    loss, metrics = TM.loss_fn(tp, cfg, {"inputs": torch.from_numpy(toks),
                                         "targets": torch.from_numpy(targets)})
    j_loss, j_metrics = JM.loss_fn(jp, cfg, {"inputs": jnp.asarray(toks),
                                             "targets": jnp.asarray(targets)}, remat="none")
    np.testing.assert_allclose(float(loss), float(j_loss), **F32)
    np.testing.assert_allclose(float(metrics["nll"]), float(j_metrics["nll"]), **F32)
    assert float(metrics["router_aux"]) == float(j_metrics["router_aux"]) == 0.0


# ---------------------------------------------------------------------------
# the deliberate differences


def test_decode_writes_the_cache_in_place():
    """Deliberate difference (ROADMAP §C): the reference returns an updated
    copy of its cache; the port writes the step's K/V into the cache it was
    given, at ``pos`` only, and returns the same tensors."""
    cfg = _smoke("smollm-135m")
    params = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 6, seed=6))
    caches = TM.init_cache(cfg, 2, 16, "cpu")
    k = caches[0]["layer0"]["kv"]["k"]
    _, after_prefill = TM.prefill_fn(params, cfg, {"inputs": toks[:, :5]}, caches)
    assert after_prefill is caches and after_prefill[0]["layer0"]["kv"]["k"] is k
    assert bool(k[:, :, :5].abs().sum() > 0) and bool((k[:, :, 5:] == 0).all())
    before = k.clone()
    _, after = TM.decode_fn(params, cfg, {"token": toks[:, 5:6], "pos": 5}, caches)
    assert after is caches and after[0]["layer0"]["kv"]["k"] is k
    changed = (k != before).any(dim=-1).any(dim=1)    # (groups, positions)
    assert changed[:, 5].all() and not changed[:, :5].any() and not changed[:, 6:].any()


def test_interop_round_trip_is_exact_and_casts_to_the_spec_dtype():
    cfg = _smoke("musicgen-large", dtype="bfloat16")
    jp, tp = _carry(cfg)
    back = interop.lm_params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert all(t.dtype == torch.bfloat16 for _, t in _named_leaves(tp))
    cache = JM.init_cache(cfg, 2, 8)
    tc = interop.lm_cache_from_numpy(jax.tree.map(_np, cache), cfg, "cpu")
    assert tc[0]["layer0"]["kv"]["k"].shape == (cfg.n_layers, 2, 8, cfg.d_kv)
    assert tc[0]["layer0"]["kv"]["k"].dtype == torch.bfloat16
    with pytest.raises(KeyError, match="spec"):
        interop.lm_params_from_numpy({"embed": back["embed"]}, cfg, "cpu")


def test_groups_are_views_of_the_stacked_leaves():
    """Deliberate difference (ROADMAP §C): the reference scans over groups;
    the port loops, each group's leaves views into the stacked tensors."""
    cfg = _smoke("qwen3-0.6b")
    params = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    stacked = params["stages"][0]["layer0"]["mixer"]["wq"]
    for g in range(cfg.n_layers):
        view = t_tf._group(params["stages"][0], g)["layer0"]["mixer"]["wq"]
        assert view.untyped_storage().data_ptr() == stacked.untyped_storage().data_ptr()
        assert torch.equal(view, stacked[g])
