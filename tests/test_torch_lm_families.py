"""The port's moe, hybrid, rwkv and vlm families (``repro_torch.models``: the
MoE FFN, the mamba mixer, the rwkv6 block, cross-attention) against the
reference (``repro.models``) on the CPU.

The reference's parameters are carried across with
``interop.lm_params_from_numpy`` and the same seeded tokens (and, for the
vlm, the same ``vision_embeds``) go through both. Tolerances, stated per
test:

* f32 SMOKE configs: logits and cache leaves ``rtol = atol = 1e-5``, except
  rwkv6's, ``5e-5``: its group norm runs over heads whose first-token output
  has a standard deviation near 1e-3, so it multiplies a one-ulp difference
  in its input several hundred times (the reference's own time mix moves by
  more than 1e-5 when its input moves by 1e-6,
  ``test_rwkv_group_norm_amplifies_one_ulp``);
* the sublayers alone on well-conditioned inputs: ``1e-5`` (``1e-6`` for
  the exact dispatch and the group norm);
* the port against itself, prefill + decode against the teacher-forced
  forward: ``2e-3``, the reference's own test's tolerance;
* bf16: ``rtol = atol = 2^-4`` (as ``tests/test_torch_lm_models.py``:
  XLA and torch round the bf16 elementwise intermediates at different
  points, about one bf16 ulp a layer), ``2^-3`` for jamba's SMOKE, which is
  8 layers deep (measured up to 0.137 on logits of magnitude up to 3.9
  away from any routing difference). A MoE token whose top-k differs
  between the two is accepted only where the drift explains it (see
  ``_flips``), and the logits downstream of such a token are left out.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import ffn as j_ffn
from repro.models import model as JM
from repro.models import rwkv as j_rwkv
from repro.models import ssm as j_ssm
from repro_torch import configs as t_configs
from repro_torch import interop
from repro_torch.configs import base as t_base
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import ffn as t_ffn
from repro_torch.models import model as TM
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf

FAMILY_ARCHS = ["llama4-scout-17b-a16e", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
                "llama-3.2-vision-90b", "rwkv6-1.6b"]
F32 = dict(rtol=1e-5, atol=1e-5)
RWKV_F32 = dict(rtol=5e-5, atol=5e-5)
BF16 = dict(rtol=2.0 ** -4, atol=2.0 ** -4)
BF16_DEEP = dict(rtol=2.0 ** -3, atol=2.0 ** -3)
KEY = jax.random.PRNGKey(0)
B, S, S_MAX = 2, 12, 16


def _tol(arch):
    return RWKV_F32 if arch == "rwkv6-1.6b" else F32


def _smoke(arch, **kw):
    return dataclasses.replace(j_configs.get_bundle(arch).smoke, **kw)


def _carry(cfg, key=KEY):
    jp = JM.init(cfg, key)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, interop.lm_params_from_numpy(tree, cfg, "cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _vision(cfg, b, seed=0):
    if cfg.family != "vlm":
        return None
    rng = np.random.default_rng(100 + seed)
    return rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_vision)).astype(np.float32)


def _flat(tree, path=""):
    """Leaves of a (numpy) cache tree by path, as float32 arrays."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{path}[{i}]").items()}
    return {path: np.asarray(tree, np.float32)}


def _ref_run(cfg, jp, toks, ve):
    """The reference: teacher-forced logits and aux, prefill over ``toks[:,
    :S-1]`` (last logits and cache), one decode step of ``toks[:, S-1]``, and
    ``loss_fn``."""
    vj = None if ve is None else jnp.asarray(ve)
    logits, _, aux = JM.forward(jp, cfg, jnp.asarray(toks), mode="train", vision_embeds=vj,
                                remat="none")
    caches = JM.init_cache(cfg, B, S_MAX)
    batch = {"inputs": jnp.asarray(toks[:, :S - 1])}
    if vj is not None:
        batch["vision_embeds"] = vj
    last, caches = JM.prefill_fn(jp, cfg, batch, caches)
    pre = _flat(jax.tree.map(np.asarray, caches))
    dec, caches = JM.decode_fn(jp, cfg, {"token": jnp.asarray(toks[:, S - 1:]),
                                         "pos": jnp.asarray(S - 1, jnp.int32)}, caches)
    loss_batch = {"inputs": jnp.asarray(toks), "targets": jnp.asarray(np.roll(toks, -1, 1))}
    if vj is not None:
        loss_batch["vision_embeds"] = vj
    loss, metrics = JM.loss_fn(jp, cfg, loss_batch, remat="none")
    return {"forward": np.asarray(logits, np.float32), "aux": float(aux),
            "prefill": np.asarray(last, np.float32), "prefill cache": pre,
            "decode": np.asarray(dec, np.float32),
            "decode cache": _flat(jax.tree.map(np.asarray, caches)),
            "loss": float(loss), "nll": float(metrics["nll"]),
            "router_aux": float(metrics["router_aux"])}


def _port_run(cfg, tp, toks, ve):
    vt = None if ve is None else interop.lm_vision_from_numpy(ve, cfg, "cpu")
    logits, _, aux = TM.forward(tp, cfg, torch.from_numpy(toks), mode="train",
                                vision_embeds=vt)
    caches = TM.init_cache(cfg, B, S_MAX, "cpu")
    batch = {"inputs": torch.from_numpy(toks[:, :S - 1])}
    if vt is not None:
        batch["vision_embeds"] = vt
    last, caches = TM.prefill_fn(tp, cfg, batch, caches)
    pre = _flat(interop.lm_cache_to_numpy(caches))
    dec, caches = TM.decode_fn(tp, cfg, {"token": torch.from_numpy(toks[:, S - 1:]),
                                         "pos": S - 1}, caches)
    loss_batch = {"inputs": torch.from_numpy(toks),
                  "targets": torch.from_numpy(np.roll(toks, -1, 1))}
    if vt is not None:
        loss_batch["vision_embeds"] = vt
    loss, metrics = TM.loss_fn(tp, cfg, loss_batch)
    return {"forward": logits.float().numpy(), "aux": float(aux),
            "prefill": last.float().numpy(), "prefill cache": pre,
            "decode": dec.float().numpy(),
            "decode cache": _flat(interop.lm_cache_to_numpy(caches)),
            "loss": float(loss), "nll": float(metrics["nll"]),
            "router_aux": float(metrics["router_aux"])}


@functools.lru_cache(maxsize=None)
def _runs(arch):
    """The reference's and the port's runs of ``arch``'s f32 SMOKE config,
    made once per test process."""
    cfg = _smoke(arch)
    assert cfg.dtype == "float32"
    jp, tp = _carry(cfg)
    toks, ve = _tokens(cfg, B, S), _vision(cfg, B)
    return _ref_run(cfg, jp, toks, ve), _port_run(cfg, tp, toks, ve)


# ---------------------------------------------------------------------------
# the five archs' SMOKE configs against the reference (f32)


@pytest.mark.parametrize("what", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_smoke_logits_match_the_reference(arch, what):
    ref, port = _runs(arch)
    cfg = _smoke(arch)
    want_shape = {"forward": (B, S, cfg.vocab_size)}.get(what, (B, cfg.vocab_size))
    assert port[what].shape == ref[what].shape == want_shape
    np.testing.assert_allclose(port[what], ref[what], err_msg=what, **_tol(arch))


@pytest.mark.parametrize("when", ["prefill cache", "decode cache"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_smoke_cache_leaves_match_the_reference(arch, when):
    ref, port = _runs(arch)
    assert sorted(port[when]) == sorted(ref[when])
    for path, want in ref[when].items():
        assert port[when][path].shape == want.shape, path
        np.testing.assert_allclose(port[when][path], want, err_msg=f"{when} {path}",
                                   **_tol(arch))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_fn_and_router_aux_match_the_reference(arch):
    ref, port = _runs(arch)
    for key in ("loss", "nll", "router_aux", "aux"):
        np.testing.assert_allclose(port[key], ref[key], err_msg=key, **_tol(arch))
    cfg = _smoke(arch)
    if cfg.family in ("moe", "hybrid"):
        assert port["router_aux"] > 0
        np.testing.assert_allclose(port["loss"], port["nll"] + cfg.router_aux_weight
                                   * port["router_aux"], rtol=1e-6)
    else:
        assert port["router_aux"] == ref["router_aux"] == 0.0


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_state_leaves_keep_their_dtypes(arch):
    """The f32 state leaves (mamba ``h``, rwkv ``wkv``) stay f32 in a bf16
    cache, as the reference's; every other leaf takes the model dtype."""
    cfg = t_configs.get_bundle(arch).smoke
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    caches = TM.init_cache(cfg, 2, 8, "cpu")
    ref = jax.tree.map(lambda a: str(a.dtype), JM.init_cache(cfg, 2, 8))
    got = [str(t.dtype).replace("torch.", "") for t in jax.tree.leaves(
        [{k: v for k, v in st.items()} for st in caches])]
    assert got == jax.tree.leaves(ref)
    f32 = {p for p, _ in _flat_specs(TM.make_cache_specs(cfg, 2, 8)) if p.endswith(("/h", "/wkv"))}
    assert bool(f32) == (cfg.family in ("hybrid", "rwkv"))


def _flat_specs(tree, path=""):
    if isinstance(tree, dict):
        return [r for k in sorted(tree) for r in _flat_specs(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [r for i, v in enumerate(tree) for r in _flat_specs(v, f"{path}[{i}]")]
    return [(path, tree)]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_decode_consistency(arch):
    """Serving path (prefill + decode with caches) == teacher-forced forward,
    the reference's test carried over to the port: ``capacity_factor`` is
    raised so the MoE dispatch drops nothing in either path."""
    cfg = _smoke(arch, capacity_factor=8.0)
    params = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2))
    ve = _vision(cfg, B, seed=2)
    vt = None if ve is None else torch.from_numpy(ve)
    logits_full, _, _ = TM.forward(params, cfg, toks, mode="train", vision_embeds=vt)
    caches = TM.init_cache(cfg, B, S, "cpu")
    pre = {"inputs": toks[:, :S - 1]}
    if vt is not None:
        pre["vision_embeds"] = vt
    last_pre, caches = TM.prefill_fn(params, cfg, pre, caches)
    np.testing.assert_allclose(last_pre, logits_full[:, S - 2], rtol=2e-3, atol=2e-3)
    dlog, _ = TM.decode_fn(params, cfg, {"token": toks[:, S - 1:S], "pos": S - 1}, caches)
    np.testing.assert_allclose(dlog, logits_full[:, S - 1], rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the reference's family unit tests, carried over


def test_moe_capacity_drops_overflow():
    """Tokens beyond expert capacity are dropped (output = residual only)."""
    cfg = _smoke("llama4-scout-17b-a16e", n_experts=2, top_k=1, capacity_factor=0.51,
                 n_shared_experts=0)
    p = t_common.init_params(t_ffn.moe_ffn_specs(cfg), torch.Generator().manual_seed(0),
                             "float32", "cpu")
    # Identical tokens route identically -> all 16 claim one expert.
    x = torch.ones((1, 16, cfg.d_model))
    y, aux = t_ffn.moe_ffn(x, p, cfg)
    # capacity = ceil(1 * 16 * 0.51 / 2) = 5 -> 11 of 16 tokens dropped:
    # their rows pass through unchanged (residual).
    delta = (y - x).abs().sum(dim=-1)[0]
    assert int((delta > 1e-6).sum()) == 5
    assert bool(torch.isfinite(aux))


def test_mamba_chunked_scan_matches_naive():
    """The selective scan == a plain per-step numpy recurrence."""
    rng = np.random.default_rng(0)
    b, s, di, n = 2, 32, 8, 4
    h0 = np.zeros((b, di, n), np.float32)
    dt = rng.uniform(0.01, 0.5, (s, b, di)).astype(np.float32)
    bm = rng.normal(size=(s, b, n)).astype(np.float32)
    cm = rng.normal(size=(s, b, n)).astype(np.float32)
    xc = rng.normal(size=(s, b, di)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (di, n)).astype(np.float32)
    ys, hT = t_ssm._selective_scan(*map(torch.from_numpy, (h0, dt, bm, cm, xc, a)))
    h = np.zeros((b, di, n), np.float32)
    for t in range(s):
        decay = np.exp(dt[t][..., None] * a)
        h = decay * h + (dt[t] * xc[t])[..., None] * bm[t][:, None, :]
        np.testing.assert_allclose(ys[t], np.einsum("ben,bn->be", h, cm[t]), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(hT, h, rtol=1e-4, atol=1e-4)
    ref = j_ssm._selective_scan(*map(jnp.asarray, (h0, dt, bm, cm, xc, a)))
    np.testing.assert_allclose(ys, ref[0], **F32)
    np.testing.assert_allclose(hT, ref[1], **F32)


def test_rwkv_decay_in_unit_interval(monkeypatch):
    """The data-dependent decay (the learned leak) stays in (0, 1), and the
    time mix's outputs are finite."""
    cfg = t_configs.get_bundle("rwkv6-1.6b").smoke
    params = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    p0 = t_tf._group(params["stages"][0], 0)["layer0"]["mixer"]
    seen = []
    scan = t_rwkv._wkv_scan

    def spy(s0, r, k, v, w, u):
        seen.append(w)
        return scan(s0, r, k, v, w, u)

    monkeypatch.setattr(t_rwkv, "_wkv_scan", spy)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    y, _, _ = t_rwkv.rwkv_time_mix(x, p0, cfg)
    assert bool(torch.isfinite(y).all())
    assert len(seen) == 1 and bool(((seen[0] > 0) & (seen[0] < 1)).all())


# ---------------------------------------------------------------------------
# the traps: top-k ties, overflow slots, ddof, the conv tail


def test_topk_on_exact_ties_takes_the_lower_expert_first():
    """``jax.lax.top_k`` orders equal values by index; the port's stable sort
    does the same (``torch.topk`` promises no order)."""
    cfg = _smoke("moonshot-v1-16b-a3b")      # 8 experts, top 2
    rng = np.random.default_rng(7)
    # Router logits on a coarse grid tie often; a zero router ties every expert.
    h = rng.integers(-2, 3, (1, 64, cfg.d_model)).astype(np.float32)
    for router in (rng.integers(-1, 2, (cfg.d_model, cfg.n_experts)).astype(np.float32),
                   np.zeros((cfg.d_model, cfg.n_experts), np.float32)):
        r = t_ffn.route(torch.from_numpy(h), torch.from_numpy(router), cfg, 4)
        probs = jax.nn.softmax(jnp.asarray(h) @ jnp.asarray(router), axis=-1)
        want_v, want_i = jax.lax.top_k(probs, cfg.top_k)
        srt = np.sort(np.asarray(probs), axis=-1)
        assert (srt[..., :-1] == srt[..., 1:]).any()          # the ties are there
        np.testing.assert_array_equal(r.expert_idx.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(r.probs, probs, rtol=1e-6, atol=1e-7)
    assert r.expert_idx[0, 0].tolist() == [0, 1]


def test_overflow_slot_is_dropped_without_a_raise():
    """A slot past capacity encodes to no column (``jax.nn.one_hot``'s all
    zeros; ``F.one_hot`` would raise): the claim drops, and the output is
    the reference's."""
    cfg = _smoke("jamba-1.5-large-398b", capacity_factor=0.5)
    jp = j_common.init_params(j_ffn.moe_ffn_specs(cfg), KEY, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    h = t_common.rms_norm(torch.from_numpy(x), tp["ln"]).reshape(1, 32, cfg.d_model)
    cap = t_ffn._capacity(cfg, 32, 0.5)
    r = t_ffn.route(h, tp["router"], cfg, cap)
    assert cap == 8 and int(r.dropped().sum()) > 0
    assert int(r.pos.max()) >= cap
    y, aux = t_ffn.moe_ffn(torch.from_numpy(x), tp, cfg)
    want = j_ffn.moe_ffn(jnp.asarray(x), jp, cfg)
    np.testing.assert_allclose(y, want[0], **F32)
    np.testing.assert_allclose(float(aux), float(want[1]), **F32)


def test_decode_capacity_is_not_dropless_for_scout():
    """``DECODE_CAPACITY_FACTOR`` gives scout FULL one slot per expert at 4
    slots (the reference's comment says "dropless in practice"), jamba 2 and
    moonshot 6 (dropless: a token claims an expert at most once)."""
    caps = {arch: t_ffn._capacity(t_configs.get_bundle(arch).model, 4,
                                  t_ffn.DECODE_CAPACITY_FACTOR)
            for arch in ("llama4-scout-17b-a16e", "jamba-1.5-large-398b",
                         "moonshot-v1-16b-a3b")}
    assert caps == {arch: j_ffn._capacity(j_configs.get_bundle(arch).model, 4,
                                          j_ffn.DECODE_CAPACITY_FACTOR) for arch in caps}
    assert caps == {"llama4-scout-17b-a16e": 1, "jamba-1.5-large-398b": 2,
                    "moonshot-v1-16b-a3b": 6}
    assert t_ffn.MOE_GROUP_TOKENS == j_ffn.MOE_GROUP_TOKENS
    assert t_ffn.DECODE_CAPACITY_FACTOR == j_ffn.DECODE_CAPACITY_FACTOR


def test_group_norm_is_the_population_variance():
    rng = np.random.default_rng(4)
    y = rng.standard_normal((2, 5, 64)).astype(np.float32)
    g, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    got = t_rwkv._group_norm(*map(torch.from_numpy, (y, g, b)), 4)
    want = j_rwkv._group_norm(*map(jnp.asarray, (y, g, b)), 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    yh = torch.from_numpy(y).reshape(2, 5, 4, 16)
    unbiased = ((yh - yh.mean(-1, keepdim=True)) * torch.rsqrt(yh.var(-1, keepdim=True) + 1e-5))
    assert not np.allclose(unbiased.reshape(2, 5, 64) * torch.from_numpy(g)
                           + torch.from_numpy(b), want, rtol=1e-3, atol=1e-3)


def test_rwkv_group_norm_amplifies_one_ulp():
    """Why rwkv6's end-to-end f32 tolerance is 5e-5: the reference's own time
    mix moves by more than 1e-5 when its input moves by 1e-6 (its group norm
    divides first-token heads of standard deviation near 1e-3 by
    ``sqrt(var + 1e-5)``)."""
    cfg = _smoke("rwkv6-1.6b")
    jp = JM.init(cfg, KEY)
    p = jax.tree.map(lambda a: a[1], jp["stages"][0]["layer0"]["mixer"])
    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 12, cfg.d_model)), jnp.float32)
    nudge = 1e-6 * jax.random.normal(jax.random.PRNGKey(5), x.shape)
    moved = jnp.abs(j_rwkv.rwkv_time_mix(x + nudge, p, cfg)[0]
                    - j_rwkv.rwkv_time_mix(x, p, cfg)[0]).max()
    assert float(moved) > 1e-5


@pytest.mark.parametrize("plen", [1, 2, 3, 5])
def test_mamba_prefill_conv_tail_matches_the_reference(plen):
    """A prompt shorter than ``d_conv - 1`` (3) leaves zeros at the front of
    the conv tail; the tail and ``h`` are the reference's, and one decode
    step from them too."""
    cfg = _smoke("jamba-1.5-large-398b")
    jp = j_common.init_params(j_ssm.mamba_specs(cfg), KEY, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(plen).standard_normal((2, plen + 1, cfg.d_model)).astype(np.float32)
    y, st = t_ssm.mamba_block(torch.from_numpy(x[:, :plen]), tp, cfg, return_state=True)
    jy, jst = j_ssm.mamba_block(jnp.asarray(x[:, :plen]), jp, cfg, return_state=True)
    assert st.conv.shape == (2, cfg.d_conv - 1, cfg.d_inner) and st.h.dtype == torch.float32
    np.testing.assert_allclose(y, jy, **F32)
    np.testing.assert_allclose(st.conv, jst.conv, **F32)
    np.testing.assert_allclose(st.h, jst.h, **F32)
    if plen < cfg.d_conv - 1:
        assert bool((st.conv[:, :cfg.d_conv - 1 - plen] == 0).all())
    y2, st2 = t_ssm.mamba_block(torch.from_numpy(x[:, plen:]), tp, cfg, state=st,
                                return_state=True)
    jy2, jst2 = j_ssm.mamba_block(jnp.asarray(x[:, plen:]), jp, cfg, state=jst,
                                  return_state=True)
    np.testing.assert_allclose(y2, jy2, **F32)
    np.testing.assert_allclose(st2.conv, jst2.conv, **F32)
    np.testing.assert_allclose(st2.h, jst2.h, **F32)


def test_rwkv_decode_form_matches_the_reference():
    """The ``s == 1`` forms of the time and channel mixes from a carried
    state (``u`` broadcast over the (B, H, dk, dv) state; ``new_att_x`` the
    normed token)."""
    cfg = _smoke("rwkv6-1.6b")
    jp = JM.init(cfg, KEY)
    pj = jax.tree.map(lambda a: a[0], jp["stages"][0]["layer0"])
    pt = {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
          for k, v in pj.items()}
    x = np.random.default_rng(5).standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    _, att_x, wkv = t_rwkv.rwkv_time_mix(xt[:, :5], pt["mixer"], cfg, return_state=True)
    _, ffn_x = t_rwkv.rwkv_channel_mix(xt[:, :5], pt["ffn"], cfg, return_state=True)
    st = t_rwkv.RWKVState(att_x=att_x, ffn_x=ffn_x, wkv=wkv)
    jst = j_rwkv.RWKVState(att_x=jnp.asarray(att_x.numpy()), ffn_x=jnp.asarray(ffn_x.numpy()),
                           wkv=jnp.asarray(wkv.numpy()))
    np.testing.assert_allclose(att_x, t_common.rms_norm(xt[:, 4], pt["mixer"]["ln"]), rtol=0,
                               atol=0)
    got = t_rwkv.rwkv_time_mix(xt[:, 5:], pt["mixer"], cfg, state=st, return_state=True)
    want = j_rwkv.rwkv_time_mix(jnp.asarray(x[:, 5:]), pj["mixer"], cfg, state=jst,
                                return_state=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **F32)
    got = t_rwkv.rwkv_channel_mix(xt[:, 5:], pt["ffn"], cfg, state_x=ffn_x, return_state=True)
    want = j_rwkv.rwkv_channel_mix(jnp.asarray(x[:, 5:]), pj["ffn"], cfg,
                                   state_x=jst.ffn_x, return_state=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **F32)


def test_cross_attention_matches_the_reference():
    """No rope on the cross layer's q or k (positions None), non-causal over
    the vision tokens, the dead pad heads masked."""
    cfg = _smoke("llama-3.2-vision-90b", head_pad=8)      # 4 live q heads of 8
    assert t_attn.attn_specs(cfg, cross=True) == t_attn.attn_specs(cfg)
    jp = j_common.init_params(j_attn.attn_specs(cfg, cross=True), KEY, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(6)
    vis = rng.standard_normal((2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    kv = t_attn.project_vision_kv(torch.from_numpy(vis), tp, cfg)
    jkv = j_attn.project_vision_kv(jnp.asarray(vis), jp, cfg)
    np.testing.assert_allclose(kv.k, jkv.k, **F32)
    np.testing.assert_allclose(kv.v, jkv.v, **F32)
    got = t_attn.cross_attention(torch.from_numpy(x), tp, cfg, kv_cache=kv)
    want = j_attn.cross_attention(jnp.asarray(x), jp, cfg, kv_cache=jkv)
    np.testing.assert_allclose(got, want, **F32)
    # non-causal: the last vision token reaches the first query
    vis2 = vis.copy()
    vis2[:, -1] += 1.0
    kv2 = t_attn.project_vision_kv(torch.from_numpy(vis2), tp, cfg)
    moved = t_attn.cross_attention(torch.from_numpy(x), tp, cfg, kv_cache=kv2)
    assert float((moved - got)[:, 0].abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# bf16


def test_bf16_rwkv6_matches_at_bf16_tolerance():
    cfg = _smoke("rwkv6-1.6b", dtype="bfloat16")
    jp, tp = _carry(cfg)
    assert tp["embed"].dtype == torch.bfloat16
    toks = _tokens(cfg, B, S, seed=1)
    ref, port = _ref_run(cfg, jp, toks, None), _port_run(cfg, tp, toks, None)
    for what in ("forward", "prefill", "decode"):
        np.testing.assert_allclose(port[what], ref[what], err_msg=what, **BF16)
    for when in ("prefill cache", "decode cache"):
        for path, want in ref[when].items():
            np.testing.assert_allclose(port[when][path], want, err_msg=f"{when} {path}", **BF16)


def _record_routes(monkeypatch):
    """Wrap both packages' ``moe_ffn`` to record, per call, each token's
    router logits (f32 of the model-dtype product) and top-k experts."""
    seen = {"ref": [], "port": []}
    j_moe, t_moe = j_ffn.moe_ffn, t_ffn.moe_ffn

    def ref_spy(x, p, cfg, cap_factor=None):
        h = j_common.rms_norm(x, p["ln"]).reshape(-1, x.shape[-1])
        logits = jnp.einsum("td,de->te", h, p["router"]).astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
        jax.debug.callback(lambda lg, i: seen["ref"].append((np.asarray(lg), np.asarray(i))),
                           logits, idx, ordered=True)
        return j_moe(x, p, cfg, cap_factor)

    def port_spy(x, p, cfg, cap_factor=None):
        h = t_common.rms_norm(x, p["ln"]).reshape(1, -1, x.shape[-1])
        r = t_ffn.route(h, p["router"], cfg, 1)
        seen["port"].append(((h[0] @ p["router"]).float().numpy(), r.expert_idx[0].numpy()))
        return t_moe(x, p, cfg, cap_factor)

    monkeypatch.setattr(j_ffn, "moe_ffn", ref_spy)
    monkeypatch.setattr(t_ffn, "moe_ffn", port_spy)
    return seen


def _flips(seen, batch, seq):
    """Tokens whose top-k sets differ, as (row, position). Each must be a
    near-tie that the drift explains: for an expert ``a`` only the reference
    picked and an expert ``b`` only the port picked, the reference's logit
    gap ``lg[a] - lg[b]`` is no larger than ``|d[a]| + |d[b]|``, ``d`` the two
    packages' router logits' difference at that token."""
    out = set()
    assert len(seen["ref"]) == len(seen["port"]) > 0
    for (r_lg, r_idx), (p_lg, p_idx) in zip(seen["ref"], seen["port"]):
        drift = np.abs(r_lg - p_lg)
        for t in range(r_idx.shape[0]):
            only_ref = set(r_idx[t].tolist()) - set(p_idx[t].tolist())
            only_port = set(p_idx[t].tolist()) - set(r_idx[t].tolist())
            for a in only_ref:
                for b in only_port:
                    assert r_lg[t, a] - r_lg[t, b] <= drift[t, a] + drift[t, b], \
                        (t, a, b, r_lg[t, a] - r_lg[t, b], drift[t, a] + drift[t, b])
            if only_ref:
                out.add((t // seq, t % seq))
    return out


def test_bf16_jamba_matches_outside_routing_flips(monkeypatch):
    """jamba in bf16: where a MoE layer routes a token differently (a near-tie,
    see :func:`_flips`), the logits at and after that position of its row
    are left out; the rest are within the bf16 tolerance, and the flips are
    few."""
    cfg = _smoke("jamba-1.5-large-398b", dtype="bfloat16")
    jp, tp = _carry(cfg)
    toks = _tokens(cfg, B, S, seed=1)
    seen = _record_routes(monkeypatch)
    want = np.asarray(JM.forward(jp, cfg, jnp.asarray(toks), mode="train", remat="none")[0],
                      np.float32)
    got = TM.forward(tp, cfg, torch.from_numpy(toks), mode="train")[0].float().numpy()
    flips = _flips(seen, B, S)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert len(seen["port"]) == n_moe
    assert len(flips) <= 4, flips                       # of 24 tokens x 4 MoE layers
    keep = np.ones((B, S), bool)
    for row, t in flips:
        keep[row, t:] = False
    assert keep.sum() >= B * S // 2
    np.testing.assert_allclose(got[keep], want[keep], **BF16_DEEP)


# ---------------------------------------------------------------------------
# the deliberate differences and the reference's aux sum


def test_prefill_and_decode_write_the_state_caches_in_place():
    """Deliberate difference (ROADMAP §C): prefill writes the mamba ``conv`` /
    ``h``, the rwkv ``att_x`` / ``ffn_x`` / ``wkv`` and the cross layers'
    vision K/V into the caches it was given; decode rewrites the recurrent
    states and never writes the vision K/V."""
    for arch, leaves in (("jamba-1.5-large-398b", ("conv", "h")),
                         ("rwkv6-1.6b", ("att_x", "ffn_x", "wkv")),
                         ("llama-3.2-vision-90b", ("kv",))):
        cfg = _smoke(arch)
        params = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.from_numpy(_tokens(cfg, 2, 6, seed=6))
        ve = _vision(cfg, 2)
        caches = TM.init_cache(cfg, 2, 8, "cpu")
        layer = caches[0]["layer0"]
        bufs = {k: layer[k] for k in leaves}
        batch = {"inputs": toks[:, :5]}
        if ve is not None:
            batch["vision_embeds"] = torch.from_numpy(ve)
        _, after = TM.prefill_fn(params, cfg, batch, caches)
        assert after is caches
        flat = lambda: {k: v for k, v in _flat(interop.lm_cache_to_numpy(bufs)).items()}
        pre = flat()
        assert all(np.abs(v).sum() > 0 for v in pre.values()), arch
        assert all(after[0]["layer0"][k] is bufs[k] for k in leaves)
        TM.decode_fn(params, cfg, {"token": toks[:, 5:6], "pos": 5}, caches)
        post = flat()
        for k in pre:
            same = np.array_equal(pre[k], post[k])
            assert same == (arch == "llama-3.2-vision-90b"), (arch, k)


def test_router_aux_sums_each_groups_last_layer(monkeypatch):
    """The reference's scan body adds only the last layer's aux of each
    group (its ``aux`` is rebound at every layer): a jamba group of 8 counts
    layer 7 and drops layers 1, 3 and 5. The port keeps that sum."""
    cfg = _smoke("jamba-1.5-large-398b", n_layers=16)
    params = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    auxes = []
    moe = t_ffn.moe_ffn

    def spy(*a, **kw):
        out = moe(*a, **kw)
        auxes.append(float(out[1]))
        return out

    monkeypatch.setattr(t_ffn, "moe_ffn", spy)
    toks = torch.from_numpy(_tokens(cfg, 2, 8, seed=8))
    _, _, aux = TM.forward(params, cfg, toks, mode="train")
    assert len(auxes) == 8                              # 4 MoE layers a group, 2 groups
    np.testing.assert_allclose(float(aux), auxes[3] + auxes[7], rtol=1e-6)
    assert abs(float(aux) - sum(auxes)) > 0.1
    jp, tp = _carry(cfg)
    want = JM.forward(jp, cfg, jnp.asarray(toks.numpy()), mode="train", remat="none")[2]
    got = TM.forward(tp, cfg, toks, mode="train")[2]
    np.testing.assert_allclose(float(got), float(want), **F32)


# ---------------------------------------------------------------------------
# interop and batch specs


def test_interop_carries_the_new_leaves():
    """Parameters (``vision_proj``, the mamba / rwkv / MoE subtrees with
    ``shared``) and caches (the f32 ``h`` / ``wkv``; an rwkv cache has no
    attention layer) round-trip exactly; ``vision_embeds`` come across in
    the model dtype."""
    for arch in FAMILY_ARCHS:
        cfg = _smoke(arch, dtype="bfloat16")
        jp, tp = _carry(cfg)
        back = interop.lm_params_to_numpy(tp)
        assert jax.tree.structure(back) == jax.tree.structure(jp)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
        rng = np.random.default_rng(9)
        cache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                             JM.init_cache(cfg, 3, 8))
        tc = interop.lm_cache_from_numpy(cache, cfg, "cpu")
        want = jax.tree.map(lambda s: str(s.dtype), JM.init_cache(cfg, 3, 8))
        got = [str(t.dtype).replace("torch.", "") for t in jax.tree.leaves(tc)]
        assert got == jax.tree.leaves(want)
        back = jax.tree.leaves(interop.lm_cache_to_numpy(tc))
        for a, b, dtype in zip(back, jax.tree.leaves(cache), got):
            if dtype == "float32":        # the state leaves travel exactly
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(
                    a, torch.from_numpy(b).to(torch.bfloat16).float().numpy())
    cfg = _smoke("llama-3.2-vision-90b", dtype="bfloat16")
    ve = _vision(cfg, 2)
    vt = interop.lm_vision_from_numpy(ve, cfg, "cpu")
    assert vt.dtype == torch.bfloat16 and tuple(vt.shape) == ve.shape
    assert torch.equal(vt, torch.from_numpy(ve).to(torch.bfloat16))


@pytest.mark.parametrize("shape", sorted(t_base.SHAPES))
@pytest.mark.parametrize("arch", sorted(t_configs.ASSIGNED_ARCHS))
def test_batch_specs_equal_the_reference(arch, shape):
    cfg = t_configs.get_bundle(arch).model
    got = TM.batch_specs(cfg, t_base.SHAPES[shape])
    want = JM.batch_specs(cfg, j_configs.base.SHAPES[shape])
    assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
        {k: dataclasses.astuple(v) for k, v in want.items()}
    assert ("vision_embeds" in got) == (cfg.family == "vlm" and
                                        t_base.SHAPES[shape].kind != "decode")
