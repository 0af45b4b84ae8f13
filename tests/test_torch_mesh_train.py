"""The LM stack on a ``DeviceMesh``: the sharded train step, sharded
checkpoints and sharded batches, on gloo worlds of CPU ranks.

Two worlds run side by side, once (module scoped), and each case is
asserted here on its own: 4 ranks on a (2, 2) ``("data", "model")`` mesh
(``tests/torch_mesh_ranks.world4``: a checkpoint, batches, smollm-135m,
qwen3-0.6b, moonshot-v1-16b-a3b, jamba-1.5-large-398b and
llama-3.2-vision-90b, a one-group MoE, smollm-135m's prefill and decode) and 2 ranks on a (1, 2) mesh (``world2``: rwkv6-1.6b, then the
4-rank checkpoint restored). Every run starts from the port's SMOKE draws
(seed 0), the reference's too. Tolerances:

* the sharded train step (state by ``state_shardings``, batch by
  ``batch_shardings``, rules active), 3 steps of smollm-135m, qwen3-0.6b,
  moonshot-v1-16b-a3b (its ``experts`` on ``"model"``, the FSDP rules),
  jamba-1.5-large-398b (mamba + MoE, 16 x 64 tokens), llama-3.2-vision-90b
  and rwkv6-1.6b SMOKE
  against the one-device port and the reference's jitted step from the
  same parameters (rwkv6 at 4 x 16 tokens: at 4 x 8 from these draws its
  time mix amplifies the one-device port's rounding to 1.7e-4 of the
  reference's grad_norm, a property of the model, ROADMAP §C): loss and
  ``grad_norm`` within ``rtol=1e-4``, every
  gathered parameter and moment within ``1e-4`` of the leaf's largest
  magnitude, with a floor of ``1e-6`` absolute (a thousandth of one update
  at the rate of 1e-3: a leaf that starts at zero, rwkv6's ``gn_beta``,
  holds only its three updates): the model axis splits the sums of the
  products. AdamW keeps its state in float32 for every arch (jamba's
  config keeps it in bfloat16, where a moment rounded the other way moves
  a leaf that starts at zero, its ``dt_bias``, by more than the floor; the
  bfloat16 AdamW is held to the reference bitwise in
  ``tests/test_torch_optim.py``);
* prefill and decode on the mesh (parameters by ``param_shardings``, caches
  by ``cache_shardings``, ``kv_seq`` over ``model``): smollm-135m SMOKE, a
  prompt of 6 tokens and 3 decode steps at positions 6, 7 and 8 on 16 cache
  rows (so the last step's row lies in the second ``model`` shard), logits
  and caches against one device and the reference within the LM tests'
  f32 tolerance, ``rtol = atol = 1e-5`` (the ranks split the softmax's sums
  over ``kv_seq``);
* checkpoints and batches: bitwise. A checkpoint written on 4 ranks has the
  files of the same values saved unsharded, byte for byte, and restores onto
  2 ranks and onto one device bitwise, each rank holding its own slice.

The MoE groups its tokens into groups of 512 and shards the group axis over
``"data"``: the moonshot cases take 8 x 128 tokens, 2 groups. At 64 tokens
(one group over a 2-way data axis) the group stays whole on each rank
(``constrain`` splits a dim only over the mesh axes that divide it) and
the ``data`` ranks split the model width of its expert block instead, one
step against the one-device port to the same tolerances:
:func:`test_one_group_moe_runs_and_matches_one_device`. The MoE FFN, the
mamba block's ``dt`` and the vision projection run on each rank's own block:
their products' local shapes are pinned.
"""
import concurrent.futures
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro import configs as j_configs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as j_pipeline
from repro.launch import steps as j_steps
from repro.models import model as JM
from repro_torch import checkpoint as ckpt
from repro_torch import interop
from repro_torch.configs import get_bundle
from repro_torch.launch.mesh import run_world
from repro_torch.models import attention as TM_attn
from repro_torch.models import ffn as t_ffn
from repro_torch.models import model as TM
from repro_torch.models import ssm as t_ssm
from repro_torch.util import tree

jax.config.update("jax_platform_name", "cpu")

TRAIN = {"smollm-135m": (16, 4), "qwen3-0.6b": (16, 4), "moonshot-v1-16b-a3b": (128, 8),
         "rwkv6-1.6b": (16, 4), "jamba-1.5-large-398b": (64, 16),
         "llama-3.2-vision-90b": (16, 4)}
FOUR = ("smollm-135m", "qwen3-0.6b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
        "llama-3.2-vision-90b")                  # on the (2, 2) mesh
MOE = ("moonshot-v1-16b-a3b", "jamba-1.5-large-398b")
TWO = ("rwkv6-1.6b",)                            # on the (1, 2) mesh
ONE_GROUP = {"moonshot-v1-16b-a3b": (16, 4)}   # 64 tokens: one MoE group
RTOL = 1e-4
ATOL = 1e-6
SERVE = ("smollm-135m", 4, 9, 16)    # arch, batch, prompt + 3 decode tokens, cache rows
# The split loss: logits shape (rows, seq[, codebooks], vocab) and dtype; 37
# splits unevenly over the 2 model ranks.
LOSSES = (((4, 6, 48), "float32"), ((4, 6, 37), "float32"), ((4, 5, 2, 24), "bfloat16"))
# Relayouts on the (2, 2) mesh: shape, then the tensor dim each mesh dim
# splits before and after (None: whole). The first is the head's logits
# moved from the vocab to the sequence (Megatron-SP); 7 and 5 split unevenly.
RELAYOUTS = (((4, 8, 12), (0, 2), (0, 1)), ((4, 7, 5), (0, 2), (0, 1)),
             ((4, 8, 12), (0, 1), (0, 2)), ((6, 5, 7, 3), (1, 0), (3, 2)),
             ((4, 6, 12), (1, 2), (1, 0)), ((4, 8, 12), (0, 2), (None, 1)))
F32 = dict(rtol=1e-5, atol=1e-5)     # the LM tests' f32 tolerance


@functools.lru_cache(maxsize=None)
def _params(arch):
    """SMOKE parameters as numpy float32 leaves in the reference's layout:
    the port's draws (seed 0), which every run here starts from, the
    reference's included."""
    cfg = get_bundle(arch).smoke
    return interop.lm_params_to_numpy(TM.init(cfg, torch.Generator().manual_seed(0), "cpu"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The two worlds, started together (the 2-rank one restores the 4-rank
    one's checkpoint once it is written)."""
    out_dir = str(tmp_path_factory.mktemp("mesh"))
    kw = dict(device="cpu", backend="gloo", threads=1, timeout=300)
    cases = {arch: (arch, _params(arch), dims) for arch, dims in TRAIN.items()}
    arch, _, _, s_max = SERVE
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        four = pool.submit(run_world, "torch_mesh_ranks:world4", 4,
                           ("smollm-135m", _params("smollm-135m")),
                           ("llama-3.2-vision-90b", (16, 4)),
                           [cases[a] for a in FOUR], [(a, _params(a), d) for a, d in
                                                      ONE_GROUP.items()], out_dir,
                           (arch, _params(arch), _serve_tokens(), s_max),
                           [_loss_case(*c) for c in LOSSES], RELAYOUTS, **kw)
        two = pool.submit(run_world, "torch_mesh_ranks:world2", 2, [cases[a] for a in TWO],
                          "smollm-135m", _params("smollm-135m"),
                          os.path.join(out_dir, "sharded"), **kw)
        four, two = four.result(), two.result()
    return {"four": four, "two": two, "dir": out_dir,
            "train": {a: (four if a in FOUR else two) for a in TRAIN}}


def _loss_case(shape, dtype):
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    return logits, rng.integers(0, shape[-1], shape[:-1]).astype(np.int64), dtype


def _serve_tokens():
    arch, batch, cols, _ = SERVE
    cfg = get_bundle(arch).smoke
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (batch, cols)).astype(np.int64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = max(RTOL * float(np.abs(want).max()), ATOL)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: |error| {err:.3g} > {tol:.3g}"


def _check_slice(s, full):
    """A rank's local shard is the slice of the full value at its offset."""
    idx = tuple(slice(o, o + n) for o, n in zip(s["offset"], s["local_shape"]))
    np.testing.assert_array_equal(s["local"].float().numpy(), np.asarray(full, np.float32)[idx])


# ---------------------------------------------------------------------------
# the sharded train step


@pytest.mark.parametrize("arch", sorted(TRAIN))
def test_sharded_train_step_matches_one_device(worlds, arch):
    state, metrics = ranks.one_device_steps(arch, _params(arch), TRAIN[arch])
    want = tree.leaves(ranks.numpy_tree(tree.map(lambda t: t.float(), state)))
    for w in worlds["train"][arch]:
        got = w["train"][arch]["metrics"]
        for i, (g, m) in enumerate(zip(got, metrics)):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(g[k], m[k], rtol=RTOL, err_msg=f"step {i} {k}")
    gathered = worlds["train"][arch][0]["train"][arch]["state"]
    got = tree.leaves(gathered)
    assert len(got) == len(want)
    for i, (g, s) in enumerate(zip(got, want)):
        assert g.shape == s.shape
        _close(g, s, f"leaf {i}")


@pytest.mark.parametrize("arch", sorted(TRAIN))
def test_sharded_train_step_matches_the_reference(worlds, arch):
    cfg = j_configs.get_bundle(arch).smoke
    jpc = j_configs.get_bundle(arch).parallel_for("train_4k").replace(
        microbatches=1, opt_state_dtype="float32")
    params = jax.tree.map(jnp.asarray, _params(arch))
    state = j_steps.TrainState(params=params, opt=j_steps.adamw.init(
        params, jnp.dtype(jpc.opt_state_dtype)))
    step = jax.jit(j_steps.make_train_step(cfg, jpc, **ranks.STEP_KW))
    seq, gb = TRAIN[arch]
    got = worlds["train"][arch][0]["train"][arch]["metrics"]
    for i in range(3):
        b = j_pipeline.make_batch(cfg, JShapeConfig("test", "train", seq, gb),
                                  j_pipeline.PipelineState(17, i))
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[i][k], float(m[k]), rtol=RTOL,
                                       err_msg=f"step {i} {k}")
    want = jax.tree.leaves(state.params)
    mine = tree.leaves(worlds["train"][arch][0]["train"][arch]["state"].params)
    for i, (g, w) in enumerate(zip(mine, want)):
        _close(g, np.asarray(w, np.float32), f"param {i}")


def test_the_state_keeps_its_placements(worlds):
    """After 3 steps every parameter still lies as ``state_shardings`` laid
    it: the gradients are reduced onto the parameters' placements."""
    for arch in TRAIN:
        first = worlds["train"][arch][0]["train"][arch]["placements"]
        assert all(w["train"][arch]["placements"] == first for w in worlds["train"][arch])
        assert any("Shard" in p for p in first) and all("Partial" not in p for p in first)


def test_one_group_moe_runs_and_matches_one_device(worlds):
    """A MoE of one token group over a 2-way data axis (moonshot SMOKE at
    4 x 16 tokens), which DTensor refused until ``constrain`` split a dim
    only over the mesh axes that divide it: the group stays whole on each
    rank, and one sharded step matches the one-device port."""
    arch = "moonshot-v1-16b-a3b"
    dims = ONE_GROUP[arch]
    state, metrics = ranks.one_device_steps(arch, _params(arch), dims, n_steps=1)
    for w in worlds["four"]:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(w["one_group"][arch]["metrics"][0][k], metrics[0][k],
                                       rtol=RTOL, err_msg=k)
    want = tree.leaves(ranks.numpy_tree(tree.map(lambda t: t.float(), state)))
    got = tree.leaves(worlds["four"][0]["one_group"][arch]["state"])
    assert len(got) == len(want)
    for i, (g, s) in enumerate(zip(got, want)):
        _close(g, s, f"leaf {i}")


# ---------------------------------------------------------------------------
# checkpoints


def _unsharded(tmp_path):
    _, _, state = ranks.port_state("smollm-135m", _params("smollm-135m"))
    d = str(tmp_path / "plain")
    ckpt.save(d, 3, state, extra_meta={"world": 4})
    return d, state


def test_sharded_checkpoint_files_equal_the_unsharded_save(worlds, tmp_path):
    d, _ = _unsharded(tmp_path)
    a, b = os.path.join(worlds["dir"], "sharded", "step_00000003"), os.path.join(d, "step_00000003")
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_the_saving_ranks_held_their_own_slices(worlds, tmp_path):
    _, state = _unsharded(tmp_path)
    full = tree.leaves(state)
    for w in worlds["four"]:
        assert len(w["ckpt_slices"]) == len(full)
        for s, f in zip(w["ckpt_slices"], full):
            _check_slice(s, f.float().numpy())


def test_sharded_checkpoint_restores_onto_two_ranks(worlds, tmp_path):
    _, state = _unsharded(tmp_path)
    full = tree.leaves(state)
    for w in worlds["two"]:
        assert w["meta"]["step"] == 3 and w["meta"]["extra"] == {"world": 4}
        for s, f in zip(w["slices"], full):
            _check_slice(s, f.float().numpy())
        for g, f in zip(tree.leaves(w["state"]), full):
            np.testing.assert_array_equal(g, f.float().numpy())
    # the model axis of the (1, 2) mesh splits what the (2, 2) mesh's did
    assert any(s["placements"] == ["R", "S(0)"] for s in worlds["two"][0]["slices"])


def test_sharded_checkpoint_restores_onto_one_device(worlds, tmp_path):
    _, state = _unsharded(tmp_path)
    restored, meta = ckpt.restore(os.path.join(worlds["dir"], "sharded"), state)
    assert meta["step"] == 3
    for a, b in zip(tree.leaves(restored), tree.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# batches


def test_make_batch_with_shardings_is_the_references(worlds):
    arch = "llama-3.2-vision-90b"
    cfg = j_configs.get_bundle(arch).smoke
    want = j_pipeline.make_batch(cfg, JShapeConfig("test", "train", 16, 4),
                                 j_pipeline.PipelineState(17, 5))
    for w in worlds["four"]:
        assert sorted(w["batch"]) == sorted(want) == ["inputs", "targets", "vision_embeds"]
        for k, v in want.items():
            got = w["batch"][k]
            np.testing.assert_array_equal(np.asarray(got["full"], np.float64),
                                          np.asarray(v, np.float64))
            _check_slice(got["slice"], v)
            assert got["slice"]["placements"][0] == "S(0)"   # batch over "data"


# ---------------------------------------------------------------------------
# attention laid out as the reference lays it out


def test_the_score_product_is_each_ranks_own_block(worlds):
    """In a train step each rank's score product is its own (batch, heads)
    block, batch over the 2 ``data`` ranks and heads over the 2 ``model``
    ranks, and the product is one DTensor ``bmm`` at the global shapes: no
    rank gathers the heads. smollm-135m (3 heads padded to 4 on 1 kv head)
    and qwen3-0.6b (4 heads on 2 kv heads) are GQA; moonshot has a kv head
    per head."""
    for arch in FOUR:
        cfg = get_bundle(arch).smoke
        seq, batch = TRAIN[arch]
        hqp, dh = TM_attn.padded_q_heads(cfg), cfg.d_head
        for w in worlds["four"]:
            products = w["train"][arch]["products"]
            assert products, arch
            first = products[0]          # the scores of the first layer's first block
            assert first["a"] == (batch // 2, hqp // 2, seq, dh), (arch, first)
            assert first["b"] == (batch // 2, hqp // 2, dh, seq), (arch, first)
            assert first["global"] == (batch * hqp, seq, seq), (arch, first)
            assert first["local"] == (batch * hqp // 4, seq, seq), (arch, first)
            assert all(p["local"][0] * 4 == p["global"][0] for p in products), arch


def test_the_expert_products_are_each_ranks_own_block(worlds):
    """In a train step each rank runs the MoE FFN on its own block of (G/2
    groups, E/2 experts), the groups over the 2 ``data`` ranks and the
    experts over the 2 ``model`` ranks: the router's own expert columns, the
    dispatch, the three expert products and the combine (a partial sum over
    ``model``), each one DTensor product at its global shapes. moonshot and
    jamba take 1024 tokens, 2 groups of 512; the first MoE layer's six
    forward products."""
    for arch in MOE:
        cfg = get_bundle(arch).smoke
        seq, batch = TRAIN[arch]
        t = t_ffn.MOE_GROUP_TOKENS
        g, e, d, f = seq * batch // t, cfg.n_experts, cfg.d_model, cfg.d_ff
        c = t_ffn._capacity(cfg, t, cfg.capacity_factor)
        gl, el = g // 2, e // 2
        want = [("_logits", (gl * t, d), (d, el), (g * t, e), (gl * t, el)),
                ("_on_block", (gl, el * c, t), (gl, t, d), (g, e * c, d), (gl, el * c, d)),
                ("_on_block", (el, gl * c, d), (el, d, f), (e, g * c, f), (el, gl * c, f)),
                ("_on_block", (el, gl * c, d), (el, d, f), (e, g * c, f), (el, gl * c, f)),
                ("_on_block", (el, gl * c, f), (el, f, d), (e, g * c, d), (el, gl * c, d)),
                ("_on_block", (gl, t, el * c), (gl, el * c, d), (g, t, d), (gl, t, d))]
        for w in worlds["four"]:
            moe = [p for p in w["train"][arch]["layers"] if p["fn"] in ("_logits", "_on_block")]
            got = [(p["fn"], p["a"], p["b"], p["global"], p["local"]) for p in moe[:6]]
            assert got == want, (arch, w["rank"], got)
            assert moe[5]["placements"] == ["S(0)", "P(sum)"], moe[5]   # the combine


def test_the_dt_product_is_each_ranks_own_columns(worlds):
    """jamba's mamba block reduces ``dt`` (B, S, dt_rank) over the split
    ``d_inner`` first, then multiplies it by each rank's own ``d_inner / 2``
    columns of ``dt_proj``: no rank computes another's columns."""
    arch = "jamba-1.5-large-398b"
    cfg = get_bundle(arch).smoke
    seq, batch = TRAIN[arch]
    r, di = t_ssm.dt_rank(cfg), cfg.d_inner
    for w in worlds["four"]:
        dts = [p for p in w["train"][arch]["layers"] if p["fn"] == "mamba_block dt"]
        assert dts, w["rank"]
        for p in dts:
            assert (p["a"], p["b"]) == ((batch // 2, seq, r), (r, di // 2)), p
            assert (p["global"], p["local"]) == ((batch, seq, di),
                                                 (batch // 2, seq, di // 2)), p


def test_the_vision_projection_is_each_ranks_own_rows(worlds):
    """llama-vision's projection of the vision tokens: each rank multiplies
    its own batch rows (over ``data``) by the weight's own model columns
    (over ``model``, the mesh dim that splits no row), forward; its weight
    gradient is then a partial sum of the rank's rows."""
    arch = "llama-3.2-vision-90b"
    cfg = get_bundle(arch).smoke
    _, batch = TRAIN[arch]
    n, dv, d = cfg.n_vision_tokens, cfg.d_vision, cfg.d_model
    for w in worlds["four"]:
        got = [p for p in w["train"][arch]["layers"] if p["fn"] == "_project_vision"]
        assert got, w["rank"]
        for p in got:
            assert (p["a"], p["b"]) == ((batch // 2, n, dv), (dv, d // 2)), p
            assert (p["global"], p["local"]) == ((batch, n, d), (batch // 2, n, d // 2)), p


def _one_device_serve():
    arch, _, _, s_max = SERVE
    return ranks.serve_steps(arch, _params(arch), _serve_tokens(), s_max)


def _reference_serve():
    arch, _, _, s_max = SERVE
    cfg = j_configs.get_bundle(arch).smoke
    params = jax.tree.map(jnp.asarray, _params(arch))
    toks = jnp.asarray(_serve_tokens().astype(np.int32))
    n = toks.shape[1] - 3
    caches = JM.init_cache(cfg, toks.shape[0], s_max)
    logits, cached = [], []
    out, caches = JM.prefill_fn(params, cfg, {"inputs": toks[:, :n]}, caches)
    logits.append(np.asarray(out, np.float32))
    cached.append([np.asarray(x, np.float32) for x in jax.tree.leaves(caches)])
    for i in range(3):
        out, caches = JM.decode_fn(params, cfg, {"token": toks[:, n + i:n + i + 1],
                                                 "pos": jnp.asarray(n + i, jnp.int32)}, caches)
        logits.append(np.asarray(out, np.float32))
        cached.append([np.asarray(x, np.float32) for x in jax.tree.leaves(caches)])
    return logits, cached


def _hold_serve(got, logits, cached, what):
    names = ["prefill"] + [f"decode {i}" for i in range(3)]
    for name, g, want in zip(names, got["logits"], logits):
        np.testing.assert_allclose(g, want, err_msg=f"{what}: {name} logits", **F32)
    for name, g, want in zip(names, got["caches"], cached):
        g = tree.leaves(g) if not isinstance(g, list) or not isinstance(g[0], np.ndarray) else g
        assert len(g) == len(want)
        for a, b in zip(g, want):
            np.testing.assert_allclose(a, b, err_msg=f"{what}: {name} cache", **F32)


def test_mesh_prefill_and_decode_match_one_device(worlds):
    one = _one_device_serve()
    cached = [tree.leaves(c) for c in one["caches"]]
    for w in worlds["four"]:
        # (layers, B, S, Hkv*Dh): batch over "data", kv_seq over "model"
        assert w["serve"]["cache_placements"] == ["S(1)", "S(2)"]
        _hold_serve(w["serve"], one["logits"], cached, f"rank {w['rank']}")


def test_mesh_prefill_and_decode_match_the_reference(worlds):
    logits, cached = _reference_serve()
    for w in worlds["four"]:
        _hold_serve(w["serve"], logits, cached, f"rank {w['rank']}")


def test_a_decode_step_moves_no_cache(worlds):
    """The second decode step (row 7, the first ``model`` shard's last) under
    ``CommDebugMode``: inside the self-attention sublayers the softmax's max
    and sum and the weighted values are all-reduced (beside the output
    projection's partial sums), and no all-gather
    reaches one layer's K cache (the one gathered there is q's heads).
    Before the row was written into its own shard, DTensor gathered every
    layer's K and V caches for the write."""
    arch, batch, _, s_max = SERVE
    cfg = get_bundle(arch).smoke
    k_cache = batch * s_max * cfg.n_kv_heads * cfg.d_head * 4     # f32 bytes, one layer
    for w in worlds["four"]:
        records = [r for r in w["serve"]["comm"]["records"] if r[3]]
        gathers = [r for r in records if "gather" in r[0]]
        reduces = [r for r in records if "all_reduce" in r[0]]
        bl, hqp = batch // 2, TM_attn.padded_q_heads(cfg)
        shapes = [r[2] for r in reduces]
        assert shapes.count((bl, hqp, 1, 1)) == 2 * cfg.n_layers, shapes   # max, sum
        assert shapes.count((bl * hqp, 1, cfg.d_head)) == cfg.n_layers, shapes   # the values
        assert all(nbytes * 2 < k_cache for _, nbytes, _, _ in gathers), gathers


# ---------------------------------------------------------------------------
# the loss on each rank's vocab shard, relayouts as one all-to-all


@pytest.mark.parametrize("case", range(len(LOSSES)), ids=[f"{s}-{d}" for s, d in LOSSES])
def test_the_split_loss_matches_one_device_and_the_reference(worlds, case):
    """The NLL of logits whose vocab the 2 ``model`` ranks split (each
    rank's max, sum of exponentials and picked logit all-reduced): the loss
    and its gradient against the one-device port's ``log_softmax`` and the
    reference's ``cross_entropy`` under ``jax.value_and_grad``, within the
    train step's tolerances; the gradient keeps the logits' split."""
    from repro.models import common as j_common
    from repro_torch.models.common import cross_entropy

    logits, labels, dtype = _loss_case(*LOSSES[case])
    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_(True)
    want = cross_entropy(x, torch.from_numpy(labels))
    (want_grad,) = torch.autograd.grad(want, x)
    j_loss, j_grad = jax.value_and_grad(j_common.cross_entropy)(
        jnp.asarray(logits, getattr(jnp, dtype)), jnp.asarray(labels.astype(np.int32)))
    for w in worlds["four"]:
        got = w["losses"][case]
        assert got["placements"] == ["S(0)", f"S({logits.ndim - 1})"]
        np.testing.assert_allclose(got["loss"], float(want.detach()), rtol=RTOL)
        np.testing.assert_allclose(got["loss"], float(j_loss), rtol=RTOL)
    grad = worlds["four"][0]["losses"][case]["grad"]
    _close(grad, want_grad.float().numpy(), "gradient against one device")
    _close(grad, np.asarray(j_grad, np.float32), "gradient against the reference")


@pytest.mark.parametrize("case", range(len(RELAYOUTS)),
                         ids=[f"{s}-{a}-{b}" for s, a, b in RELAYOUTS])
def test_a_moved_split_is_one_all_to_all(worlds, case):
    """A split that moves from one tensor dim to another over a mesh dim
    is one all-to-all of the local shards, forward and backward, with no
    all-gather (DTensor gathered the whole tensor on gloo); the value and
    the gradient are DTensor's own layouts bitwise, uneven splits too. The
    last case also gathers the ``data`` split, which stays DTensor's
    all-gather."""
    _, src, dst = RELAYOUTS[case]
    for w in worlds["four"]:
        got = w["relayouts"][case]
        assert got["value"] and got["grad"], got
        assert "_c10d_functional::all_to_all_single" in got["collectives"], got
        gathers = [c for c in got["collectives"] if "gather" in c]
        assert bool(gathers) == (None in dst and None not in src), got


@pytest.mark.parametrize("arch", FOUR)
def test_no_rank_holds_a_whole_vocab_slab(worlds, arch):
    """In the first sharded train step no rank holds a block of a (rows,
    seq, vocab) slab with the vocab whole over the whole sequence: where
    the rules split the vocab (the FSDP archs) none with the vocab whole at
    all; where they split the sequence over ``model`` (Megatron-SP, the
    reference's layout: the vocab whole, as its rules leave it) only the
    rank's own rows and half of the sequence."""
    cfg = get_bundle(arch).smoke
    seq, batch = TRAIN[arch]
    seq_split = get_bundle(arch).parallel_for("train_4k").seq_shard_activations
    for w in worlds["four"]:
        slabs = w["train"][arch]["vocab_slabs"]
        if not seq_split:
            assert slabs == [], (arch, slabs)
        assert all(int(np.prod(s[:-1])) <= batch // 2 * seq // 2 for s in slabs), (arch, slabs)
