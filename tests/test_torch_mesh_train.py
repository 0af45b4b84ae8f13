"""The LM stack on a ``DeviceMesh``: the sharded train step, sharded
checkpoints and sharded batches, on gloo worlds of CPU ranks.

Two worlds run side by side, once (module scoped), and each case is
asserted here on its own: 4 ranks on a (2, 2) ``("data", "model")`` mesh
(``tests/torch_mesh_ranks.world4``: a checkpoint, batches, smollm-135m and
moonshot-v1-16b-a3b, a one-group MoE) and 2 ranks on a (1, 2) mesh
(``world2``: rwkv6-1.6b, then the 4-rank checkpoint restored). Every run
starts from the port's SMOKE draws (seed 0), the reference's too.
Tolerances:

* the sharded train step (state by ``state_shardings``, batch by
  ``batch_shardings``, rules active), 3 steps of smollm-135m, moonshot-v1-16b-a3b
  (its ``experts`` on ``"model"``, the FSDP rules) and rwkv6-1.6b SMOKE
  against the one-device port and the reference's jitted step from the
  same parameters (rwkv6 at 4 x 16 tokens: at 4 x 8 from these draws its
  time mix amplifies the one-device port's rounding to 1.7e-4 of the
  reference's grad_norm, a property of the model, ROADMAP §C): loss and
  ``grad_norm`` within ``rtol=1e-4``, every
  gathered parameter and moment within ``1e-4`` of the leaf's largest
  magnitude, with a floor of ``1e-6`` absolute (a thousandth of one update
  at the rate of 1e-3: a leaf that starts at zero, rwkv6's ``gn_beta``,
  holds only its three updates): the model axis splits the sums of the
  products;
* checkpoints and batches: bitwise. A checkpoint written on 4 ranks has the
  files of the same values saved unsharded, byte for byte, and restores onto
  2 ranks and onto one device bitwise, each rank holding its own slice.

The MoE groups its tokens into groups of 512 and shards the group axis over
``"data"``: the moonshot cases take 8 x 128 tokens, 2 groups. At 64 tokens
(one group over a 2-way data axis) the group stays whole on each rank
(``constrain`` splits a dim only over the mesh axes that divide it), one
step against the one-device port to the same tolerances:
:func:`test_one_group_moe_runs_and_matches_one_device`.
jamba-1.5-large-398b's backward fails on DTensor (ROADMAP §C) and is not
run here.
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
from repro_torch import checkpoint as ckpt
from repro_torch import interop
from repro_torch.configs import get_bundle
from repro_torch.launch.mesh import run_world
from repro_torch.models import model as TM
from repro_torch.util import tree

jax.config.update("jax_platform_name", "cpu")

TRAIN = {"smollm-135m": (16, 4), "moonshot-v1-16b-a3b": (128, 8), "rwkv6-1.6b": (16, 4)}
FOUR = ("smollm-135m", "moonshot-v1-16b-a3b")   # on the (2, 2) mesh
TWO = ("rwkv6-1.6b",)                            # on the (1, 2) mesh
ONE_GROUP = {"moonshot-v1-16b-a3b": (16, 4)}   # 64 tokens: one MoE group
RTOL = 1e-4
ATOL = 1e-6


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
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        four = pool.submit(run_world, "torch_mesh_ranks:world4", 4,
                           ("smollm-135m", _params("smollm-135m")),
                           ("llama-3.2-vision-90b", (16, 4)),
                           [cases[a] for a in FOUR], [(a, _params(a), d) for a, d in
                                                      ONE_GROUP.items()], out_dir, **kw)
        two = pool.submit(run_world, "torch_mesh_ranks:world2", 2, [cases[a] for a in TWO],
                          "smollm-135m", _params("smollm-135m"),
                          os.path.join(out_dir, "sharded"), **kw)
        four, two = four.result(), two.result()
    return {"four": four, "two": two, "dir": out_dir,
            "train": {a: (four if a in FOUR else two) for a in TRAIN}}


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
    jpc = j_configs.get_bundle(arch).parallel_for("train_4k").replace(microbatches=1)
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
