"""Logical-axis sharding rules in the port (``repro_torch.parallel.sharding``,
``launch/mesh.make_rules`` / ``make_production_mesh``, the sharding and
struct builders of ``launch/steps.py``, ``constrain`` at the models' call
sites) against the reference (``repro.parallel.sharding``,
``repro.launch.mesh``, ``repro.launch.steps``) on the CPU.

Every comparison here is bitwise: these are tables.

* The reference's ``tests/test_sharding_rules.py`` (all 8) and
  ``test_system.py::test_tp_divisibility_invariants``, each run on the
  reference and on the port.
* For the ten LM archs, every applicable shape and ``multi_pod`` in {False,
  True}: ``make_rules(...).mapping`` entry for entry; the spec of every leaf
  of ``param_shardings``, ``opt_shardings`` (AdamW and Adafactor),
  ``batch_shardings`` and ``cache_shardings`` equal to ``tuple(PartitionSpec)``
  of the reference's; every struct's shape and dtype equal to the
  reference's ``ShapeDtypeStruct``. The reference's builders run on a
  (1, 1) or (1, 1, 1) ``jax`` mesh of the right names (its specs do not
  depend on the sizes); the port's on a stand-in mesh, since a spec needs
  only the rules.
* The production meshes, (16, 16) and (2, 16, 16), built on the fake
  process group in a child process (``tests/torch_fake_meshes.py``), so that
  no later test inherits the fake group: their dim names, and the DTensor
  placements of ``param_shardings`` of every FULL arch, each ``Shard(d)``
  where the reference's spec puts that mesh axis on dim ``d``, each
  sharded dim divisible by its mesh axis; and the rank order of a tensor
  dim over two mesh axes (``("pod", "data")``): every rank of a fake
  (2, 2, 2) mesh keeps the slice JAX gives the device at the same place
  of ``jax.make_mesh``.
* ``constrain``: ``x`` itself without rules or without a mesh; under rules
  without a mesh a forward of every SMOKE arch is bitwise the forward
  without rules.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import applicable_shapes as j_applicable
from repro.launch import mesh as j_mesh
from repro.launch import steps as j_steps
from repro.models import attention as j_attn
from repro.models import model as JM
from repro.models.common import is_spec as j_is_spec
from repro.parallel import sharding as j_sh
from repro_torch.configs import ASSIGNED_ARCHS, get_bundle
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.models import attention as t_attn
from repro_torch.models import model as TM
from repro_torch.models.common import map_specs
from repro_torch.parallel import sharding as t_sh
from repro_torch.util import tree

jax.config.update("jax_platform_name", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# the reference's tests/test_sharding_rules.py, on both


@pytest.mark.parametrize("sh", [j_sh, t_sh], ids=["reference", "port"])
def test_spec_basic(sh):
    r = sh.AxisRules(sh.BASE_RULES)
    assert P(*r.spec(("batch", "seq", "embed"))) == P("data", None, None)
    assert P(*r.spec(("vocab", "embed_param"))) == P("model", None)


@pytest.mark.parametrize("sh", [j_sh, t_sh], ids=["reference", "port"])
def test_unknown_axis_raises(sh):
    r = sh.AxisRules(sh.BASE_RULES)
    with pytest.raises(KeyError):
        r.spec(("nonsense",))


@pytest.mark.parametrize("sh", [j_sh, t_sh], ids=["reference", "port"])
def test_overrides(sh):
    r = sh.AxisRules(sh.BASE_RULES).with_overrides(sh.multipod_overrides())
    assert P(*r.spec(("batch",))) == P(("pod", "data"))
    r2 = sh.AxisRules(sh.BASE_RULES).with_overrides(sh.fsdp_overrides())
    assert P(*r2.spec(("qkv_in", "q_heads"))) == P("data", "model")


@pytest.mark.parametrize("sh", [j_sh, t_sh], ids=["reference", "port"])
def test_duplicate_mesh_axis_dedup(sh):
    """Colliding rules (Megatron-SP seq=model meeting heads=model) must not
    produce an invalid spec -- earlier dims win."""
    r = sh.AxisRules(sh.BASE_RULES).with_overrides({"seq": "model"})
    assert P(*r.spec(("batch", "seq", "act_heads"))) == P("data", "model", None)


def test_constrain_noop_without_rules():
    x = jnp.ones((4, 4))
    assert j_sh.constrain(x, "batch", "embed") is x
    t = torch.ones(4, 4)
    assert t_sh.constrain(t, "batch", "embed") is t


def test_constrain_rank_mismatch():
    """Mesh None -> no-op regardless of the rank of the axes; under a mesh a
    rank mismatch raises (the port's check, the reference's message)."""
    for sh, x in ((j_sh, jnp.ones((2, 2))), (t_sh, torch.ones(2, 2))):
        with sh.use_rules(sh.AxisRules(sh.BASE_RULES, mesh=None)):
            assert sh.constrain(x, "batch", "embed") is x
            assert sh.constrain(x, "batch") is x
    with t_sh.use_rules(t_sh.AxisRules(t_sh.BASE_RULES, mesh=_stand_in(("data", "model")))):
        with pytest.raises(ValueError, match="rank mismatch: 1 axes for shape"):
            t_sh.constrain(torch.ones(2, 2), "batch")


@pytest.mark.parametrize("sh", [j_sh, t_sh], ids=["reference", "port"])
def test_make_rules_shapes(sh):
    """Rule assembly per shape kind (no devices needed: mesh=None path)."""
    cfgs = j_configs if sh is j_sh else __import__("repro_torch.configs", fromlist=["x"])
    r = sh.AxisRules(sh.BASE_RULES).with_overrides({"kv_seq": "model"})
    assert P(*r.spec(("batch", "kv_seq", None))) == P("data", "model", None)
    bundle = cfgs.get_bundle("jamba-1.5-large-398b")
    assert bundle.parallel_for("train_4k").fsdp
    assert bundle.parallel_for("decode_32k").fsdp  # falls back to "*"


@pytest.mark.parametrize("attn,cfgs", [(j_attn, j_configs), (t_attn, None)],
                         ids=["reference", "port"])
def test_head_maps(attn, cfgs):
    get = cfgs.get_bundle if cfgs else get_bundle
    cfg = dataclasses.replace(get("smollm-135m").model)  # 9 heads, pad 16
    assert attn.padded_q_heads(cfg) == 16
    to_kv, mask = attn.head_maps(cfg)
    assert mask.sum() == 9              # 9 live, 7 dead
    assert to_kv.max() < cfg.n_kv_heads
    # real heads group 3 q per kv
    assert list(to_kv[:9]) == [0, 0, 0, 1, 1, 1, 2, 2, 2]


def test_base_rules_and_overrides_are_the_references():
    assert t_sh.BASE_RULES == j_sh.BASE_RULES
    assert list(t_sh.BASE_RULES) == list(j_sh.BASE_RULES)
    assert t_sh.fsdp_overrides() == j_sh.fsdp_overrides()
    assert t_sh.multipod_overrides() == j_sh.multipod_overrides()
    for axes in ("data", ("pod", "data")):
        assert t_sh.seq_shard_overrides(axes) == j_sh.seq_shard_overrides(axes)
    assert t_sh.seq_shard_overrides() == j_sh.seq_shard_overrides()


@pytest.mark.parametrize("specs_of", ["reference", "port"])
def test_tp_divisibility_invariants(specs_of):
    """Every model-axis-sharded parameter dim divides the 16-way TP width."""
    for arch in ASSIGNED_ARCHS:
        if specs_of == "reference":
            specs = jax.tree.leaves(JM.specs(j_configs.get_bundle(arch).model), is_leaf=j_is_spec)
        else:
            specs = []
            map_specs(specs.append, TM.specs(get_bundle(arch).model))
        assert specs
        for s in specs:
            for dim, ax in zip(s.shape, s.axes):
                if ax is None:
                    continue
                if t_sh.BASE_RULES.get(ax) == "model":
                    assert dim % 16 == 0, f"{arch}: axis {ax} dim {dim} !% 16"


# ---------------------------------------------------------------------------
# rule, spec and struct parity for every arch, shape and mesh


def _stand_in(names, shape=None):
    """A mesh for rules that need only its names and sizes (specs and
    placements, no process group)."""
    shape = shape or (2,) * len(names)
    return types.SimpleNamespace(mesh_dim_names=tuple(names), ndim=len(names),
                                 mesh=np.empty(shape))


@functools.lru_cache(maxsize=None)
def _j_mesh(multi_pod):
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = np.asarray(jax.devices()[:1]).reshape((1,) * len(names))
    return jax.sharding.Mesh(devs, names)


def _cells():
    return [(arch, shape, multi) for arch in ASSIGNED_ARCHS
            for shape in j_applicable(j_configs.get_bundle(arch).model)
            for multi in (False, True)]


def _j_specs(tree_):
    """The reference's sharding tree as a flat list of specs (``None`` for a
    leaf without a sharding)."""
    leaves = jax.tree.leaves(tree_, is_leaf=lambda x: x is None or isinstance(
        x, jax.sharding.NamedSharding))
    return [None if s is None else tuple(s.spec) for s in leaves]


def _t_specs(tree_):
    return [None if s is None else tuple(P(*s.spec)) for s in tree.leaves(tree_)]


def _rules(arch, shape_name, multi):
    jb, tb = j_configs.get_bundle(arch), get_bundle(arch)
    jrules = j_mesh.make_rules(_j_mesh(multi), jb.model, J_SHAPES[shape_name],
                               jb.parallel_for(shape_name), multi_pod=multi)
    names = ("pod", "data", "model") if multi else ("data", "model")
    trules = t_mesh.make_rules(_stand_in(names), tb.model, SHAPES[shape_name],
                               tb.parallel_for(shape_name), multi_pod=multi)
    return jb.model, tb.model, jrules, trules


def test_every_cell_is_counted():
    assert len(_cells()) == 64


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_make_rules_mapping_is_the_references(arch):
    for a, shape_name, multi in _cells():
        if a != arch:
            continue
        jb, tb = j_configs.get_bundle(arch), get_bundle(arch)
        want = j_mesh.make_rules(None, jb.model, J_SHAPES[shape_name],
                                 jb.parallel_for(shape_name), multi_pod=multi)
        got = t_mesh.make_rules(None, tb.model, SHAPES[shape_name],
                                tb.parallel_for(shape_name), multi_pod=multi)
        assert dict(got.mapping) == dict(want.mapping), (shape_name, multi)
        assert list(got.mapping) == list(want.mapping)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_shardings_are_the_references(arch, multi):
    for a, shape_name, m in _cells():
        if a != arch or m != multi:
            continue
        jcfg, tcfg, jr, tr = _rules(arch, shape_name, multi)
        shape_j, shape_t = J_SHAPES[shape_name], SHAPES[shape_name]
        pairs = [
            (j_steps.param_shardings(jcfg, jr), t_steps.param_shardings(tcfg, tr)),
            (j_steps.opt_shardings(jcfg, jr, "adamw"), t_steps.opt_shardings(tcfg, tr, "adamw")),
            (j_steps.opt_shardings(jcfg, jr, "adafactor"),
             t_steps.opt_shardings(tcfg, tr, "adafactor")),
            (j_steps.batch_shardings(jcfg, shape_j, jr),
             t_steps.batch_shardings(tcfg, shape_t, tr)),
            (j_steps.cache_shardings(jcfg, shape_j, jr),
             t_steps.cache_shardings(tcfg, shape_t, tr)),
        ]
        pc = j_configs.get_bundle(arch).parallel_for(shape_name)
        pairs.append((j_steps.state_shardings(jcfg, jr, pc),
                      t_steps.state_shardings(tcfg, tr, get_bundle(arch).parallel_for(shape_name))))
        for i, (want, got) in enumerate(pairs):
            w, g = _j_specs(want), _t_specs(got)
            assert len(w) == len(g) and w == g, (shape_name, i)


def _j_structs(tree_):
    return [(tuple(s.shape), str(s.dtype), None if s.sharding is None else tuple(s.sharding.spec))
            for s in jax.tree.leaves(tree_)]


def _t_structs(tree_):
    return [(tuple(s.shape), str(s.dtype).replace("torch.", ""),
             None if s.sharding is None else tuple(P(*s.sharding.spec)))
            for s in tree.leaves(tree_)]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_structs_are_the_references(arch):
    for a, shape_name, multi in _cells():
        if a != arch:
            continue
        jcfg, tcfg, jr, tr = _rules(arch, shape_name, multi)
        shape_j, shape_t = J_SHAPES[shape_name], SHAPES[shape_name]
        for jrules, trules in ((jr, tr), (None, None)):
            for opt in ("adamw", "adafactor"):
                for dt in ("float32", "bfloat16"):
                    jpc = j_configs.get_bundle(arch).parallel_for(shape_name).replace(
                        optimizer=opt, opt_state_dtype=dt)
                    tpc = get_bundle(arch).parallel_for(shape_name).replace(
                        optimizer=opt, opt_state_dtype=dt)
                    assert (_t_structs(t_steps.state_structs(tcfg, tpc, trules))
                            == _j_structs(j_steps.state_structs(jcfg, jpc, jrules)))
            assert (_t_structs(t_steps.params_structs(tcfg, trules))
                    == _j_structs(j_steps.params_structs(jcfg, jrules)))
            assert (_t_structs(t_steps.batch_structs(tcfg, shape_t, trules))
                    == _j_structs(j_steps.batch_structs(jcfg, shape_j, jrules)))
            assert (_t_structs(t_steps.cache_structs(tcfg, shape_t, trules))
                    == _j_structs(j_steps.cache_structs(jcfg, shape_j, jrules)))


def test_logical_axes_and_shapes_of_are_the_references():
    from repro.models import common as j_common
    from repro_torch.models import common as t_common
    for arch in ASSIGNED_ARCHS:
        js, ts = JM.specs(j_configs.get_bundle(arch).model), TM.specs(get_bundle(arch).model)
        is_t = lambda x: isinstance(x, tuple)
        assert (jax.tree.leaves(j_common.logical_axes(js), is_leaf=is_t)
                == [s.axes for s in tree.leaves(ts)])
        assert (jax.tree.leaves(j_common.shapes_of(js), is_leaf=is_t)
                == [s.shape for s in tree.leaves(ts)])
        axes = t_common.logical_axes(ts)
        assert axes["final_ln"] == ("norm",) and t_common.shapes_of(ts)["final_ln"] == ts[
            "final_ln"].shape


def test_placements_of_specs():
    """Spec entries become DTensor placements by mesh-dim name, ``Shard``
    only over a mesh dim of more than one rank; an entry that names mesh
    axes out of the mesh's order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _stand_in(("pod", "data", "model"))
    assert t_sh.placements_of(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert t_sh.placements_of(mesh, (None, "data")) == (Replicate(), Shard(1), Replicate())
    assert t_sh.placements_of(mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        t_sh.placements_of(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="names mesh axis 'model'"):
        t_sh.placements_of(_stand_in(("data",)), ("model",))
    # a mesh dim of one rank splits nothing
    one = _stand_in(("data", "model"), (1, 4))
    assert t_sh.placements_of(one, ("data", "model")) == (Replicate(), Shard(1))


# ---------------------------------------------------------------------------
# the production meshes, in a child process on the fake process group


@pytest.fixture(scope="module")
def fake_meshes():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(HERE), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, os.path.join(HERE, "torch_fake_meshes.py")],
                         env=env, capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _placements_from(spec, names):
    out = []
    for name in names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(f"S({dims[0]})" if dims else "R")
    return out


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_production_meshes_on_the_fake_group(fake_meshes, multi):
    got = fake_meshes["multi" if multi else "single"]
    names = ["pod", "data", "model"] if multi else ["data", "model"]
    assert got["names"] == names
    assert got["shape"] == ([2, 16, 16] if multi else [16, 16])
    assert sorted(got["archs"]) == sorted(ASSIGNED_ARCHS)
    for arch, res in got["archs"].items():
        jb = j_configs.get_bundle(arch)
        jr = j_mesh.make_rules(None, jb.model, J_SHAPES["train_4k"],
                               jb.parallel_for("train_4k"), multi_pod=multi)
        axes = jax.tree.leaves(jax.tree.map(lambda s: s.axes, JM.specs(jb.model),
                                            is_leaf=j_is_spec),
                               is_leaf=lambda x: isinstance(x, tuple))
        want = [_placements_from(tuple(jr.spec(a)), names) for a in axes]
        assert res["placements"] == want, arch
        assert res["indivisible"] == [], arch


@pytest.mark.parametrize("case", ["batch", "batch_model"])
def test_two_mesh_axes_on_one_dim_follow_jax_device_order(fake_meshes, case):
    """``("pod", "data")`` on one dim: rank r of the fake (2, 2, 2) mesh keeps
    the slice JAX gives ``jax.make_mesh((2, 2, 2))``'s device at flat index r."""
    specs = {"batch": P(("pod", "data"), None), "batch_model": P(("pod", "data"), "model")}
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    index = jax.sharding.NamedSharding(mesh, specs[case]).devices_indices_map(x.shape)
    got = fake_meshes["order"][case]
    for r, dev in enumerate(mesh.devices.flat):
        np.testing.assert_array_equal(np.asarray(got[r], np.float32), x[index[dev]])


# ---------------------------------------------------------------------------
# constrain at the models' call sites


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_rules_without_a_mesh_change_no_number(arch):
    """Under every cell's rules without a mesh, a train-mode forward of the
    SMOKE config is bitwise the forward without rules (``constrain`` hands
    back its input)."""
    torch.set_num_threads(1)
    cfg = get_bundle(arch).smoke
    params = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    g = np.random.default_rng(3)
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (2, 8) + (
        (cfg.n_codebooks,) if cfg.family == "audio" else ()), dtype=np.int32))
    ve = None
    if cfg.family == "vlm":
        ve = torch.from_numpy(g.standard_normal(
            (2, cfg.n_vision_tokens, cfg.d_vision), dtype=np.float32)).to(TM.dtype_of(cfg))
    want, _, _ = TM.forward(params, cfg, toks, mode="train", vision_embeds=ve, remat="none")
    seen = []
    real = t_sh.constrain

    def counting(x, *axes):
        y = real(x, *axes)
        seen.append(y is x)
        return y

    rules = t_mesh.make_rules(None, cfg, SHAPES["train_4k"],
                              get_bundle(arch).parallel_for("train_4k"))
    mods = [sys.modules[m] for m in ("repro_torch.models.model", "repro_torch.models.attention",
                                     "repro_torch.models.ffn", "repro_torch.models.ssm",
                                     "repro_torch.models.rwkv", "repro_torch.models.transformer")]
    try:
        for m in mods:
            m.constrain = counting
        with t_sh.use_rules(rules):
            got, _, _ = TM.forward(params, cfg, toks, mode="train", vision_embeds=ve,
                                   remat="none")
    finally:
        for m in mods:
            m.constrain = real
    assert seen and all(seen)
    assert torch.equal(got, want)
