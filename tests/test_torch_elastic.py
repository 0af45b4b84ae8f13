"""Elastic re-meshing in the port (``repro_torch.runtime.elastic``) against
the reference (``repro.runtime.elastic``), on the CPU.

* The reference's ``tests/test_checkpoint_runtime.py::TestElastic`` (4),
  each run on the reference and on the port; the port's checkpoint
  round trip restores onto a one-rank ``DeviceMesh`` (a gloo world of one
  in this process, torn down after the test).
* ``plan_remesh`` field for field the reference's on the sweep of old
  shapes {(16, 16), (2, 16, 16), (4, 4), (2, 16)} x every ``n_lost_chips``
  from 0 up to the first that raises, which raises in both with the same
  message. Bitwise: these are integers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import checkpoint as j_ckpt
from repro.runtime import elastic as j_elastic
from repro_torch import checkpoint as t_ckpt
from repro_torch.launch import mesh as t_mesh
from repro_torch.parallel.sharding import NamedSharding, gather, is_dtensor
from repro_torch.runtime import elastic as t_elastic
from repro_torch.util import tree

jax.config.update("jax_platform_name", "cpu")

SWEEP = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
         ((4, 4), ("data", "model")), ((2, 16), ("data", "model"))]


@pytest.mark.parametrize("elastic", [j_elastic, t_elastic], ids=["reference", "port"])
class TestElastic:
    def test_plan_shrinks_data_axis_only(self, elastic):
        plan = elastic.plan_remesh(
            old_shape=(16, 16), axis_names=("data", "model"), n_lost_chips=16)
        assert plan.new_shape[1] == 16          # model preserved
        assert plan.new_shape[0] == 8           # data shrinks to pow2 fit
        assert plan.microbatch_multiplier == 2  # global batch preserved

    def test_plan_multipod(self, elastic):
        plan = elastic.plan_remesh(
            old_shape=(2, 16, 16), axis_names=("pod", "data", "model"),
            n_lost_chips=256)
        assert plan.new_shape[-1] == 16
        assert np.prod(plan.new_shape) <= 256

    def test_model_axis_unrecoverable(self, elastic):
        with pytest.raises(ValueError):
            elastic.plan_remesh(old_shape=(2, 16), axis_names=("data", "model"),
                                n_lost_chips=20)

    def test_checkpoint_reshard_roundtrip(self, elastic, tmp_path):
        """A checkpoint restores bit-exactly regardless of target sharding
        (a single device here)."""
        d = str(tmp_path)
        if elastic is j_elastic:
            t = {"a": jnp.full((4, 4), 2.5), "nested": {"b": jnp.arange(6).reshape(2, 3)}}
            j_ckpt.save(d, 1, t)
            sh = jax.sharding.SingleDeviceSharding(jax.devices()[0])
            restored, _ = j_ckpt.restore(d, t, shardings=jax.tree.map(lambda _: sh, t))
            np.testing.assert_allclose(np.asarray(restored["a"]), np.asarray(t["a"]))
            return
        t = {"a": torch.full((4, 4), 2.5), "nested": {"b": torch.arange(6).reshape(2, 3)}}
        t_ckpt.save(d, 1, t)
        assert not dist.is_initialized()
        try:
            plan = t_elastic.plan_remesh(old_shape=(4, 1), axis_names=("data", "model"),
                                         n_lost_chips=3)
            assert plan.new_shape == (1, 1) and plan.microbatch_multiplier == 4
            mesh = t_elastic.build_mesh(plan, device="cpu")
            assert tuple(mesh.mesh_dim_names) == ("data", "model")
            shardings = {"a": NamedSharding(mesh, ("data", "model")),
                         "nested": {"b": NamedSharding(mesh, (None, "model"))}}
            restored, _ = t_ckpt.restore(d, t, shardings=shardings)
            assert all(is_dtensor(x) for x in tree.leaves(restored))
            for got, want in zip(tree.leaves(restored), tree.leaves(t)):
                assert torch.equal(gather(got), want) and got.dtype == want.dtype
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


def _sweep_cases():
    for shape, names in SWEEP:
        total = int(np.prod(shape))
        for lost in range(total + 1):
            yield shape, names, lost


@pytest.mark.parametrize("shape,names", SWEEP, ids=["16x16", "2x16x16", "4x4", "2x16"])
def test_plan_remesh_is_the_references(shape, names):
    total, raised = int(np.prod(shape)), False
    for lost in range(total + 1):
        kw = dict(old_shape=shape, axis_names=names, n_lost_chips=lost)
        try:
            want = j_elastic.plan_remesh(**kw)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                t_elastic.plan_remesh(**kw)
            assert str(got.value) == str(e)
            raised = True
            break
        assert dataclasses.asdict(t_elastic.plan_remesh(**kw)) == dataclasses.asdict(want)
    assert raised


def test_plan_fields_are_the_references():
    assert ([f.name for f in dataclasses.fields(t_elastic.RemeshPlan)]
            == [f.name for f in dataclasses.fields(j_elastic.RemeshPlan)])


def test_build_mesh_refuses_a_world_of_another_size():
    plan = t_elastic.plan_remesh(old_shape=(16, 16), axis_names=("data", "model"),
                                 n_lost_chips=16)
    with pytest.raises(ValueError, match=r"a \(8, 16\) \('data', 'model'\) mesh needs 128 "
                                         r"ranks; this world has 1"):
        t_elastic.build_mesh(plan, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 256 ranks; this world has 1"):
        t_mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks; this world has 1"):
        t_mesh.make_production_mesh(multi_pod=True, device="cpu")
