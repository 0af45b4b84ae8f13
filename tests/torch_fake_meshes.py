"""Child process of ``tests/test_torch_sharding_rules.py``: the production
meshes on the fake process group.

Run as a script (``python tests/torch_fake_meshes.py``), it prints one JSON
object: for the (16, 16) and (2, 16, 16) meshes, built in a fake world of
256 and 512 ranks, the mesh's names and shape and the DTensor placements of
``param_shardings`` of every FULL arch (with every model-sharded dim that
does not divide its mesh axis), and the local slice every rank of a fake
world of 8 keeps of two global tensors laid over a (2, 2, 2) ``("pod",
"data", "model")`` mesh. The fake group never leaves this process.
"""
import json

import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import ASSIGNED_ARCHS, get_bundle
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import steps
from repro_torch.parallel.sharding import NamedSharding, place
from repro_torch.util import tree

ORDER_CASES = {"batch": (("pod", "data"), None), "batch_model": (("pod", "data"), "model")}
ORDER_SHAPE = (8, 4)


def production(multi: bool) -> dict:
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512 if multi else 256)
    try:
        mesh = launch_mesh.make_production_mesh(multi_pod=multi, device="cpu")
        out = {"names": list(mesh.mesh_dim_names), "shape": list(mesh.mesh.shape), "archs": {}}
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        for arch in ASSIGNED_ARCHS:
            bundle = get_bundle(arch)
            rules = launch_mesh.make_rules(mesh, bundle.model, SHAPES["train_4k"],
                                           bundle.parallel_for("train_4k"), multi_pod=multi)
            shard = tree.leaves(steps.param_shardings(bundle.model, rules))
            shapes = [st.shape for st in tree.leaves(steps.params_structs(bundle.model))]
            bad = []
            for sh, shape in zip(shard, shapes):
                for name, p in zip(mesh.mesh_dim_names, sh.placements):
                    if p.is_shard() and shape[p.dim] % sizes[name]:
                        bad.append([list(shape), p.dim, name])
            out["archs"][arch] = {"placements": [[str(p) for p in sh.placements] for sh in shard],
                                  "indivisible": bad}
        return out
    finally:
        dist.destroy_process_group()


def order() -> dict:
    x = torch.arange(ORDER_SHAPE[0] * ORDER_SHAPE[1], dtype=torch.float32).reshape(ORDER_SHAPE)
    out = {k: [] for k in ORDER_CASES}
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
        try:
            mesh = launch_mesh.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
            for k, spec in ORDER_CASES.items():
                out[k].append(place(x, NamedSharding(mesh, spec)).to_local().tolist())
        finally:
            dist.destroy_process_group()
    return out


if __name__ == "__main__":
    print(json.dumps({"single": production(False), "multi": production(True),
                      "order": order()}))
