"""Rank bodies of ``tests/test_torch_mesh_train.py``: what each rank of a gloo
world runs on a ``DeviceMesh`` of the LM stack.

Each function is started on every rank by ``repro_torch.launch.mesh.run_world``
(which passes the world's ``SNNMesh`` first; these bodies build their own
``DeviceMesh``) and returns host values that the test asserts on. Every rank
starts from the same global values, passed in as numpy trees, so nothing here
imports the reference.
"""
import contextlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import checkpoint as ckpt
from repro_torch import interop
from repro_torch.configs import get_bundle
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import steps
from repro_torch.models import attention
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.common import cross_entropy
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import gather, is_dtensor, use_rules
from repro_torch.util import tree

AXES = ("data", "model")
STEP_KW = dict(peak_lr=1e-3, warmup_steps=2, total_steps=3)


def shape_of(dims):
    return ShapeConfig("test", "train", dims[0], dims[1])


def port_state(arch, params_np):
    """The SMOKE train state (AdamW, the CLI's knobs, its state in float32)
    from numpy parameters."""
    cfg = get_bundle(arch).smoke
    pcfg = get_bundle(arch).parallel_for("train_4k").replace(microbatches=1,
                                                            opt_state_dtype="float32")
    params = interop.lm_params_from_numpy(params_np, cfg, "cpu")
    return cfg, pcfg, steps.TrainState(params=params, opt=adamw.init(
        params, getattr(torch, pcfg.opt_state_dtype)))


def slices(x):
    """A DTensor's local shard with its global offset and shape."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local_shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return {"local": x.to_local().clone(), "offset": tuple(offset),
            "local_shape": tuple(local_shape), "placements": [str(p) for p in x.placements]}


@contextlib.contextmanager
def products_seen(seen):
    """Each product of the attention core on a mesh (``folded_bmm``) while
    active: the local blocks' shapes, the product's global and local shapes
    and its placements, appended to ``seen``."""
    real = attention.folded_bmm

    def recording(a, b, mesh, pa, pb):
        out = real(a, b, mesh, pa, pb)
        seen.append({"a": tuple(a.shape), "b": tuple(b.shape), "global": tuple(out.shape),
                     "local": tuple(out.to_local().shape),
                     "placements": [str(p) for p in out.placements]})
        return out

    attention.folded_bmm = recording
    try:
        yield seen
    finally:
        attention.folded_bmm = real


def _product(fn, a, b, out):
    return {"fn": fn, "a": tuple(a.to_local().shape) if is_dtensor(a) else tuple(a.shape),
            "b": tuple(b.to_local().shape) if is_dtensor(b) else tuple(b.shape),
            "global": tuple(out.shape), "local": tuple(out.to_local().shape),
            "placements": [str(p) for p in out.placements]}


@contextlib.contextmanager
def layer_products_seen(seen, cfg):
    """Each forward product on DTensors of the MoE FFN (``torch.mm`` /
    ``torch.bmm`` called from ``models/ffn.py``: the router, the dispatch,
    the three expert products and the combine), of the mamba block's ``dt``
    (``ssm.dot`` against ``dt_proj``) and of the vision projection
    (``model.dot`` against ``vision_proj``) while active: the function that
    made it, the operands' local shapes, the product's global and local
    shapes and its placements, appended to ``seen``."""
    real = {"mm": torch.mm, "bmm": torch.bmm, "ssm": ssm.dot, "model": M.dot}

    def moe(name):
        def product(a, b):
            out = real[name](a, b)
            caller = sys._getframe(1).f_code
            if is_dtensor(out) and caller.co_filename.endswith(os.path.join("models", "ffn.py")):
                seen.append(_product(caller.co_name, a, b, out))
            return out
        return product

    def dot(module, fn, rows):
        def product(x, w):
            out = real[module](x, w)
            if is_dtensor(out) and w.shape[0] == rows:
                seen.append(_product(fn, x, w, out))
            return out
        return product

    torch.mm, torch.bmm = moe("mm"), moe("bmm")
    ssm.dot = dot("ssm", "mamba_block dt", ssm.dt_rank(cfg))
    M.dot = dot("model", "_project_vision", cfg.d_vision or -1)
    try:
        yield seen
    finally:
        torch.mm, torch.bmm, ssm.dot, M.dot = real["mm"], real["bmm"], real["ssm"], real["model"]


class VocabSlabs(TorchDispatchMode):
    """While active (a mode above DTensor), the local shape of every op's
    output, a DTensor's own shard, that has three dims or more and the
    whole vocab ``vocab`` as its last: each block of a (rows, seq, vocab)
    slab that a rank holds, in ``shapes``. The local ops of a
    redistribution are seen too (DTensor's gather of a split that moves);
    the meta tensors of DTensor's sharding propagation, at global shapes,
    hold nothing and are passed over."""

    def __init__(self, vocab: int):
        super().__init__()
        self.vocab = vocab
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            local = getattr(t, "_local_tensor", t)
            if isinstance(local, torch.Tensor) and local.device.type != "meta" \
                    and local.dim() >= 3 and local.shape[-1] == self.vocab:
                self.shapes.add(tuple(local.shape))
        return out


def _run_steps(arch, params_np, dims, mesh_shape, n_steps, seen=None, layers=None,
               slabs=None):
    """``n_steps`` of the sharded train step on a ``mesh_shape`` mesh, the
    state placed by ``state_shardings``, each batch by ``batch_shardings``,
    the rules active. ``seen`` collects the attention core's products of
    the first step (:func:`products_seen`), ``layers`` the MoE FFN's and the
    mamba block's (:func:`layer_products_seen`), ``slabs`` the blocks of a
    whole-vocab slab it held (:class:`VocabSlabs`)."""
    cfg, pcfg, state = port_state(arch, params_np)
    shape = shape_of(dims)
    mesh = launch_mesh.make_mesh(mesh_shape, AXES, device="cpu")
    rules = launch_mesh.make_rules(mesh, cfg, shape, pcfg)
    state = steps.place_state(state, steps.state_shardings(cfg, rules, pcfg))
    bsh = steps.batch_shardings(cfg, shape, rules)
    step = steps.make_train_step(cfg, pcfg, **STEP_KW)
    metrics = []
    with use_rules(rules):
        for i in range(n_steps):
            batch = pipeline.make_batch(cfg, shape, pipeline.PipelineState(17, i),
                                        device="cpu", shardings=bsh)
            with contextlib.ExitStack() as stack:
                if seen is not None and i == 0:
                    stack.enter_context(products_seen(seen))
                if layers is not None and i == 0:
                    stack.enter_context(layer_products_seen(layers, cfg))
                if slabs is not None and i == 0:
                    slabs.append(stack.enter_context(VocabSlabs(cfg.vocab_size)))
                state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _train(out, train_cases, mesh_shape):
    """``train_cases``: ``(arch, params_np, dims)`` -> 3 sharded steps; the
    metrics, the placements, the attention core's products of the first
    step and the MoE FFN's and mamba block's, and on rank 0 the gathered
    state."""
    for arch, params_np, dims in train_cases:
        seen, layers, slabs = [], [], []
        state, metrics = _run_steps(arch, params_np, dims, mesh_shape, 3, seen, layers, slabs)
        full = tree.map(gather, state)
        out["train"][arch] = {
            "metrics": metrics,
            "placements": [str(tuple(p.placements)) for p in tree.leaves(state.params)],
            "products": seen,
            "layers": layers,
            "vocab_slabs": sorted(slabs[0].shapes),
            "state": interop.train_state_to_numpy(full) if dist.get_rank() == 0 else None,
        }


class CommBytes:
    """``CommDebugMode`` that also keeps each collective's name, operand
    bytes and shape, and whether it ran inside the self-attention sublayer
    (``records``), the rank's own tensors beneath DTensor."""

    def __enter__(self):
        from torch.distributed.tensor.debug import CommDebugMode

        records = self.records = []
        inside = [False]

        class Mode(CommDebugMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = super().__torch_dispatch__(func, types, args, kwargs)
                name = getattr(getattr(func, "_schema", None), "name", "")
                if out is not NotImplemented and "c10d" in name:
                    first = next((a for a in args if isinstance(a, torch.Tensor)), None)
                    nbytes = first.numel() * first.element_size() if first is not None else 0
                    records.append((name, nbytes, tuple(getattr(first, "shape", ())),
                                    inside[0]))
                return out

        real = self.real = attention.self_attention

        def tagged(*a, **kw):
            inside[0] = True
            try:
                return real(*a, **kw)
            finally:
                inside[0] = False

        attention.self_attention = tagged
        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        attention.self_attention = self.real
        self.counts = {str(k): v for k, v in self.mode.get_comm_counts().items()}
        return False


def serve_steps(arch, params_np, tokens, s_max, mesh_shape=None):
    """Prefill over ``tokens[:, :-3]`` then three decode steps of its last
    three columns, teacher-forced, on ``s_max`` rows of cache: the last
    logits of each call and the caches after each, gathered (numpy). On a
    ``mesh_shape`` mesh the parameters lie by ``param_shardings`` and the
    caches by ``cache_shardings`` under a decode cell's rules (``kv_seq``
    over ``model``), the steps under ``implicit_replication``; the second
    decode step's collectives are kept (:class:`CommBytes`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_bundle(arch).smoke
    params = interop.lm_params_from_numpy(params_np, cfg, "cpu")
    caches = M.init_cache(cfg, tokens.shape[0], s_max, "cpu")
    ctx, rules, comm = contextlib.nullcontext(), None, None
    if mesh_shape is not None:
        mesh = launch_mesh.make_mesh(mesh_shape, AXES, device="cpu")
        shape = ShapeConfig("serve", "decode", s_max, tokens.shape[0])
        rules = launch_mesh.make_rules(mesh, cfg, shape, get_bundle(arch).parallel_for(
            "decode_32k"))
        params = steps.place_state(params, steps.param_shardings(cfg, rules))
        caches = steps.place_state(caches, steps.cache_shardings(cfg, shape, rules))
        ctx = implicit_replication()
    toks = torch.from_numpy(tokens)
    n = tokens.shape[1] - 3
    logits, cached = [], []

    def keep(out, c):
        logits.append(gather(out).float().numpy())
        cached.append(interop.lm_cache_to_numpy(tree.map(gather, c)))

    with use_rules(rules), ctx:
        out, caches = M.prefill_fn(params, cfg, {"inputs": toks[:, :n]}, caches)
        keep(out, caches)
        for i in range(3):
            step_comm = CommBytes() if (mesh_shape is not None and i == 1) else None
            with step_comm or contextlib.nullcontext():
                out, caches = M.decode_fn(params, cfg, {"token": toks[:, n + i:n + i + 1],
                                                        "pos": n + i}, caches)
            comm = step_comm or comm
            keep(out, caches)
    placements = None
    if mesh_shape is not None:
        k = caches[0]["layer0"]["kv"]["k"]
        placements = [str(p) for p in k.placements]
    return {"logits": logits, "caches": cached, "cache_placements": placements,
            "comm": None if comm is None else {"counts": comm.counts, "records": comm.records}}


def split_losses(cases):
    """``cases``: ``(logits, labels, dtype)``, numpy float32 logits and
    int64 labels -> for each, the NLL of the logits in ``dtype`` laid over a
    (2, 2) mesh with their rows over ``data`` and their vocab over
    ``model`` (the split loss), the gradient's placements, and on rank 0
    the gradient gathered (float32 numpy)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = launch_mesh.make_mesh((2, 2), AXES, device="cpu")
    out = []
    for logits, labels, dtype in cases:
        x = distribute_tensor(torch.from_numpy(logits).to(getattr(torch, dtype)), mesh,
                              (Shard(0), Shard(logits.ndim - 1)), src_data_rank=None)
        x.requires_grad_(True)
        lab = distribute_tensor(torch.from_numpy(labels), mesh, (Shard(0), Replicate()),
                                src_data_rank=None)
        loss = cross_entropy(x, lab)
        (grad,) = torch.autograd.grad(loss, x)
        full = gather(grad).float().numpy()
        out.append({"loss": float(gather(loss.detach())),
                    "placements": [str(p) for p in grad.placements],
                    "grad": full if dist.get_rank() == 0 else None})
    return out


def relayouts(cases):
    """``cases``: ``(shape, src, dst)``, each placement a tensor dim or None
    per mesh dim of the (2, 2) mesh -> for each, whether DTensor's
    redistribution of a seeded tensor laid out by ``src`` gives ``dst``'s
    shard and placements and its gradient ``src``'s, against the shards
    that ``distribute_tensor`` cuts, and the collectives it ran
    (:class:`CommBytes`), both ways."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = launch_mesh.make_mesh((2, 2), AXES, device="cpu")
    place = lambda dims: tuple(Replicate() if d is None else Shard(d) for d in dims)  # noqa: E731
    out = []
    for shape, src, dst in cases:
        gen = torch.Generator().manual_seed(len(out))
        full, dy = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
        x = distribute_tensor(full, mesh, place(src), src_data_rank=None).requires_grad_(True)
        with CommBytes() as comm:
            y = x.redistribute(mesh, place(dst))
            (gx,) = torch.autograd.grad(y, x, distribute_tensor(dy, mesh, place(dst),
                                                                 src_data_rank=None))
        want = distribute_tensor(full, mesh, place(dst), src_data_rank=None)
        out.append({"value": torch.equal(y.to_local(), want.to_local())
                    and tuple(y.placements) == place(dst),
                    "grad": torch.equal(gx.full_tensor(), dy)
                    and tuple(gx.placements) == place(src),
                    "collectives": sorted({r[0] for r in comm.records})})
    return out


def world4(_snn_mesh, ckpt_case, batch_case, train_cases, one_group, out_dir, serve_case,
           loss_cases=(), relayout_cases=()):
    """Everything the 4-rank (2, 2) world runs, in one world:

    * ``ckpt_case``: ``(arch, params_np)`` -> a train state placed by
      ``state_shardings`` and saved to ``out_dir/sharded`` (every rank
      takes part, rank 0 writes); each leaf's local slice;
    * ``batch_case``: ``(arch, dims)`` -> ``make_batch(shardings=)``, local
      slices and gathered;
    * ``train_cases``: as :func:`_train`;
    * ``one_group``: ``(arch, params_np, dims)`` -> one sharded step of a
      MoE whose tokens make one group (split over fewer rows than ranks):
      its metrics, and on rank 0 the gathered state;
    * ``serve_case``: ``(arch, params_np, tokens, s_max)`` -> prefill and
      three decode steps (:func:`serve_steps`);
    * ``loss_cases``: as :func:`split_losses`; ``relayout_cases``: as
      :func:`relayouts`.
    """
    torch.set_num_threads(1)
    out = {"rank": dist.get_rank(), "train": {}, "one_group": {},
           "losses": split_losses(loss_cases), "relayouts": relayouts(relayout_cases)}
    arch, params_np, tokens, s_max = serve_case
    out["serve"] = serve_steps(arch, params_np, tokens, s_max, (2, 2))
    arch, params_np = ckpt_case
    cfg, pcfg, state = port_state(arch, params_np)
    mesh = launch_mesh.make_mesh((2, 2), AXES, device="cpu")
    rules = launch_mesh.make_rules(mesh, cfg, shape_of((16, 4)), pcfg)
    placed = steps.place_state(state, steps.state_shardings(cfg, rules, pcfg))
    ckpt.save(os.path.join(out_dir, "sharded"), 3, placed, extra_meta={"world": 4})
    out["ckpt_slices"] = [slices(x) for x in tree.leaves(placed)]

    arch, dims = batch_case
    cfg = get_bundle(arch).smoke
    shape = shape_of(dims)
    rules = launch_mesh.make_rules(mesh, cfg, shape,
                                   get_bundle(arch).parallel_for("train_4k"))
    batch = pipeline.make_batch(cfg, shape, pipeline.PipelineState(17, 5), device="cpu",
                                shardings=steps.batch_shardings(cfg, shape, rules))
    out["batch"] = {k: {"slice": slices(v), "full": gather(v).numpy()} for k, v in batch.items()}

    _train(out, train_cases, (2, 2))
    for arch, params_np, dims in one_group:
        state, metrics = _run_steps(arch, params_np, dims, (2, 2), 1)
        full = tree.map(gather, state)
        out["one_group"][arch] = {
            "metrics": metrics,
            "state": interop.train_state_to_numpy(full) if dist.get_rank() == 0 else None,
        }
    return out


def world2(_snn_mesh, train_cases, arch, params_np, ckpt_dir, timeout=240.0):
    """The 2-rank (1, 2) world, run beside the 4-rank one: ``train_cases``
    as :func:`_train`, then the 4-rank checkpoint restored onto the mesh
    once it is written: each leaf's local slice, and the gathered state."""
    torch.set_num_threads(1)
    out = {"rank": dist.get_rank(), "train": {}}
    _train(out, train_cases, (1, 2))
    deadline = time.monotonic() + timeout
    while ckpt.latest_step(ckpt_dir) is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint under {ckpt_dir} after {timeout:.0f} s")
        time.sleep(0.1)
    cfg, pcfg, like = port_state(arch, params_np)
    mesh = launch_mesh.make_mesh((1, 2), AXES, device="cpu")
    rules = launch_mesh.make_rules(mesh, cfg, shape_of((16, 4)), pcfg)
    restored, meta = ckpt.restore(ckpt_dir, like,
                                  shardings=steps.state_shardings(cfg, rules, pcfg))
    out.update(slices=[slices(x) for x in tree.leaves(restored)],
               state=interop.train_state_to_numpy(tree.map(gather, restored)), meta=meta)
    return out


def one_device_steps(arch, params_np, dims, n_steps=3):
    """The same steps on one device, no mesh, no rules (in the test's own
    process)."""
    cfg, pcfg, state = port_state(arch, params_np)
    shape = shape_of(dims)
    step = steps.make_train_step(cfg, pcfg, **STEP_KW)
    metrics = []
    for i in range(n_steps):
        batch = pipeline.make_batch(cfg, shape, pipeline.PipelineState(17, i), device="cpu")
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def numpy_tree(t):
    return tree.map(lambda a: np.asarray(a), t)
