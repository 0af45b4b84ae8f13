"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake world.

Counterpart of ``repro.launch.dryrun``. The reference AOT-compiles each cell
on 256 or 512 placeholder CPU devices. The port makes a fake world of 256 or
512 ranks in one process (``torch.distributed``'s ``"fake"`` backend with a
``FakeStore``: no rank exists, every collective returns at once), builds the
production mesh and the cell's sharding rules on it, lays every argument out
as a DTensor whose local shard is a fake tensor (shapes and dtypes, no
data) and runs the cell's unchanged step on rank 0's shards. For each cell
this proves, without hardware:

  * the sharding is coherent: DTensor lays every op of the step out (the
    port has no GSPMD: an op it refuses fails the cell);
  * the memory plan: the local shards' bytes and the traced peak;
  * the roofline terms, from :mod:`repro_torch.launch.hlo_cost`'s record
    of rank 0's local ops.

Artifacts: one JSON per cell under ``--out`` (default ``artifacts/dryrun``),
with the reference's keys. On the port they mean:

  n_chips, n_params,   the reference's: ranks of the fake world, parameters,
  n_active_params      parameters a token touches (MoE at top_k / E)
  memory_analysis      argument_size_in_bytes / output_size_in_bytes: the
                       bytes of rank 0's local shards of the step's
                       arguments / outputs, exact; temp_size_in_bytes: as
                       XLA's, the traced peak of the storages the step
                       allocated that are neither arguments nor outputs
                       (a train step's new parameters and moments are
                       outputs); alias_size_in_bytes: the bytes of outputs
                       that are arguments (the caches, written in place);
                       generated_code_size_in_bytes: 0 (eager PyTorch
                       generates no code); and the port's own
                       traced_peak_in_bytes: the traced peak of every
                       storage the step allocated, outputs included (what
                       the card's ``max_memory_allocated`` sees above the
                       arguments)
  timings              mesh_s (fake world, mesh and rules), trace_s (the
                       recorded step), analysis_s (the summing)
  cost_analysis_raw    flops: ``torch.utils.flop_counter.FlopCounterMode``'s
                       count of the same run, which sees the DTensor-level
                       ops at their global shapes (the whole step, not a
                       device's); bytes_accessed: null (it counts no bytes)
  hlo_cost             flops_per_device, dot_bytes_per_device,
                       collective_bytes_per_device (by kind) and
                       total_collective_bytes_per_device: rank 0's local
                       counts, loops multiplied by their trip counts
  device               the device type of the fake tensors and the mesh
  layout               the port's own: ``departures``, each local product
                       against its even share (1 / n_chips) of the same
                       product at its global shapes (how many exceed it, by
                       how many FLOPs, the first that does, with its
                       stack, and every ``sites`` where one does: op and
                       innermost ``models/`` frame, count, largest times
                       its share, FLOPs above the shares), the three
                       ``largest_products`` by FLOPs, and ``temp_at_peak``:
                       the largest storages alive at the temp's peak, each
                       with its bytes, shape, dtype, op and innermost
                       ``models/``, ``optim/`` or ``launch/`` frame

Every cell runs in a process of its own (``--all`` starts one child per
cell, as the reference's does), and :func:`run_cell` tears its fake world
down before it returns.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k --device cpu
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --arch snn-64k --device cpu
  python -m repro_torch.launch.dryrun --all --device cpu   # every cell, both meshes

Without ``--device`` the fake tensors and the mesh are the card's (a card
must be visible, as for every entry point of the port; nothing is
allocated on it).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import torch

from repro_torch import device as _device

DEFAULT_OUT = "artifacts/dryrun"


def cell_name(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'multipod' if multi_pod else 'singlepod'}"


@contextlib.contextmanager
def fake_world(size: int):
    """A world of ``size`` ranks in this process, as rank 0: the ``"fake"``
    process group, torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up in this process; the dry run "
                           "makes its own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_tree(structs, mode, dev: torch.device):
    """DTensors (or plain tensors, for a struct without a sharding) whose
    local shards are fake tensors of ``mode`` on ``dev``, one per
    ``ShapeDtypeStruct`` of ``structs``. The local shapes are computed outside
    the fake mode (DTensor's helper reads a tensor there)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.util import tree

    def make(st):
        if st.sharding is None:
            with mode:
                return torch.empty(st.shape, dtype=st.dtype, device=dev)
        placements = st.sharding.placements
        local, _ = compute_local_shape_and_global_offset(st.shape, st.sharding.mesh,
                                                         placements)
        with mode:
            t = torch.empty(tuple(local), dtype=st.dtype, device=dev)
        stride = torch.empty(st.shape, device="meta").stride()
        return DTensor.from_local(t, st.sharding.mesh, placements, run_check=False,
                                  shape=torch.Size(st.shape), stride=stride)

    return tree.map(make, structs)


def trace(fn: Callable, structs, device=None, *, edit: Optional[Callable] = None):
    """``fn(*args)`` recorded (:func:`repro_torch.launch.hlo_cost.record`)
    on fake arguments made from ``structs``, a tuple of trees of
    ``ShapeDtypeStruct``s: each a DTensor over its sharding's mesh whose
    local shard is a fake tensor on ``device`` (None: the card), or a plain
    fake tensor without a sharding. ``edit(args)`` may change the arguments
    first. Returns ``(output, recording, args)``."""
    from repro_torch.launch import hlo_cost

    dev = _device.resolve(device)
    mode = hlo_cost.FakeRecorder()
    args = tuple(_fake_tree(st, mode, dev) for st in structs)
    if edit is not None:
        edit(args)
    out, rec = hlo_cost.record(fn, *args, fake_mode=mode)
    return out, rec, args


def _tree_bytes(values) -> int:
    from repro_torch.launch.hlo_cost import tensors

    return sum(t.numel() * t.element_size() for t in tensors(values))


def _struct_bytes(structs) -> int:
    """Rank 0's local bytes of a struct tree (what the arguments hold)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.util import tree

    total = 0
    for st in tree.leaves(structs):
        shape = st.shape
        if st.sharding is not None:
            shape, _ = compute_local_shape_and_global_offset(
                st.shape, st.sharding.mesh, st.sharding.placements)
        total += math.prod(shape) * torch.empty((), dtype=st.dtype).element_size()
    return total


def _alias_bytes(outputs, inputs) -> int:
    from repro_torch.launch.hlo_cost import tensors

    keys = {t.untyped_storage()._cdata for t in tensors(inputs)}
    return sum(t.numel() * t.element_size() for t in tensors(outputs)
               if t.untyped_storage()._cdata in keys)


def _summary(rec) -> Dict:
    from repro_torch.launch import hlo_cost

    s = hlo_cost.analyze(rec)
    return {
        "flops_per_device": s.flops,
        "dot_bytes_per_device": s.dot_bytes,
        "collective_bytes_per_device": dict(s.collective_bytes),
        "total_collective_bytes_per_device": s.total_collective_bytes,
    }


def _write(result: Dict, out_dir: str, name: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return path


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             save_hlo: bool = False,
             rule_overrides_json: Optional[str] = None,
             tag: str = "", device=None) -> Dict:
    """Trace one LM cell on rank 0 of a fake world of 256 (512 with
    ``multi_pod``) ranks and write its artifact; returns it."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_bundle
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import hlo_cost, steps
    from repro_torch.launch.mesh import make_production_mesh, make_rules
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import use_rules

    dev = _device.resolve(device)
    bundle = get_bundle(arch)
    cfg = bundle.model
    shape = SHAPES[shape_name]
    pcfg = bundle.parallel_for(shape_name)
    if rule_overrides_json:
        pcfg = pcfg.replace(rule_overrides={**dict(pcfg.rule_overrides),
                                            **json.loads(rule_overrides_json)})

    t0 = time.time()
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        rules = make_rules(mesh, cfg, shape, pcfg, multi_pod=multi_pod)
        result: Dict = {
            "arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "kind": shape.kind,
            "n_chips": int(math.prod(mesh.mesh.shape)),
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            "n_params": M.n_params(cfg),
            "n_active_params": n_active_params(cfg),
            "parallel": {
                "fsdp": pcfg.fsdp, "microbatches": pcfg.microbatches,
                "remat": pcfg.remat, "optimizer": pcfg.optimizer,
                "opt_state_dtype": pcfg.opt_state_dtype,
                "seq_shard_activations": pcfg.seq_shard_activations,
                "rule_overrides": dict(pcfg.rule_overrides),
            },
            "tag": tag,
            "device": dev.type,
        }
        if shape.kind == "train":
            step_fn = steps.make_train_step(cfg, pcfg)
            structs = (steps.state_structs(cfg, pcfg, rules),
                       steps.batch_structs(cfg, shape, rules))
        else:  # prefill / decode share the (params, batch, caches) signature
            step_fn = (steps.make_prefill_step(cfg) if shape.kind == "prefill"
                       else steps.make_decode_step(cfg))
            structs = (steps.params_structs(cfg, rules),
                       steps.batch_structs(cfg, shape, rules),
                       steps.cache_structs(cfg, shape, rules))

        def edit(args):
            if shape.kind == "decode":
                # The step reads its position as a Python int (the reference's
                # is a traced scalar): the last one, every cache row valid.
                args[1]["pos"] = shape.seq_len - 1

        arg_bytes = _struct_bytes(structs)
        t_trace0 = time.time()
        with use_rules(rules), FlopCounterMode(display=False) as counter, \
                hlo_cost.GlobalDots() as global_dots:
            if shape.kind == "train":
                out, rec, args = trace(step_fn, structs, dev, edit=edit)
            else:
                with implicit_replication():
                    out, rec, args = trace(step_fn, structs, dev, edit=edit)
        t_trace = time.time() - t_trace0
        t_a0 = time.time()
        mem = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": _tree_bytes(out),
            "temp_size_in_bytes": rec.temp_bytes,
            "alias_size_in_bytes": _alias_bytes(out, args),
            "generated_code_size_in_bytes": 0,
            "traced_peak_in_bytes": rec.peak_bytes,
        }
        print("memory_analysis:", mem)
        ca = hlo_cost.cost_dict(counter)
        summary = _summary(rec)
        layout = hlo_cost.departures(rec, global_dots.products, result["n_chips"])
        top = [{"flops": v, "op": r.op, "local_shapes": r.shapes, "stack": list(r.stack)}
               for v, r in hlo_cost.largest(rec, n=3)]
        print("cost_analysis: flops=%s (global)" % ca.get("flops"))
        name = cell_name(arch, shape_name, multi_pod)
        if save_hlo:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, name + (f".{tag}" if tag else "") + ".hlo"),
                      "w") as f:
                f.write(rec.text())
        t_analysis = time.time() - t_a0

    result.update({
        "timings": {"mesh_s": t_trace0 - t0, "trace_s": t_trace, "analysis_s": t_analysis},
        "memory_analysis": mem,
        "cost_analysis_raw": {"flops": float(ca.get("flops", 0.0)), "bytes_accessed": None},
        "hlo_cost": summary,
        "layout": {"departures": layout, "largest_products": top,
                   "temp_at_peak": [a._asdict() for a in rec.at_peak]},
        "status": "ok",
    })
    path = _write(result, out_dir, name + (f".{tag}" if tag else ""))
    print(f"[dryrun] OK {name} trace={t_trace:.1f}s -> {path}")
    return result


def run_snn_cell(arch: str, multi_pod: bool, out_dir: str,
                 batch: int = 256, n_ticks: int = 8, device=None) -> Dict:
    """Dry-run the paper's technique at production scale: one synchronous
    tick rollout of the all-to-all SNN core on rank 0 of a fake world of 256
    (512) ranks, on the config's backend.

    The port's fabric shards by destination (since its sharded fabric, a
    deliberate difference): rank r holds columns ``[r*n/D, (r+1)*n/D)`` of
    ``W`` and ``w_in`` (``c=None``, the implicit all-to-all) and of the LIF
    state, and each tick all-gathers the arriving spikes
    (``parallel/snn_sharding.sharded_scan``). The reference lays ``W`` 2-D
    over (model, data).
    """
    import dataclasses

    from repro_torch.configs import get_bundle
    from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
    from repro_torch.core.lif import LIFParams, LIFState
    from repro_torch.core.network_types import SNNParams, SNNState
    from repro_torch.launch import hlo_cost
    from repro_torch.parallel.mesh import make_snn_mesh
    from repro_torch.parallel.snn_sharding import sharded_scan

    dev = _device.resolve(device)
    cfg = get_bundle(arch).model
    n = cfg.n_neurons
    size = 512 if multi_pod else 256
    t0 = time.time()
    with fake_world(size):
        mesh = dataclasses.replace(make_snn_mesh(size, device=dev), device=dev)
        nl = n // size
        mode = hlo_cost.FakeRecorder()
        f32 = torch.float32
        with mode:
            e = lambda *s, dtype=f32: torch.empty(s, dtype=dtype, device=dev)  # noqa: E731
            params = SNNParams(
                w=e(n, nl), c=None, w_in=e(n, nl),
                lif=LIFParams(v_th=e(nl), leak=e(nl), r_ref=e(nl, dtype=torch.int32),
                              gain=e(nl), i_bias=e(nl), v_reset=e(nl)))
            state = SNNState(lif=LIFState(v=e(batch, nl), r=e(batch, nl, dtype=torch.int32),
                                          y=e(batch, nl)),
                             delay_buf=e(batch, 1, nl), tick=e(dtype=torch.int32))
            ext = e(n_ticks, batch, n)
        engine = TickEngine(EngineOptions(mode=cfg.snn_mode, backend=cfg.snn_backend,
                                          mesh=mesh))
        carry = TickCarry(state=state)
        args = (params, carry, ext)
        arg_bytes = _tree_bytes(args)
        t1 = time.time()
        (final, raster), rec = hlo_cost.record(
            lambda p, c, x: sharded_scan(engine, p, c, x, n_ticks), *args, fake_mode=mode)
        t_trace = time.time() - t1
        summary = _summary(rec)
        mem = {"argument_size_in_bytes": arg_bytes, "temp_size_in_bytes": rec.temp_bytes,
               "traced_peak_in_bytes": rec.peak_bytes}
    shape = f"tick_rollout_b{batch}_t{n_ticks}"
    result = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16", "kind": "snn_tick",
        "n_chips": size,
        "seq_len": n_ticks, "global_batch": batch,
        "n_params": n * n, "n_active_params": n * n,
        "parallel": {}, "tag": "",
        "device": dev.type,
        "timings": {"mesh_s": t1 - t0, "trace_s": t_trace},
        "memory_analysis": mem,
        "cost_analysis_raw": {},
        "hlo_cost": summary,
        "status": "ok",
    }
    path = _write(result, out_dir, cell_name(arch, shape, multi_pod))
    print(f"[dryrun] OK snn cell {arch} ({result['mesh']}) "
          f"mem={mem} flops/dev={summary['flops_per_device'] / 1e12:.2f}TF -> {path}")
    return result


def n_active_params(cfg) -> int:
    """Parameters touched per token: MoE experts count at top_k/E (+shared)."""
    from repro_torch.models import model as M
    from repro_torch.models.common import map_specs

    total = [0.0]

    def add(leaf):
        n = math.prod(leaf.shape)
        if "experts" in leaf.axes and cfg.n_experts:
            n = n * cfg.top_k / cfg.n_experts
        total[0] += n

    map_specs(add, M.specs(cfg))
    return int(total[0])


def all_cells():
    from repro_torch.configs import ASSIGNED_ARCHS, get_bundle
    from repro_torch.configs.base import applicable_shapes

    cells = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_bundle(arch).model
        for shape_name in applicable_shapes(cfg):
            for multi_pod in (False, True):
                cells.append((arch, shape_name, multi_pod))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write the recorded ops as text (<cell>.hlo)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--rule-overrides", default=None,
                    help="JSON dict of logical-axis overrides (hillclimb)")
    ap.add_argument("--tag", default="", help="artifact suffix (hillclimb iters)")
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors and the mesh (default: the card)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    if args.all:
        failures = []
        for arch, shape_name, multi_pod in all_cells():
            name = cell_name(arch, shape_name, multi_pod)
            path = os.path.join(args.out, name + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[dryrun] skip existing {name}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--out", args.out,
                   "--device", dev.type]
            if multi_pod:
                cmd.append("--multi-pod")
            if args.save_hlo:
                cmd.append("--save-hlo")
            print(f"[dryrun] === {name} ===", flush=True)
            rc = subprocess.run(cmd).returncode
            if rc != 0:
                failures.append(name)
                print(f"[dryrun] FAIL {name} (rc={rc})", flush=True)
        if failures:
            print("[dryrun] FAILURES:", failures)
            sys.exit(1)
        print("[dryrun] all cells passed")
        return

    try:
        if args.arch and args.arch.endswith("snn") or args.arch == "snn-64k":
            run_snn_cell(args.arch, args.multi_pod, args.out, device=dev)
        else:
            run_cell(args.arch, args.shape, args.multi_pod, args.out,
                     save_hlo=args.save_hlo,
                     rule_overrides_json=args.rule_overrides, tag=args.tag, device=dev)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
