"""End-to-end training driver: data -> train step -> checkpoint/restart.

Counterpart of ``repro.launch.train``, with its flags, defaults and output:
the counter-based resumable pipeline (seed 17), the train step
(``parallel_for("train_4k")`` with one microbatch, ``warmup_steps =
min(20, steps // 5 + 1)``), async checkpoints every ``--ckpt-every``
steps, the straggler monitor and the bounded-retry restart loop
(:mod:`repro_torch.runtime.fault_tolerance`). A run with ``--ckpt-dir``
resumes from the newest checkpoint there, the pipeline state included.
It trains on the card unless ``--device cpu``; the parameters are the
port's own draws (seed 0), not the reference's.

``--mesh single|multi`` trains on the production mesh, (16, 16) ``("data",
"model")`` or (2, 16, 16) with ``"pod"`` (:mod:`repro_torch.launch.mesh`),
over the world the process joined (``torchrun`` sets it up; 256 or 512
ranks): the train state is laid over the mesh by the cell's rules
(``make_rules``, ``steps.state_shardings``), each batch by
``batch_shardings``, and the loop runs under ``use_rules``. In a world of
another size it exits naming the ranks the mesh needs and the world it
found.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --smoke \\
      --steps 100 --ckpt-dir /tmp/ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import device as _device
from repro_torch.configs import get_bundle
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.parallel.sharding import use_rules
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.straggler import StragglerMonitor

log = logging.getLogger("repro_torch.train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none",
                    help="'none' = one device, unsharded")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' trains on the host)")
    args = ap.parse_args(argv)

    bundle = get_bundle(args.arch)
    cfg = bundle.smoke if args.smoke else bundle.model
    dev = _device.resolve(args.device)
    shape = ShapeConfig("cli", "train", args.seq_len, args.global_batch)
    pcfg = bundle.parallel_for("train_4k").replace(microbatches=1)

    rules = state_sh = batch_sh = None
    if args.mesh != "none":
        multi = args.mesh == "multi"
        mesh_mod.init_world(dev)
        try:
            mesh = mesh_mod.make_production_mesh(multi_pod=multi, device=dev)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}") from None
        rules = mesh_mod.make_rules(mesh, cfg, shape, pcfg, multi_pod=multi)
        state_sh = steps_mod.state_shardings(cfg, rules, pcfg)
        batch_sh = steps_mod.batch_shardings(cfg, shape, rules)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = steps_mod.place_state(steps_mod.init_train_state(cfg, pcfg, gen, dev), state_sh)
    train_step = steps_mod.make_train_step(
        cfg, pcfg, peak_lr=args.peak_lr, warmup_steps=min(20, args.steps // 5 + 1),
        total_steps=args.steps)

    pipe = pipeline.PipelineState(seed=17, step=0)
    monitor = StragglerMonitor()
    checkpointer = (ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None)
    start_step = 0

    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, meta = ckpt.restore(args.ckpt_dir, state, shardings=state_sh)
        start_step = meta["step"]
        pipe = pipeline.PipelineState.from_dict(meta["extra"]["pipeline"])
        log.warning("resumed from step %d", start_step)

    losses = []

    def one_step(step: int, carry):
        state, pipe = carry
        t0 = time.time()
        batch = pipeline.make_batch(cfg, shape, pipe, device=dev, shardings=batch_sh)
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        monitor.observe("host0", time.time() - t0)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({time.time()-t0:.2f}s)", flush=True)
        return state, pipeline.advance(pipe)

    def save_fn(step, carry):
        if checkpointer is not None:
            state, pipe = carry
            checkpointer.save_async(step, state,
                                    extra_meta={"pipeline": pipe.as_dict()})

    def restore_fn():
        if checkpointer is not None:
            checkpointer.wait()     # the write in flight is the newest checkpoint
        restored, meta = ckpt.restore(args.ckpt_dir, state, shardings=state_sh)
        p = pipeline.PipelineState.from_dict(meta["extra"]["pipeline"])
        return meta["step"], (restored, p)

    with use_rules(rules):
        final_step, (state, pipe) = ft.run_resilient_loop(
            n_steps=args.steps, start_step=start_step,
            step_fn=one_step, state=(state, pipe),
            save_fn=save_fn, restore_fn=restore_fn,
            checkpoint_every=args.ckpt_every)
    if checkpointer is not None:
        checkpointer.wait()

    print(f"done: {final_step} steps; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"stragglers: {monitor.stragglers()}")
    return losses


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
