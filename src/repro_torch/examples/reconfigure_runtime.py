"""Runtime reconfiguration without re-synthesis (the paper's core claim).

Counterpart of ``examples/reconfigure_runtime.py``. One 74-neuron fabric is
set up ONCE; the Iris task and the MNIST task then run on it purely by
rewriting the register bank (connection list, weights, thresholds) -- the
Iris net occupies neurons 0..6 of the fabric, MNIST all 74. Connectivity is
data.

Nothing is traced here, so "one compiled program" is counted as the serving
path counts it: the programs put into use, by their key (backend and
shapes), must be one. On the card the tick runs kernel B2 (the
``pallas_fused`` backend; the reference's engine is ``jnp``), and after the
first program no launch may be planned anew: B1/B2's launch-plan cache takes
no miss. (The kernel library is built once per process, at the first
launch, so there is no rebuild to count.)

  PYTHONPATH=src python -m repro_torch.examples.reconfigure_runtime [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import connectivity
from repro_torch.core.engine import EngineOptions, TickEngine
from repro_torch.core.lif import LIFParams
from repro_torch.core.network import SNNParams, SNNState, params_from_registers
from repro_torch.core.registers import RegisterBank, WeightLayout
from repro_torch.kernels import _plan

BACKEND = "pallas_fused"   # one resident tick datapath; networks are register data

N = 74  # one physical fabric, sized for the larger task
TASKS = ("iris", "mnist", "iris-again")


def make_bank() -> RegisterBank:
    return RegisterBank(N, weight_layout=WeightLayout.PER_SYNAPSE)


def program_iris(bank: RegisterBank) -> None:
    """Iris 4->3 net embedded in neurons 0..6 of the 74-neuron fabric."""
    c = np.zeros((N, N), np.bool_)
    c[:7, :7] = connectivity.layered([4, 3])
    bank.set_connection_list(c)
    w = np.zeros((N, N), np.uint8)
    w[:4, 4:7] = np.random.default_rng(0).integers(1, 200, (4, 3))
    bank.set_weights(w)
    th = np.zeros(N, np.uint8)
    th[4:7] = 100
    bank.set_thresholds(th)


def program_mnist(bank: RegisterBank) -> None:
    """MNIST 64->10 net across the full fabric."""
    c = np.zeros((N, N), np.bool_)
    c[:74, :74] = connectivity.layered([64, 10])
    bank.set_connection_list(c)
    w = np.zeros((N, N), np.uint8)
    w[:64, 64:74] = np.random.default_rng(1).integers(1, 60, (64, 10))
    bank.set_weights(w)
    th = np.zeros(N, np.uint8)
    th[64:74] = 200
    bank.set_thresholds(th)


def plan_misses() -> int:
    """Misses of B1/B2's launch-plan cache so far."""
    return _plan.plan.cache_info().misses


def reconfigure(engine: TickEngine, device) -> dict:
    """Run Iris, MNIST and Iris again on one fabric by register rewrites.

    Each program is a frozen rollout of 4 ticks over a batch of 8 with the
    first tick's inputs clamped on. Returns the per-task ``seconds``,
    ``spikes`` and ``rasters`` (host copies), the ``programs`` put into use
    (in all, and after each task) and the ``new_plans`` after the first
    program."""
    dev = _device.resolve(device)
    bank = make_bank()
    programs = set()

    def tick_program(w, c, v_th, ext):
        key = (engine.options.backend, tuple(w.shape), tuple(c.shape), tuple(v_th.shape),
               tuple(ext.shape), w.dtype)
        programs.add(key)
        lif = dataclasses.replace(LIFParams.make(N, v_th=1.0, device=dev), v_th=v_th)
        p = SNNParams(w=w, c=c, w_in=torch.eye(N, device=dev), lif=lif)
        state = SNNState.zeros((ext.shape[1],), N, device=dev)
        _, raster = engine.rollout(p, state, ext, ext.shape[0])
        return raster

    def run():
        p = params_from_registers(bank, device=dev)
        ext = torch.zeros((4, 8, N), device=dev)
        ext[0, :, :4] = 1.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        raster = tick_program(p.w, p.c, p.lif.v_th, ext).cpu()
        return time.perf_counter() - t0, raster.numpy()

    out = {"seconds": [], "spikes": [], "rasters": [], "programs_so_far": []}
    misses = []
    for task, program in zip(TASKS, (program_iris, program_mnist, program_iris)):
        program(bank)     # a pure register rewrite: same shapes
        seconds, raster = run()
        misses.append(plan_misses())
        out["seconds"].append(seconds)
        out["spikes"].append(float(raster.sum()))
        out["rasters"].append(raster)
        out["programs_so_far"].append(len(programs))
    out["programs"] = len(programs)
    out["new_plans"] = misses[-1] - misses[0]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    out = reconfigure(TickEngine(EngineOptions(backend=BACKEND)), dev)
    notes = (" (includes the first launch)", " (no new plan)", "")
    for task, seconds, spikes, so_far, note in zip(TASKS, out["seconds"], out["spikes"],
                                                   out["programs_so_far"], notes):
        print(f"{task:10s}: {seconds * 1e3:7.1f} ms{note}, {spikes:.0f} spikes, "
              f"programs so far: {so_far}")
    if out["programs"] != 1 or out["new_plans"]:
        raise AssertionError(f"reconfiguration put {out['programs']} programs into use and "
                             f"planned {out['new_plans']} new launches")
    print(f"\nOK: three reconfigurations on {BACKEND} ({dev}), ONE program, "
          f"{out['new_plans']} new launch plans after the first (the paper's "
          "no-re-synthesis property)")
    return out


if __name__ == "__main__":
    main()
