#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``src/repro_torch/csrc``
with ``nvcc`` for ``sm_90a``, then runs four phases, each of which fails the
script on any mismatch:

1. kernels: kernel B2 (``tick_fused``) in every variant (premasked ``W*C`` or
   ``w`` + ``c``, the previous ``y`` as a depth-1 ring, a uniform ring of
   depth 4 written in place, per-synapse delays over a ring of depth 4
   written through, drive or none, fixed leak or Euler) and kernel B1
   (``lif_step``), each against its plain PyTorch twin on the card, at
   4096 neurons with 8 slots of one row and with one network of 8 rows.
   Inputs sit on the u8 weight grid, so equality is exact (tolerance 0).
   Then each kernel's median time over 30 runs (CUDA events), its bound,
   its twin's time and one ``torch.matmul`` of the product part.
2. rollout: ``network.rollout`` at the ``snn-fused`` width (4096 neurons,
   32 ticks, batch 8) on ``pallas`` and ``pallas_fused`` against ``jnp``,
   for ``max_delay`` 1 and 4 and per-synapse delays; rasters and final
   state must be bitwise equal. Kernel B1's launches are counted here (the
   ``pallas`` backend's path).
3. serve: ``SNNServer`` at the ``snn-fused`` FULL config (n_max 4096, 8
   slots, 32 ticks, ``pallas_fused``), 8 frozen RegisterBank tenants and
   16 requests in 2 waves; each request's counts and prediction must equal
   the same server's on ``jnp``, and kernel B2 must launch exactly
   waves x 32 times.
4. a JSON line of the kernels, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA device is visible or
the package is missing. Nothing here imports JAX or the ``repro`` package.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N = 4096          # snn-fused FULL width
SLOTS = 8         # serving slots
ROWS = 8          # batch rows when one network is shared
TICKS = 32        # snn-fused FULL ticks per wave
RING = 4          # delay-ring depth for the ring variants
RUNS = 30         # timed runs per measurement, after warm-up

# Per-card peaks: memory bytes/s and f32 (non-tensor-core) FLOP/s.
CARDS = {"H200": (4.8e12, 67e12), "PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12)}
H100_SXM = (3.35e12, 67e12)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in CARDS.items():
        if key in name:
            return val
    return H100_SXM


def median_ms(fn, runs: int = RUNS) -> float:
    """Median device time of ``fn`` over ``runs`` launches (CUDA events),
    after two warm-up calls. Every call streams its operands from device
    memory: the weights exceed the 50 MB L2 cache."""
    import torch

    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def max_abs_err(got, want) -> float:
    """Largest |difference| over matching tensors (0.0 when bitwise equal)."""
    err = 0.0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        err = max(err, (g.double() - w.double()).abs().max().item())
    return err


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain twins
# ---------------------------------------------------------------------------

def kernel_inputs(gen, dev, S, B, slotted_w, *, ring=1, delays=False, euler=False):
    """u8-grid inputs for one kernel call: integer weights, 0/1 spikes,
    integer state and drive, so every sum is exact in f32."""
    import torch

    i32, f32 = torch.int32, torch.float32
    wshape = (S, N, N) if slotted_w else (N, N)
    rnd = lambda lo, hi, shape, dt=f32: torch.randint(
        lo, hi, shape, generator=gen, device=dev, dtype=i32).to(dt)
    c = rnd(0, 2, wshape)
    w = rnd(0, 256, wshape)
    rows = {
        "v_th": rnd(1, 40000, (S, N) if slotted_w else (N,)),
        "leak": (rnd(0, 16, (S, N) if slotted_w else (N,)) / 16.0 if euler
                 else rnd(0, 9, (S, N) if slotted_w else (N,))),
        "r_ref": rnd(0, 4, (S, N) if slotted_w else (N,), i32),
        "gain": torch.ones((S, N) if slotted_w else (N,), device=dev),
        "i_bias": rnd(0, 4, (S, N) if slotted_w else (N,)),
        "v_reset": torch.zeros((S, N) if slotted_w else (N,), device=dev),
    }
    return {
        "w": w, "c": c, "wc": w * c,
        "ring": (torch.rand((S, B, ring, N), generator=gen, device=dev) < 0.1).to(f32),
        "y": (torch.rand((S, B, N), generator=gen, device=dev) < 0.1).to(f32),
        "v": rnd(-20, 30000, (S, B, N)),
        "r": rnd(0, 3, (S, B, N), i32),
        "drive": rnd(0, 256, (S, B, N)),
        "delays": rnd(1, ring + 1, wshape, i32) if delays else None,
        "rows": rows,
    }


def tick_case(inp, *, premasked, ring, delays, drive, in_place):
    """Arguments of one fused_tick call (shared by kernel and twin)."""
    import torch

    D = inp["ring"].shape[-2]
    tick = torch.tensor(6, dtype=torch.int32, device=inp["v"].device)
    slots = torch.stack([tick % D, (tick + 1) % D]).to(torch.int32)
    w = inp["wc"] if premasked else inp["w"]
    read = inp["ring"] if ring else inp["y"].unsqueeze(-2)
    dly_full = inp["ring"] if ring and D > 1 else None
    args = (slots, read, w, None if premasked else inp["c"],
            inp["delays"] if delays else None, inp["v"], inp["r"],
            inp["drive"] if drive else None, dly_full, *inp["rows"].values())
    return args, {"dly_out": dly_full if in_place else None}


def run_kernel_phase(dev, gen):
    import torch

    from repro_torch.kernels import lif_step, ref, tick_fused

    errs = {"tick_fused": 0.0, "lif_step": 0.0}
    cases = 0
    for S, B, slotted in ((SLOTS, 1, True), (1, ROWS, False)):
        for euler in (False, True):
            mode = "euler" if euler else "fixed_leak"
            for variant in ("plain", "ring", "delays"):
                D = 1 if variant == "plain" else RING
                inp = kernel_inputs(gen, dev, S, B, slotted, ring=D,
                                    delays=variant == "delays", euler=euler)
                combos = [(True, True), (False, True), (True, False)]
                for premasked, drive in combos:
                    args, kw = tick_case(
                        inp, premasked=premasked, ring=variant != "plain",
                        delays=variant == "delays", drive=drive,
                        in_place=variant == "ring")
                    want = ref.fused_tick_ref(*args, mode=mode)
                    if kw["dly_out"] is not None:
                        # In place: the kernel writes the ring it reads; give it a copy.
                        ring_copy = kw["dly_out"].clone()
                        args = tuple(ring_copy if a is kw["dly_out"] else a for a in args)
                        kw = {"dly_out": ring_copy}
                    got = tick_fused.fused_tick(*args, mode=mode, **kw)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    errs["tick_fused"] = max(errs["tick_fused"], err)
                    if err != 0.0 or not all(
                            torch.equal(g, w) for g, w in zip(got, want) if w is not None):
                        raise AssertionError(
                            f"tick_fused S={S} B={B} {mode} {variant} premasked={premasked} "
                            f"drive={drive}: max |err| {err}")
                    cases += 1
                if variant == "plain":
                    for drive in (True, False):
                        s = inp["y"]
                        a = (s, inp["w"], inp["c"], inp["v"], inp["r"],
                             inp["drive"] if drive else None, *inp["rows"].values())
                        want = ref.fused_lif_step_ref(*a, mode=mode)
                        got = lif_step.fused_lif_step(*a, mode=mode)
                        torch.cuda.synchronize()
                        err = max_abs_err(got, want)
                        errs["lif_step"] = max(errs["lif_step"], err)
                        if err != 0.0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
                            raise AssertionError(
                                f"lif_step S={S} B={B} {mode} drive={drive}: max |err| {err}")
                        cases += 1
                del inp
    log(f"kernels: {cases} cases equal to their plain twins bitwise (tolerance 0)")
    return errs


def time_kernels(dev, gen, card):
    """Each kernel at the serving path's shapes: 8 slots of one row, 4096
    neurons, per-slot weights, drive on, depth-1 ring (B2 premasked)."""
    import torch

    from repro_torch.kernels import lif_step, ref, tick_fused

    bw, flops = card
    inp = kernel_inputs(gen, dev, SLOTS, 1, True)
    rows = tuple(inp["rows"].values())
    out = {}

    args, _ = tick_case(inp, premasked=True, ring=False, delays=False, drive=True,
                        in_place=False)
    s = inp["y"]
    wc = inp["wc"]
    t_ms = median_ms(lambda: tick_fused.fused_tick(*args))
    p_ms = median_ms(lambda: ref.fused_tick_ref(*args))
    l_ms = median_ms(lambda: torch.matmul(s, wc))
    moved = nbytes(args[0], s, wc, inp["v"], inp["r"], inp["drive"], *rows) + 3 * nbytes(s)
    ops = 2 * SLOTS * N * N
    out["tick_fused"] = (t_ms, p_ms, l_ms, moved, ops)

    a = (s, inp["w"], inp["c"], inp["v"], inp["r"], inp["drive"], *rows)
    t_ms = median_ms(lambda: lif_step.fused_lif_step(*a))
    p_ms = median_ms(lambda: ref.fused_lif_step_ref(*a))
    l_ms = median_ms(lambda: torch.matmul(s, wc))
    moved = nbytes(s, inp["w"], inp["c"], inp["v"], inp["r"], inp["drive"], *rows) + 3 * nbytes(s)
    ops = 3 * SLOTS * N * N   # mask multiply + multiply-add per synapse
    out["lif_step"] = (t_ms, p_ms, l_ms, moved, ops)

    # The rollout phase's shape: one network, 8 rows, shared weights.
    inp8 = kernel_inputs(gen, dev, 1, ROWS, False)
    args8, _ = tick_case(inp8, premasked=True, ring=False, delays=False, drive=True,
                         in_place=False)
    log(f"time tick_fused at S=1 B={ROWS} (shared weights): "
        f"{median_ms(lambda: tick_fused.fused_tick(*args8)):.4f} ms, plain "
        f"{median_ms(lambda: ref.fused_tick_ref(*args8)):.4f} ms, torch.matmul "
        f"{median_ms(lambda: torch.matmul(inp8['y'], inp8['wc'])):.4f} ms")
    del inp8, args8

    # The drive ext @ w_in the serving path runs beside B2 every tick.
    w_in = torch.eye(N, device=dev).expand(SLOTS, N, N).contiguous()
    d_ms = median_ms(lambda: torch.matmul(inp["drive"], w_in))
    timed = {}
    for name, (t_ms, p_ms, l_ms, moved, ops) in out.items():
        bound = max(moved / bw, ops / flops) * 1e3
        timed[name] = {"ms": t_ms, "plain_ms": p_ms, "library_ms": l_ms,
                       "bound_ms": bound, "bound_by": "bytes" if moved / bw >= ops / flops
                       else "operations"}
        log(f"time {name}: {t_ms:.4f} ms (bound {bound:.4f} ms, plain {p_ms:.4f} ms, "
            f"torch.matmul {l_ms:.4f} ms) at S={SLOTS} B=1 N=K={N}")
    log(f"time drive ext @ w_in (S={SLOTS}, eye({N}) per slot): {d_ms:.4f} ms "
        f"(bound {nbytes(w_in) / bw * 1e3:.4f} ms)")
    return timed


# ---------------------------------------------------------------------------
# phase 2: rollout at the snn-fused width
# ---------------------------------------------------------------------------

def run_rollout_phase(dev, gen):
    import torch

    from repro_torch.core import network
    from repro_torch.core.lif import LIFParams
    from repro_torch.kernels import lif_step

    i32 = torch.int32
    rnd = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen, device=dev,
                                              dtype=i32)
    c = (torch.rand((N, N), generator=gen, device=dev) < 0.05).float()
    params = network.SNNParams(
        w=rnd(0, 256, (N, N)).float() * c, c=c, w_in=torch.eye(N, device=dev),
        lif=LIFParams(v_th=rnd(500, 5000, (N,)).float(), leak=rnd(0, 9, (N,)).float(),
                      r_ref=rnd(0, 4, (N,)), gain=torch.ones(N, device=dev),
                      i_bias=torch.zeros(N, device=dev), v_reset=torch.zeros(N, device=dev)))
    ext = ((torch.rand((TICKS, ROWS, N), generator=gen, device=dev) < 0.1).float()
           * rnd(80, 256, (TICKS, ROWS, N)).float())
    lif_step.launches = 0
    for D, with_delays in ((1, False), (RING, False), (RING, True)):
        delays = rnd(1, D + 1, (N, N)) if with_delays else None
        st0 = network.SNNState.zeros((ROWS,), N, max_delay=D, device=dev)
        runs = {}
        for backend in ("jnp", "pallas", "pallas_fused"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final, raster = network.rollout(params, st0, ext, TICKS, delays=delays,
                                            backend=backend)
            torch.cuda.synchronize()
            runs[backend] = (final, raster, time.perf_counter() - t0)
        fj, rj, _ = runs["jnp"]
        if rj.shape != (TICKS, ROWS, N) or not torch.isfinite(fj.lif.v).all():
            raise AssertionError("rollout: bad raster shape or non-finite state")
        for backend in ("pallas", "pallas_fused"):
            f, r, _ = runs[backend]
            same = (torch.equal(r, rj) and torch.equal(f.lif.v, fj.lif.v)
                    and torch.equal(f.lif.r, fj.lif.r) and torch.equal(f.lif.y, fj.lif.y)
                    and torch.equal(f.delay_buf, fj.delay_buf)
                    and torch.equal(f.tick, fj.tick))
            if not same:
                raise AssertionError(f"rollout {backend} D={D} delays={with_delays} "
                                     "differs from jnp")
        log(f"rollout D={D} delays={with_delays}: pallas and pallas_fused == jnp bitwise; "
            f"spike rate {rj.mean().item():.4f}; wall "
            + ", ".join(f"{b} {t:.3f} s" for b, (_, _, t) in runs.items()))
    return lif_step.launches


# ---------------------------------------------------------------------------
# phase 3: the serving path at snn-fused FULL
# ---------------------------------------------------------------------------

def run_serve_phase(dev):
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.kernels import lif_step, tick_fused
    from repro_torch.launch.serve import SNNServer, make_demo_requests, make_demo_tenants

    cfg = get_bundle("snn-fused").model
    results = {}
    for backend in ("jnp", cfg.snn_backend):
        server = SNNServer(n_max=cfg.n_neurons, slots=SLOTS, max_ticks=cfg.n_ticks,
                           mode=cfg.snn_mode, backend=backend, device=dev)
        names = make_demo_tenants(server, SLOTS, seed=0)
        reqs = make_demo_requests(server, names, 2 * SLOTS, seed=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lif_step.launches = tick_fused.launches = 0
        t0 = time.perf_counter()
        stats = server.serve(reqs)
        wall = time.perf_counter() - t0
        log(f"serve {backend}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        launches = {"tick_fused": tick_fused.launches, "lif_step": lif_step.launches}
        results[backend] = (reqs, stats, launches, wall)
        del server
    reqs_j, stats_j, _, wall_j = results["jnp"]
    reqs_f, stats_f, launches, wall_f = results[cfg.snn_backend]
    for rj, rf in zip(reqs_j, reqs_f):
        if rf.counts is None or not np_equal(rf.counts, rj.counts) or rf.pred != rj.pred:
            raise AssertionError(f"serve: request {rf.rid} differs from jnp")
    waves = stats_f["waves"]
    if stats_f["n_requests"] != 2 * SLOTS or waves < 2:
        raise AssertionError(f"serve: expected {2 * SLOTS} requests in >= 2 waves")
    if launches["tick_fused"] != waves * cfg.n_ticks:
        raise AssertionError(f"serve: tick_fused launched {launches['tick_fused']} times, "
                             f"expected waves x ticks = {waves * cfg.n_ticks}")
    for k, v in stats_f.items():
        if k != "results":
            log(f"serve {k}: {v}")
    log(f"serve: {stats_f['n_requests']} requests == jnp on the card (counts and preds); "
        f"wall per wave {wall_f / waves:.4f} s ({cfg.snn_backend}), "
        f"{wall_j / stats_j['waves']:.4f} s (jnp); launches {launches}")
    return launches


def np_equal(a, b) -> bool:
    import numpy as np

    return a is not None and b is not None and np.array_equal(a, b)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch import device as port_device
    from repro_torch.kernels import _build

    dev = port_device.resolve(None)
    smi = nvidia_smi()
    card = peaks(smi)
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build = _build.build()
    log(f"build: {build.path.parent.name} in {time.perf_counter() - t0:.2f} s")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", build.log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", build.log))
    if regs:
        log(f"ptxas: {len(regs)} kernels for sm_90a, {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes spilled")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    errs = run_kernel_phase(dev, gen)
    timed = time_kernels(dev, gen, card)
    b1_launches = run_rollout_phase(dev, gen)
    launches = run_serve_phase(dev)
    launches["lif_step"] = b1_launches
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    sources = {
        "tick_fused": ("src/repro_torch/csrc/tick_fused.cu", "src/repro/kernels/tick_fused.py:66"),
        "lif_step": ("src/repro_torch/csrc/lif_step.cu", "src/repro/kernels/lif_step.py:93"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": errs[name],
                        **timed[name]})
    log(f"kernels launched: tick_fused {launches['tick_fused']} (serve), "
        f"lif_step {launches['lif_step']} (pallas rollouts)")
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
