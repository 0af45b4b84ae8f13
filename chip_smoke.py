#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``src/repro_torch/csrc``
with ``nvcc`` for ``sm_90a``, then runs these phases, each of which fails the
script on any mismatch:

1. kernels: kernel B2 (``tick_fused``) in every variant (premasked ``W*C`` or
   ``w`` + ``c``, the previous ``y`` as a depth-1 ring, a uniform ring of
   depth 4 written in place, per-synapse delays over a ring of depth 4
   written through, drive or none, fixed leak or Euler) and kernel B1
   (``lif_step``), each against its plain PyTorch twin on the card, at 4096
   neurons with 8 slots of one row, with one network of 8 rows and of 16
   rows (K split across a cluster in every ring mode), and at a ragged width
   (37, the element fill), printing the plans (fill, K split) each shape
   took. Then the split's own cases: one network of 16 rows with K = 4100
   (not a multiple of the stage rows times the split) and K = 4097 (the
   element fill), B1 and B2 in every operand form; B1's ``run_if`` gate
   closed and open under a cluster launch. Inputs sit on the u8 weight grid,
   so equality is exact (tolerance 0). Then two launches of B1 and B2 on
   normal-float weights at one network of 8 rows must be bitwise equal (no
   atomics), each within 4 f32 ulps of sum(|s| * |w*c|) of the float64
   product. Then kernel B5 (``stdp_update``) against its twin: ``stdp`` and ``rstdp``
   with per-slot rewards, the ``learn_until`` gate open and closed per slot,
   all-zero, full and partial plastic masks, ``w``/``elig`` in place, at
   the serving shape (8 slots of one row, 4096 x 4096) and at a ragged
   width (37), bitwise; one shared network of 8 and of 16 rows (half and
   5 % masks) to ``rtol=atol=1e-6`` (the batch sum's order differs from
   cuBLAS's).
   Then B1 and B2 timed at the main path's shapes (B2 premasked in a served
   frozen wave and streaming ``w`` and ``c`` in a learning wave, B1 masked,
   at 8 slots of one row; B2 premasked and B1 masked at one network of 8
   rows; B1 premasked at 16 rows, the event arm's dense launch), each beside
   its bound, its twin and ``torch.matmul(s, W*C)`` on the premasked
   operand, taken in turns over 30 rounds, a device sleep ahead of each
   launch, the L2 flushed before each launch at one network; the plan of
   each timed launch is printed. Then B5 timed the same way at the main
   path's four shapes (a served learning wave with one slot open, every
   synapse plastic under ``stdp`` and ``rstdp`` at 8 slots of one row, a
   learning rollout's 8 rows on one 5 % mask), each beside its bound, its
   twin, ``torch.baddbmm`` of its LTP term and ``w.add_(c)`` over the same
   matrices, the L2 flushed before each launch.
2. rollout: ``network.rollout`` at the ``snn-fused`` width (4096 neurons,
   32 ticks, batch 8) on ``pallas`` and ``pallas_fused`` against ``jnp``,
   for ``max_delay`` 1 and 4 and per-synapse delays; rasters and final
   state must be bitwise equal. Each backend runs again with telemetry on:
   every bit as off, the telemetry kernel launched once per tick, ``spikes``
   equal to the raster's sums, and the three backends' telemetry bitwise
   equal. Kernel B1's launches are counted here (the ``pallas`` backend's
   path).
3. learning rollout: ``network.learning_rollout`` at the same width with one
   shared weight matrix, ``stdp`` and ``rstdp`` (a nonzero reward sequence),
   on ``pallas_fused`` and ``pallas``; B5 must launch rollouts x 32 times.
   Each runs again with telemetry on (every learned bit as off, B5's dw
   statistics against the ``jnp`` rollout's ``w' - w`` to rtol=1e-5).
   Each rollout is then checked tick by tick from a shared carry: one tick
   through the kernels and one through the plain ``jnp`` path must agree
   (``v``, ``w``, ``elig``, traces to ``rtol=1e-5, atol=1e-3``), and every
   spike that differs must be a rounding tie (the plain path's
   pre-threshold potential within ``1e-4 * max(1, |v_th|)`` of ``v_th``;
   the tie's own neuron and weight column are then left out). The ties
   are counted and printed.
4. serve: ``SNNServer`` at the ``snn-fused`` FULL config (n_max 4096, 8
   slots, 32 ticks, ``pallas_fused``) with the 8 demo RegisterBank tenants
   (the last, ``dense-7``, plastic), against the same server on ``jnp``,
   twice. First the 14 of the 16 demo requests that go to frozen tenants:
   these waves hold no plastic tenant and run the frozen rollout (``W*C``
   hoisted); every count and prediction must be bitwise equal, B2 must
   launch waves x 32 times and B5 never. Then all 16 requests in 2 waves:
   frozen tenants' counts and predictions must be equal, the learning waves
   pass the tick-by-tick check above, the plastic tenant's weights move,
   stay in ``[w_min, w_max]`` and round-trip through ``weights_to_bank``
   byte-exactly, no wave holds two of its requests, and B2 and the
   telemetry kernel launch waves x 32 times and B5 learning waves x 32
   times. The servers run with telemetry on, their default; the 16 requests
   served again with it off give every count, prediction and learned weight
   bitwise, and the tenant report and the registry's counters are printed.
   Then continuous admission, by the reference's benchmark recipe
   (``benchmarks/bench_serve.py``'s continuous section): two servers at the
   same config with ``chunk_ticks`` 8, one warmed with 8 requests through
   ``serve``, one through ``serve_continuous``, then the bimodal mix of 64
   requests (seed 7) through each. Every count and prediction and the
   plastic tenant's learned weights must be bitwise equal between the two
   paths; frozen tenants' counts equal a ``jnp`` server's continuous serve;
   B2 and the telemetry kernel launch chunks x 8 times and B5 learning
   chunks x 8; every frozen chunk's B2 plan is premasked; every chunk
   dispatch runs under ``torch.cuda.set_sync_debug_mode("error")``; the
   second serve rebuilds nothing and adds no launch plan. It prints the
   reference's continuous metrics (min-of-3 walls of mixes 100-102), the
   host time per stage (fill, assemble, dispatch, retire), the device-busy
   share from a profiled repeat of the last timed mix, and the clone the
   owned learning carry avoids. Then an ``AsyncSNNServer`` over the
   continuous server: a mix submitted concurrently while its worker is
   held, then released (every result equal to a direct
   ``serve_continuous`` of the same requests), with ``queue_full`` and
   ``tenant_cap`` provoked and counted.
5. event kernels: kernels B3 (``event_dispatch_db``) and B4
   (``event_dispatch``) against their plain twin, bitwise, on u8-grid
   ``W*C`` at the ``snn-event`` FULL shape (16 rows, K = N = 4096, spike
   lists of a 0.05-rate raster, k = 409) and on zero-spike rows, ragged
   counts, ``counts == k``, a ragged width (37) and a slot axis, with and
   without drive, fixed leak and Euler, the device gate set and clear (and
   kernel B1's matching ``run_if`` gate on the premasked ``W*C``). Then B4
   alone on what its redesign must still take, bitwise and each launched
   twice with the two results bitwise equal: lists out of order and with
   repeated ids, normal-float weights, 40 rows (three groups of rows),
   k = 1400 (passes over the lists), a ragged width and a slot axis; the plan
   of each is printed. Then B3, B4, the twin and ``torch.matmul(s, wc)``
   timed at the snn-event FULL shape and at ``counts == k`` (no sentinel
   tail), each beside its bound (B4's counts the sentinel row once), with
   B4's plan and, at FULL, B4's time on smaller stages, and a crossover sweep of B3 against B1 and ``torch.matmul`` at
   8 to 4096 spikes per row, which prints where the dense product wins and
   the gather penalty that implies.
6. event rollout: ``network.rollout`` on the ``snn-event`` FULL fabric (4096
   neurons, ``sparse_random(4096, 0.05)``, u8 weights through a
   ``RegisterBank``, thresholds that keep it subcritical, input rate 0.05,
   32 ticks, batch 16, ``max_delay`` 4) with ``dispatch="topk"`` (kernel B3,
   under ``torch.cuda.set_sync_debug_mode("error")``, so a host sync in the
   tick loop fails it), ``"fan_in"``, ``"dense"``, ``"auto"``, ``topk`` with
   the knee armed, ``topk`` with a budget small enough to overflow, and
   ``topk`` on kernel B4, each with telemetry on and off; rasters and final
   state bitwise equal to the ``jnp`` backend. Each run prints its arms
   (event, dense on overflow, dense by the knee), read from its telemetry,
   and launches. Then the fabric on a slot axis of two networks, one driven
   at a tenth of the other's rate, with the knee: each slot decides its own
   arm, the rasters equal ``jnp``'s and the per-slot arms read from the
   per-slot telemetry equal the arms replayed on the host from the ``jnp``
   raster. Then one event-backend ``learning_rollout`` (``stdp``) with the
   tick-by-tick check of phase 3.
7. event serve: the serve phase's server with ``event_density=0.2``: the
   demo's ring and sparse tenants ride the event program (fan-in gather);
   every frozen tenant's counts and predictions equal the ``jnp`` server's
   without the event program; the event tenants' report shows no overflow
   and no knee tick (the fan-in gather).
8. telemetry: the telemetry kernel against its twin at 8 slots x 4096, one
   network of 16 rows and a ragged width (37), frozen, learning (B5's
   partials), event (overflow flags) and knee forms, u8 grid, normal floats
   and int32 state, three ticks from a random start: bitwise but ``v_sum``
   on normal floats and ``dw_l1``/``dw_sq`` (rtol=1e-6); two runs bitwise
   equal. Kernel B5 with its dw statistics at four shapes: the learned
   tensors bitwise those without them, the statistics against the twin's
   to rtol=1e-5, two launches bitwise equal. Then the telemetry kernel's
   device time per launch at the served shape beside its twin and bound,
   B5 at the served learning wave without and with its statistics, in
   turns, and telemetry's overhead by the reference's gate method
   (interleaved off/on pairs, the median ratio) at its gate point (n 1024,
   ``jnp``) and on the served snn-fused FULL waves.
9. spike_matmul: kernel B6 against its twin at ``tests/test_kernels.py``'s
   five sweep shapes, ``predict_int``'s Iris (45 x 4 -> 3) and MNIST
   (80 x 64 -> 10) products, each in f32 and bf16: normal weights within
   the reference's tolerance (1e-5 f32, 2e-2 bf16), 0/1 spikes times u8-grid
   weights bitwise; and one network of 8 rows at K = N = 4096 and four
   ragged shapes on the stream-K split, on the u8 grid bitwise and on
   normal weights (B6 and its twin each within 4 f32 ulps of
   sum(|s| * |w*c|) of the float64 product, per output); in every case two
   launches bitwise equal. Then B6 at 8 x 4096 x 4096 in f32 and bf16 (the
   twin,
   ``torch.matmul(s, w * c)`` with the mask inside, on the premasked
   operand, and ``torch.dot(w, c)`` over the same bytes, in turns, the L2
   flushed before each launch), and profiler device time at the two
   classifier shapes.
10. classifiers: the paper's Iris and MNIST-8x8 networks through
   ``classifier.train``, ``deploy``, ``predict_float`` and ``predict_int``
   with ``device=None`` (every launch count zeroed just before, read just
   after: B6 once per ``predict_int``, no other kernel); ``predict_int`` on
   the card bitwise equal to the CPU's on the same bank and B6's product
   equal to ``x @ w_int``; the reference's accuracy floors; the model
   trained on the card and the one trained on the CPU from the same seed
   give equal test predictions (float and integer), and a 100-epoch fit from
   one init agrees within 1e-4 on the two. Accuracies and the wall times of
   ``train`` and ``predict_int`` are logged.
11. learning workload: ``online_learning --fast`` (the ``mnist-stdp`` fabric:
   64 inputs, 64 feature neurons under STDP with a fixed -127 lateral block,
   10 R-STDP outputs, 8 ticks a presentation) on ``pallas`` (B1 and B5),
   ``pallas_fused`` (B2 and B5) and ``jnp``, every launch count zeroed just
   before and read just after: the reference's PASS condition, the readback
   byte-exact with 18576 transactions and identical spikes, B1 or B2 once a
   tick of every rollout and B5 once a learning tick. On each kernel
   backend, the whole ``--fast`` schedule in lockstep with ``jnp`` from
   shared states (it must reproduce the run's learned state bitwise): every
   presentation agrees with ``jnp`` unless a tick had a rounding tie, the
   first 32 of each stage and every disagreement held tick by tick against
   the plain path as in phase 3 (ties counted), the WTA block bitwise; the
   run's accuracies and probed spikes equal ``jnp``'s run's unless the
   lockstep showed rounding. From the run's learned state, its frozen
   rollouts (``feature_counts`` on 128 and 32 rows at N = 128,
   ``readout_predict`` on 32 at N = 74) against ``jnp`` tick by tick, rasters
   and predictions equal up to counted ties, and the readback (40 rows)
   bitwise ``jnp``'s. One presentation of each stage under
   ``torch.cuda.set_sync_debug_mode("error")``; the device-busy share over
   16 presentations of each stage under the profiler; the full run once on
   ``pallas`` (its accuracies, seconds and presentations per second a stage,
   and its frozen rollouts at 320 and 80 rows held the same way); B1, B2 and
   B5 bitwise equal to their twins on u8-grid inputs at every batch shape of
   the workload (B = 1, 32, 40, 80, 128, 320 at 128 neurons; 1, 8, 32, 80 at
   74), on the fill each width asks for, and timed beside their bounds,
   their twins and ``torch.matmul`` (B5: ``torch.addmm`` of its LTP term).
12. reconfiguration: ``reconfigure_runtime.main`` (one 74-neuron fabric,
   Iris, MNIST and Iris again by register rewrites, 4 ticks over 8 rows on
   ``pallas_fused``): B2 launched 12 times and nothing else; the same
   programs on ``pallas`` (B1) and ``jnp``: rasters bitwise equal to
   ``jnp``'s, spike totals 2344 / 2288 / 2344, one program in use and no
   new launch plan after the first.
13. analysis: the port's static-analysis gate
   (``repro_torch.analysis.check``, ``--all``) on the card, with 0 errors;
   every tick program (4 backends x frozen/learning x telemetry on/off) at
   snn-fused FULL (4096 neurons, 8 slots, 32 ticks), then the wave, chunk
   and refill programs of a ``jnp`` server at the same config with the event
   program (the demo tenants), each with its tick body (and the refill)
   under ``torch.cuda.set_sync_debug_mode("error")``; every kernel launch
   the earlier phases profiled (``device_ms``), the launches of three of
   those tick programs at FULL (B1, B2, B3, B5, telemetry; B6 on its
   stream-K split at 8 x 4096 x 4096 in the first's trace) held to the
   launch descriptor its
   wrapper built: the trace's grid, block and shared memory (a launch whose
   traces came back empty twice is profiled once more here, and an empty
   trace fails the phase); and each kernel's static shared memory in the
   compiler's report equal to its descriptors'.
14. the sharded fabric: ``snn-64k`` FULL (65,536 neurons, ``c=None``, ``W``
   16 GiB of f32 built rank-local) as a world of one rank on the card
   (NCCL), through ``serve_sharded_main`` on ``jnp``, ``event`` (B1's dense
   arm and B3 behind its gate), ``pallas`` (B1 on ``W`` alone) and
   ``pallas_fused`` (B2 on ``W`` alone), the telemetry kernel on each: 6
   chunks of 8 ticks after a warm-up each, no new launch plan, every run's
   rasters, potentials and telemetry bitwise the ``jnp`` run's, a sparse
   event tick (B3 gathering about 2048 rows of ``W``) bitwise ``jnp``'s and
   ``torch.matmul`` over the same ``W`` on its spikes timed (B3's library
   call at that shape), that tick's B3 launch timed alone again (the
   profiler's device time of the kernel, beside its bound: those rows of
   ``W`` once and the LIF state), the peak device memory of each, and ticks timed
   by CUDA events beside their bounds (the bytes of ``W`` each reads over
   the card's memory rate) and ``torch.matmul(s, W)``. Then a world of two
   gloo ranks sharing the card
   (their spike exchange staged through the host) at 4096 neurons with an
   explicit ``c``, 8 rows, 16 ticks, telemetry on: frozen on ``pallas`` (B1
   at N = 2048), ``pallas_fused`` (remapped to B1), ``event`` (B3) and
   ``event`` on B4, every raster and final state bitwise the world of one
   on ``jnp`` (the plain path; the dyadic grid makes every sum order exact)
   and on its own backend; learning on ``pallas`` (B5): bitwise the world of
   one on ``pallas``, and tick by tick from the sharded kernels' carry
   against the plain path's world of one (``jnp``, the plain plasticity
   pass) within rtol=1e-5, atol=1e-3 outside counted rounding ties; the
   telemetry totals as the CPU tests hold them. Each rank's launches and
   plans are printed, and every launch count of the runs goes into the
   kernels line.
15. LM serving: ``python -m repro_torch.launch.serve`` with no arguments
   (``repro_torch.launch.serve.main([])``: smollm-135m FULL in bf16, 6
   requests, 12 new tokens each, 4 slots, a 64-token cache) served twice,
   cold and warm, with every kernel count at 0 before and after (no
   hand-written kernel lies on the LM path: cuBLAS products and plain tensor
   ops, as the reference computes its LM in jnp); 72 tokens each time, the
   two runs' tokens equal. The first wave replayed from the same seeded
   parameters: its tokens equal the CLI's, its prefill and decode logits
   within 2^-3 of one no-cache forward over the same prefix, and every greedy
   token that forward's argmax unless its top-2 gap is under 2^-2 (ties
   counted and printed). smollm-135m SMOKE in f32 from the same parameters on
   the card and the CPU: the served tokens equal, a wave's logits within
   1e-4. Then one decode step of each FULL config (smollm-135m, smollm-360m,
   qwen3-0.6b, starcoder2-15b at 31.9 GB, musicgen-large) timed: wall,
   device time and device events a step, the busy share, the byte bound
   (parameters and cache over the card's memory rate), peak memory.
16. LM serving for the moe, hybrid, rwkv and vlm families:
   ``python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b`` (FULL,
   28.4 B parameters, 56.8 GB in bf16) and ``--arch rwkv6-1.6b`` (FULL),
   each once with every kernel count at 0 (no hand-written kernel lies on
   this path) and 72 tokens; each first wave replayed from the same seeded
   parameters (its tokens the CLI's) and held against one no-cache forward
   over the same prefix, within 2^-3 (moonshot with ``capacity_factor`` 8.0
   on both sides, the rows that dropped a claim left out and counted), every
   greedy token that forward's argmax unless its top-2 gap is under 2^-2.
   The five archs' SMOKE configs in f32 on the card and the CPU from the
   same parameters: served tokens equal (the vlm, which the server refuses,
   through ``prefill_fn`` / ``decode_fn`` with seeded ``vision_embeds``), a
   wave's logits within 1e-4. Then one decode step timed at moonshot and
   rwkv6 FULL, scout FULL cut to 8 of its 48 layers, the vlm FULL cut to 2
   of its 20 groups (seeded vision input), and one decode-mode layer of
   each of jamba FULL's kinds (mamba + dense, mamba + MoE, attn + dense):
   wall, device time and events, the busy share, the byte bound over every
   expert and over the experts routed to, the decode-time capacity drops,
   peak memory.
17. LM training: ``python -m repro_torch.examples.train_lm --full``
   (smollm-135m FULL in bf16 through the train CLI: 60 steps of 8 x 64
   tokens, checkpoints every 20, peak lr 1e-3): the loss decreases and the
   checkpoints rotate to 3. Then, in a fresh directory, the CLI stopped
   after 40 steps of the same schedule and run again to 60, which resumes
   at 40 from the bf16 checkpoint: its 20 losses against the uninterrupted
   run's (within 1e-3 relative; whether bitwise is printed) and its final
   checkpoint against the uninterrupted one's, file by file. Two backward
   passes of one batch at FULL, the gradient leaves that differ bitwise
   named. Every family's SMOKE config in f32 from the same parameters on
   the card and the CPU, 3 train steps (jamba also at 2 microbatches with
   its bf16 optimizer state; the vlm with seeded ``vision_embeds``): loss,
   grad_norm and lr within 1e-4. Then one train step timed at
   smollm-135m FULL, rwkv6-1.6b FULL and moonshot FULL cut to its first 2
   layers, at 8 x 64 tokens, under remat ``none`` and ``block``: wall,
   device time and events, busy share, tokens/s and peak memory, against
   the FLOP bound (8 x params x tokens with remat's second forward, 6 x
   without, over the dense bf16 peak; moonshot's routed experts only) and
   the byte bound (parameters read 3 times, gradients 4 times, ``m`` and
   ``v`` read and written, parameters written). Every kernel count is 0
   across the phase.
18. lm mesh: the LM stack on a ``DeviceMesh``. (a) smollm-135m FULL at 8 x
   64 tokens (bf16, AdamW, remat ``block``), 3 train steps on a (1, 1)
   ``("data", "model")`` mesh over a world of one rank on NCCL, the state
   laid out by ``state_shardings``, the batches by ``batch_shardings``, the
   rules active, against the same steps on one device (``--mesh none``):
   losses and the gathered state compared bitwise (when they differ, the
   first operation of a forward whose result differs is named), each
   step's wall, device time and device events on both paths, peak memory.
   (b) The production meshes, (16, 16) and (2, 16, 16), built on the fake
   process group in a child process; ``param_shardings`` of every FULL arch
   laid on them, every sharded dim dividing its mesh axis. (c) The mesh
   state saved (each DTensor whole) and restored with ``shardings=`` onto
   the mesh: every leaf bitwise, every placement as ``state_shardings``;
   whether the files are those of the ``--mesh none`` state's save. (d)
   ``sqrt_rn`` on the card against ``numpy.sqrt`` on 2^20 float32 draws at
   scales 1e-6, 1 and 1e3: 0 misses. Every kernel count is 0 across the
   phase.
19. dry run: (a) ``python -m repro_torch.launch.dryrun`` on the card's
   device type, each cell in a child process of its own with its own
   timeout, all started together: qwen3-0.6b decode_32k on the (16, 16)
   and (2, 16, 16) meshes, smollm-135m and qwen3-0.6b train_4k,
   moonshot-v1-16b-a3b decode_32k, qwen3-0.6b, moonshot-v1-16b-a3b and
   jamba-1.5-large-398b prefill_32k on (16, 16), and snn-64k; each
   artifact's status, per-device FLOPs, argument, temp (outputs left out,
   as XLA's) and full traced peak bytes, trace seconds and every site of
   products over their even share are printed, and for the train cells the
   storages alive at the temp's peak; a cell that fails, a site the
   reference's layout does not have (all but decode's ``_project_kv`` and
   rwkv6's replicated LoRA products), FLOPs a device outside their slack
   of the reference's (smollm and qwen3 train, moonshot and jamba
   prefill) or a train temp above 1.5x the reference's (smollm and qwen3)
   fails the phase. (b) The cost model against a step the card
   runs: smollm-135m FULL at 8 x 64 tokens, remat ``block``, one device;
   the step traced on fake tensors (the recorder's full peak: arguments
   plus every storage the step allocated, its outputs included) against
   ``torch.cuda.max_memory_allocated`` of the
   real step (within 10 %), and the traced FLOPs against the FLOPs of the
   real step's own ops, counted by the same rules (equal). Every kernel
   count is 0 across the phase.
20. a JSON line of the kernels (the six ported ones and the telemetry
   kernel), the card's name and power limit, and the result line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA device is visible or
the package is missing. Nothing here imports JAX or the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
TIE = 1e-4        # a spike decision within TIE * max(1, |v_th|) of v_th is a rounding tie
EVENT_ROWS = 16   # batch rows of the snn-event rollout
EVENT_K = 409     # the snn-event plan's spike budget: 2 * rate * n at rate 0.05
EVENT_KNEE = 300  # the knee armed in the event rollout: inside the fabric's spike counts
EVENT_SMALL_K = 250   # a spike budget the fabric's busier ticks overflow
FLUSH_BYTES = 128 * 2**20   # read between timed launches to empty the 50 MB L2
SLEEP_CYCLES = 400_000      # a device sleep (~0.2 ms) ahead of each timed launch
CROSSOVER_M = (8, 32, 128, 512, 2048, 4096)   # spikes per row in the crossover sweep

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


def device_ms(fn, runs: int = RUNS) -> float:
    """Mean device time of one call of ``fn``: the summed time of every kernel
    and copy it ran on the card, from ``torch.profiler``'s CUDA trace over
    ``runs`` calls after two warm-up calls. Unlike :func:`median_ms` it
    leaves out the host's launch overhead, which dominates a call shorter
    than the Python that launches it. A trace that comes back with no device
    activity at all (seen on the H100 once in the crossover sweep, and once
    in three traces in a row of B6 at ``predict_int``'s shapes) is taken
    again; after three such traces the call is timed by :func:`events_ms`
    instead, and a line says so. The launches a trace holds are held to the
    descriptors their wrappers built (:func:`hold_trace`, for the analysis
    phase); a call whose traces hold none of them is kept for that phase to
    profile once more."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with launches_seen() as seen, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            if attempt < 2 and not hold_trace(prof, seen):
                TRACES["retry"].append(frozen(fn))   # profiled once more by the analysis phase
            return us / runs / 1e3
        if attempt == 1 and seen:
            TRACES["retry"].append(frozen(fn))   # profiled once more by the analysis phase
    ms = events_ms(fn, runs)
    log(f"device_ms: torch.profiler recorded no device time in 3 traces; timed by CUDA "
        f"events behind a device sleep instead: {ms:.4f} ms")
    return ms

def frozen(fn):
    """``fn`` bound to the values its closure holds now: a lambda made in a
    loop reads the loop's variables when it is called, and a call kept for
    a later phase must run with this iteration's."""
    import types

    def copy(cell):
        try:
            return types.CellType(cell.cell_contents)
        except ValueError:        # not bound yet: the enclosing scope's own cell
            return cell

    cells = getattr(fn, "__closure__", None)
    if not cells:
        return fn
    return types.FunctionType(fn.__code__, fn.__globals__, fn.__name__, fn.__defaults__,
                              tuple(copy(c) for c in cells))


# The profiled kernel launches held to their descriptors (the analysis
# phase): keys checked, launches checked, mismatches, and the calls whose
# traces came back empty twice.
TRACES = {"checked": {}, "launches": 0, "dropped": 0, "bad": [], "retry": [], "missing": []}
KERNEL_MODULES = ("lif_step", "tick_fused", "event_dispatch", "stdp_update", "spike_matmul",
                  "telemetry")


@contextlib.contextmanager
def launches_seen():
    """Every launch descriptor the kernel wrappers build while active, in
    launch order (each wrapper keeps its last as ``last_launch``)."""
    import importlib

    mods = [importlib.import_module(f"repro_torch.kernels.{m}") for m in KERNEL_MODULES]
    seen = []
    saved = [(m, m._launch) for m in mods]

    def watched(m, fn):
        def launch(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.append(m.last_launch)
            return out
        return launch

    for m, fn in saved:
        m._launch = watched(m, fn)
    try:
        yield seen
    finally:
        for m, fn in saved:
            m._launch = fn


def launch_key(d) -> tuple:
    return (d.symbol, d.grid, d.block, d.smem_dynamic, d.smem_static)


def trace_kernels(prof, symbols) -> tuple:
    """``(kernel events whose names hold one of symbols, in start order, every
    device event's category and name, the runtime calls)`` of a profiler
    trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    import os

    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    got = [e for e in events if e.get("cat") == "kernel"
           and any(sym in e.get("name", "") for sym in symbols)]
    if got and not TRACES["launches"]:
        log(f"analysis: a kernel event's args in the trace: {sorted(got[0].get('args', {}))}")
    device = [(e.get("cat"), e.get("name", "")[:60]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    runtime = sorted({e.get("name") for e in events if e.get("cat") == "cuda_runtime"})
    return sorted(got, key=lambda e: e["ts"]), device, runtime


def hold_trace(prof, seen) -> bool:
    """Hold every profiled launch's grid, block and shared memory equal to the
    descriptor its wrapper built for it (once per distinct descriptor);
    returns False when the trace holds no kernel event for some descriptor.

    The profiler can drop a launch's kernel record (seen: 1-7 of 30 B4
    launches in a trace), so events are matched to the launches in order by
    kernel name, a launch with no record skipped and counted."""
    if not seen or all(launch_key(d) in TRACES["checked"] for d in seen):
        return True
    events, device, runtime = trace_kernels(prof, {d.symbol for d in seen})
    j, held = 0, set()
    for e in events:
        while j < len(seen) and seen[j].symbol not in e["name"]:
            j += 1
        if j == len(seen):
            TRACES["bad"].append(f"a kernel event {e['name'][:60]} past the launches of "
                                 f"{sorted({d.name for d in seen})}")
            return True
        d = seen[j]
        j += 1
        args = e.get("args", {})
        grid, block = tuple(args.get("grid", ())), tuple(args.get("block", ()))
        # CUPTI's record sums static and dynamic shared memory
        smem, want = int(args.get("shared memory", -1)), d.smem_static + d.smem_dynamic
        if grid != d.grid or block != d.block or smem != want:
            TRACES["bad"].append(f"{d.name}: traced {e['name'][:60]} grid {grid} block "
                                 f"{block} shared {smem} against the descriptor's grid "
                                 f"{d.grid} block {d.block} shared {want}")
            continue
        held.add(launch_key(d))
        TRACES["checked"][launch_key(d)] = TRACES["checked"].get(launch_key(d), 0) + 1
        TRACES["launches"] += 1
    TRACES["dropped"] += len(seen) - len(events)
    if {launch_key(d) for d in seen} - held - set(TRACES["checked"]):
        TRACES["missing"].append(sorted({d.name for d in seen}))
        log(f"analysis: no kernel event of {sorted({d.symbol for d in seen})} in a trace of "
            f"{len(seen)} launches; its device events {device[:6]} ({len(device)}), runtime "
            f"calls {runtime}")
        return False
    return True


def events_ms(fn, runs: int = RUNS) -> float:
    """Median device time of one call of ``fn`` from a CUDA event pair around
    it, behind a device sleep at least four times as long as the host takes
    to launch ``fn`` (at 2 GHz), so that every launch of ``fn`` is queued
    before the device reaches the first event and the pair brackets the
    device's work alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return paired_ms({"fn": fn}, runs, sleep=max(SLEEP_CYCLES, int(8e9 * host_s)))["fn"]


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

def kernel_inputs(gen, dev, S, B, slotted_w, *, ring=1, delays=False, euler=False, n=N):
    """u8-grid inputs for one kernel call at width ``n``: integer weights, 0/1
    spikes, integer state and drive, so every sum is exact in f32."""
    import torch

    N = n  # noqa: N806 (the width of this call)
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


# B1/B2's shapes in phase 1: (slots, rows, per-slot weights, width). The
# serving shape; one network of 8 rows (the rollouts) and of 16 (the event
# arm's dense launch), where K is split across a cluster; a ragged width on
# the element path.
KERNEL_SHAPES = ((SLOTS, 1, True, N), (1, ROWS, False, N), (1, EVENT_ROWS, False, N),
                 (3, 4, True, 37))


def run_kernel_phase(dev, gen):
    import torch

    from repro_torch.kernels import lif_step, ref, tick_fused

    errs = {"tick_fused": 0.0, "lif_step": 0.0}
    cases = 0
    for S, B, slotted, n in KERNEL_SHAPES:
        plans = set()
        for euler in (False, True):
            mode = "euler" if euler else "fixed_leak"
            for variant in ("plain", "ring", "delays"):
                D = 1 if variant == "plain" else RING
                inp = kernel_inputs(gen, dev, S, B, slotted, ring=D,
                                    delays=variant == "delays", euler=euler, n=n)
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
                            f"tick_fused S={S} B={B} n={n} {mode} {variant} premasked="
                            f"{premasked} drive={drive}: max |err| {err}")
                    plans.add((tick_fused.last_plan.path, tick_fused.last_plan.ks))
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
                                f"lif_step S={S} B={B} n={n} {mode} drive={drive}: max |err| "
                                f"{err}")
                        plans.add((lif_step.last_plan.path, lif_step.last_plan.ks))
                        cases += 1
                del inp
        log(f"kernels at S={S} B={B} N=K={n}: plans (fill, K split) {sorted(plans)}")
        want_fill = "cp.async" if n % 4 == 0 else "element"
        if {p for p, _ in plans} != {want_fill} or (S == 1 and min(k for _, k in plans) < 2):
            raise AssertionError(f"kernels at S={S} B={B} n={n}: plans {plans}, expected the "
                                 f"{want_fill} fill{' and a K split' if S == 1 else ''}")
    cases += run_split_cases(dev, gen, errs)
    log(f"kernels: {cases} cases equal to their plain twins bitwise (tolerance 0)")
    return errs


def split_inputs(gen, dev, B, K, n, D):
    """u8-grid inputs of one network with K != N: (K, n) weights, a (1, B, D,
    K) spike history and (1, B, n) state."""
    import torch

    i32, f32 = torch.int32, torch.float32
    rnd = lambda lo, hi, shape, dt=f32: torch.randint(
        lo, hi, shape, generator=gen, device=dev, dtype=i32).to(dt)
    w, c = rnd(0, 256, (K, n)), rnd(0, 2, (K, n))
    return {"w": w, "c": c, "wc": w * c, "delays": rnd(1, D + 1, (K, n), i32),
            "hist": (torch.rand((1, B, D, K), generator=gen, device=dev) < 0.1).to(f32),
            "v": rnd(-20, 30000, (1, B, n)), "r": rnd(0, 3, (1, B, n), i32),
            "drive": rnd(0, 256, (1, B, n)),
            "rows": (rnd(1, 40000, (n,)), rnd(0, 9, (n,)), rnd(0, 4, (n,), i32),
                     torch.ones(n, device=dev), rnd(0, 4, (n,)), torch.zeros(n, device=dev))}


def run_split_cases(dev, gen, errs):
    """The K split's own cases, bitwise: one network of 16 rows with a K that
    is not a multiple of the stage rows times the split (4100 on the
    asynchronous fill, 4097 on the element fill), B1 and B2 in every operand
    form; B1's ``run_if`` gate closed and open under a cluster launch. Then two
    launches on normal-float weights at one network of 8 rows must be bitwise
    equal (no atomics), B1's product within 4 f32 ulps of sum(|s| * |w*c|)
    of the float64 product. Returns the count of bitwise cases."""
    import torch

    from repro_torch.kernels import lif_step, ref, tick_fused

    cases = 0
    for K in (N + 4, N + 1):
        x = split_inputs(gen, dev, EVENT_ROWS, K, N, RING)
        slots = torch.tensor([6 % RING, 7 % RING], dtype=torch.int32, device=dev)
        s = x["hist"][:, :, 0].contiguous()
        for w, c in ((x["wc"], None), (x["w"], x["c"])):
            a = (s, w, c, x["v"], x["r"], x["drive"], *x["rows"])
            calls = [("lif_step", lif_step, lambda: lif_step.fused_lif_step(*a),
                      lambda: ref.fused_lif_step_ref(*a))]
            for dl in (None, x["delays"]):
                t = (slots, x["hist"], w, c, dl, x["v"], x["r"], x["drive"], None, *x["rows"])
                calls.append(("tick_fused", tick_fused, lambda t=t: tick_fused.fused_tick(*t),
                              lambda t=t: ref.fused_tick_ref(*t)))
            for name, mod, kernel, twin in calls:
                got, want = kernel(), twin()
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                errs[name] = max(errs[name], err)
                fill = "cp.async" if K % 4 == 0 else "element"
                if err != 0.0 or mod.last_plan.ks < 2 or mod.last_plan.path != fill:
                    raise AssertionError(f"{name} at B={EVENT_ROWS} K={K}: max |err| {err}, "
                                         f"plan {mod.last_plan}")
                cases += 1
        log(f"kernels at S=1 B={EVENT_ROWS} K={K} N={N}: B1 and B2 bitwise; "
            f"{tick_fused.last_plan}")
        del x
    # B1's gate under a cluster launch: closed writes nothing, open writes the twin.
    x = split_inputs(gen, dev, EVENT_ROWS, N, N, 1)
    s = x["hist"][:, :, 0].contiguous()
    base = (s, x["wc"], None, x["v"], x["r"], x["drive"], *x["rows"])
    for gate in (False, True):
        out = ref.LIFStepOut(torch.full_like(x["v"], -7.0), torch.full_like(x["r"], 9),
                             torch.full_like(x["v"], 3.0))
        want = ref.fused_lif_step_ref(*base) if gate else [t.clone() for t in out]
        got = lif_step.fused_lif_step(*base, run_if=torch.tensor(gate, device=dev), out=out)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["lif_step"] = max(errs["lif_step"], err)
        if err != 0.0 or lif_step.last_plan.ks < 2:
            raise AssertionError(f"lif_step run_if={gate} under a K split: max |err| {err}, "
                                 f"plan {lif_step.last_plan}")
        cases += 1
    del x
    # Determinism off the u8 grid: no spike, so v' is the product itself.
    sp, w, c = sm_inputs(gen, dev, ROWS, N, N, u8=False)
    zeros = torch.zeros((1, ROWS, N), device=dev)
    rows = (torch.full((N,), 1e30, device=dev), torch.zeros(N, device=dev),
            torch.zeros(N, dtype=torch.int32, device=dev), torch.ones(N, device=dev),
            torch.zeros(N, device=dev), torch.zeros(N, device=dev))
    a = (sp.unsqueeze(0), w, c, zeros, torch.zeros_like(zeros, dtype=torch.int32), None, *rows)
    slots = torch.zeros(2, dtype=torch.int32, device=dev)
    t = (slots, sp.reshape(1, ROWS, 1, N), w * c, None, None, zeros,
         torch.zeros_like(zeros, dtype=torch.int32), None, None, *rows)
    first = [lif_step.fused_lif_step(*a), tick_fused.fused_tick(*t)]
    second = [lif_step.fused_lif_step(*a), tick_fused.fused_tick(*t)]
    torch.cuda.synchronize()
    for name, g1, g2 in zip(("lif_step", "tick_fused"), first, second):
        if not all(torch.equal(p, q) for p, q in zip(g1, g2) if p is not None):
            raise AssertionError(f"{name}: two launches on normal weights differ")
        close, err = wide_close(g1[0][0], sp, w, c)
        if not close:
            raise AssertionError(f"{name} on normal weights: max |err| {err} from the float64 "
                                 f"product, beyond {SM_WIDE_ULPS} f32 ulps of sum(|s||w*c|)")
        log(f"{name} at S=1 B={ROWS} N=K={N} on normal weights: two launches bitwise equal; "
            f"max |err| {err:.3g} from the float64 product (within {SM_WIDE_ULPS} f32 ulps of "
            f"sum(|s||w*c|)); K split {lif_step.last_plan.ks} ways")
    return cases


def paired_ms(fns: dict, runs: int = RUNS, flush=None, sleep: int = SLEEP_CYCLES) -> dict:
    """Median device time of each of ``fns`` over ``runs`` rounds, the
    functions taken in turns within a round (so a kernel and its library
    call see the same card state). Each launch is preceded by a sleep kernel,
    so the CUDA events bracket the device's work and not the host's Python;
    with ``flush`` (a buffer larger than the 50 MB L2) read before each
    launch, every launch starts from a cold L2. ``sleep`` is the sleep's
    length in device cycles."""
    import torch

    for fn in fns.values():
        fn()
        fn()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            if flush is not None:
                flush.sum()
            torch.cuda._sleep(sleep)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            times[name].append((start, end))
    torch.cuda.synchronize()
    return {name: statistics.median(a.elapsed_time(b) for a, b in pairs)
            for name, pairs in times.items()}


# B1/B2 timed at the main path's shapes: (label, kernel, slots, rows,
# per-slot weights, operand form).
TIMED = (("served frozen wave", "tick_fused", SLOTS, 1, True, "premasked"),
         ("learning wave, w and c streamed", "tick_fused", SLOTS, 1, True, "masked"),
         ("masked", "lif_step", SLOTS, 1, True, "masked"),
         ("rollout, shared weights", "tick_fused", 1, ROWS, False, "premasked"),
         ("pallas rollout, shared weights", "lif_step", 1, ROWS, False, "masked"),
         ("event dense arm, shared weights", "lif_step", 1, EVENT_ROWS, False, "premasked"))


def time_kernels(dev, gen, card):
    """B1 and B2 at the main path's shapes (``TIMED``): the kernel, its twin
    and ``torch.matmul(s, wc)`` on the premasked ``W*C`` (half of a masked
    launch's bytes), in turns; at one network (S = 1, where ``W*C`` barely exceeds the L2) each launch
    starts from a flushed L2. Returns the JSON rows (B2 in the served frozen
    wave, B1 masked at the serving shape) and B2's time in a learning wave."""
    import torch

    from repro_torch.kernels import lif_step, ref, tick_fused

    bw, flops = card
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    rows_json, streamed = {}, None
    for label, name, S, B, slotted, form in TIMED:
        inp = kernel_inputs(gen, dev, S, B, slotted)
        rows = tuple(inp["rows"].values())
        w, c = (inp["wc"], None) if form == "premasked" else (inp["w"], inp["c"])
        if name == "tick_fused":
            args, _ = tick_case(inp, premasked=form == "premasked", ring=False, delays=False,
                                drive=True, in_place=False)
            kernel, twin = tick_fused.fused_tick, ref.fused_tick_ref
            mod = tick_fused
            s = inp["y"]
            moved = nbytes(args[0], s, w, c, inp["v"], inp["r"], inp["drive"], *rows)
        else:
            s = inp["y"]
            args = (s, w, c, inp["v"], inp["r"], inp["drive"], *rows)
            kernel, twin = lif_step.fused_lif_step, ref.fused_lif_step_ref
            mod = lif_step
            moved = nbytes(s, w, c, inp["v"], inp["r"], inp["drive"], *rows)
        moved += 3 * nbytes(inp["v"])   # v', r', y'

        n_w = w.shape[0] if w.dim() == 3 else 1
        ops = 2 * S * B * N * N + (n_w * N * N if c is not None else 0)
        wc = inp["wc"]

        t = paired_ms({"kernel": lambda: kernel(*args), "plain": lambda: twin(*args),
                       "library": lambda: torch.matmul(s, wc)},
                      flush=flush if S == 1 else None)
        kernel(*args)
        plan = mod.last_plan
        bound = max(moved / bw, ops / flops) * 1e3
        log(f"time {name} ({label}, {form}): {t['kernel']:.4f} ms at S={S} B={B} N=K={N}, "
            f"{100 * bound / t['kernel']:.0f}% of its bound {bound:.4f} ms "
            f"({moved / 2**20:.1f} MiB); plain {t['plain']:.4f} ms, torch.matmul(s, W*C) "
            f"{t['library']:.4f} ms"
            + ("; L2 flushed before each launch" if S == 1 else ""))
        log(f"plan {name} ({label}): {plan}")
        row = {"ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
               "bound_ms": bound,
               "bound_by": "bytes" if moved / bw >= ops / flops else "operations"}
        if label == "served frozen wave" or (name == "lif_step" and S == SLOTS):
            rows_json[name] = row
        if label.startswith("learning wave"):
            streamed = t["kernel"]
        del inp, args, w, c, wc
    del flush

    # The drive ext @ w_in the serving path runs beside B2 every tick.
    drive = torch.zeros((SLOTS, 1, N), device=dev)
    w_in = torch.eye(N, device=dev).expand(SLOTS, N, N).contiguous()
    d_ms = median_ms(lambda: torch.matmul(drive, w_in))
    log(f"time drive ext @ w_in (S={SLOTS}, eye({N}) per slot): {d_ms:.4f} ms "
        f"(bound {nbytes(w_in) / bw * 1e3:.4f} ms)")
    return rows_json, streamed


def stdp_hyper(rule: str) -> dict:
    """The serving default rule (``stdp``) or its R-STDP variant, as the
    kernel's keyword arguments."""
    from repro_torch.plasticity import PlasticityParams
    from repro_torch.plasticity.rules import hyper_kwargs

    return hyper_kwargs(PlasticityParams.make(rule, a_plus=0.5, a_minus=0.25,
                                               lr_reward=0.5))


def stdp_inputs(gen, dev, S, B, K, N, *, slotted=True, masks="mixed"):
    """Inputs of one B5 call: 0/1 spikes, traces in [0, 1), weights in
    [0, 255), normal eligibility. ``masks="mixed"``: slot 0 frozen (all-zero
    mask), slot 1 fully plastic, the others half; ``"ones"``: every synapse
    learns; ``"sparse"``: a 5 % mask (the learning rollout's)."""
    import torch

    lead = (S,) if slotted else ()
    u = lambda shape: torch.rand(lead + shape, generator=gen, device=dev)
    if masks == "ones":
        c = torch.ones(lead + (K, N), device=dev)
    else:
        c = (u((K, N)) < (0.5 if masks == "mixed" else 0.05)).float()
    if masks == "mixed" and slotted and S > 1:
        c[0] = 0.0
        c[1] = 1.0
    return {"s_pre": (u((B, K)) < 0.2).float(), "x_pre": u((B, K)),
            "s_post": (u((B, N)) < 0.2).float(), "x_post": u((B, N)),
            "w": u((K, N)) * 255.0, "c": c,
            "elig": torch.randn(lead + (K, N), generator=gen, device=dev)}


STDP_ARGS = ("s_pre", "x_pre", "s_post", "x_post", "w", "c", "elig")


def run_stdp_kernel_phase(dev, gen):
    """B5 against its twin: bitwise at B = 1 (the serving shape and a ragged
    width), ``rtol=atol=1e-6`` for one shared network of 8 and 16 rows (half
    and 5 % masks)."""
    import torch

    from repro_torch.kernels import ref, stdp_update

    err, cases = 0.0, 0
    for S, n in ((SLOTS, N), (3, 37)):
        inp = stdp_inputs(gen, dev, S, 1, n, n)
        reward = torch.linspace(-1.5, 2.0, S, device=dev)
        tick = torch.tensor(7, dtype=torch.int32, device=dev)
        until = torch.tensor([8, 7, 0, 100, 8, 7, 9, 3][:S], dtype=torch.int32, device=dev)
        for rule in ("stdp", "rstdp"):
            for gate in ({}, {"tick": tick, "learn_until": until}):
                args = [inp[k] for k in STDP_ARGS]
                want = ref.fused_stdp_step_ref(*args, reward, **gate, **stdp_hyper(rule))
                w, e = inp["w"].clone(), inp["elig"].clone()
                got = stdp_update.fused_stdp_step(*args[:4], w, args[5], e, reward,
                                                  in_place=True, **gate, **stdp_hyper(rule))
                torch.cuda.synchronize()
                if got.w is not w or got.elig is not e:
                    raise AssertionError("stdp_update: in-place outputs are not the inputs")
                case_err = max_abs_err(got, want)
                err = max(err, case_err)
                if case_err != 0.0 or not all(torch.equal(g, x) for g, x in zip(got, want)):
                    raise AssertionError(f"stdp_update S={S} n={n} {rule} gate={bool(gate)}: "
                                         f"max |err| {case_err}")
                cases += 1
        # Out of place: the inputs stay as they were.
        w0 = inp["w"].clone()
        stdp_update.fused_stdp_step(*[inp[k] for k in STDP_ARGS], reward,
                                    **stdp_hyper("rstdp"))
        torch.cuda.synchronize()
        if not torch.equal(inp["w"], w0):
            raise AssertionError("stdp_update wrote w without in_place")
        del inp
    batched = 0
    for B, masks in ((ROWS, "mixed"), (ROWS, "sparse"), (EVENT_ROWS, "sparse")):
        inp = stdp_inputs(gen, dev, 1, B, N, N, slotted=False, masks=masks)
        for rule in ("stdp", "rstdp"):
            args = [inp[k] for k in STDP_ARGS]
            r = torch.tensor(0.75, device=dev)
            want = ref.fused_stdp_step_ref(*args, r, **stdp_hyper(rule))
            got = stdp_update.fused_stdp_step(*args, r, **stdp_hyper(rule))
            torch.cuda.synchronize()
            for g, x in zip(got, want):
                torch.testing.assert_close(g, x, rtol=1e-6, atol=1e-6)
            err = max(err, max_abs_err(got, want))
            batched += 1
        del inp
    log(f"stdp_update: {cases} cases bitwise equal to the twin at B=1 (slot axis, "
        f"masks all-zero/full/partial, gate open/closed, in place, n={N} and 37); "
        f"{batched} cases at B={ROWS} and {EVENT_ROWS} (half and 5 % masks) within "
        f"rtol=atol=1e-6; max |err| {err}; plan {stdp_update.last_plan}")
    return err


def stdp_bytes(inp, reward, rule, open_slots):
    """Bytes B5 must move on these inputs: in every slot whose gate is open
    the mask, ``w`` read and written where c > 0 and, for R-STDP, ``elig``
    read and written (a closed slot reads no matrix); spikes and traces in,
    traces out. It counts 8 bytes per learning synapse; on a sparse mask the
    card moves whole 32-byte sectors, so the true floor there is higher."""
    c = inp["c"]
    K, N = c.shape[-2:]
    opened = [s for s, o in enumerate(open_slots) if o]
    if c.dim() == 3:
        open_c = c[opened]
        learn = int((open_c > 0).sum().item())
    else:
        open_c = c if opened else c[:0]
        learn = int((c > 0).sum().item()) * len(opened)
    moved = nbytes(open_c, reward) + 8 * learn
    if rule == "rstdp":
        moved += 8 * K * N * len(opened)
    traces = nbytes(inp["s_pre"], inp["x_pre"], inp["s_post"], inp["x_post"])
    return moved + traces + nbytes(inp["x_pre"], inp["x_post"])


# B5 timed at the main path's shapes: (label, rule, slots, rows, masks, the
# open slots' gate). The JSON row is the fully plastic STDP case.
STDP_TIMED = (
    ("served learning wave, gate open in slot 7 only", "stdp", SLOTS, 1, "ones", "served"),
    ("stdp, every synapse plastic", "stdp", SLOTS, 1, "ones", None),
    ("rstdp, every synapse plastic", "rstdp", SLOTS, 1, "ones", None),
    ("learning rollout, one shared 5 % mask", "stdp", 1, ROWS, "sparse", None),
)


def time_stdp(dev, gen, card):
    """B5 at the main path's shapes (``STDP_TIMED``): the kernel, its twin,
    ``torch.baddbmm`` of the LTP outer product alone (one of the update's
    terms, not the same function) and ``w.add_(c)`` over the same matrices,
    in turns, a device sleep ahead of each launch and the L2 flushed before
    it (so no launch starts by writing back the dirty lines of the one
    before). Returns the JSON row (every synapse plastic, STDP)."""
    import torch

    from repro_torch.kernels import ref, stdp_update

    bw, flops = card
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    rows = {}
    for label, rule, S, B, masks, gated in STDP_TIMED:
        slotted = S > 1
        inp = stdp_inputs(gen, dev, S, B, N, N, slotted=slotted, masks=masks)
        reward = torch.full((S,) if slotted else (), 0.5, device=dev)
        gate, open_slots = {}, [True] * S
        if gated:
            gate = {"tick": torch.zeros((), dtype=torch.int32, device=dev),
                    "learn_until": torch.tensor([0] * (S - 1) + [TICKS], dtype=torch.int32,
                                                device=dev)}
            open_slots = [False] * (S - 1) + [True]
        args = [inp[k] for k in STDP_ARGS]
        hyper = stdp_hyper(rule)
        x_pre_t = inp["x_pre"].transpose(-1, -2)
        # The same matrix bytes through one streaming PyTorch call: w += c over
        # the open slots (c read, w read and written; elig too for R-STDP).
        opened = [i for i, o in enumerate(open_slots) if o]
        ws, cs = (inp["w"][opened[0]], inp["c"][opened[0]]) if slotted and len(opened) == 1 \
            else (inp["w"], inp["c"])
        stream = (lambda: (ws.add_(cs), inp["elig"].add_(inp["c"]))) if rule == "rstdp" \
            else (lambda: ws.add_(cs))
        t = paired_ms({
            "kernel": lambda: stdp_update.fused_stdp_step(*args, reward, in_place=True, **gate,
                                                          **hyper),
            "plain": lambda: ref.fused_stdp_step_ref(*args, reward, **gate, **hyper),
            "library": lambda: (torch.baddbmm if slotted else torch.addmm)(
                inp["w"], x_pre_t, inp["s_post"]),
            "stream": stream}, flush=flush)
        moved = stdp_bytes(inp, reward, rule, open_slots)
        # LTP, LTD, dw, update and clip per synapse of an open slot
        ops = 10 * sum(open_slots) * N * N
        bound = max(moved / bw, ops / flops) * 1e3
        log(f"time stdp_update ({label}): {t['kernel']:.4f} ms at S={S} B={B} N=K={N}, "
            f"{100 * bound / t['kernel']:.0f}% of its bound {bound:.4f} ms "
            f"({moved / 2**20:.1f} MiB; 8 bytes per learning synapse); plain "
            f"{t['plain']:.4f} ms, torch.baddbmm (LTP term alone) {t['library']:.4f} ms, "
            f"w.add_(c) over the same matrices {t['stream']:.4f} ms; L2 flushed before each "
            f"launch")
        log(f"plan stdp_update ({label}): {stdp_update.last_plan}")
        rows[label] = {"ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
                       "bound_ms": bound,
                       "bound_by": "bytes" if moved / bw >= ops / flops else "operations"}
        del inp, args, x_pre_t
    del flush
    return rows["stdp, every synapse plastic"]


# ---------------------------------------------------------------------------
# phase 2: rollout at the snn-fused width
# ---------------------------------------------------------------------------

TELEMETRY_LEAVES = ("ticks", "spikes", "v_sum", "v_max", "ref_sum", "overflow", "policy_dense",
                    "dw_l1", "dw_sq")


def same_state(a, b) -> bool:
    """Two network states bitwise equal (LIF state, ring, tick counter)."""
    import torch

    return (torch.equal(a.lif.v, b.lif.v) and torch.equal(a.lif.r, b.lif.r)
            and torch.equal(a.lif.y, b.lif.y) and torch.equal(a.delay_buf, b.delay_buf)
            and torch.equal(a.tick, b.tick))


def run_rollout_phase(dev, gen):
    """``network.rollout`` on ``jnp``, ``pallas`` and ``pallas_fused``, each with
    telemetry off and on: every raster and final state bitwise equal, the
    telemetry kernel launched once per tick of an on-rollout, ``spikes`` equal
    to the raster's sums, and the three backends' telemetry bitwise equal
    (the same states folded in by the same kernel)."""
    import torch

    from repro_torch.core import network
    from repro_torch.core.lif import LIFParams
    from repro_torch.kernels import lif_step, telemetry

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
        runs, telem = {}, {}
        for backend in ("jnp", "pallas", "pallas_fused"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final, raster = network.rollout(params, st0, ext, TICKS, delays=delays,
                                            backend=backend)
            torch.cuda.synchronize()
            runs[backend] = (final, raster, time.perf_counter() - t0)
            telemetry.launches = 0
            f_on, r_on, telem[backend] = network.rollout(params, st0, ext, TICKS, delays=delays,
                                                         backend=backend, telemetry=True)
            torch.cuda.synchronize()
            if not (torch.equal(r_on, raster) and same_state(f_on, final)):
                raise AssertionError(f"rollout {backend} D={D}: telemetry on changed a bit")
            if telemetry.launches != TICKS or not torch.equal(telem[backend].spikes,
                                                              raster.sum((0, 2))):
                raise AssertionError(f"rollout {backend} D={D}: telemetry launched "
                                     f"{telemetry.launches} times, or spikes != raster sums")
        fj, rj, _ = runs["jnp"]
        if rj.shape != (TICKS, ROWS, N) or not torch.isfinite(fj.lif.v).all():
            raise AssertionError("rollout: bad raster shape or non-finite state")
        for backend in ("pallas", "pallas_fused"):
            f, r, _ = runs[backend]
            if not (torch.equal(r, rj) and same_state(f, fj)):
                raise AssertionError(f"rollout {backend} D={D} delays={with_delays} "
                                     "differs from jnp")
            if not all(torch.equal(getattr(telem[backend], k), getattr(telem["jnp"], k))
                       for k in TELEMETRY_LEAVES):
                raise AssertionError(f"rollout {backend} D={D}: telemetry differs from jnp's")
        log(f"rollout D={D} delays={with_delays}: pallas and pallas_fused == jnp bitwise, "
            f"telemetry off and on (every leaf equal across backends, {TICKS} telemetry "
            f"launches a rollout); spike rate {rj.mean().item():.4f}; wall "
            + ", ".join(f"{b} {t:.3f} s" for b, (_, _, t) in runs.items()))
    return lif_step.launches


# ---------------------------------------------------------------------------
# the tick-by-tick check of a learning run (gate (c))
# ---------------------------------------------------------------------------

def pre_threshold(carry, params, ext):
    """The plain path's pre-threshold potential of one fixed-leak tick from
    ``carry`` (``max_delay == 1``): ``v + syn + i_bias - sign(v) * leak_step``."""
    import torch

    from repro_torch.kernels import ops

    st = carry.state
    S = ops.slot_count(params)
    w = params.w if carry.w is None else carry.w
    syn = ops.flatten_state(st.lif.y, S) @ (w * params.c)
    drive = ops.drive_of(ext, params.w_in, S)
    if drive is not None:
        syn = syn + drive
    row = (lambda p: p.unsqueeze(-2)) if S is not None else (lambda p: p)
    v = ops.flatten_state(st.lif.v, S)
    leak = row(params.lif.leak)
    leak_step = torch.minimum(leak * (v != 0).float(), v.abs())
    return v + syn + row(params.lif.i_bias) - torch.sign(v) * leak_step, row(params.lif.v_th)


def check_learning_ticks(kernel_eng, plain_eng, params, carry, n_ticks, ext_at, reward_at,
                         *, plastic_c=None, learn_until=None, what=""):
    """Gate (c): from the kernel path's carry, one tick through the kernels
    and one through the plain path, for every tick, held to each other by
    :func:`compare_learning_tick`. Returns ``(final kernel carry, ties, max
    |dv|, max |dw|)``."""
    ties, dv, dw = 0, 0.0, 0.0
    for t in range(n_ticks):
        xs = (ext_at(t), reward_at(t))
        kw = dict(params=params, plastic_c=plastic_c, learn_until=learn_until)
        ck, yk = kernel_eng.tick_body(carry, xs, **kw)
        cp, yp = plain_eng.tick_body(carry, xs, **kw)
        tt, tv, tw = compare_learning_tick(carry, params, xs[0], ck, yk, cp, yp,
                                           what=f"{what} tick {t}")
        ties, dv, dw = ties + tt, max(dv, tv), max(dw, tw)
        carry = ck
    return carry, ties, dv, dw


def compare_learning_tick(carry, params, ext, ck, yk, cp, yp, *, what=""):
    """One learning tick from ``carry``: the kernel path's ``(ck, yk)``
    against the plain path's ``(cp, yp)``. ``v``, ``w``, ``elig`` and the
    traces must agree to rtol=1e-5, atol=1e-3 outside the neurons (and
    weight columns) of rounding ties; every spike that differs must be a
    tie. Returns ``(ties, max |dv|, max |dw|)``."""
    import torch

    from repro_torch.kernels import ops

    S = ops.slot_count(params)
    ties = 0
    close = lambda a, b, ok: bool((torch.isclose(a, b, rtol=1e-5, atol=1e-3) | ~ok).all())
    diff = ops.flatten_state(yk != yp, S)                      # (S|1, B, N)
    if diff.any():
        v_tilde, v_th = pre_threshold(carry, params, ext)
        tie = (v_tilde - v_th).abs() <= TIE * v_th.abs().clamp_min(1.0)
        if (diff & ~tie).any():
            raise AssertionError(f"{what}: {int((diff & ~tie).sum())} spikes "
                                 "differ from the plain path and are no rounding tie")
        ties += int(diff.sum())
    same = ~diff
    cols = ~diff.any(dim=-2, keepdim=True)                       # (S|1, 1, N)
    wcols = cols if S is not None else cols[0]
    flat = lambda x: ops.flatten_state(x, S)
    checks = [
        ("v", flat(ck.state.lif.v), flat(cp.state.lif.v), same),
        ("r", flat(ck.state.lif.r).float(), flat(cp.state.lif.r).float(), same),
        ("x_pre", flat(ck.plast.x_pre), flat(cp.plast.x_pre), torch.ones_like(same)),
        ("x_post", flat(ck.plast.x_post), flat(cp.plast.x_post), same),
        ("w", ck.w, cp.w, wcols.expand_as(ck.w)),
        ("elig", ck.plast.elig, cp.plast.elig, wcols.expand_as(ck.plast.elig)),
    ]
    for name, a, b, ok in checks:
        if not close(a, b, ok):
            raise AssertionError(f"{what}: {name} differs from the plain path "
                                 "beyond rtol=1e-5, atol=1e-3")
    dv = ((flat(ck.state.lif.v) - flat(cp.state.lif.v)).abs() * same).max().item()
    dw = ((ck.w - cp.w).abs() * wcols).max().item()
    return ties, dv, dw


# ---------------------------------------------------------------------------
# phase 3: learning rollouts at the snn-fused width
# ---------------------------------------------------------------------------

def learning_net(dev, gen):
    """One shared network at the snn-fused width for the learning phase:
    a 5 % connection list with u8 weights on it, thresholds 500-5000."""
    import torch

    from repro_torch.core import network
    from repro_torch.core.lif import LIFParams

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
    return params, ext


def run_learning_phase(dev, gen):
    """``network.learning_rollout`` (4096 neurons x 32 ticks x batch 8, one
    shared w) for ``stdp`` and ``rstdp`` on ``pallas_fused`` and ``pallas``;
    B5 launches must equal rollouts x 32; then each rollout again with
    telemetry on (every learned bit as off; B5's dw statistics against the
    ``jnp`` learning rollout's ``w' - w`` to rtol=1e-5) and tick by tick."""
    import torch

    from repro_torch.core import network
    from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
    from repro_torch.kernels import lif_step, stdp_update, telemetry, tick_fused
    from repro_torch.plasticity import PlasticityParams, PlasticityState

    params, ext = learning_net(dev, gen)
    rewards = torch.where(torch.arange(TICKS, device=dev) % 4 == 3, 1.0, -0.25)
    rules = {"stdp": PlasticityParams.make("stdp", a_plus=0.5, a_minus=0.25),
             "rstdp": PlasticityParams.make("rstdp", a_plus=0.5, a_minus=0.25,
                                            lr_reward=2.0)}
    runs = [(rule, backend) for rule in rules for backend in ("pallas_fused", "pallas")]
    st0 = network.SNNState.zeros((ROWS,), N, device=dev)
    pst0 = PlasticityState.zeros((ROWS,), N, device=dev)
    w0 = params.w.clone()
    out = {}
    torch.cuda.synchronize()
    lif_step.launches = tick_fused.launches = stdp_update.launches = 0
    t0 = time.perf_counter()
    for rule, backend in runs:
        out[rule, backend] = network.learning_rollout(
            params, st0, pst0, ext, TICKS, plasticity=rules[rule], backend=backend,
            rewards=rewards if rule == "rstdp" else None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"stdp_update": stdp_update.launches, "tick_fused": tick_fused.launches,
                "lif_step": lif_step.launches}
    if launches != {"stdp_update": len(runs) * TICKS, "tick_fused": 2 * TICKS,
                    "lif_step": 2 * TICKS}:
        raise AssertionError(f"learning rollouts: launches {launches}, expected "
                             f"stdp_update {len(runs)} x {TICKS}, tick_fused and lif_step "
                             f"2 x {TICKS}")
    if not torch.equal(params.w, w0):
        raise AssertionError("learning_rollout wrote the caller's weights")
    log(f"learning rollouts ({len(runs)} x {TICKS} ticks, batch {ROWS}, {N} neurons): "
        f"launches {launches}; wall {wall:.3f} s")
    for rule, backend in runs:
        (fs, fp, fw), raster = out[rule, backend]
        telemetry.launches = stdp_update.launches = 0
        (ts, tp, tw), traster, tel = network.learning_rollout(
            params, st0, pst0, ext, TICKS, plasticity=rules[rule], backend=backend,
            rewards=rewards if rule == "rstdp" else None, telemetry=True)
        torch.cuda.synchronize()
        if not (torch.equal(tw, fw) and torch.equal(traster, raster) and same_state(ts, fs)
                and torch.equal(tp.elig, fp.elig) and torch.equal(tp.x_post, fp.x_post)):
            raise AssertionError(f"learning {rule}/{backend}: telemetry on changed a bit")
        t_launches = telemetry.launches
        if t_launches != TICKS or stdp_update.launches != TICKS \
                or not float(tel.dw_l1.min()) > 0:
            raise AssertionError(f"learning {rule}/{backend} with telemetry: launches "
                                 f"{telemetry.launches} telemetry, {stdp_update.launches} "
                                 f"stdp_update, dw_l1 {tel.dw_l1.tolist()}")
        if raster.shape != (TICKS, ROWS, N) or not torch.isfinite(fw).all():
            raise AssertionError(f"learning {rule}/{backend}: bad raster or non-finite w")
        moved = (fw - w0).abs().max().item()
        if moved == 0.0 or fw.min() < 0.0 or fw.max() > 255.0:
            raise AssertionError(f"learning {rule}/{backend}: w moved {moved}, range "
                                 f"[{fw.min().item()}, {fw.max().item()}]")
        kernel_eng = TickEngine(EngineOptions(backend=backend, plasticity=rules[rule]))
        plain_eng = TickEngine(EngineOptions(backend="jnp", plasticity=rules[rule],
                                             plasticity_backend="jnp"))
        carry0 = TickCarry(state=st0, plast=pst0, w=params.w)
        reward_at = (lambda t: rewards[t]) if rule == "rstdp" else (lambda t: None)
        ck, ties, dv, dw = check_learning_ticks(
            kernel_eng, plain_eng, params, carry0, TICKS, lambda t: ext[t], reward_at,
            plastic_c=params.c, what=f"learning {rule}/{backend}")
        if not (torch.equal(ck.w, fw) and torch.equal(ck.state.lif.v, fs.lif.v)
                and torch.equal(ck.plast.elig, fp.elig)):
            raise AssertionError(f"learning {rule}/{backend}: the tick-by-tick kernel chain "
                                 "differs from the rollout (in place vs out of place)")
        (_, _, pw), praster, ptel = network.learning_rollout(
            params, st0, pst0, ext, TICKS, plasticity=rules[rule], backend="jnp",
            rewards=rewards if rule == "rstdp" else None, telemetry=True)
        dw_rel = ((tel.dw_l1 - ptel.dw_l1).abs() / ptel.dw_l1).max().item()
        if torch.equal(praster, raster) and torch.equal(pw, fw) and dw_rel > 1e-5:
            raise AssertionError(f"learning {rule}/{backend}: B5's dw_l1 {tel.dw_l1[0]} against "
                                 f"jnp's {ptel.dw_l1[0]} (rel {dw_rel:.3g} > 1e-5)")
        log(f"learning {rule}/{backend}: tick by tick == plain path (rtol=1e-5, atol=1e-3), "
            f"{ties} rounding ties, max |dv| {dv:.3g}, max |dw| {dw:.3g}; |w - w0| up to "
            f"{moved:.3f}, spike rate {raster.mean().item():.4f}; free-running against jnp: "
            f"{int((praster != raster).sum())} raster entries differ, max |dw| "
            f"{(pw - fw).abs().max().item():.3g}; telemetry on: every bit as off, "
            f"{t_launches} launches, dw_l1 {tel.dw_l1[0].item():.6g} (B5 statistics) "
            f"against jnp's {ptel.dw_l1[0].item():.6g} (rel {dw_rel:.2g}), dw_l2 "
            f"{tel.dw_sq[0].sqrt().item():.6g}")
    return launches


# ---------------------------------------------------------------------------
# phase 4: the serving path at snn-fused FULL
# ---------------------------------------------------------------------------

def serve_config():
    """The snn-fused FULL configuration the serve phase runs."""
    from repro_torch.configs import get_bundle

    return get_bundle("snn-fused").model


def serve_once(dev, cfg, backend, *, frozen_only=False, event_density=None, telemetry=True):
    """Serve the demo tenants' 16 requests (``frozen_only``: those of the
    frozen tenants) on a fresh server (``event_density``: with the event
    program; ``telemetry``: the server's default, on); returns the server,
    the requests, the stats, the kernel launches, the wall time, the waves'
    request ids and the plastic tenants' weights before and after each wave
    (copies taken around ``run_wave``)."""
    import torch

    from repro_torch.kernels import event_dispatch, lif_step, stdp_update, telemetry as tk
    from repro_torch.kernels import tick_fused
    from repro_torch.launch.serve import SNNServer, make_demo_requests, make_demo_tenants

    server = SNNServer(n_max=cfg.n_neurons, slots=SLOTS, max_ticks=cfg.n_ticks,
                       mode=cfg.snn_mode, backend=backend, device=dev,
                       event_density=event_density, telemetry=telemetry)
    names = make_demo_tenants(server, SLOTS, seed=0)
    reqs = make_demo_requests(server, names, 2 * SLOTS, seed=1)
    plastic = [n for n in names if server.tenants[n].plastic]
    if frozen_only:
        reqs = [r for r in reqs if r.tenant not in plastic]
    waves, snaps = [], {n: [server.tenants[n].params.w.clone()] for n in plastic}
    run_wave = server.run_wave

    def logged(wave):
        waves.append([(r.rid, r.tenant) for r in wave if r.rid >= 0])
        run_wave(wave)
        for n in plastic:
            snaps[n].append(server.tenants[n].params.w.clone())

    server.run_wave = logged
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lif_step.launches = tick_fused.launches = stdp_update.launches = tk.launches = 0
    event_dispatch.launches = event_dispatch.launches_db = 0
    t0 = time.perf_counter()
    stats = server.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"tick_fused": tick_fused.launches, "lif_step": lif_step.launches,
                "stdp_update": stdp_update.launches, "telemetry": tk.launches}
    if event_density is not None:
        launches.update(event_dispatch_db=event_dispatch.launches_db,
                        event_dispatch=event_dispatch.launches)
    log(f"serve {backend}{' (frozen tenants only)' if frozen_only else ''}"
        f"{'' if telemetry else ' (telemetry off)'}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del server.run_wave   # no cycle through the closure: the server frees on last use
    return server, reqs, stats, launches, wall, waves, snaps


def serve_both(dev, cfg, **kw):
    """:func:`serve_once` on ``jnp``, then on the config's kernel backend; the
    ``jnp`` server is dropped first, so each peak holds one server."""
    plain = (None,) + serve_once(dev, cfg, "jnp", **kw)[1:]
    return plain, serve_once(dev, cfg, cfg.snn_backend, **kw)


def check_learning_waves(server, reqs, waves, snaps):
    """Gate (c) on every learning wave of the kernel server: rebuild the
    wave's inputs with the plastic tenant's weights as they were before it,
    run it tick by tick through the kernels and the plain path, and require
    the kernel chain to end on the weights the served wave wrote back."""
    import dataclasses

    from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
    from repro_torch.core.network_types import SNNState
    from repro_torch.launch.serve import ServeRequest
    from repro_torch.plasticity import PlasticityState

    import numpy as np
    import torch

    plain = TickEngine(dataclasses.replace(server.engine.options, backend="jnp",
                                           plasticity_backend="jnp"))
    by_rid = {r.rid: r for r in reqs}
    total_ties, n_checked = 0, 0
    for i, wave in enumerate(waves):
        learners = [t for _, t in wave if server.tenants[t].plastic]
        if not learners:
            continue
        for t in learners:
            server.tenants[t].params = dataclasses.replace(server.tenants[t].params,
                                                           w=snaps[t][i].clone())
        wave_reqs = [by_rid[rid] for rid, _ in wave]
        while len(wave_reqs) < server.slots:
            wave_reqs.append(ServeRequest(rid=-1, tenant=wave_reqs[0].tenant,
                                          ext=np.zeros((1, 1), np.float32), n_ticks=0))
        params, ext, _, learn_until, rewards = server._assemble(wave_reqs)
        S, N = server.slots, server.n_max
        carry = TickCarry(state=SNNState.zeros((S,), N, device=server.device),
                          plast=PlasticityState.zeros((), N, device=server.device, slots=S),
                          w=params.w)
        ck, ties, dv, dw = check_learning_ticks(
            server.engine, plain, params, carry, server.max_ticks, lambda t: ext[t],
            lambda t: rewards[t], learn_until=learn_until,
            what=f"serve wave {i + 1}")
        for slot, (_, t) in enumerate(wave):
            if server.tenants[t].plastic and not torch.equal(ck.w[slot], snaps[t][i + 1]):
                raise AssertionError(f"serve wave {i + 1}: the tick-by-tick kernel chain "
                                     f"ends off the weights written back to {t}")
        total_ties += ties
        n_checked += 1
        log(f"serve wave {i + 1} (learns {learners}): tick by tick == plain path "
            f"(rtol=1e-5, atol=1e-3), {ties} rounding ties, max |dv| {dv:.3g}, "
            f"max |dw| {dw:.3g}")
    return n_checked, total_ties


def run_frozen_serve(dev, cfg):
    """The frozen-only waves (no plastic tenant in them): the hoisted frozen
    rollout, bitwise equal to the ``jnp`` server on every request."""
    import torch

    plain, kernel = serve_both(dev, cfg, frozen_only=True)
    _, reqs_j, stats_j, _, wall_j, waves_j, _ = plain
    server, reqs_f, stats_f, launches, wall_f, waves, snaps = kernel
    if not reqs_f or any(server.tenants[r.tenant].plastic for r in reqs_f):
        raise AssertionError("serve (frozen): expected requests of frozen tenants only")
    for rj, rf in zip(reqs_j, reqs_f):
        if not np_equal(rf.counts, rj.counts) or rf.pred != rj.pred:
            raise AssertionError(f"serve (frozen): request {rf.rid} differs from jnp")
    n_waves = stats_f["waves"]
    if waves != waves_j or stats_f["n_requests"] != len(reqs_f) or n_waves < 2:
        raise AssertionError("serve (frozen): expected >= 2 waves, the same on both servers")
    expected = {"tick_fused": n_waves * cfg.n_ticks, "lif_step": 0, "stdp_update": 0,
                "telemetry": n_waves * cfg.n_ticks}
    if launches != expected:
        raise AssertionError(f"serve (frozen): launches {launches}, expected {expected}")
    if not all(torch.equal(w, ws[0]) for ws in snaps.values() for w in ws):
        raise AssertionError("serve (frozen): a plastic tenant's weights changed")
    log(f"serve (frozen tenants only): {stats_f['n_requests']} requests in {n_waves} waves, "
        f"every count and prediction == jnp bitwise; wall per wave {wall_f / n_waves:.4f} s "
        f"({cfg.snn_backend}), {wall_j / stats_j['waves']:.4f} s (jnp); launches {launches}")
    return launches


def check_telemetry_serve(dev, cfg, server, reqs, snaps, learner):
    """The served waves with telemetry on (the server's default) against the
    same requests served with it off: every count, prediction and learned
    weight bitwise equal, no telemetry launch when off; then the per-tenant
    report and the registry's counters, checked against the served requests."""
    import torch

    off = serve_once(dev, cfg, cfg.snn_backend, telemetry=False)
    _, reqs_o, stats_o, launches_o, _, _, snaps_o = off
    for rf, ro in zip(reqs, reqs_o):
        if not np_equal(rf.counts, ro.counts) or rf.pred != ro.pred:
            raise AssertionError(f"serve: request {rf.rid} differs with telemetry off")
    if not all(torch.equal(a, b) for a, b in zip(snaps[learner], snaps_o[learner])):
        raise AssertionError(f"serve: {learner} learned other weights with telemetry off")
    if launches_o["telemetry"] != 0 or server.tenant_report() == {}:
        raise AssertionError(f"serve: telemetry off launched {launches_o}, or no report on")
    reg = server.registry.to_dict()
    value = lambda name, labels="": reg[name]["values"].get(labels, 0.0)
    report = server.tenant_report()
    spikes = sum(float(r.counts.sum()) for r in reqs)
    if value("snn_requests_total") != len(reqs) or value("snn_spikes_out_total") != spikes \
            or sum(row["requests"] for row in report.values()) != len(reqs):
        raise AssertionError(f"serve: registry or report off the served requests: {reg}")
    for name, row in report.items():
        log(f"serve tenant_report {name}: " + ", ".join(f"{k}={v}" for k, v in row.items()))
    log("serve registry: " + ", ".join(
        f"{name}{labels} {v}" for name in ("snn_requests_total", "snn_waves_total",
                                           "snn_spikes_out_total",
                                           "snn_event_overflow_ticks_total",
                                           "snn_event_policy_dense_ticks_total",
                                           "snn_weight_delta_l1_total")
        for labels, v in reg[name]["values"].items()))
    log(f"serve: telemetry on (the default) == off bitwise: every count, prediction and "
        f"learned weight of {len(reqs)} requests; launches off {launches_o}")


def run_serve_phase(dev):
    import numpy as np

    from repro_torch.core.registers import RegisterBank, WeightLayout
    from repro_torch.plasticity import quantize_weights, weights_to_bank

    cfg = serve_config()
    frozen_launches = run_frozen_serve(dev, cfg)
    plain, kernel = serve_both(dev, cfg)
    _, reqs_j, stats_j, _, wall_j, waves_j, snaps_j = plain
    server, reqs_f, stats_f, launches, wall_f, waves, snaps = kernel
    plastic = sorted(snaps)
    if len(plastic) != 1:
        raise AssertionError(f"serve: expected one plastic demo tenant, got {plastic}")
    learner = plastic[0]
    n_diff = 0
    for rj, rf in zip(reqs_j, reqs_f):
        if rf.counts is None:
            raise AssertionError(f"serve: request {rf.rid} got no counts")
        if server.tenants[rf.tenant].plastic:
            n_diff += int((rf.counts != rj.counts).sum())
        elif not np_equal(rf.counts, rj.counts) or rf.pred != rj.pred:
            raise AssertionError(f"serve: frozen request {rf.rid} differs from jnp")
    n_waves = stats_f["waves"]
    learning_waves = sum(any(server.tenants[t].plastic for _, t in w) for w in waves)
    if stats_f["n_requests"] != 2 * SLOTS or n_waves < 2 or waves != waves_j:
        raise AssertionError(f"serve: expected {2 * SLOTS} requests in >= 2 waves, the same "
                             "waves on both servers")
    if any(sum(t == learner for _, t in w) > 1 for w in waves):
        raise AssertionError(f"serve: a wave held two requests of the plastic {learner}")
    if learning_waves < 2:
        raise AssertionError(f"serve: {learner} learned in {learning_waves} waves, expected 2")
    expected = {"tick_fused": n_waves * cfg.n_ticks, "lif_step": 0,
                "stdp_update": learning_waves * cfg.n_ticks,
                "telemetry": n_waves * cfg.n_ticks}
    if launches != expected:
        raise AssertionError(f"serve: launches {launches}, expected {expected} "
                             "(waves x ticks, learning waves x ticks)")
    t = server.tenants[learner]
    w_final = t.params.w
    pp = server.engine.options.plasticity
    live = w_final[:t.n, :t.n]
    moved = (w_final - snaps[learner][0]).abs().max().item()
    if moved == 0.0 or live.min() < pp.w_min or live.max() > pp.w_max:
        raise AssertionError(f"serve: {learner} moved {moved}, range "
                             f"[{live.min().item()}, {live.max().item()}]")
    if (w_final[t.n:].abs().sum() + w_final[:, t.n:].abs().sum()).item() != 0.0:
        raise AssertionError(f"serve: {learner}'s padding learned")
    bank = RegisterBank(t.n, weight_layout=WeightLayout.PER_SYNAPSE)
    bank.set_connection_list(t.params.c[:t.n, :t.n].cpu().numpy() > 0)
    stored = weights_to_bank(bank, live)
    echo = RegisterBank(t.n, weight_layout=WeightLayout.PER_SYNAPSE)
    echo.load_bytes(bank.serialize())
    if echo.serialize() != bank.serialize() or not np.array_equal(echo.weights, stored) \
            or not np.array_equal(stored, quantize_weights(live)):
        raise AssertionError(f"serve: {learner}'s learned weights do not round-trip "
                             "through the register bank")
    n_checked, ties = check_learning_waves(server, reqs_f, waves, snaps)
    dw_servers = (snaps_j[learner][-1] - w_final).abs().max().item()
    for k, v in stats_f.items():
        if k != "results":
            log(f"serve {k}: {v}")
    check_telemetry_serve(dev, cfg, server, reqs_f, snaps, learner)
    log(f"serve: {stats_f['n_requests']} requests in {n_waves} waves ({learning_waves} "
        f"learning); frozen tenants == jnp on the card (counts and preds); plastic "
        f"{learner}: {n_diff} counts differ from jnp, max |dw| against the jnp server "
        f"{dw_servers:.3g}, |w - w0| up to {moved:.3f}, u8 bank round trip byte-exact; "
        f"{n_checked} learning waves tick by tick == plain path, {ties} rounding ties; "
        f"wall per wave {wall_f / n_waves:.4f} s ({cfg.snn_backend}), "
        f"{wall_j / stats_j['waves']:.4f} s (jnp); launches {launches}")
    return launches, frozen_launches


# ---------------------------------------------------------------------------
# phase 4b: continuous admission and the async front-end
# ---------------------------------------------------------------------------

CONT_CHUNK = 8        # chunk_ticks of the continuous phase
CONT_REQUESTS = 64    # the bimodal mix (the reference's benchmark recipe)
CONT_REPS = 3         # timed serves per path; the minimum wall is kept


def make_serving_mix(server, names, n_requests, *, seed):
    """A bimodal serving mix: about 75 % short requests (2 to max_ticks // 8
    ticks), the rest running the full budget; a copy of
    ``benchmarks/bench_serve.py``'s, draw for draw."""
    import numpy as np

    from repro_torch.launch.serve import ServeRequest

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        t = server.tenants[names[i % len(names)]]
        if rng.random() < 0.75:
            ticks = int(rng.integers(2, max(3, server.max_ticks // 8) + 1))
        else:
            ticks = server.max_ticks
        ext = ((rng.random((ticks, t.n_in)) < 0.3)
               * rng.integers(80, 255, (ticks, t.n_in))).astype(np.float32)
        reqs.append(ServeRequest(rid=i, tenant=t.name, ext=ext, n_ticks=ticks))
    return reqs


def continuous_server(dev, cfg, backend):
    """A server at the serve phase's configuration with ``chunk_ticks`` 8 and
    the 8 demo tenants (the last, ``dense-7``, plastic)."""
    from repro_torch.launch.serve import SNNServer, make_demo_tenants

    server = SNNServer(n_max=cfg.n_neurons, slots=SLOTS, max_ticks=cfg.n_ticks,
                       mode=cfg.snn_mode, backend=backend, chunk_ticks=CONT_CHUNK, device=dev)
    return server, make_demo_tenants(server, SLOTS, seed=0)


def plan_misses() -> dict:
    """Misses of the kernel build and of every launch-plan cache: a miss is a
    rebuild or a new plan."""
    from repro_torch.kernels import _build, _event_plan, _plan, _stream

    return {"build": _build.build.cache_info().misses, "B1/B2": _plan.plan.cache_info().misses,
            "B5": _stream.stdp_plan.cache_info().misses,
            "B6": _stream.spike_matmul_plan.cache_info().misses,
            "B4": _event_plan.event_plan.cache_info().misses}


def watch_chunks(server, log):
    """Run every chunk dispatch of ``server`` under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in it raises) and
    log ``(learning, B2's plan, how)`` after each, ``how`` one of ``eager``,
    ``captured`` (recorded as a CUDA graph, then replayed) and ``replayed``.
    A replay calls no kernel wrapper: its plan is the one the wrapper saw
    while its graph was captured. A frozen chunk that ran its wrappers
    though its size had a graph raises."""
    import torch

    from repro_torch.kernels import tick_fused

    run = server._run_chunk
    captured = {}   # a resident's graph -> B2's plan in its capture

    def watched(res, engine, backend, chunk, *args, learning, **kw):
        tick_fused.last_plan = None
        before = res.graphs.get(chunk)
        torch.cuda.set_sync_debug_mode("error")
        try:
            run(res, engine, backend, chunk, *args, learning=learning, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        plan, graph = tick_fused.last_plan, res.graphs.get(chunk)
        if learning or graph is None:
            how = "eager"
        elif before is None and plan is not None:
            how, captured[graph] = "captured", plan
        elif before is graph and plan is None:
            how, plan = "replayed", captured[graph]
        else:
            raise AssertionError(f"continuous: a frozen chunk of {chunk} ticks ran its "
                                 f"wrappers (plan {plan}) beside its graph")
        log.append((learning, plan, how))

    server._run_chunk = watched


def same_results(a, b) -> bool:
    return all(x.rid == y.rid and np_equal(x.counts, y.counts) and x.pred == y.pred
               for x, y in zip(a, b)) and len(a) == len(b)


def timed_walls(serve) -> dict:
    """The walls of ``CONT_REPS`` serves of fresh mixes (seeds 100, 101, ...),
    by seed; the reference's benchmark keeps the minimum."""
    import torch

    walls = {}
    for rep in range(CONT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(100 + rep)
        torch.cuda.synchronize()
        walls[100 + rep] = time.perf_counter() - t0
    return walls


def host_line(host: dict, chunks: int) -> str:
    return ", ".join(f"{k} {v[0] * 1e6:.1f} us in {v[1]} ({v[0] / max(1, v[1]) * 1e6:.1f} us "
                     f"each, {v[0] / max(1, chunks) * 1e6:.1f} us a chunk)"
                     for k, v in host.items())


def run_async_check(sw, sc, names):
    """An ``AsyncSNNServer`` over the continuous server: the mix submitted
    concurrently while the worker is held at the start of its scheduler run,
    then released; every future resolves, with the results of a direct
    ``serve_continuous`` of the same requests on the twin server. The held
    worker provokes ``queue_full`` (a 65th request with 64 queued) and, in a
    second burst of 8 requests of one tenant, ``tenant_cap``; both counted."""
    import asyncio
    import threading

    import torch

    from repro_torch.launch.serve import ServeRequest
    from repro_torch.launch.serve_async import AsyncSNNServer

    gate, idle = threading.Event(), threading.Event()
    run = sc.serve_continuous

    def held(*args, **kw):
        if not gate.wait(timeout=300):
            raise TimeoutError("the async check never released its worker")
        try:
            return run(*args, **kw)
        finally:
            idle.set()

    sc.serve_continuous = held
    mix = make_serving_mix(sc, names, CONT_REQUESTS, seed=104)
    direct = make_serving_mix(sw, names, CONT_REQUESTS, seed=104)
    tenant = names[0]
    own = [r for r in mix if r.tenant == tenant][:SLOTS]
    burst = [ServeRequest(rid=200 + i, tenant=tenant, ext=r.ext.copy(), n_ticks=r.n_ticks)
             for i, r in enumerate(own)]
    burst_direct = [ServeRequest(rid=r.rid, tenant=tenant, ext=r.ext.copy(), n_ticks=r.n_ticks)
                    for r in burst]
    extra = lambda rid: ServeRequest(rid=rid, tenant=tenant, ext=own[0].ext.copy(),
                                     n_ticks=own[0].n_ticks)

    async def queued(front, n):
        for _ in range(1000):
            if len(front._queue) == n:
                return
            await asyncio.sleep(0)
        raise AssertionError(f"async: expected {n} queued requests, have {len(front._queue)}")

    async def go():
        front = AsyncSNNServer(sc, max_queue=CONT_REQUESTS, tenant_cap=SLOTS)
        try:
            tasks = [asyncio.ensure_future(front.submit(r)) for r in mix]
            await queued(front, CONT_REQUESTS)
            full = await front.submit(extra(900))
            gate.set()
            results = await asyncio.gather(*tasks)
            # The worker's scheduler run polls its feeder once more after the
            # last retire: wait for it to return before holding it again.
            if not await asyncio.get_running_loop().run_in_executor(None, idle.wait, 300):
                raise TimeoutError("async: the worker's first run never returned")
            gate.clear()
            tasks = [asyncio.ensure_future(front.submit(r)) for r in burst]
            await queued(front, len(burst))
            capped = await front.submit(extra(901))
            gate.set()
            results2 = await asyncio.gather(*tasks)
        finally:
            gate.set()
            await front.aclose()
        return full, results, capped, results2

    t0 = time.perf_counter()
    full, results, capped, results2 = asyncio.run(go())
    wall = time.perf_counter() - t0
    sc.serve_continuous = run
    sw.serve_continuous(direct)
    sw.serve_continuous(burst_direct)
    if not (full.rejected and full.reason == "queue_full" and capped.rejected
            and capped.reason == "tenant_cap"):
        raise AssertionError(f"async: expected queue_full and tenant_cap, got {full}, {capped}")
    if any(r.rejected for r in results + results2) or not same_results(direct, results) \
            or not same_results(burst_direct, results2):
        raise AssertionError("async: a result differs from the direct serve_continuous")
    learner = names[-1]
    if not torch.equal(sw.tenants[learner].params.w, sc.tenants[learner].params.w):
        raise AssertionError(f"async: {learner} learned other weights than the direct serve")
    reg = sc.registry
    counts = {reason: reg.get("snn_admission_rejections_total").value(reason=reason)
              for reason in ("queue_full", "tenant_cap", "unknown_tenant", "shutdown")}
    if counts != {"queue_full": 1, "tenant_cap": 1, "unknown_tenant": 0, "shutdown": 0} \
            or reg.get("snn_async_queue_depth").value() != 0 \
            or reg.get("snn_async_submitted_total").value() != CONT_REQUESTS + len(burst):
        raise AssertionError(f"async: rejections {counts}, depth or submissions off")
    ttfts = sorted(r.ttft_s for r in results)
    log(f"async: {len(results)} + {len(results2)} futures resolved, every result == a direct "
        f"serve_continuous of the same requests (and {learner}'s weights); rejections "
        f"{counts}; wall {wall:.4f} s, ttft {ttfts[0]:.4f}-{ttfts[-1]:.4f} s")


def run_continuous_phase(dev):
    """Continuous admission at snn-fused FULL against the wave path (the
    reference's benchmark recipe), then the async front-end; returns the
    continuous run's kernel launches."""
    import torch

    from repro_torch.launch.serve import device_profile, make_demo_requests

    cfg = serve_config()
    sw, names = continuous_server(dev, cfg, cfg.snn_backend)
    sw.serve(make_demo_requests(sw, names, SLOTS, seed=99))
    sc, _ = continuous_server(dev, cfg, cfg.snn_backend)
    chunk_log = []
    watch_chunks(sc, chunk_log)   # from the first chunk: the captures too
    sc.serve_continuous(make_demo_requests(sc, names, SLOTS, seed=99))
    learner = names[-1]
    if not sc.tenants[learner].plastic:
        raise AssertionError(f"continuous: expected {learner} plastic")
    warm_compiles, misses0 = sc.compiles, plan_misses()
    reqs_w = make_serving_mix(sw, names, CONT_REQUESTS, seed=7)
    reqs_c = make_serving_mix(sc, names, CONT_REQUESTS, seed=7)
    t0 = time.perf_counter()
    stats_w = sw.serve(reqs_w)
    torch.cuda.synchronize()
    wall_w1 = time.perf_counter() - t0
    torch.cuda.synchronize()
    warm_log = list(chunk_log)
    del chunk_log[:]
    zero_launches()
    t0 = time.perf_counter()
    stats_c = sc.serve_continuous(reqs_c)
    torch.cuda.synchronize()
    wall_c1 = time.perf_counter() - t0
    launches = kernel_launches()
    misses1 = plan_misses()
    del sc._run_chunk
    host = {k: list(v) for k, v in sc.host_time.items()}
    chunks, learning = stats_c["chunks"], sum(l for l, _, _ in chunk_log)
    replayed = sum(how == "replayed" for _, _, how in chunk_log)
    exact = same_results(reqs_w, reqs_c)
    if not exact:
        raise AssertionError("continuous: a count or prediction differs from the wave path")
    if not torch.equal(sw.tenants[learner].params.w, sc.tenants[learner].params.w):
        raise AssertionError(f"continuous: {learner}'s learned weights differ from the wave "
                             "path's")
    # A chunk replayed from its CUDA graph launches through no wrapper (the
    # profiled serve below counts its kernels on the device); the captured
    # one called them once, while it was recorded. Every frozen chunk but
    # the server's first (the warm-up) runs as its graph.
    eager = chunks - replayed
    expected = {"tick_fused": eager * CONT_CHUNK, "lif_step": 0,
                "stdp_update": learning * CONT_CHUNK, "event_dispatch_db": 0,
                "event_dispatch": 0, "spike_matmul": 0, "telemetry": eager * CONT_CHUNK}
    frozen_eager = sum(not l and how == "eager" for l, _, how in warm_log + chunk_log)
    graphed = sum(how != "eager" for _, _, how in chunk_log)
    if launches != expected or len(chunk_log) != chunks or not 0 < learning < chunks \
            or frozen_eager > 1 or not graphed:
        raise AssertionError(f"continuous: launches {launches}, expected {expected} (chunks "
                             f"{chunks}, learning {learning}, as CUDA graphs {graphed}, of "
                             f"them replayed {replayed}; frozen and eager since the first "
                             f"serve {frozen_eager}, logged {len(chunk_log)})")
    frozen_plans = {(p.has_c, str(p)) for l, p, _ in chunk_log if not l}
    if any(has_c for has_c, _ in frozen_plans) or any(not p.has_c for l, p, _ in chunk_log if l):
        raise AssertionError(f"continuous: a frozen chunk streamed w and c: {frozen_plans}")
    recompiles = sc.compiles - warm_compiles
    if misses1 != misses0 or recompiles or stats_c["recompiles_after_warmup"]:
        raise AssertionError(f"continuous: a rebuild or new plan on the second serve: "
                             f"{misses0} -> {misses1}, compiles {warm_compiles} -> "
                             f"{sc.compiles}")
    # Frozen tenants against the plain jnp server's continuous serve (the
    # frozen tenants' requests alone: their counts do not depend on the
    # schedule).
    sj, _ = continuous_server(dev, cfg, "jnp")
    frozen = [r for r in make_serving_mix(sj, names, CONT_REQUESTS, seed=7)
              if not sj.tenants[r.tenant].plastic]
    sj.serve_continuous(frozen)
    by_rid = {r.rid: r for r in reqs_c}
    if not same_results(frozen, [by_rid[r.rid] for r in frozen]):
        raise AssertionError("continuous: a frozen tenant's counts differ from jnp's")
    del sj
    log(f"continuous: {stats_c['n_requests']} requests in {chunks} chunks of {CONT_CHUNK} "
        f"ticks ({learning} learning, {chunks - learning} frozen on the premasked stack) "
        f"against {stats_w['waves']} waves of {cfg.n_ticks}, {graphed} as CUDA graphs "
        f"({replayed} replayed, {graphed - replayed} captured); every count and prediction == "
        f"the wave path, {learner}'s weights == the wave path's bitwise, {len(frozen)} frozen "
        f"requests == jnp; launches {launches}; no host sync in {chunks} dispatches; plans "
        f"{misses1} (unchanged), compiles {sc.compiles} (unchanged), frozen B2 plan "
        f"{sorted(frozen_plans)}; first walls {wall_w1:.4f} s (wave), {wall_c1:.4f} s")
    log(f"continuous host time, first serve of the mix (no profiler): "
        f"{host_line(host, chunks)}")
    walls_w = timed_walls(lambda s: sw.serve(make_serving_mix(sw, names, CONT_REQUESTS,
                                                              seed=s)))
    chunks_c = {}

    def serve_c(seed):
        chunks_c[seed] = sc.serve_continuous(
            make_serving_mix(sc, names, CONT_REQUESTS, seed=seed))["chunks"]

    walls_c = timed_walls(serve_c)
    last = max(walls_c)
    log(f"continuous host time, timed serve of mix {last} (warm, no profiler): "
        f"{host_line(sc.host_time, chunks_c[last])}")
    log("continuous walls by mix seed (s): wave " + ", ".join(
        f"{k}: {v:.4f}" for k, v in walls_w.items()) + "; continuous " + ", ".join(
        f"{k}: {v:.4f} ({chunks_c[k]} chunks)" for k, v in walls_c.items()))
    wall_w, wall_c = min(walls_w.values()), min(walls_c.values())
    useful = stats_w["useful_slot_ticks"]
    metrics = {
        "continuous_n_requests": CONT_REQUESTS,
        "continuous_chunk_ticks": CONT_CHUNK,
        "continuous_useful_slot_ticks": useful,
        "continuous_goodput_slot_ticks_per_s": round(useful / max(1e-9, wall_c), 1),
        "continuous_p99_ttft_s": stats_c["p99_ttft_s"],
        "continuous_goodput_win_vs_wave": round(wall_w / max(1e-9, wall_c), 3),
        "continuous_wave_exact": bool(exact),
        "continuous_recompiles": recompiles,
        "continuous_wall_s": round(wall_c, 4),
        "wave_wall_s_on_mix": round(wall_w, 4),
        "wave_p99_ttft_s": stats_w["p99_ttft_s"],
    }
    log("continuous metrics: " + json.dumps(metrics))
    # The last timed mix again under the profiler: the same kernels on the
    # same schedule (its device work does not depend on the learned values).
    stats_p, wall_p, busy_p, rows, _ = device_profile(
        lambda: sc.serve_continuous(make_serving_mix(sc, names, CONT_REQUESTS, seed=last)), dev)
    sw.serve(make_serving_mix(sw, names, CONT_REQUESTS, seed=last))   # the same history
    if not torch.equal(sw.tenants[learner].params.w, sc.tenants[learner].params.w):
        raise AssertionError(f"continuous: {learner}'s weights differ from the wave server's "
                             "after the same timed mixes")
    if stats_p["chunks"] != chunks_c[last]:
        raise AssertionError("continuous: the profiled serve ran another schedule")
    # On the device, replays included: every chunk's B2 and telemetry
    # launches, one a tick.
    on_device = {k: sum(n for _, n, key in rows if f"{k}_kernel" in key)
                 for k in ("tick_fused", "telemetry")}
    if on_device != dict.fromkeys(on_device, stats_p["chunks"] * CONT_CHUNK):
        raise AssertionError(f"continuous: the profiled serve's {stats_p['chunks']} chunks "
                             f"launched {on_device} on the device, expected "
                             f"{stats_p['chunks'] * CONT_CHUNK} each")
    log(f"continuous profile (mix seed {last}, {stats_p['chunks']} chunks): "
        + (f"device busy {busy_p:.4f} s, {busy_p / walls_c[last]:.4f} of the unprofiled wall "
           f"{walls_c[last]:.4f} s ({busy_p / wall_p:.4f} of {wall_p:.4f} s under the "
           "profiler); " if busy_p > 0 else
           f"device busy not measured (the profiler recorded no device time; unprofiled "
           f"wall {walls_c[last]:.4f} s)")
        + "; ".join(f"{key[:60]} {us / 1e3:.3f} ms {n}x" for us, n, key in rows[:8])
        + f"; device launches {on_device}")
    clone_ms = device_ms(lambda: sc.tenants[learner].params.w.expand(
        SLOTS, -1, -1).clone(), runs=10)
    log(f"continuous: the learning carry's clone that the owned carry avoids, {SLOTS} x "
        f"{cfg.n_neurons}^2 f32: {clone_ms:.4f} ms device time a learning chunk")
    run_async_check(sw, sc, names)
    return launches


# ---------------------------------------------------------------------------
# phase 5: the event kernels B3 / B4 against their twin
# ---------------------------------------------------------------------------

def event_inputs(gen, dev, *, S=1, B=None, n=None, k=None, rate=0.05, euler=False,
                 slotted=False, spikes_per_row=None):
    """u8-grid inputs of one event-kernel call (K = N presynaptic rows, ``n``
    columns, ``B`` rows, default the snn-event FULL shape): ``W*C`` of u8
    weights on a 5 % mask, the spike lists of a raster at ``rate`` (or with
    exactly ``spikes_per_row[b]`` spikes in row b), integer state, drive and
    rows."""
    import torch

    from repro_torch.kernels import ops

    B = EVENT_ROWS if B is None else B
    n = N if n is None else n
    k = EVENT_K if k is None else k
    K = N
    i32, f32 = torch.int32, torch.float32
    lead = (S,) if slotted else ()
    rnd = lambda lo, hi, shape, dt=f32: torch.randint(
        lo, hi, shape, generator=gen, device=dev, dtype=i32).to(dt)
    mask = (torch.rand(lead + (K, n), generator=gen, device=dev) < 0.05).to(f32)
    wc = rnd(0, 256, lead + (K, n)) * mask
    if spikes_per_row is None:
        s = (torch.rand(lead + (B, K), generator=gen, device=dev) < rate).to(f32)
    else:
        order = torch.rand(lead + (B, K), generator=gen, device=dev).argsort(-1)
        m = torch.as_tensor(spikes_per_row, device=dev).reshape(B, 1)
        s = (order.argsort(-1) < m).to(f32)
    idx, counts, _ = ops.spike_list(s, k)
    row = lead + (n,)
    rows = {"v_th": rnd(1, 40000, row),
            "leak": rnd(0, 16, row) / 16.0 if euler else rnd(0, 9, row),
            "r_ref": rnd(0, 4, row, i32), "gain": torch.ones(row, device=dev),
            "i_bias": rnd(0, 4, row), "v_reset": torch.zeros(row, device=dev)}
    return {"s": s, "idx": idx, "counts": counts, "wc": wc, "wcs": ops.sentinel_rows(wc),
            "v": rnd(-20, 30000, lead + (B, n)), "r": rnd(0, 3, lead + (B, n), i32),
            "drive": rnd(0, 256, lead + (B, n)), "rows": tuple(rows.values())}


def run_event_kernel_phase(dev, gen):
    """B3 and B4 against the twin, and kernel B1's ``run_if`` gate on the
    premasked ``W*C`` against its twin, bitwise, in every case; the gate set
    leaves the prefilled outputs untouched."""
    import torch

    from repro_torch.kernels import event_dispatch, lif_step, ref

    half = EVENT_ROWS // 2
    spike_cases = {
        "snn-event FULL": {},
        "zero-spike rows": {"spikes_per_row": [0] * half + [N // 20] * half},
        "ragged counts": {"spikes_per_row": [b * EVENT_K // EVENT_ROWS
                                             for b in range(EVENT_ROWS)]},
        "counts == k and past k": {"spikes_per_row": [EVENT_K, EVENT_K + 60] * half},
        "N = 37": {"n": 37, "B": 4},
        "slot axis": {"S": 3, "B": 4, "slotted": True},
    }
    errs = {"event_dispatch_db": 0.0, "event_dispatch": 0.0, "lif_step": 0.0}
    cases = 0
    for label, kw in spike_cases.items():
        for euler in (False, True):
            inp = event_inputs(gen, dev, euler=euler, **kw)
            mode = "euler" if euler else "fixed_leak"
            for drive in (True, False):
                d = inp["drive"] if drive else None
                base = (inp["v"], inp["r"], d, *inp["rows"])
                for gate in (None, False, True):
                    skip = None if gate is None else torch.tensor(gate, device=dev)
                    for name, fn, w, walk in (
                            ("event_dispatch_db", event_dispatch.event_lif_dispatch_db,
                             inp["wc"], "live"),
                            ("event_dispatch", event_dispatch.event_lif_dispatch,
                             inp["wcs"], "all")):
                        want = ref.event_lif_dispatch_ref(inp["idx"], inp["counts"], w, *base,
                                                          mode=mode, walk=walk)
                        out = None
                        if gate is not None:
                            out = ref.LIFStepOut(torch.full_like(inp["v"], -7.0),
                                                 torch.full_like(inp["r"], 9),
                                                 torch.full_like(inp["v"], 3.0))
                            if gate:
                                want = ref.LIFStepOut(*(t.clone() for t in out))
                        extra = {"counts": inp["counts"]} if walk == "live" else {}
                        got = fn(inp["idx"], w, *base, mode=mode, skip=skip, out=out, **extra)
                        torch.cuda.synchronize()
                        err = max_abs_err(got, want)
                        errs[name] = max(errs[name], err)
                        if err != 0.0 or not all(torch.equal(g, x) for g, x in zip(got, want)):
                            raise AssertionError(f"{name} ({label}, {mode}, drive={drive}, "
                                                 f"gate={gate}): max |err| {err}")
                        cases += 1
                    if gate is not None:
                        # B1's half of the device-side choice, on the premasked W*C.
                        dense = ref.fused_lif_step_ref(inp["s"], inp["wc"], None, *base,
                                                       mode=mode)
                        out = ref.LIFStepOut(torch.full_like(inp["v"], -7.0),
                                             torch.full_like(inp["r"], 9),
                                             torch.full_like(inp["v"], 3.0))
                        want = dense if gate else ref.LIFStepOut(*(t.clone() for t in out))
                        got = lif_step.fused_lif_step(inp["s"], inp["wc"], None, *base,
                                                      mode=mode, run_if=skip, out=out)
                        torch.cuda.synchronize()
                        err = max_abs_err(got, want)
                        errs["lif_step"] = max(errs["lif_step"], err)
                        if err != 0.0:
                            raise AssertionError(f"lif_step run_if={gate} ({label}, {mode}): "
                                                 f"max |err| {err}")
                        cases += 1
            del inp
    log(f"event kernels: {cases} cases of event_dispatch_db (B3), event_dispatch (B4) and "
        "lif_step's gate equal to their plain twins bitwise (tolerance 0): "
        + ", ".join(spike_cases) + "; fixed_leak and euler; drive on and off; gate "
        "none / clear / set")
    errs["event_dispatch"] = max(errs["event_dispatch"], run_b4_list_cases(dev, gen))
    return errs


def b4_lists(gen, idx, K, *, unsorted=False, dup=False):
    """Spike lists B4 takes though ``ops.spike_list`` never makes them, per
    slot: with ``dup``, the rows ``b % 3 != 1`` with a third of their live
    ids repeated (ascending, then the sentinel K); with ``unsorted``, the
    rows ``b % 3 != 2`` shuffled after that. With both, rows ``b % 3 == 0``
    are repeated and out of order, ``1`` out of order, ``2`` repeated in
    order."""
    import torch

    idx = idx.clone(memory_format=torch.contiguous_format)
    k = idx.shape[-1]
    for lists in idx.reshape(-1, *idx.shape[-2:]):
        for b, row in enumerate(lists):
            if dup and b % 3 != 1:
                live = row[row < K]
                rep = torch.sort(torch.cat([live, live[: max(1, live.numel() // 3)]])).values
                row[:] = K
                row[: min(k, rep.numel())] = rep[:k]
            if unsorted and b % 3 != 2:
                row[:] = row[torch.randperm(k, generator=gen, device=row.device)]
    return idx


def b4_list_kinds(idx, K):
    """Rows (over every slot) whose ids do not ascend, and rows that list a
    live id more than once."""
    flat = idx.reshape(-1, idx.shape[-1])
    down = int((flat.diff(dim=-1) < 0).any(-1).sum())
    ids = flat.sort(-1).values
    repeated = int(((ids.diff(dim=-1) == 0) & (ids[:, 1:] < K)).any(-1).sum())
    return down, repeated


def run_b4_list_cases(dev, gen):
    """Kernel B4 against its twin, bitwise, on what its redesign must still
    take: lists out of order and with repeated ids, float weights (normal,
    on the 5 % mask), more than one group of 16 rows, more slots than one
    pass, a ragged width on the element fill (its lists out of order and
    repeated), a slot axis; every case launched twice, the two results
    bitwise equal. Returns the largest |error| (0.0)."""
    import torch

    from repro_torch.kernels import event_dispatch, ref

    def floats(inp):
        wc = torch.randn(inp["wc"].shape, generator=gen, device=dev) * (inp["wc"] != 0)
        return torch.nn.functional.pad(wc, (0, 0, 0, 1))

    cases = [("float weights", {}, dict(floats=True)),
             ("unsorted lists", {}, dict(unsorted=True)),
             ("repeated ids, float weights", {}, dict(dup=True, floats=True)),
             ("B = 40 (3 groups)", {"B": 40}, dict(floats=True)),
             ("k = 1400 (passes of the lists)", {"k": 1400, "rate": 0.3}, dict(floats=True)),
             ("N = 37, unsorted, repeated", {"n": 37, "B": 4}, dict(unsorted=True, dup=True)),
             ("slot axis, float weights", {"S": 3, "B": 4, "slotted": True},
              dict(floats=True)),
             ("5 slots, unsorted", {"S": 5, "slotted": True}, dict(unsorted=True))]
    plans = []
    for label, kw, how in cases:
        inp = event_inputs(gen, dev, **kw)
        idx = b4_lists(gen, inp["idx"], N, unsorted=how.get("unsorted", False),
                       dup=how.get("dup", False))
        down, repeated = b4_list_kinds(idx, N)
        if (how.get("unsorted") and not down) or (how.get("dup") and not repeated):
            raise AssertionError(f"event_dispatch ({label}): the lists are not what the case "
                                 f"names ({down} rows out of order, {repeated} repeated)")
        wcs = floats(inp) if how.get("floats") else inp["wcs"]
        base = (inp["v"], inp["r"], inp["drive"], *inp["rows"])
        counts = torch.full(idx.shape[:-1], idx.shape[-1], dtype=torch.int32, device=dev)
        want = ref.event_lif_dispatch_ref(idx, counts, wcs, *base, walk="all")
        got = event_dispatch.event_lif_dispatch(idx, wcs, *base)
        again = event_dispatch.event_lif_dispatch(idx, wcs, *base)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0.0 or not all(torch.equal(g, x) for g, x in zip(got, want)):
            raise AssertionError(f"event_dispatch ({label}): max |err| {err}")
        if not all(torch.equal(g, x) for g, x in zip(got, again)):
            raise AssertionError(f"event_dispatch ({label}): two launches differ")
        plans.append(f"{label}: {down} rows out of order, {repeated} with repeated ids; "
                     f"{event_dispatch.last_plan}")
        del inp, idx, wcs, base
    log(f"event_dispatch (B4): {len(cases)} more cases equal to the twin bitwise "
        "(tolerance 0), each launched twice, the two bitwise equal: "
        + ", ".join(label for label, _, _ in cases))
    for line in plans:
        log(f"  plan event_dispatch ({line})")
    return 0.0


def event_bytes(inp, walk):
    """Bytes the event tick must move on these inputs, and its adds: each
    distinct live row of ``W*C`` read once (a row that several batch rows
    spiked is added into each of them from one read, in the same per-row
    order) and, for B4 (``walk="all"``), the all-zero sentinel row once where
    some row has a tail; the spike lists (and B3's counts), the state, drive
    and rows read once, and v', r', y' written once; the adds are sum of
    counts x N (a sentinel slot adds nothing)."""
    import torch

    idx, counts, wc = inp["idx"], inp["counts"], inp["wc"]
    N_, K1 = wc.shape[-1], wc.shape[-2] + 1
    ids = idx.reshape(-1, *idx.shape[-2:]).long()
    ids = ids + K1 * torch.arange(ids.shape[0], device=ids.device).reshape(-1, 1, 1)
    live = torch.arange(idx.shape[-1], device=idx.device) < counts.reshape(
        ids.shape[:2]).unsqueeze(-1)
    distinct = int(torch.unique(ids[live]).numel())
    if walk == "all":
        distinct += int((~live).any(-1).any(-1).sum().item())   # per slot with a tail
    moved = distinct * N_ * 4 + nbytes(idx, counts if walk == "live" else None, inp["v"],
                                       inp["r"], inp["drive"], *inp["rows"]) \
        + 3 * nbytes(inp["v"])
    return moved, int(counts.sum().item()) * N_, distinct


B4_STAGE_ROWS = (64, 128, 256, 384, 448)   # rows a stage, the planner's last


def time_b4_stages(inp, base):
    """B4 at one shape on double buffers of ``B4_STAGE_ROWS`` rows a stage
    (``_event_plan.STAGE_BYTES``, the planner's choice, is the last), each
    launch bitwise equal to the planned one: the times behind the planner's
    stage size."""
    import torch

    from repro_torch.kernels import _event_plan, event_dispatch

    run = lambda: event_dispatch.event_lif_dispatch(inp["idx"], inp["wcs"], *base)
    want = run()
    keep, times = _event_plan.STAGE_BYTES, []
    try:
        for rows in B4_STAGE_ROWS:
            _event_plan.STAGE_BYTES = rows * _event_plan.TILE_N * 4
            _event_plan.event_plan.cache_clear()
            if not all(torch.equal(g, x) for g, x in zip(run(), want)):
                raise AssertionError(f"event_dispatch at {rows} rows a stage differs from the "
                                     "planned launch")
            times.append((rows, device_ms(run), event_dispatch.last_plan.smem))
    finally:
        _event_plan.STAGE_BYTES = keep
        _event_plan.event_plan.cache_clear()
    return ", ".join(f"{r} rows {t:.4f} ms ({s / 1024:.1f} KiB shared)" for r, t, s in times)


def time_event(dev, gen, card):
    """B3, B4, the twin and ``torch.matmul(s, wc)`` at the snn-event FULL
    shape, and at ``counts == k`` (every slot live, no sentinel tail); B4's
    plan under its time, and at FULL B4 on smaller stages; then the crossover sweep of B3 against B1 and
    ``torch.matmul``. Every time is device time (:func:`device_ms`); the
    CUDA-event time of a launch, host overhead included, is logged beside the
    kernels'."""
    import torch

    from repro_torch.kernels import event_dispatch, lif_step, ref

    bw, flops = card
    rows = {}
    for shape, kw in (("snn-event FULL", {}),
                      ("counts == k", {"spikes_per_row": [EVENT_K] * EVENT_ROWS})):
        inp = event_inputs(gen, dev, **kw)
        base = (inp["v"], inp["r"], inp["drive"], *inp["rows"])
        lib = device_ms(lambda: torch.matmul(inp["s"], inp["wc"]))
        for name, fn, w, walk, extra in (
                ("event_dispatch_db", event_dispatch.event_lif_dispatch_db, inp["wc"], "live",
                 {"counts": inp["counts"]}),
                ("event_dispatch", event_dispatch.event_lif_dispatch, inp["wcs"], "all", {})):
            moved, adds, distinct = event_bytes(inp, walk)
            bound = max(moved / bw, adds / flops) * 1e3
            bound_by = "bytes" if moved / bw >= adds / flops else "operations"
            t_ms = device_ms(lambda: fn(inp["idx"], w, *base, **extra))
            e_ms = median_ms(lambda: fn(inp["idx"], w, *base, **extra))
            p_ms = device_ms(lambda: ref.event_lif_dispatch_ref(
                inp["idx"], inp["counts"], w, *base, walk=walk), runs=5)
            if shape == "snn-event FULL":
                rows[name] = {"ms": t_ms, "plain_ms": p_ms, "library_ms": lib,
                              "bound_ms": bound, "bound_by": bound_by}
            log(f"time {name} ({shape}): {t_ms:.4f} ms device time (bound {bound:.4f} ms, "
                f"{100 * bound / t_ms:.0f}% of it, {moved / 2**20:.1f} MiB for {distinct} "
                f"distinct of {int(inp['counts'].sum())} live rows; plain {p_ms:.4f} ms, "
                f"torch.matmul {lib:.4f} ms; {e_ms:.4f} ms a launch by CUDA events, host "
                f"overhead included) at B={EVENT_ROWS} K=N={N} k={EVENT_K}")
            if name == "event_dispatch":
                log(f"plan event_dispatch ({shape}): {event_dispatch.last_plan}")
                if shape == "snn-event FULL":
                    log(f"time event_dispatch ({shape}) by stage size, two stages, each "
                        f"bitwise the planned launch: {time_b4_stages(inp, base)}")
    del inp, base
    # Crossover: B3 against the dense arms, m spikes in every row (k = m).
    sweep = []
    for m in CROSSOVER_M:
        inp = event_inputs(gen, dev, k=m, spikes_per_row=[m] * EVENT_ROWS)
        base = (inp["v"], inp["r"], inp["drive"], *inp["rows"])
        t_ev = device_ms(lambda: event_dispatch.event_lif_dispatch_db(
            inp["idx"], inp["wc"], *base, counts=inp["counts"]))
        t_b1 = device_ms(lambda: lif_step.fused_lif_step(inp["s"], inp["wc"], None, *base))
        t_mm = device_ms(lambda: torch.matmul(inp["s"], inp["wc"]))
        sweep.append((m, t_ev, t_b1, t_mm))
        log(f"crossover m={m}: device time event_dispatch_db {t_ev:.4f} ms, lif_step "
            f"(dense, premasked) {t_b1:.4f} ms, torch.matmul {t_mm:.4f} ms")
        del inp, base
    for label, col in (("lif_step", 2), ("torch.matmul", 3)):
        m_star = crossing(sweep, col)
        if m_star is None:
            log(f"crossover: {label} never beats event_dispatch_db up to m={CROSSOVER_M[-1]} "
                "spikes per row")
        else:
            log(f"crossover: {label} beats event_dispatch_db from m = {m_star:.1f} spikes per "
                f"row; implied gather penalty N / m = {N / m_star:.3f} (GATHER_PENALTY['gpu'] "
                "= 6.0)")
    return rows


def crossing(sweep, col):
    """The spike count where the dense column's time meets the event time,
    interpolated linearly between the sweep points that bracket it."""
    prev = None
    for point in sweep:
        m, t_ev, t_dense = point[0], point[1], point[col]
        if t_dense <= t_ev:
            if prev is None:
                return float(m)
            m0, e0, d0 = prev[0], prev[1], prev[col]
            gap0, gap1 = e0 - d0, t_ev - t_dense
            return m0 + (m - m0) * (-gap0) / (gap1 - gap0)
        prev = point
    return None


# ---------------------------------------------------------------------------
# phase 6: the event rollout at snn-event FULL
# ---------------------------------------------------------------------------

def event_net(dev, gen):
    """The snn-event FULL fabric: ``sparse_random(4096, 0.05)``, u8 weights in
    [0, 3) through a RegisterBank (thresholds 200-255, leak 0-7, refractory
    2: subcritical), and a 0.05-rate impulse drive of 255 modulated over 8
    ticks between 0.02 and 0.08, 32 ticks, batch 16."""
    import numpy as np
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.core import connectivity, network
    from repro_torch.core.registers import RegisterBank, WeightLayout

    cfg = get_bundle("snn-event").model
    n = cfg.n_neurons
    rng = np.random.default_rng(0)
    c = connectivity.sparse_random(n, cfg.snn_density, seed=0)
    bank = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
    bank.set_connection_list(c)
    bank.set_weights((rng.integers(0, 3, (n, n)) * c).astype(np.uint8))
    bank.set_thresholds(rng.integers(200, 256, n).astype(np.uint8))
    bank.set_leak(rng.integers(0, 8, n).astype(np.uint8))
    bank.set_refractory(2)
    params = network.params_from_registers(bank, device=dev)
    t = torch.arange(cfg.n_ticks, device=dev, dtype=torch.float32)
    rate = cfg.snn_rate * (1 + 0.6 * torch.sin(2 * math.pi * t / 8))
    ext = (torch.rand((cfg.n_ticks, EVENT_ROWS, n), generator=gen, device=dev)
           < rate[:, None, None]).float() * 255.0
    return cfg, params, ext


def telemetry_arms(tel):
    """Each network's arms (event, dense on overflow, dense by the knee) from
    its telemetry, read from its first row: ``(ticks - overflow -
    policy_dense, overflow, policy_dense)``, ``(S, 3)`` with a slot axis of
    ``(S, B)`` accumulators, else ``(3,)``."""
    import torch

    first = lambda t: t.reshape(t.shape[0], -1)[:, 0] if t.dim() > 1 else t.reshape(-1)[0]
    ticks, over, policy = (first(t).cpu().long() for t in (tel.ticks, tel.overflow,
                                                            tel.policy_dense))
    return torch.stack([ticks - over - policy, over, policy], dim=-1)


def run_event_rollout_phase(dev, gen):
    """``network.rollout`` on the snn-event FULL fabric through every
    strategy, with telemetry on and off, each bitwise equal to the jnp
    backend; the arms each run took are read from its telemetry. Returns B3's
    launches in the ``topk`` run and B4's in the ``grid`` run."""
    import torch

    from repro_torch.core import dispatch_policy, network
    from repro_torch.core.engine import EngineOptions
    from repro_torch.kernels import event_dispatch, lif_step, telemetry
    from repro_torch.kernels.ops import EventFanIn

    cfg, params, ext = event_net(dev, gen)
    T, n = cfg.n_ticks, cfg.n_neurons
    st0 = network.SNNState.zeros((EVENT_ROWS,), n, max_delay=RING, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fj, rj = network.rollout(params, st0, ext, T)
    torch.cuda.synchronize()
    wall_j = time.perf_counter() - t0
    knee = EVENT_KNEE
    plan = dispatch_policy.plan(params.c, w_in=params.w_in, batch=EVENT_ROWS)
    opts = lambda **kw: EngineOptions(backend="event", event_dispatch="topk", **kw)
    # (label, rollout keywords, whether the tick runs the kernels behind the
    # device flag, each tick's arm then counted by the telemetry)
    runs = [
        ("topk", dict(dispatch="topk"), True),
        ("fan_in", dict(dispatch="fan_in", neighbors=EventFanIn.from_dense(params.c)), False),
        ("dense", dict(dispatch="dense"), False),
        (f"auto (plan: {plan.strategy}, ext_diag {plan.ext_diag}, cap {plan.cap})",
         dict(dispatch=plan), plan.strategy == "topk"),
        (f"topk, knee {knee}", dict(options=opts(event_k_active=EVENT_K, event_knee=knee)),
         True),
        (f"topk, k_active {EVENT_SMALL_K}", dict(options=opts(event_k_active=EVENT_SMALL_K)),
         True),
        ("topk on B4", dict(options=opts(event_k_active=EVENT_K, event_kernel="grid")), True),
    ]
    network.rollout(params, st0, ext[:2], 2, dispatch="topk")       # warm-up
    launches = {}
    for label, kw, gated in runs:
        sync_free = label == "topk"
        if "options" in kw:
            on = dict(kw, options=dataclasses.replace(kw["options"], telemetry=True))
        else:
            on = dict(kw, telemetry=True)
        torch.cuda.synchronize()
        lif_step.launches = event_dispatch.launches = event_dispatch.launches_db = 0
        telemetry.launches = 0
        t0 = time.perf_counter()
        if sync_free:
            torch.cuda.set_sync_debug_mode("error")
        try:
            f, r, tel = network.rollout(params, st0, ext, T, **on)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"event_dispatch_db": event_dispatch.launches_db,
               "event_dispatch": event_dispatch.launches, "lif_step": lif_step.launches}
        launches[label] = got
        t_launches = telemetry.launches
        f_off, r_off = network.rollout(params, st0, ext, T, **kw)
        if not (torch.equal(r, rj) and same_state(f, fj)):
            raise AssertionError(f"event rollout {label}: differs from jnp")
        if not (torch.equal(r_off, r) and same_state(f_off, f)):
            raise AssertionError(f"event rollout {label}: telemetry on changed a bit")
        if t_launches != T or not torch.equal(tel.spikes, r.sum((0, 2))):
            raise AssertionError(f"event rollout {label}: {t_launches} telemetry launches, "
                                 "or its spikes differ from the raster's")
        arms = "all ticks on its one arm"
        ev, over, by_knee = telemetry_arms(tel).tolist()
        if gated:
            arms = (f"arms read from the telemetry: event {ev}, dense on overflow {over}, "
                    f"dense by the knee {by_knee}")
            if ev + over + by_knee != T:
                raise AssertionError(f"event rollout {label}: {arms}, not {T} ticks")
            kernel = "event_dispatch" if "B4" in label else "event_dispatch_db"
            if got[kernel] != T or got["lif_step"] != T:
                raise AssertionError(f"event rollout {label}: launches {got}, expected {T} of "
                                     f"{kernel} and of the gated lif_step")
            if label.startswith("topk, knee") and not (ev and by_knee):
                raise AssertionError(f"event rollout {label}: the knee took one arm only "
                                     f"({arms})")
            if label.startswith("topk, k_active") and not (ev and over):
                raise AssertionError(f"event rollout {label}: no overflow tick ({arms})")
        elif any(got.values()) or over + by_knee:
            raise AssertionError(f"event rollout {label}: launched kernels {got}, arms "
                                 f"{[ev, over, by_knee]}")
        log(f"event rollout {label}: == jnp bitwise (raster and final state), telemetry on "
            f"and off; spike rate "
            f"{r.mean().item():.4f}; {arms}; launches {got}; wall {wall:.4f} s (jnp "
            f"{wall_j:.4f} s)" + ("; no host sync in the tick loop" if sync_free else ""))
    return launches["topk"]["event_dispatch_db"], launches["topk on B4"]["event_dispatch"]


EVENT_SLOTS = 2   # slots of the slot-axis knee run


def knee_arms(raster, k, knee, hysteresis):
    """Each slot's arms, replayed on the host from a raster ``(T, S, B, n)``
    by the reference's rule: the spikes arriving at tick t are those emitted
    at t - 1 (none at t = 0); a slot overflows when one of its rows passes
    ``k``, goes dense by the knee past ``min(knee, k)`` or, once dense, until
    it falls to ``hysteresis`` of that; returns ``(S, 3)`` counts (event,
    dense on overflow, dense by the knee)."""
    import torch

    T, S = raster.shape[:2]
    m = torch.zeros((T, S), dtype=torch.int64)
    m[1:] = (raster[:-1] > 0).sum(-1).amax(-1).cpu()
    hi = min(knee, k)
    lo = int(hi * hysteresis)
    arms = torch.zeros((S, 3), dtype=torch.int64)
    prev = torch.zeros(S, dtype=torch.bool)
    for t in range(T):
        dense = (m[t] > hi) | (prev & (m[t] > lo))
        over = m[t] > k
        arm = torch.where(over, 1, torch.where(dense, 2, 0))
        arms[torch.arange(S), arm] += 1
        prev = dense
    return arms


def run_event_slots_phase(dev, gen):
    """The snn-event FULL fabric on a slot axis of ``EVENT_SLOTS`` networks
    with the knee armed: slot 0 under the fabric's drive, slot 1 under a
    drive cut to a tenth. Every slot decides its own arm, as the reference
    does per network under vmap: the rasters and final state equal the jnp
    backend's bitwise, and each slot's arms, read from its per-slot
    telemetry, equal the arms replayed on the host from the jnp raster."""
    import torch

    from repro_torch.core import network
    from repro_torch.core.engine import EngineOptions
    from repro_torch.kernels import event_dispatch, lif_step

    cfg, params, ext = event_net(dev, gen)
    T, n, S = cfg.n_ticks, cfg.n_neurons, EVENT_SLOTS
    stack = lambda t: t.unsqueeze(0).expand((S,) + t.shape).contiguous()
    lif = params.lif
    slotted = network.SNNParams(
        w=stack(params.w), c=stack(params.c), w_in=stack(params.w_in),
        lif=type(lif)(**{f.name: stack(getattr(lif, f.name)) for f in dataclasses.fields(lif)}))
    quiet = ext * (torch.rand(ext.shape, generator=gen, device=dev) < 0.1)
    ext_s = torch.stack([ext, quiet], dim=1)                   # (T, S, B, n)
    st0 = network.SNNState.zeros((S, EVENT_ROWS), n, max_delay=RING, device=dev)
    fj, rj = network.rollout(slotted, st0, ext_s, T)
    opts = EngineOptions(backend="event", event_dispatch="topk", event_k_active=EVENT_K,
                         event_knee=EVENT_KNEE, telemetry=True)
    torch.cuda.synchronize()
    lif_step.launches = event_dispatch.launches_db = 0
    f, r, tel = network.rollout(slotted, st0, ext_s, T, options=opts)
    torch.cuda.synchronize()
    same = (torch.equal(r, rj) and torch.equal(f.lif.v, fj.lif.v)
            and torch.equal(f.lif.r, fj.lif.r) and torch.equal(f.delay_buf, fj.delay_buf))
    if not same:
        raise AssertionError("event rollout on a slot axis with the knee: differs from jnp")
    want = knee_arms(rj, EVENT_K, EVENT_KNEE, opts.event_hysteresis)
    got = telemetry_arms(tel)
    if not torch.equal(got, want) or tuple(tel.overflow.shape) != (S, EVENT_ROWS):
        raise AssertionError(f"event slots: per-slot arms from the telemetry {got.tolist()}, "
                             f"replayed from the jnp raster {want.tolist()}")
    if lif_step.launches != T or event_dispatch.launches_db != T:
        raise AssertionError(f"event slots: launches lif_step {lif_step.launches}, "
                             f"event_dispatch_db {event_dispatch.launches_db}, not {T} each")
    log(f"event rollout on {S} slots, knee {EVENT_KNEE}: == jnp bitwise (raster and final "
        f"state); per-slot arms (event, dense on overflow, dense by the knee) from the "
        f"telemetry {got.tolist()} == replayed from the jnp raster; spike rate per slot "
        f"{[round(x, 4) for x in r.mean(dim=(0, 2, 3)).tolist()]}")


def run_event_learning(dev, gen):
    """One ``learning_rollout`` (stdp) on the event backend at snn-event FULL,
    checked tick by tick against the plain path."""
    import torch

    from repro_torch.core import network
    from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
    from repro_torch.kernels import event_dispatch, stdp_update
    from repro_torch.plasticity import PlasticityParams, PlasticityState

    cfg, params, ext = event_net(dev, gen)
    T, n = cfg.n_ticks, cfg.n_neurons
    rule = PlasticityParams.make("stdp", a_plus=0.5, a_minus=0.25)
    st0 = network.SNNState.zeros((EVENT_ROWS,), n, device=dev)
    pst0 = PlasticityState.zeros((EVENT_ROWS,), n, device=dev)
    w0 = params.w.clone()
    torch.cuda.synchronize()
    event_dispatch.launches_db = stdp_update.launches = 0
    (fs, fp, fw), raster = network.learning_rollout(params, st0, pst0, ext, T,
                                                    plasticity=rule, backend="event")
    torch.cuda.synchronize()
    got = {"event_dispatch_db": event_dispatch.launches_db,
           "stdp_update": stdp_update.launches}
    if got != {"event_dispatch_db": T, "stdp_update": T}:
        raise AssertionError(f"event learning: launches {got}, expected {T} each")
    moved = (fw - w0).abs().max().item()
    if moved == 0.0 or not torch.equal(params.w, w0):
        raise AssertionError(f"event learning: w moved {moved}, or the caller's w was written")
    kernel_eng = TickEngine(EngineOptions(backend="event", plasticity=rule))
    plain_eng = TickEngine(EngineOptions(backend="jnp", plasticity=rule,
                                         plasticity_backend="jnp"))
    ck, ties, dv, dw = check_learning_ticks(
        kernel_eng, plain_eng, params, TickCarry(state=st0, plast=pst0, w=params.w), T,
        lambda t: ext[t], lambda t: None, plastic_c=params.c, what="event learning")
    if not torch.equal(ck.w, fw):
        raise AssertionError("event learning: the tick-by-tick kernel chain differs from "
                             "the rollout")
    log(f"event learning stdp ({T} ticks, batch {EVENT_ROWS}, {n} neurons): tick by tick == "
        f"plain path (rtol=1e-5, atol=1e-3), {ties} rounding ties, max |dv| {dv:.3g}, max "
        f"|dw| {dw:.3g}; |w - w0| up to {moved:.3f}; launches {got}")
    return got


# ---------------------------------------------------------------------------
# phase 7: serving with the event program
# ---------------------------------------------------------------------------

def run_event_serve_phase(dev):
    """The serve phase's server with ``event_density=0.2`` against the ``jnp``
    server without the event program: every frozen tenant bitwise equal."""
    cfg = serve_config()
    _, reqs_j, stats_j, _, wall_j, _, _ = serve_once(dev, cfg, "jnp")
    server, reqs_f, stats_f, launches, wall_f, waves, _ = serve_once(
        dev, cfg, cfg.snn_backend, event_density=0.2)
    on_event = sorted(n for n, t in server.tenants.items() if t.backend == "event")
    if not on_event or any(server.tenants[n].plastic for n in on_event):
        raise AssertionError(f"event serve: tenants on the event program {on_event}")
    for rj, rf in zip(reqs_j, reqs_f):
        if server.tenants[rf.tenant].plastic:
            continue
        if not np_equal(rf.counts, rj.counts) or rf.pred != rj.pred:
            raise AssertionError(f"event serve: frozen request {rf.rid} ({rf.tenant}) "
                                 "differs from jnp")
    by_backend = {}
    for wave in waves:
        backends = {server.tenants[t].backend for _, t in wave}
        if len(backends) != 1:
            raise AssertionError(f"event serve: a wave mixed programs {backends}")
        b = backends.pop()
        by_backend[b] = by_backend.get(b, 0) + 1
    learning = sum(any(server.tenants[t].plastic for _, t in w) for w in waves)
    expected = {"tick_fused": by_backend.get(cfg.snn_backend, 0) * cfg.n_ticks,
                "lif_step": 0, "stdp_update": learning * cfg.n_ticks,
                "telemetry": len(waves) * cfg.n_ticks, "event_dispatch_db": 0,
                "event_dispatch": 0}
    if launches != expected or by_backend.get("event", 0) < 1:
        raise AssertionError(f"event serve: launches {launches}, expected {expected}; "
                             f"waves {by_backend}")
    report = server.tenant_report()
    if sorted(n for n, row in report.items() if row["backend"] == "event") != on_event \
            or any(report[n]["overflow_ticks"] or report[n]["policy_dense_ticks"]
                   for n in on_event):
        raise AssertionError(f"event serve: tenant report {report}")
    log(f"event serve: {stats_f['n_requests']} requests in {stats_f['waves']} waves "
        f"{by_backend} ({learning} learning), event program (fan-in cap {server.event_cap}) "
        f"for {on_event}; every frozen count and prediction == jnp without the event "
        f"program; wall {wall_f:.4f} s against {wall_j:.4f} s (jnp, {stats_j['waves']} "
        f"waves); launches {launches}; tenant report of the event tenants (fan-in: no "
        f"overflow, no knee) " + "; ".join(
            f"{n} spike_rate {report[n]['spike_rate']} dispatch {report[n]['dispatch']}"
            for n in on_event))
    return by_backend


# ---------------------------------------------------------------------------
# phase 8: the telemetry kernel, B5's dw statistics and telemetry's overhead
# ---------------------------------------------------------------------------

# The telemetry kernel's shapes: (slots, rows, width). The served wave (8
# slots of one row at 4096), the event rollout's one network of 16 rows
# (0-d flags), a ragged width on a slot axis.
TELEMETRY_SHAPES = ((SLOTS, 1, N), (1, EVENT_ROWS, N), (3, 2, 37))
# Which per-tick operands ride along: none (a frozen dense wave), the dw
# partials (a learning wave), the overflow flag (the event arm), and the
# flag, the knee's gate and the partials together.
TELEMETRY_FORMS = ("frozen", "learning", "event", "knee")
# Kernel B5's registers per instantiation before it gained the dw statistics
# (ptxas for sm_90a): the instantiations without the statistics must keep them.
B5_REGISTERS = {"stdp_update_kernelILb0ELb0EE": 120, "stdp_update_kernelILb1ELb0EE": 117,
                     "stdp_update_element_kernelILb0EE": 93}
OVERHEAD_PAIRS = 9   # interleaved off/on pairs, as the reference's gate takes them
OVERHEAD_FLOOR = 0.9  # the reference's floor on telemetry-on / -off ticks/s


def telemetry_inputs(gen, dev, S, B, n, form, *, grid=True, int_state=False, parts=5):
    """One tick's operands of the telemetry kernel and a random start: 0/1
    spikes, potentials on the integer grid (sums exact below 2^24) or normal
    floats (or int32 state, the int datapath), refractory counters, per-slot
    flags (0-d at S = 1), and dw partials ``(S, parts, 2)``."""
    import torch

    from repro_torch.obs import TickTelemetry

    lead = (S, B) if S > 1 else (B,)
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen, device=dev,
                                             dtype=torch.int32)
    y = (u(*lead, n) < 0.2).float()
    if int_state:
        y, v = y.int(), ri(-300, 3000, lead + (n,))
    elif grid:
        v = ri(-300, 3000, lead + (n,)).float()
    else:
        v = torch.randn(lead + (n,), generator=gen, device=dev) * 50.0
    flag = lambda: (u(S) < 0.5) if S > 1 else (u(1) < 0.5).reshape(())
    over = flag() if form in ("event", "knee") else None
    take = flag() if form == "knee" else None
    dw = u(S, parts, 2) * 10.0 if form in ("learning", "knee") else None
    start = TickTelemetry.zeros(lead, dev).copy_(TickTelemetry(
        ticks=ri(0, 9, lead), spikes=ri(0, 500, lead).float(), v_sum=torch.randn(
            lead, generator=gen, device=dev), v_max=u(*lead) * 100.0, ref_sum=u(*lead),
        overflow=ri(0, 5, lead), policy_dense=ri(0, 5, lead), dw_l1=u(*lead) * 100.0,
        dw_sq=u(*lead) * 1000.0))
    return {"y": y, "v": v, "r": ri(0, 3, lead + (n,)), "over": over, "take_dense": take,
            "dw": dw, "start": start}


def telemetry_twin(tel, inp):
    """The plain twin's fold of ``inp`` into ``tel`` (a new record)."""
    from repro_torch.core.lif import LIFState

    over, take = inp["over"], inp["take_dense"]
    policy = None
    if take is not None:
        policy = (take if over is None else take & ~over).int()
    return tel.accumulate(LIFState(v=inp["v"], r=inp["r"], y=inp["y"]),
                          overflow_inc=None if over is None else over.int(),
                          policy_inc=policy, dw_stats=inp["dw"])


def run_telemetry_kernel_phase(dev, gen):
    """The telemetry kernel against its twin on the card, three ticks from a
    random start, at ``TELEMETRY_SHAPES`` in every ``TELEMETRY_FORMS``:
    ``ticks``, ``spikes``, ``v_max``, ``ref_sum``, ``overflow`` and
    ``policy_dense`` bitwise, ``v_sum`` bitwise on the integer grid and on
    normal floats to 1e-6 of the magnitudes it sums (``|v_sum| + ticks *
    mean |v|``: the neuron sums go in another order, and a mean near zero
    cancels), ``dw_l1``/``dw_sq`` (the partials summed in another order) to
    rtol=1e-6; int32 state (the int datapath) bitwise; two runs bitwise
    equal. Returns the largest |error| over every leaf."""
    import torch

    from repro_torch.kernels import telemetry

    exact = ("ticks", "spikes", "v_max", "ref_sum", "overflow", "policy_dense")
    err, cases = 0.0, 0
    variants = [(True, False), (False, False)]
    for S, B, n in TELEMETRY_SHAPES:
        for form in TELEMETRY_FORMS:
            for grid, int_state in variants + ([(True, True)] if form == "frozen" else []):
                inp = telemetry_inputs(gen, dev, S, B, n, form, grid=grid,
                                       int_state=int_state)
                runs = []
                for _ in range(2):
                    got = inp["start"].clone()
                    for _ in range(3):
                        telemetry.tick_telemetry(got, inp["y"], inp["v"], inp["r"],
                                                 over=inp["over"], take_dense=inp["take_dense"],
                                                 dw_stats=inp["dw"])
                    runs.append(got)
                want = inp["start"]
                for _ in range(3):
                    want = telemetry_twin(want, inp)
                torch.cuda.synchronize()
                what = f"telemetry S={S} B={B} n={n} {form} grid={grid} int={int_state}"
                for f in TELEMETRY_LEAVES:
                    a, b = getattr(runs[0], f), getattr(want, f)
                    if not torch.equal(a, getattr(runs[1], f)):
                        raise AssertionError(f"{what}: two runs differ in {f}")
                    e = (a.double() - b.double()).abs().max().item()
                    err = max(err, e)
                    if f in exact or (f == "v_sum" and grid):
                        if not torch.equal(a, b):
                            raise AssertionError(f"{what}: {f} differs from the twin by {e}")
                    elif f == "v_sum":
                        scale = b.abs() + 3 * inp["v"].abs().float().mean(-1)
                        if not bool(((a - b).abs() <= 1e-6 * scale).all()):
                            raise AssertionError(f"{what}: v_sum differs from the twin by {e}, "
                                                 "past 1e-6 of the magnitudes summed")
                    else:
                        torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=f"{what}: {f}")
                cases += 1
    log(f"telemetry kernel: {cases} cases against the twin (3 ticks each, shapes "
        f"{TELEMETRY_SHAPES}, forms {TELEMETRY_FORMS}, u8 grid, normal floats, int32 state): "
        f"ticks, spikes, v_max, ref_sum, overflow, policy_dense bitwise; v_sum bitwise on the "
        f"grid, 1e-6 of the magnitudes summed on floats; dw_l1/dw_sq rtol=1e-6; two runs "
        f"bitwise equal; max "
        f"|err| {err:.3g}")
    return err


# B5's statistics: (label, rule, slots, rows, width, masks, the gate).
B5_STATS_CASES = (
    ("served learning wave, gate open in slot 7 only", "stdp", SLOTS, 1, N, "ones", "served"),
    ("8 slots, mixed masks, per-slot rewards", "rstdp", SLOTS, 1, N, "mixed", None),
    ("one shared network of 8 rows, 5 % mask", "rstdp", 1, ROWS, N, "sparse", None),
    ("ragged width 37, element fill, gate per slot", "stdp", 3, 1, 37, "mixed", "mixed"),
)


def run_b5_stats_phase(dev, gen):
    """Kernel B5 with its dw statistics: the learned ``w``, ``elig`` and
    traces bitwise those of the launch without them; each slot's statistics
    against the twin's ``sum |w' - w|`` and ``sum (w' - w)^2`` to rtol=1e-5
    (exact zeros in a closed slot); two launches bitwise equal."""
    import torch

    from repro_torch.kernels import ref, stdp_update

    worst = 0.0
    for label, rule, S, B, n, masks, gated in B5_STATS_CASES:
        slotted = S > 1
        inp = stdp_inputs(gen, dev, S, B, n, n, slotted=slotted, masks=masks)
        reward = (torch.linspace(-1.5, 2.0, S, device=dev) if slotted
                  else torch.tensor(0.75, device=dev))
        gate = {}
        if gated:
            until = [0] * (S - 1) + [TICKS] if gated == "served" else [8, 0, 100][:S]
            gate = {"tick": torch.tensor(3, dtype=torch.int32, device=dev),
                    "learn_until": torch.tensor(until, dtype=torch.int32, device=dev)}
        hyper = stdp_hyper(rule)
        args = [inp[k] for k in STDP_ARGS]

        def launch(stats):
            w, e = inp["w"].clone(), inp["elig"].clone()
            return stdp_update.fused_stdp_step(*args[:4], w, args[5], e, reward, in_place=True,
                                               dw_stats=stats, **gate, **hyper)

        plain = launch(False)
        out, stats = launch(True)
        _, again = launch(True)
        _, twin = ref.fused_stdp_step_ref(*args, reward, dw_stats=True, **gate, **hyper)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(plain, out)):
            raise AssertionError(f"stdp_update ({label}): the statistics changed a learned bit")
        if not torch.equal(stats, again):
            raise AssertionError(f"stdp_update ({label}): two launches' statistics differ")
        got, want = stats.sum(1), twin.sum(1)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0,
                                   msg=f"stdp_update ({label}) statistics")
        closed = [i for i in range(S) if gate and int(gate["learn_until"][i]) <= 3]
        if any(stats[i].abs().sum().item() != 0.0 for i in closed):
            raise AssertionError(f"stdp_update ({label}): a closed slot has statistics")
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        worst = max(worst, rel)
        log(f"stdp_update dw statistics ({label}): {tuple(stats.shape)} partials per (slot, "
            f"block), sum |dw| per slot {[round(x, 3) for x in got[:, 0].tolist()]} against "
            f"the twin's within rel {rel:.2g} (rtol 1e-5); learned tensors bitwise those of "
            f"the launch without statistics; two launches bitwise equal; plan "
            f"{stdp_update.last_plan.fill}, {stdp_update.last_plan.blocks} blocks")
        del inp, args, plain, out
    return worst


def time_telemetry(dev, gen, card):
    """The telemetry kernel at the served wave's shape (8 slots x 4096), in
    the frozen form and the learning form (B5's partials), by profiler
    device time per launch, beside its twin and its byte bound; and B5 at
    the served learning wave without and with its statistics, in turns, the
    L2 flushed before each launch. Returns the telemetry kernel's JSON row
    (the learning form)."""
    import torch

    from repro_torch.kernels import stdp_update, telemetry

    bw, flops = card
    # B5 without and with its statistics, in turns.
    inp = stdp_inputs(gen, dev, SLOTS, 1, N, N, masks="ones")
    reward = torch.full((SLOTS,), 0.5, device=dev)
    gate = {"tick": torch.zeros((), dtype=torch.int32, device=dev),
            "learn_until": torch.tensor([0] * (SLOTS - 1) + [TICKS], dtype=torch.int32,
                                        device=dev)}
    args = [inp[k] for k in STDP_ARGS]
    hyper = stdp_hyper("stdp")
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    t = paired_ms({
        "without": lambda: stdp_update.fused_stdp_step(*args, reward, in_place=True, **gate,
                                                       **hyper),
        "with": lambda: stdp_update.fused_stdp_step(*args, reward, in_place=True,
                                                    dw_stats=True, **gate, **hyper)},
        flush=flush)
    _, partials = stdp_update.fused_stdp_step(*args, reward, in_place=True, dw_stats=True,
                                              **gate, **hyper)
    log(f"time stdp_update (served learning wave) without its statistics {t['without']:.4f} "
        f"ms, with them {t['with']:.4f} ms ({100 * (t['with'] / t['without'] - 1):+.1f} %), "
        f"in turns, L2 flushed before each launch")
    del flush, inp, args
    rows = {}
    for form in ("frozen", "learning"):
        tin = telemetry_inputs(gen, dev, SLOTS, 1, N, "frozen")
        dw = partials if form == "learning" else None
        tel = tin["start"]
        kernel = device_ms(lambda: telemetry.tick_telemetry(tel, tin["y"], tin["v"], tin["r"],
                                                            dw_stats=dw))
        tin["dw"] = dw
        plain = device_ms(lambda: telemetry_twin(tel, tin))
        moved = nbytes(tin["y"], tin["v"], tin["r"], dw) + 2 * nbytes(
            *(getattr(tel, f) for f in TELEMETRY_LEAVES))
        ops = 5 * tin["v"].numel()
        bound = max(moved / bw, ops / flops) * 1e3
        extra = "" if dw is None else f", B5 partials {tuple(dw.shape)}"
        log(f"time telemetry ({form} form{extra}): "
            f"{kernel:.4f} ms device time per launch at S={SLOTS} B=1 n={N} (bound {bound:.6f} ms "
            f"for {moved / 2**10:.1f} KiB, bytes; launch-bound), plain twin {plain:.4f} ms; no "
            f"single PyTorch call computes this function (four reductions and nine updates)")
        rows[form] = {"ms": kernel, "plain_ms": plain, "library_ms": None, "bound_ms": bound,
                      "bound_by": "bytes" if moved / bw >= ops / flops else "operations"}
    return rows["learning"]


def overhead_pairs(run_off, run_on, pairs=OVERHEAD_PAIRS):
    """The reference's gate method: interleaved off/on runs (each ended by a
    synchronize), the median of the per-pair wall ratios off / on (the
    on/off ticks/s ratio), and each side's best wall."""
    import torch

    run_off(), run_on()
    torch.cuda.synchronize()
    ratios, best = [], {"off": float("inf"), "on": float("inf")}
    for _ in range(pairs):
        walls = {}
        for name, fn in (("off", run_off), ("on", run_on)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            best[name] = min(best[name], walls[name])
        ratios.append(walls["off"] / walls["on"])
    return statistics.median(ratios), best, ratios


def gate_verdict(ratio) -> str:
    return ("meets" if ratio >= OVERHEAD_FLOOR else "MISSES") + f" the {OVERHEAD_FLOOR} floor"


def run_telemetry_overhead(dev):
    """Telemetry-on against telemetry-off ticks/s by the reference's gate
    method, at its gate point (n = 1024, batch 4, 8 ticks, max_delay 4,
    ``jnp``; its ``_sweep_case``: a 50 % sparse_random fabric, dyadic u8-grid
    weights near 2/sqrt(n), v_th 1, leak 0.1, refractory 1, a 0.1-rate
    drive) and on the served snn-fused FULL waves (``pallas_fused``, the 16
    demo requests: the 14 of frozen tenants, then all 16 with the learning
    waves). A miss is printed with its numbers, not raised."""
    import numpy as np
    import torch

    from repro_torch.core import connectivity, network
    from repro_torch.core.lif import LIFParams
    from repro_torch.launch.serve import SNNServer, make_demo_requests, make_demo_tenants

    n, batch, n_ticks, depth = 1024, 4, 8, 4
    rng = np.random.default_rng(7)
    c = connectivity.sparse_random(n, 0.5, seed=7)
    scale = 2.0 ** round(np.log2(2.0 / np.sqrt(n)))
    w = (rng.integers(0, 256, (n, n)) * (2.0 ** -7) * scale).astype(np.float32)
    params = network.SNNParams(
        w=torch.as_tensor(w, device=dev), c=torch.as_tensor(c, dtype=torch.float32, device=dev),
        w_in=torch.eye(n, device=dev),
        lif=LIFParams.make(n, v_th=1.0, leak=0.1, r_ref=1, device=dev))
    st0 = network.SNNState.zeros((batch,), n, max_delay=depth, device=dev)
    ext = torch.as_tensor((rng.random((n_ticks, batch, n)) < 0.1).astype(np.float32),
                          device=dev)
    off = lambda: network.rollout(params, st0, ext, n_ticks)
    on = lambda: network.rollout(params, st0, ext, n_ticks, telemetry=True)
    ratio, best, ratios = overhead_pairs(off, on)
    (_, r_off), (_, r_on, tel) = off(), on()
    if not torch.equal(r_off, r_on) or not torch.equal(tel.spikes, r_on.sum((0, 2))):
        raise AssertionError("telemetry gate point: telemetry changed the raster or its spikes")
    log(f"telemetry overhead at the reference's gate point (n={n}, batch {batch}, {n_ticks} "
        f"ticks, max_delay {depth}, jnp): on/off ticks/s ratio {ratio:.4f} (median of "
        f"{len(ratios)} interleaved pairs, {min(ratios):.4f}-{max(ratios):.4f}), "
        f"{gate_verdict(ratio)}; off {n_ticks / best['off']:.1f} ticks/s, on "
        f"{n_ticks / best['on']:.1f} ticks/s (best walls); raster equal, spikes == raster sums")
    cfg = serve_config()
    servers = {}
    for flag in (False, True):
        server = SNNServer(n_max=cfg.n_neurons, slots=SLOTS, max_ticks=cfg.n_ticks,
                           mode=cfg.snn_mode, backend=cfg.snn_backend, device=dev,
                           telemetry=flag)
        servers[flag] = (server, make_demo_tenants(server, SLOTS, seed=0))
    results = {}
    for label, frozen_only in (("frozen tenants only", True), ("with the learning waves", False)):
        def serve(flag):
            server, names = servers[flag]
            reqs = make_demo_requests(server, names, 2 * SLOTS, seed=1)
            if frozen_only:
                reqs = [r for r in reqs if not server.tenants[r.tenant].plastic]
            results[flag] = server.serve(reqs)

        ratio, best, ratios = overhead_pairs(lambda: serve(False), lambda: serve(True))
        ticks = results[True]["ticks"]
        if results[True]["preds"] != results[False]["preds"]:
            raise AssertionError(f"telemetry overhead ({label}): predictions differ on/off")
        log(f"telemetry overhead on the served snn-fused FULL waves ({label}, "
            f"{results[True]['n_requests']} requests, {results[True]['waves']} waves, "
            f"{cfg.snn_backend}): on/off ticks/s ratio {ratio:.4f} (median of {len(ratios)} "
            f"interleaved pairs, {min(ratios):.4f}-{max(ratios):.4f}), {gate_verdict(ratio)}; "
            f"off {ticks / best['off']:.1f} ticks/s ({best['off'] * 1e3:.2f} ms), on "
            f"{ticks / best['on']:.1f} ticks/s ({best['on'] * 1e3:.2f} ms) (best walls)")
    servers.clear()


# ---------------------------------------------------------------------------
# phase 9: kernel B6 (spike_matmul) against its plain twin, and its times
# ---------------------------------------------------------------------------

# tests/test_kernels.py's sweep, then predict_int's products (Iris: 45 test
# samples x 4 levels -> 3 outputs; MNIST: 80 test images x 64 pixels -> 10):
# normal weights at the reference's tolerance and the u8 grid bitwise. At the
# snn-fused width (one network of 8 rows) the u8 grid bitwise, and normal
# weights held to a tolerance set by K: the reference states 1e-5 for its
# sweep (K <= 1024), and over K = 4096 the sum orders of B6 and cuBLAS differ
# by a few ulps of sums near 30. There B6 and its twin must each lie within
# SM_WIDE_ULPS f32 ulps of sum(|s| * |w*c|) of the float64 product, per output.
SM_SHAPES = ((1, 8, 8), (4, 74, 74), (17, 300, 139), (32, 512, 128), (8, 1024, 256),
             (45, 4, 3), (80, 64, 10))
SM_WIDE = (ROWS, N, N)
# Shapes on B6's stream-K split with ragged edges: K off the 32-row tile, odd K
# (the element fill), N off the 128-column tile, both with few rows.
SM_SPLIT = ((ROWS, N + 4, N), (3, N + 1, 1000), (ROWS, N // 2, N + 4), (20, 1000, 777))
SM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # the reference's (tests/test_kernels.py)
SM_WIDE_ULPS = 4


def sm_inputs(gen, dev, B, K, N_, *, u8):
    """``u8``: 0/1 spikes (rate 0.5) and integer weights in [0, 256), where
    every sum is exact; else tests/test_kernels.py's draw: spikes at rate 0.2,
    normal weights. The mask is 0/1 at 0.5 either way."""
    import torch

    s = (torch.rand((B, K), generator=gen, device=dev) < (0.5 if u8 else 0.2)).float()
    if u8:
        w = torch.randint(0, 256, (K, N_), generator=gen, device=dev).float()
    else:
        w = torch.randn((K, N_), generator=gen, device=dev)
    c = (torch.rand((K, N_), generator=gen, device=dev) < 0.5).float()
    return s, w, c


def wide_close(got, s, w, c):
    """Whether ``got`` lies within ``SM_WIDE_ULPS`` f32 ulps of
    ``sum(|s| * |w*c|)`` of the float64 product ``s @ (w*c)``, per output,
    and the largest |error| against that product."""
    import torch

    sd, wc = s.double(), w.double() * c.double()
    exact = sd @ wc
    tol = SM_WIDE_ULPS * torch.finfo(torch.float32).eps * (sd.abs() @ wc.abs())
    err = (got.double() - exact).abs()
    return bool((err <= tol).all()), float(err.max())


def run_spike_matmul_phase(dev, gen):
    """B6 against its twin at every shape of ``SM_SHAPES`` in f32 and bf16:
    normal weights within the reference's tolerance, u8-grid weights
    bitwise; at ``SM_WIDE`` normal weights against the float64 product at a
    tolerance set by K. Returns the largest |difference| from the twin over
    every case."""
    import torch

    from repro_torch.kernels import ref, spike_matmul

    errs = {}
    wide = {}
    cases = 0
    paths = {}
    for B, K, N_ in SM_SHAPES + (SM_WIDE,) + SM_SPLIT:
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            for u8 in (False, True):
                s, w, c = (t.to(dt) for t in sm_inputs(gen, dev, B, K, N_, u8=u8))
                got = spike_matmul.spike_matmul(s, w, c)
                plan = spike_matmul.last_plan
                again = spike_matmul.spike_matmul(s, w, c)
                want = ref.spike_matmul_ref(s, w, c)
                torch.cuda.synchronize()
                paths[f"{B}x{K}x{N_} {name}"] = f"{plan.path}/{plan.fill}"
                err = max_abs_err([got], [want])
                ok = got.dtype == torch.float32 and got.shape == (B, N_)
                if not torch.equal(got, again):
                    raise AssertionError(f"spike_matmul {B}x{K}x{N_} {name}: two launches differ")
                if u8:
                    ok = ok and torch.equal(got, want)
                elif (B, K, N_) == SM_WIDE or (B, K, N_) in SM_SPLIT:
                    (ok_got, e_got), (ok_want, e_want) = (wide_close(x, s, w, c)
                                                          for x in (got, want))
                    ok = ok and ok_got and ok_want
                    if (B, K, N_) == SM_WIDE:
                        wide[name] = (e_got, e_want)
                else:
                    ok = ok and torch.allclose(got, want, rtol=SM_TOL[name], atol=SM_TOL[name])
                if not ok:
                    raise AssertionError(f"spike_matmul {B}x{K}x{N_} {name} "
                                         f"{'u8 grid' if u8 else 'normal'}: max |err| {err}")
                key = ("u8 grid" if u8 else f"wide {name}" if (B, K, N_) == SM_WIDE
                       else f"split {name}" if (B, K, N_) in SM_SPLIT else name)
                errs[key] = max(errs.get(key, 0.0), err)
                cases += 1
    log(f"spike_matmul: {cases} cases against the twin: u8 grid bitwise (f32 and bf16), "
        f"normal weights max |err| f32 {errs['float32']:.3g} (tolerance 1e-5), bf16 "
        f"{errs['bfloat16']:.3g} (2e-2), and within {SM_WIDE_ULPS} f32 ulps at "
        f"{'x'.join(map(str, SM_WIDE))} and the ragged split shapes (max |err| f32 "
        f"{errs['split float32']:.3g}, bf16 {errs['split bfloat16']:.3g}); every case two "
        f"launches bitwise equal; plan (path/fill) per shape: "
        + ", ".join(f"{k} {v}" for k, v in paths.items()))
    log(f"spike_matmul at {'x'.join(map(str, SM_WIDE))} on normal weights: within "
        f"{SM_WIDE_ULPS} f32 ulps of sum(|s||w*c|) of the float64 product, max |err| "
        + ", ".join(f"{k} B6 {g:.3g} twin {t:.3g} (B6 - twin {errs['wide ' + k]:.3g})"
                    for k, (g, t) in wide.items()))
    return max(errs.values())


def time_spike_matmul(dev, gen, card):
    """B6 at one network of 8 rows, K = N = 4096, in f32 and bf16: the
    kernel, its twin, ``torch.matmul(s, W*C)`` on the premasked operand (half
    the bytes) and ``torch.matmul(s, w * c)`` with the mask product inside
    the timed call, in turns, a device sleep ahead of each launch and the L2
    flushed before it. Then profiler device time at predict_int's shapes,
    where one launch is shorter than the host's launch overhead. Returns the
    f32 JSON row (library: the mask product inside)."""
    import torch

    from repro_torch.kernels import ref, spike_matmul

    bw, flops = card
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    row = None
    for dt in (torch.float32, torch.bfloat16):
        s, w, c = (t.to(dt) for t in sm_inputs(gen, dev, ROWS, N, N, u8=True))
        wc = w * c
        t = paired_ms({"kernel": lambda: spike_matmul.spike_matmul(s, w, c),
                       "plain": lambda: ref.spike_matmul_ref(s, w, c),
                       "premasked": lambda: torch.matmul(s, wc),
                       "masked": lambda: torch.matmul(s, w * c),
                       "stream": lambda: torch.dot(w.view(-1), c.view(-1))}, flush=flush)
        moved = nbytes(s, w, c) + ROWS * N * 4      # every input once, the f32 output once
        ops = 2 * ROWS * N * N + N * N                # multiply-adds and the mask multiply
        bound = max(moved / bw, ops / flops) * 1e3
        name = str(dt).split(".")[1]
        log(f"time spike_matmul ({name}): {t['kernel']:.4f} ms at B={ROWS} K=N={N}, "
            f"{100 * bound / t['kernel']:.0f}% of its bound {bound:.4f} ms for "
            f"{moved / 1e6:.1f} MB; plain {t['plain']:.4f} ms, torch.matmul(s, w * c) "
            f"{t['masked']:.4f} ms, torch.matmul(s, W*C)* {t['premasked']:.4f} ms "
            f"(* premasked: half the bytes), torch.dot(w, c) over the same bytes "
            f"{t['stream']:.4f} ms; L2 flushed before each launch")
        log(f"plan spike_matmul ({name}): {spike_matmul.last_plan}")
        if dt == torch.float32:
            row = {"ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["masked"],
                   "bound_ms": bound,
                   "bound_by": "bytes" if moved / bw >= ops / flops else "operations"}
        del s, w, c, wc
    del flush
    for B, K, N_ in SM_SHAPES[5:]:
        s, w, c = sm_inputs(gen, dev, B, K, N_, u8=True)
        wc = w * c
        tiny = [device_ms(fn) for fn in (lambda: spike_matmul.spike_matmul(s, w, c),
                                         lambda: ref.spike_matmul_ref(s, w, c),
                                         lambda: torch.matmul(s, wc))]
        log(f"time spike_matmul at B={B} K={K} N={N_}: {tiny[0]:.4f} ms device time "
            f"(bound {(nbytes(s, w, c) + B * N_ * 4) / bw * 1e3:.3g} ms, bytes, launch-bound; "
            f"plain {tiny[1]:.4f} ms, torch.matmul {tiny[2]:.4f} ms); plan "
            f"{spike_matmul.last_plan}")
    return row


# ---------------------------------------------------------------------------
# phase 10: the paper's classifiers on the card (Iris §III.A, MNIST §III.B)
# ---------------------------------------------------------------------------

CLASSIFIERS = ("iris", "mnist")
FIT_EPOCHS = 100   # the card's fit and the CPU's from one init, held to FIT_TOL
FIT_TOL = 1e-4
# The reference's accuracy floors (tests/test_e2e_iris.py, test_e2e_mnist.py).
FLOORS = {"iris": {"float train": 0.90, "int test": 0.85, "float/int agreement": 0.9},
          "mnist": {"float train": 0.9, "int test": 0.8, "min per class": 0.5}}


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels import (
        event_dispatch, lif_step, spike_matmul, stdp_update, telemetry, tick_fused,
    )

    return {"tick_fused": tick_fused.launches, "lif_step": lif_step.launches,
            "stdp_update": stdp_update.launches, "event_dispatch_db": event_dispatch.launches_db,
            "event_dispatch": event_dispatch.launches, "spike_matmul": spike_matmul.launches,
            "telemetry": telemetry.launches}


def zero_launches() -> None:
    from repro_torch.kernels import (
        event_dispatch, lif_step, spike_matmul, stdp_update, telemetry, tick_fused,
    )

    tick_fused.launches = lif_step.launches = stdp_update.launches = 0
    event_dispatch.launches = event_dispatch.launches_db = spike_matmul.launches = 0
    telemetry.launches = 0


def classifier_data(name):
    """The e2e tests' pipelines: Iris level-encoded (4 levels), a 0.3 test
    split; MNIST-8x8 binarized to 64 spikes, 40 images per digit, a fifth
    held out."""
    import torch

    from repro_torch.core import encoding
    from repro_torch.data import iris, mnist

    if name == "iris":
        x, y = iris.load(seed=0)
        levels = encoding.level_encode(torch.from_numpy(iris.normalize(x)), levels=4).numpy()
        return iris.train_test_split(levels, y, test_frac=0.3)
    x, y = mnist.load(n_per_class=40, seed=0)
    s = mnist.to_spikes(x)
    n_test = len(y) // 5
    return (s[n_test:], y[n_test:]), (s[:n_test], y[:n_test])


def run_classifier_phase(dev):
    """``train``, ``deploy``, ``predict_float`` and ``predict_int`` with
    ``device=None`` for Iris and MNIST (the main path: every launch count is
    zeroed just before and read just after; B6 must launch once per
    ``predict_int`` and nothing else at all). Then, off the path: the card's
    ``predict_int`` bitwise equal to the CPU's on the same deployed bank; the
    card-trained model against the CPU-trained one of the same seed (equal
    test predictions, float and integer); a ``FIT_EPOCHS`` fit from one init
    on both within ``FIT_TOL``; the reference's floors; wall times. Returns
    B6's launches on the path."""
    import numpy as np
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.core import classifier as clf
    from repro_torch.kernels import spike_matmul

    try:
        one = torch.ones((2, 2), dtype=torch.int32, device=dev)
        torch.matmul(one, one)
        log("int32 torch.matmul on the card: accepted by this torch build")
    except RuntimeError as exc:
        log(f"int32 torch.matmul on the card: refused ({str(exc).splitlines()[0]})")

    data = {name: classifier_data(name) for name in CLASSIFIERS}
    runs = {}
    torch.cuda.synchronize()
    zero_launches()
    for name in CLASSIFIERS:
        cfg = get_bundle(f"{name}-snn").model
        (xtr, ytr), (xte, yte) = data[name]
        t0 = time.perf_counter()
        model = clf.train(xtr, ytr, cfg)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        dep = clf.deploy(model, n_neurons=cfg.n_neurons)
        pf_train, pf_test = clf.predict_float(model, xtr), clf.predict_float(model, xte)
        before = spike_matmul.launches
        pi = clf.predict_int(dep, xte)
        if spike_matmul.launches != before + 1:
            raise AssertionError(f"classifier {name}: predict_int launched B6 "
                                 f"{spike_matmul.launches - before} times, not once")
        runs[name] = (cfg, model, dep, pf_train, pf_test, pi, t_train)
    torch.cuda.synchronize()
    launches = kernel_launches()
    expected = dict.fromkeys(launches, 0)
    expected["spike_matmul"] = len(CLASSIFIERS)
    if launches != expected:
        raise AssertionError(f"classifier path: launches {launches}, expected {expected}")

    for name, (cfg, model, dep, pf_train, pf_test, pi, t_train) in runs.items():
        (xtr, ytr), (xte, yte) = data[name]
        pi_cpu = clf.predict_int(dep, xte, device="cpu")
        if pi.dtype != pi_cpu.dtype or not np.array_equal(pi, pi_cpu):
            raise AssertionError(f"classifier {name}: predict_int on the card != on the CPU")
        syn = clf.synaptic_input(dep, xte).cpu()
        if not torch.equal(syn, torch.from_numpy(np.asarray(xte, np.int32) @ dep.w_int)):
            raise AssertionError(f"classifier {name}: B6's product != x @ w_int")
        acc = {"float train": clf.accuracy(pf_train, ytr), "int test": clf.accuracy(pi, yte)}
        if name == "iris":
            acc["float/int agreement"] = float((pf_test == pi).mean())
        else:
            acc["min per class"] = min(float((pi[yte == d] == d).mean()) for d in range(10))
        short = {k: v for k, v in acc.items() if v < FLOORS[name][k]}
        if short:
            raise AssertionError(f"classifier {name}: below the reference's floors {short} "
                                 f"(floors {FLOORS[name]})")
        # The CPU-trained model of the same seed.
        t0 = time.perf_counter()
        model_cpu = clf.train(xtr, ytr, cfg, device="cpu")
        t_cpu = time.perf_counter() - t0
        dep_cpu = clf.deploy(model_cpu, n_neurons=cfg.n_neurons, device="cpu")
        same_f = np.array_equal(pf_test, clf.predict_float(model_cpu, xte, device="cpu"))
        same_i = np.array_equal(pi, clf.predict_int(dep_cpu, xte, device="cpu"))
        if not (same_f and same_i):
            raise AssertionError(f"classifier {name}: the card-trained model's test "
                                 f"predictions differ from the CPU-trained one's (float "
                                 f"{same_f}, int {same_i})")
        dw = float(np.abs(model.w - model_cpu.w).max())
        db = float(np.abs(model.bias - model_cpu.bias).max())
        same_bytes = dep.bank.serialize() == dep_cpu.bank.serialize()
        # One short fit from one init on both devices.
        n_in, n_out = cfg.layer_sizes
        fits = []
        for d in (dev, torch.device("cpu")):
            xd = torch.as_tensor(np.asarray(xtr, np.float32), device=d)
            yd = torch.as_tensor(np.asarray(ytr), dtype=torch.int64, device=d)
            fits.append(clf._fit(clf.init_raw(n_in, n_out, 0, d), xd, yd, FIT_EPOCHS, 0.1))
        fit_err = max(max_abs_err([fits[0][k].cpu()], [fits[1][k]]) for k in ("w", "b"))
        if not all(torch.allclose(fits[0][k].cpu(), fits[1][k], rtol=FIT_TOL, atol=FIT_TOL)
                   for k in ("w", "b")):
            raise AssertionError(f"classifier {name}: a {FIT_EPOCHS}-epoch fit on the card "
                                 f"differs from the CPU's by {fit_err} (tolerance {FIT_TOL})")
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clf.predict_int(dep, xte)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        log(f"classifier {name} ({cfg.layer_sizes[0]}->{cfg.layer_sizes[1]}, "
            f"{dep.bank.n} neurons, {len(yte)} test samples): "
            + ", ".join(f"{k} {v:.3f}" for k, v in acc.items())
            + f"; predict_int card == CPU bitwise, 1 B6 launch; train {t_train:.2f} s on the "
            f"card ({t_cpu:.2f} s on the CPU), predict_int {statistics.median(walls) * 1e3:.3f} "
            f"ms wall (median of 10); CPU-trained model of seed 0: test predictions equal, "
            f"max |dw| {dw:.3g}, |dbias| {db:.3g}, v_th {model.v_th:.6f} vs "
            f"{model_cpu.v_th:.6f}, register bytes {'equal' if same_bytes else 'differ'}; "
            f"{FIT_EPOCHS}-epoch fit card vs CPU max |err| {fit_err:.3g} (tolerance {FIT_TOL})")
    return launches["spike_matmul"]


# ---------------------------------------------------------------------------
# phase 11: the on-device learning workload (mnist-stdp, online_learning)
# ---------------------------------------------------------------------------

LEARN_BACKENDS = ("pallas", "pallas_fused", "jnp")   # the example's default first
LEARN_CHECKED = 32     # presentations of each stage held tick by tick against jnp
LEARN_PROFILED = 16    # presentations of each stage under the profiler
# Frozen rollouts a run: feature_counts x 4, readout_predict, the readback x 2.
LEARN_FROZEN = 7
LEARN_LINES = (r"random init ([\d.]+) -> STDP ([\d.]+)", r"end-to-end test accuracy: ([\d.]+)",
               r"(\d+) transactions", r"spikes identical before/after \((\d+) hidden")


def learning_schedule(schedule: str):
    """The example's ``SCHEDULES[schedule]`` and its split: ``(train spikes,
    train labels, test spikes, test labels, stage-1 epochs, stage-2 epochs)``."""
    from repro_torch.examples import online_learning as ol

    n_per_class, ep1, ep2 = ol.SCHEDULES[schedule]
    return (*ol.load_split(n_per_class), ep1, ep2)


def learning_expected(backend: str, schedule: str):
    """The launches an ``online_learning`` run must make: one B1 (``pallas``)
    or B2 (``pallas_fused``) launch a tick of every rollout and one B5 launch
    a learning tick; nothing on ``jnp``. Also the stages' presentations."""
    from repro_torch.configs.mnist_stdp import RUN

    _, ytr, _, _, ep1, ep2 = learning_schedule(schedule)
    train = len(ytr)
    ticks = RUN.ticks_per_sample
    learning = (ep1 + ep2) * train * ticks
    want = dict.fromkeys(kernel_launches(), 0)
    if backend != "jnp":
        want["lif_step" if backend == "pallas" else "tick_fused"] = (
            learning + LEARN_FROZEN * ticks)
        want["stdp_update"] = learning
    return want, (ep1 * train, ep2 * train)


def run_online_learning(backend: str, schedule: str):
    """``online_learning.main`` on the card, its launches counted from 0: the
    exit code, its output, the wall, each stage's seconds (a sync on either
    side of ``train_features`` and ``train_readout``), the launches and what
    each stage learned (``(w, theta)``, ``w_out``)."""
    import contextlib
    import io

    import torch

    from repro_torch.examples import online_learning as ol

    seconds, learned = {}, {}

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            learned[name] = out
            return out
        return run

    real = ol.train_features, ol.train_readout
    ol.train_features = timed("stage 1", real[0])
    ol.train_readout = timed("stage 2", real[1])
    buf = io.StringIO()
    try:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            code = ol.main((["--fast"] if schedule == "fast" else []) + ["--backend", backend])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
    finally:
        ol.train_features, ol.train_readout = real
    return code, buf.getvalue(), wall, seconds, launches, learned


def check_frozen_ticks(kernel_eng, plain_eng, params, ext, *, what=""):
    """A frozen rollout from rest, tick by tick from the kernel path's state:
    one tick through the kernels and one through the plain path, both on the
    ``W*C`` a rollout hoists. Every spike that differs must be a rounding tie,
    and ``v`` agree to rtol=1e-5, atol=1e-3 elsewhere. Returns ``(the kernel
    path's final state, its raster, ties)``."""
    import torch

    from repro_torch.core.engine import TickCarry
    from repro_torch.core.network import SNNState
    from repro_torch.core.network_types import masked_weights
    from repro_torch.kernels import ops

    wc = masked_weights(params)
    carry = TickCarry(state=SNNState.zeros((ext.shape[1],), ext.shape[2], device=ext.device))
    ties, ys = 0, []
    for t in range(ext.shape[0]):
        ck, yk = kernel_eng.tick_body(carry, (ext[t], None), params=params, wc=wc)
        cp, yp = plain_eng.tick_body(carry, (ext[t], None), params=params, wc=wc)
        diff = yk != yp
        if diff.any():
            v_tilde, v_th = pre_threshold(carry, params, ext[t])
            tie = (v_tilde - v_th).abs() <= TIE * v_th.abs().clamp_min(1.0)
            off = ops.flatten_state(diff, None) & ~tie
            if off.any():
                raise AssertionError(f"{what} tick {t}: {int(off.sum())} spikes differ from the "
                                     "plain path and are no rounding tie")
            ties += int(diff.sum())
        vk, vp = ck.state.lif.v, cp.state.lif.v
        if not bool((torch.isclose(vk, vp, rtol=1e-5, atol=1e-3) | diff).all()):
            raise AssertionError(f"{what} tick {t}: v differs from the plain path beyond "
                                 "rtol=1e-5, atol=1e-3")
        carry = ck
        ys.append(yk)
    return carry.state, torch.stack(ys), ties


def lockstep_presentations(dev, backend: str):
    """The ``--fast`` run's whole schedule on ``backend`` as ``main`` walks it
    (the seed-0 initial state and order, stage 2 fed the kernel path's own
    ``feature_counts`` raster), each presentation also on ``jnp`` from the
    same state. Every presentation must agree with ``jnp`` (counts and
    predictions exactly, ``w`` and ``theta`` to ``rtol=1e-5, atol=1e-3``)
    unless a tick had a rounding tie: the first ``LEARN_CHECKED`` of each
    stage and every one that disagrees are held tick by tick (phase 3's
    check), which counts the ties. The fixed WTA block comes out bitwise.
    Then one presentation of each stage under ``set_sync_debug_mode("error")``.
    Returns per stage ``(presentations, ties, presentations whose w or theta
    is not bitwise jnp's, max |dv|, max |dw|)``, the learned state
    ``((w, theta), w_out)`` and the profiling inputs."""
    import numpy as np
    import torch

    from repro_torch.configs.mnist_stdp import N_CLASSES, N_HIDDEN, N_INPUT, RUN
    from repro_torch.core.engine import TickCarry
    from repro_torch.core.network import SNNState
    from repro_torch.examples import online_learning as ol
    from repro_torch.plasticity import PlasticityState

    T = RUN.ticks_per_sample
    kern, plain = ol.ENGINES[backend], ol.ENGINES["jnp"]
    xtr, ytr, _, _, ep1, ep2 = learning_schedule("fast")
    xs = torch.as_tensor(np.asarray(xtr, np.float32), device=dev)
    close = lambda a, b: bool(torch.isclose(a, b, rtol=1e-5, atol=1e-3).all())
    fresh = lambda n: TickCarry(state=SNNState.zeros((1,), n, device=dev),
                                plast=PlasticityState.zeros((1,), n, device=dev))
    found = {}

    def held(tally, k, agree, check, what):
        if k < LEARN_CHECKED or not agree:
            _, ties, dv, dw = check(what)
            if not agree and not ties:
                raise AssertionError(f"{what}: differs from jnp with no rounding tie")
            tally[1] += ties
            tally[3], tally[4] = max(tally[3], dv), max(tally[4], dw)

    n = N_INPUT + N_HIDDEN
    rng = np.random.default_rng(0)
    w, theta = ol.init_feature_state(rng, dev)
    lateral = w[N_INPUT:, N_INPUT:].clone()
    tally = [0, 0, 0, 0.0, 0.0]
    for _ in range(ep1):
        for i in rng.permutation(len(xtr)):
            x = xs[int(i)]
            wk, tk, ck = ol.stdp_present(w, theta, x, backend=backend)
            wp, tp, cp = ol.stdp_present(w, theta, x, backend="jnp")
            ext = ol._clamp(x.unsqueeze(0), n, T)
            held(tally, tally[0], torch.equal(ck, cp) and close(wk, wp) and close(tk, tp),
                 lambda what: check_learning_ticks(
                     kern.feature, plain.feature, ol.feature_net(w, theta),
                     dataclasses.replace(fresh(n), w=w), T, lambda t: ext[t], lambda t: None,
                     plastic_c=ol.plastic_mask(dev), what=what),
                 f"online_learning stage 1 ({backend}) presentation {tally[0]}")
            tally[2] += not (torch.equal(wk, wp) and torch.equal(tk, tp))
            if not torch.equal(wk[N_INPUT:, N_INPUT:], lateral):
                raise AssertionError(f"online_learning stage 1 ({backend}): the fixed WTA block "
                                     "moved")
            w, theta = wk, tk
            tally[0] += 1
    found["stage 1"] = tuple(tally)

    m = N_HIDDEN + N_CLASSES
    _, raster = ol.feature_counts(w, theta, xs, backend=backend)
    hid = raster[..., N_INPUT:]
    rng = np.random.default_rng(1)      # train_readout's generator (seed + 1)
    w_out = torch.as_tensor(rng.uniform(0.5 * RUN.readout_w_init, 1.5 * RUN.readout_w_init,
                                        (m, m)).astype(np.float32), device=dev)
    zero = torch.zeros((), device=dev)
    tally = [0, 0, 0, 0.0, 0.0]
    for _ in range(ep2):
        for i in rng.permutation(len(ytr)):
            hr, label = hid[:, int(i)], int(ytr[i])
            wk, pk = ol.rstdp_present(w_out, hr, label, backend=backend)
            wp, pp = ol.rstdp_present(w_out, hr, label, backend="jnp")
            ext = torch.zeros((T, 1, m), device=dev)
            ext[:, 0, :N_HIDDEN] = hr
            held(tally, tally[0], int(pk) == int(pp) and close(wk, wp),
                 lambda what: check_learning_ticks(
                     kern.readout, plain.readout, ol.readout_net(w_out),
                     dataclasses.replace(fresh(m), w=w_out), T, lambda t: ext[t],
                     lambda t: zero, what=what),
                 f"online_learning stage 2 ({backend}) presentation {tally[0]}")
            tally[2] += not torch.equal(wk, wp)
            w_out = wk
            tally[0] += 1
    found["stage 2"] = tuple(tally)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ol.stdp_present(w, theta, xs[0], backend=backend)
        ol.rstdp_present(w_out, hid[:, 0], int(ytr[0]), backend=backend)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return found, ((w, theta), w_out), (w, theta, xs, w_out, hid, ytr)


def check_frozen_paths(dev, backend: str, schedule: str, learned):
    """A run's frozen rollouts from its learned state, at the run's batch
    shapes, through ``backend``'s kernels against ``jnp``: ``feature_counts``
    on the train and test sets (N = 128) and ``readout_predict`` on the test
    set (N = 74, fed ``jnp``'s test raster), rasters and predictions equal up
    to rounding ties counted tick by tick (a prediction may also turn on a
    score within rounding of the runner-up's); then the readback (B = 40, u8
    weights and thresholds): register payload, probed count and rasters
    bitwise ``jnp``'s. Returns ``{rollout: (rows, ties, spikes that differ,
    predictions that differ)}``."""
    import numpy as np
    import torch

    from repro_torch.configs.mnist_stdp import N_CLASSES, N_HIDDEN, N_INPUT, RUN
    from repro_torch.core.network import SNNState
    from repro_torch.examples import online_learning as ol

    T = RUN.ticks_per_sample
    kern, plain = ol.ENGINES[backend].infer, ol.ENGINES["jnp"].infer
    (w, theta), w_out = learned["stage 1"], learned["stage 2"]
    xtr, _, xte, _, _, _ = learning_schedule(schedule)
    n, m = N_INPUT + N_HIDDEN, N_HIDDEN + N_CLASSES
    what = f"online_learning {schedule} ({backend})"
    found = {}

    def held(name, params, ext, raster_k, raster_p):
        _, raster_t, ties = check_frozen_ticks(kern, plain, params, ext, what=f"{what} {name}")
        if not torch.equal(raster_t.float(), raster_k.float()):
            raise AssertionError(f"{what} {name}: the rollout's raster is not its ticks' raster")
        differ = int((raster_k != raster_p).sum())
        if differ and not ties:
            raise AssertionError(f"{what} {name}: {differ} spikes differ from jnp's with no "
                                 "rounding tie")
        found[name] = (ext.shape[1], ties, differ, None)

    for name, x in (("feature_counts train", xtr), ("feature_counts test", xte)):
        xs = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        _, rk = ol.feature_counts(w, theta, xs, backend=backend)
        _, rp = ol.feature_counts(w, theta, xs, backend="jnp")
        held(name, ol.feature_net(w, theta), ol._clamp(xs, n, T), rk, rp)

    hid = rp[..., N_INPUT:]
    b = hid.shape[1]
    params = ol.readout_net(w_out)
    ext = torch.zeros((T, b, m), device=dev)
    ext[..., :N_HIDDEN] = hid
    pk = ol.readout_predict(w_out, hid, backend=backend)
    pp = ol.readout_predict(w_out, hid, backend="jnp")
    st0 = SNNState.zeros((b,), m, device=dev)
    fk, rk = kern.rollout(params, st0, ext, T)
    _, rp = plain.rollout(params, st0, ext, T)
    held("readout_predict test", params, ext, rk, rp)
    score = rk[..., N_HIDDEN:].sum(0) * RUN.readout_v_th + fk.lif.v[:, N_HIDDEN:]
    if not torch.equal(torch.argmax(score, dim=-1), pk):
        raise AssertionError(f"{what} readout_predict: not the argmax of its own rollout")
    wrong = pk != pp
    if wrong.any():
        gap = (score.gather(1, pk[:, None]) - score.gather(1, pp[:, None])).abs()[:, 0]
        near = gap <= TIE * score.abs().amax(1).clamp_min(1.0)
        if not found["readout_predict test"][1] and not bool(near[wrong].all()):
            raise AssertionError(f"{what} readout_predict: {int(wrong.sum())} predictions "
                                 "differ from jnp's with no rounding tie")
    found["readout_predict test"] = found["readout_predict test"][:3] + (int(wrong.sum()),)

    (bk, nk), (bp, npl) = (ol.readback_roundtrip(w, theta, backend=b)
                           for b in (backend, "jnp"))
    probe = ol.readback_probe(dev)
    rk, rp = (ol.readback_spikes(bk, probe, backend=b) for b in (backend, "jnp"))
    if bk.serialize() != bp.serialize() or nk != npl or not torch.equal(rk, rp):
        raise AssertionError(f"{what} readback: payload, probed spikes ({nk} vs {npl}) or "
                             "raster not bitwise jnp's")
    found["readback"] = (probe.shape[1], 0, 0, None)
    return found


def frozen_line(found: dict) -> str:
    return "; ".join(f"{k} B={rows}: {ties} ties, {differ} spikes differ"
                     + ("" if wrong is None else f", {wrong} predictions differ")
                     for k, (rows, ties, differ, wrong) in found.items())


def profile_presentations(dev, backend: str, state):
    """``LEARN_PROFILED`` presentations of each stage, once without and once
    under the profiler: the device-busy share of the unprofiled wall and the
    kernels by device time."""
    import torch

    from repro_torch.examples import online_learning as ol
    from repro_torch.launch.serve import device_profile

    w, theta, xs, w_out, hid, ytr = state
    stages = {
        "stage 1": lambda: [ol.stdp_present(w, theta, xs[i], backend=backend)
                            for i in range(LEARN_PROFILED)],
        "stage 2": lambda: [ol.rstdp_present(w_out, hid[:, i], int(ytr[i]), backend=backend)
                            for i in range(LEARN_PROFILED)],
    }
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for _ in range(3):       # a trace with no device activity is taken again
            _, wall_p, busy, rows, _ = device_profile(fn, dev)
            if busy > 0:
                break
        log(f"online_learning profile ({backend}, {name}, {LEARN_PROFILED} presentations): "
            + (f"device busy {busy * 1e3:.4f} ms, {busy / wall:.4f} of the unprofiled wall "
               if busy > 0 else "device busy not measured (the profiler recorded no device "
               "time in 3 traces), unprofiled wall ")
            + f"{wall * 1e3:.3f} ms ({wall / LEARN_PROFILED * 1e3:.4f} ms a presentation; "
            + (f"{busy / wall_p:.4f} of " if busy > 0 else "")
            + f"{wall_p * 1e3:.3f} ms under the profiler); "
            + "; ".join(f"{key[:50]} {us / 1e3:.4f} ms {n}x" for us, n, key in rows[:6]))


# B1 and B2 at the learning workload's and the reconfiguration's shapes:
# (label, rows, width, learning tick). A learning tick streams w and c into
# both kernels (masked); a frozen rollout gives B2 the hoisted W*C
# (premasked) and B1 w and c.
LEARN_TIMED = (
    ("stage-1 learning tick", 1, 128, True),
    ("feature_counts, --fast test set", 32, 128, False),
    ("readback probe", 40, 128, False),
    ("feature_counts, full test set", 80, 128, False),
    ("feature_counts, --fast train set", 128, 128, False),
    ("feature_counts, full train set", 320, 128, False),
    ("stage-2 learning tick", 1, 74, True),
    ("reconfiguration program", 8, 74, False),
    ("readout_predict, --fast test set", 32, 74, False),
    ("readout_predict, full test set", 80, 74, False),
)


def time_learning_kernels(dev, gen, card):
    """B1, B2 and B5 at the learning workload's shapes (128 and 74 neurons)
    on u8-grid inputs: each call bitwise equal to its twin (tolerance 0) and
    on the fill its width asks for (``cp.async`` at 128, ``element`` at 74),
    then timed by profiler device time (a launch here is shorter than its
    Python) beside its twin, ``torch.matmul(s, W*C)`` for B1/B2 and its
    bound. B5 runs on the example's plastic masks (the 64 x 64 block of
    128 x 128 under ``stdp``, with the fixed -127 WTA block where the mask is
    0, which must come out untouched; the 64 x 10 block of 74 x 74 under
    ``rstdp``), beside ``torch.addmm`` of its LTP term. Returns each kernel's
    largest |error|."""
    import torch

    from repro_torch.configs.mnist_stdp import RUN
    from repro_torch.core import connectivity
    from repro_torch.kernels import lif_step, ref, stdp_update, tick_fused

    bw, flops = card
    errs = {"lif_step": 0.0, "tick_fused": 0.0, "stdp_update": 0.0}

    def same(name, what, got, want):
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        if err != 0.0 or not all(torch.equal(g, x) for g, x in zip(got, want) if x is not None):
            raise AssertionError(f"{name} ({what}): differs from its twin, max |err| {err}")

    for label, B, n, learning in LEARN_TIMED:
        inp = kernel_inputs(gen, dev, 1, B, False, n=n)
        rows_in = tuple(inp["rows"].values())
        s = inp["y"]
        for name in ("lif_step", "tick_fused"):
            form = "masked" if learning or name == "lif_step" else "premasked"
            w, c = (inp["wc"], None) if form == "premasked" else (inp["w"], inp["c"])
            if name == "tick_fused":
                args, _ = tick_case(inp, premasked=form == "premasked", ring=False,
                                    delays=False, drive=True, in_place=False)
                kernel, twin, mod = tick_fused.fused_tick, ref.fused_tick_ref, tick_fused
                moved = nbytes(args[0], s, w, c, inp["v"], inp["r"], inp["drive"], *rows_in)
            else:
                args = (s, w, c, inp["v"], inp["r"], inp["drive"], *rows_in)
                kernel, twin, mod = lif_step.fused_lif_step, ref.fused_lif_step_ref, lif_step
                moved = nbytes(s, w, c, inp["v"], inp["r"], inp["drive"], *rows_in)
            what = f"{label}, B={B} N=K={n}, {form}"
            same(name, what, kernel(*args), twin(*args))
            torch.cuda.synchronize()
            fill = "cp.async" if n % 4 == 0 else "element"
            if mod.last_plan.path != fill:
                raise AssertionError(f"{name} ({what}): plan {mod.last_plan}, expected the "
                                     f"{fill} fill")
            moved += 3 * nbytes(inp["v"])
            ops = 2 * B * n * n + (n * n if c is not None else 0)
            bound = max(moved / bw, ops / flops) * 1e3
            wc = inp["wc"]
            t = {"kernel": device_ms(lambda: kernel(*args)),
                 "plain": device_ms(lambda: twin(*args)),
                 "library": device_ms(lambda: torch.matmul(s, wc))}
            log(f"time {name} ({label}, {form}): == twin bitwise; {t['kernel'] * 1e3:.3f} us "
                f"device time at B={B} N=K={n}, {100 * bound / t['kernel']:.1f}% of its bound "
                f"{bound * 1e3:.4f} us ({moved / 2**10:.1f} KiB); plain {t['plain'] * 1e3:.3f} "
                f"us, torch.matmul(s, W*C) {t['library'] * 1e3:.3f} us; plan {mod.last_plan}")
    for label, rule, n, blocks in (("stage-1 learning tick", "stdp", 128, (64, 64)),
                                   ("stage-2 learning tick", "rstdp", 74, (64, 10))):
        inp = stdp_inputs(gen, dev, 1, 1, n, n, slotted=False, masks="ones")
        inp["c"] = torch.as_tensor(connectivity.layered(list(blocks)), dtype=torch.float32,
                                   device=dev)
        if rule == "stdp":
            lo = blocks[0]
            inp["w"][lo:, lo:] = torch.as_tensor(
                -RUN.lateral_inhibition * connectivity.all_to_all(n - lo), dtype=torch.float32,
                device=dev)
        reward = torch.zeros((), device=dev)
        args = [inp[k] for k in STDP_ARGS]
        hyper = stdp_hyper(rule)
        got = stdp_update.fused_stdp_step(*args, reward, **hyper)
        same("stdp_update", f"{label}, {rule}", got,
             ref.fused_stdp_step_ref(*args, reward, **hyper))
        fixed = inp["c"] == 0
        if not torch.equal(got.w[fixed], inp["w"][fixed]):
            raise AssertionError(f"stdp_update ({label}): a weight outside the plastic mask moved")
        moved = stdp_bytes(inp, reward, rule, [True])
        ops = 10 * n * n
        bound = max(moved / bw, ops / flops) * 1e3
        t = {"kernel": device_ms(lambda: stdp_update.fused_stdp_step(*args, reward, **hyper)),
             "plain": device_ms(lambda: ref.fused_stdp_step_ref(*args, reward, **hyper)),
             "library": device_ms(lambda: torch.addmm(inp["w"], inp["x_pre"].T,
                                                      inp["s_post"]))}
        log(f"time stdp_update ({label}, {rule}, plastic block {blocks[0]}x{blocks[1]} of "
            f"{n}x{n}): == twin bitwise, the weights outside the mask untouched; "
            f"{t['kernel'] * 1e3:.3f} us device time, "
            f"{100 * bound / t['kernel']:.1f}% of its bound {bound * 1e3:.4f} us "
            f"({moved / 2**10:.1f} KiB); plain {t['plain'] * 1e3:.3f} us, torch.addmm (LTP term "
            f"alone) {t['library'] * 1e3:.3f} us; plan {stdp_update.last_plan}")
    return errs


def run_learning_workload_phase(dev, gen, card):
    """The on-device learning workload: ``online_learning --fast`` on each of
    ``LEARN_BACKENDS`` (PASS, the readback byte-exact with identical spikes,
    B1 or B2 once a tick run and B5 once a learning tick); on each kernel
    backend the whole ``--fast`` schedule in lockstep with ``jnp``, which
    must reproduce the run's learned state bitwise, and that run's frozen
    rollouts from its learned state against ``jnp``. The accuracies and the
    probed spike count must equal ``jnp``'s run's unless the lockstep showed
    rounding (ties, or weights off jnp's last bits). Then a profiler pass,
    the full run once on the default backend with its frozen rollouts held
    the same way, and the kernels checked and timed at the workload's
    shapes. Returns each run's launches, by ``<schedule>/<backend>``, and
    the kernels' largest |error|."""
    import torch

    runs, accs, learned = {}, {}, {}
    for backend in LEARN_BACKENDS:
        code, out, wall, seconds, launches, learned[backend] = run_online_learning(
            backend, "fast")
        want, (p1, p2) = learning_expected(backend, "fast")
        found = [re.search(p, out) for p in LEARN_LINES]
        if code != 0 or "PASS - on-device learning separates classes" not in out \
                or not all(found) or found[2].group(1) != "18576":
            raise AssertionError(f"online_learning --fast --backend {backend}: exit {code}\n{out}")
        if launches != want:
            raise AssertionError(f"online_learning --fast --backend {backend}: launches "
                                 f"{launches}, expected {want}")
        runs[f"fast/{backend}"] = launches
        accs[backend] = (found[0].group(1), found[0].group(2), found[1].group(1),
                         found[3].group(1))
        log(f"online_learning --fast --backend {backend}: PASS; cluster accuracy "
            f"{accs[backend][0]} -> {accs[backend][1]}, readout {accs[backend][2]}; readback "
            f"{found[2].group(1)} transactions, spikes identical ({found[3].group(1)} hidden "
            f"spikes probed); launches {launches}; wall {wall:.3f} s, stage 1 "
            f"{seconds['stage 1']:.3f} s ({p1} presentations, {p1 / seconds['stage 1']:.1f}/s), "
            f"stage 2 {seconds['stage 2']:.3f} s ({p2}, {p2 / seconds['stage 2']:.1f}/s)")
    log(f"online_learning --fast (random init, STDP, readout, probed spikes) by backend {accs}")
    state = None
    for backend in LEARN_BACKENDS[:2]:
        found, mine, st = lockstep_presentations(dev, backend)
        state = state or st
        run = learned[backend]
        if not all(torch.equal(a, b) for a, b in zip((*mine[0], mine[1]),
                                                     (*run["stage 1"], run["stage 2"]))):
            raise AssertionError(f"online_learning {backend}: the lockstep walk did not "
                                 "reproduce the run's learned state")
        shown = sum(ties + rounded for _, ties, rounded, _, _ in found.values())
        if accs[backend] != accs["jnp"] and not shown:
            raise AssertionError(f"online_learning --fast {backend}: {accs[backend]} against "
                                 f"jnp's {accs['jnp']} with no rounding on the way")
        frozen = check_frozen_paths(dev, backend, "fast", run)
        log(f"online_learning {backend}: the whole --fast schedule in lockstep with jnp from "
            f"shared states (the run's learned state bitwise; the first {LEARN_CHECKED} of "
            f"each stage and every disagreement tick by tick, rtol=1e-5, atol=1e-3): "
            + "; ".join(f"{k} {p} presentations, {t} rounding ties, {r} with w off jnp's bits, "
                        f"max |dv| {dv:.3g}, max |dw| {dw:.3g}"
                        for k, (p, t, r, dv, dw) in found.items())
            + "; the fixed WTA block bitwise; one presentation of each stage with no host "
            f"sync; accuracies and probed spikes "
            + ("equal to jnp's run" if accs[backend] == accs["jnp"] else "differ (rounding)")
            + f"; frozen rollouts from the learned state against jnp: {frozen_line(frozen)}")
    profile_presentations(dev, LEARN_BACKENDS[0], state)

    backend = LEARN_BACKENDS[0]
    code, out, wall, seconds, launches, full = run_online_learning(backend, "full")
    want, (p1, p2) = learning_expected(backend, "full")
    found = [re.search(p, out) for p in LEARN_LINES]
    if code != 0 or not all(found) or launches != want:
        raise AssertionError(f"online_learning --backend {backend} (full): exit {code}, "
                             f"launches {launches}, expected {want}\n{out}")
    runs[f"full/{backend}"] = launches
    frozen = check_frozen_paths(dev, backend, "full", full)
    log(f"online_learning --backend {backend} (full, {p1} + {p2} presentations): PASS; "
        f"cluster accuracy {found[0].group(1)} -> {found[0].group(2)}, readout "
        f"{found[1].group(1)}; readback {found[2].group(1)} transactions, spikes identical "
        f"({found[3].group(1)} probed); launches {launches}; wall {wall:.3f} s, stage 1 "
        f"{seconds['stage 1']:.3f} s ({p1 / seconds['stage 1']:.1f} presentations/s), "
        f"stage 2 {seconds['stage 2']:.3f} s ({p2 / seconds['stage 2']:.1f}/s); frozen "
        f"rollouts from the learned state against jnp: {frozen_line(frozen)}")
    return runs, time_learning_kernels(dev, gen, card)


# ---------------------------------------------------------------------------
# phase 12: runtime reconfiguration (reconfigure_runtime)
# ---------------------------------------------------------------------------

RECONF_TOTALS = [2344.0, 2288.0, 2344.0]   # the reference's spike totals
RECONF_TICKS = 4


def run_reconfigure_phase(dev):
    """``reconfigure_runtime.main`` on the card (``pallas_fused``, launches
    counted from 0: B2 once a tick of each of the three programs), then the
    same programs on ``pallas`` (B1) and ``jnp``: every raster bitwise equal
    to ``jnp``'s, the reference's spike totals, one program in use and, after
    the first program, no new launch plan. Returns
    the launches of the main run."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core.engine import EngineOptions, TickEngine
    from repro_torch.examples import reconfigure_runtime as rc

    buf = io.StringIO()
    torch.cuda.synchronize()
    zero_launches()
    with contextlib.redirect_stdout(buf):
        fused = rc.main([])
    torch.cuda.synchronize()
    launches = kernel_launches()
    want = dict.fromkeys(launches, 0)
    want["tick_fused"] = len(rc.TASKS) * RECONF_TICKS
    if launches != want:
        raise AssertionError(f"reconfigure: launches {launches}, expected {want}")
    runs = {"pallas_fused": fused}
    for backend in ("pallas", "jnp"):
        zero_launches()
        runs[backend] = rc.reconfigure(TickEngine(EngineOptions(backend=backend)), dev)
        torch.cuda.synchronize()
        got = kernel_launches()["lif_step"]
        if got != (len(rc.TASKS) * RECONF_TICKS if backend == "pallas" else 0):
            raise AssertionError(f"reconfigure on {backend}: {got} B1 launches")
    for backend, out in runs.items():
        if out["spikes"] != RECONF_TOTALS or out["programs"] != 1 or out["new_plans"]:
            raise AssertionError(f"reconfigure on {backend}: spikes {out['spikes']}, programs "
                                 f"{out['programs']}, new plans "
                                 f"{out['new_plans']}")
        if not all(np.array_equal(a, b) for a, b in zip(out["rasters"], runs["jnp"]["rasters"])):
            raise AssertionError(f"reconfigure on {backend}: a raster differs from jnp's")
    log("reconfigure: " + "; ".join(
        f"{b} spikes {[int(s) for s in o['spikes']]}, {o['programs']} program, "
        f"{o['new_plans']} new plans after the first, walls "
        + ", ".join(f"{s * 1e3:.3f}" for s in o["seconds"]) + " ms"
        for b, o in runs.items())
        + f"; rasters bitwise equal to jnp's; launches {launches}")
    for line in buf.getvalue().splitlines():
        if line.strip():
            log(f"reconfigure | {line}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the sharded fabric
# ---------------------------------------------------------------------------

SHARD_N = 4096          # the two-rank world's fabric (the snn-event width)
SHARD_ROWS = 8          # its batch rows
SHARD_TICKS = 16
SHARD_DENSITY = 0.05    # with this threshold the fabric starts sparse (the event arm)
SHARD_V_TH = 3.5        # and turns dense near the end (the overflow fallback to B1)
SHARD_RATE = 0.05
SHARD_REQUESTS = 6      # serve_sharded_main's timed chunks at snn-64k FULL (the CLI's default)
SHARD_TIMED = 10        # one-tick chunks timed at snn-64k FULL
SHARD_SPARSE = 1 / 32   # the spike rate of the 64k event tick held against jnp (B3's gather)
SHARD_64K = ("jnp", "event", "pallas", "pallas_fused")
SHARD_CASES = (("frozen pallas", dict(backend="pallas")),
               ("frozen pallas_fused", dict(backend="pallas_fused")),
               ("frozen event", dict(backend="event")),
               ("frozen event grid", dict(backend="event", event_kernel="grid")),
               ("learning pallas", dict(backend="pallas", learning=True)))
SHARD_PLASTICITY = dict(rule="stdp", a_plus=0.05, a_minus=0.05)


def device_sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def shard_inputs():
    """The two-rank world's global inputs, on the host: dyadic weights (exact
    f32 sums in any order), ``sparse_random(4096, 0.05)``, ``w_in = 2 I``, a
    0.05-rate drive over 8 rows."""
    import numpy as np
    import torch

    from repro_torch.core import connectivity
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network_types import SNNParams
    from repro_torch.parallel import snn_sharding

    n = SHARD_N
    params = SNNParams(
        w=snn_sharding.make_sharded_dyadic_weights(n, device="cpu"),
        c=torch.from_numpy(connectivity.sparse_random(n, SHARD_DENSITY, seed=1)
                           .astype(np.float32)),
        w_in=torch.eye(n) * 2.0,
        lif=LIFParams.make(n, v_th=SHARD_V_TH, leak=0.25, r_ref=1, device="cpu"))
    rng = np.random.default_rng(1)
    ext = torch.from_numpy((rng.random((SHARD_TICKS, SHARD_ROWS, n)) < SHARD_RATE)
                           .astype(np.float32))
    return params, ext


def shard_run(mesh, engine_mesh, opts: dict) -> dict:
    """One case of the two-rank world on ``mesh``'s shard (``engine_mesh=None``
    with a one-rank ``mesh``: the single-device engine on the whole fabric),
    telemetry on; every launch count zeroed just before and read just after.
    Returns the results gathered to the global layout on the host."""
    import torch

    from repro_torch.core.engine import EngineOptions, TickEngine
    from repro_torch.core.network_types import SNNState
    from repro_torch.kernels import event_dispatch, lif_step, stdp_update
    from repro_torch.parallel import snn_sharding
    from repro_torch.plasticity import PlasticityParams, PlasticityState

    opts = dict(opts)
    learning = opts.pop("learning", False)
    rules = snn_sharding.snn_rules(mesh.axis)
    glob, ext = shard_inputs()
    params = snn_sharding.place(glob, snn_sharding.params_specs(rules, glob), mesh)
    st0 = SNNState.zeros((SHARD_ROWS,), SHARD_N, device="cpu")
    st_specs = snn_sharding.state_specs(rules, st0)
    st0 = snn_sharding.place(st0, st_specs, mesh)
    ext = ext.to(mesh.device)
    eng = TickEngine(EngineOptions(
        mesh=engine_mesh, telemetry=True, **opts,
        plasticity=PlasticityParams.make(**SHARD_PLASTICITY) if learning else None))
    device_sync(mesh.device)
    zero_launches()
    lif_step.last_plan = event_dispatch.last_plan = stdp_update.last_plan = None
    t0 = time.perf_counter()
    if learning:
        pl_specs = PlasticityState(x_pre=None, x_post=-1, elig=-1)
        pl0 = snn_sharding.place(PlasticityState.zeros((SHARD_ROWS,), SHARD_N, device="cpu"),
                                 pl_specs, mesh)
        (st, _, w), raster, tel = eng.learning_rollout(params, st0, pl0, ext, SHARD_TICKS)
    else:
        (st, raster, tel), w = eng.rollout(params, st0, ext, SHARD_TICKS), None
    device_sync(mesh.device)
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    st = snn_sharding.collect(st, st_specs, mesh)
    return {"raster": mesh.all_gather(raster).cpu().numpy(),
            "v": st.lif.v.cpu().numpy(), "r": st.lif.r.cpu().numpy(),
            "w": None if w is None else mesh.all_gather(w).cpu().numpy(),
            "telem": tel.numpy(), "launches": launches, "wall": wall,
            "plans": {k: str(p) for k, p in (("B1", lif_step.last_plan),
                                            ("B4", event_dispatch.last_plan),
                                            ("B5", stdp_update.last_plan)) if p is not None}}


def sharded_learning_ticks(mesh) -> dict:
    """The two-rank learning case tick by tick: from the sharded kernel
    chain's carry, one tick of the sharded kernels (B1 at N = n/2, B5 with a
    full-width ``x_pre``; a one-tick ``chunk``) and, on rank 0, one tick of
    the plain path's world of one on the gathered carry (``jnp``, the plain
    plasticity pass), held by :func:`compare_learning_tick`. Run after the
    rollout's launches were read: these launches compare and do not count.
    Returns rank 0's ties and largest gaps and the chain's final ``w``."""
    import torch

    from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
    from repro_torch.core.network_types import SNNState
    from repro_torch.parallel import snn_sharding
    from repro_torch.plasticity import PlasticityParams, PlasticityState

    pp = PlasticityParams.make(**SHARD_PLASTICITY)
    rules = snn_sharding.snn_rules(mesh.axis)
    glob, ext = shard_inputs()
    params = snn_sharding.place(glob, snn_sharding.params_specs(rules, glob), mesh)
    whole = snn_sharding.place(glob, None, mesh)        # the world of one's operands
    full = TickCarry(state=SNNState.zeros((SHARD_ROWS,), SHARD_N, device="cpu"),
                     plast=PlasticityState.zeros((SHARD_ROWS,), SHARD_N, device="cpu"),
                     w=glob.w)
    specs = snn_sharding.carry_specs(rules, full)
    carry = snn_sharding.place(full, specs, mesh)
    g = snn_sharding.place(full, None, mesh)
    ext = ext.to(mesh.device)
    zero = torch.zeros((), device=mesh.device)
    eng = TickEngine(EngineOptions(mesh=mesh, backend="pallas", plasticity=pp))
    plain = TickEngine(EngineOptions(backend="jnp", plasticity=pp, plasticity_backend="jnp"))
    ties, dv, dw = 0, 0.0, 0.0
    for t in range(SHARD_TICKS):
        nxt, y = eng.chunk(params, carry, ext[t:t + 1], 1)
        g1 = snn_sharding.collect(nxt, specs, mesh)
        gy = mesh.all_gather(y[0])
        if mesh.rank == 0:
            cp, yp = plain.tick_body(g, (ext[t], zero), params=whole)
            tt, tv, tw = compare_learning_tick(g, whole, ext[t], g1, gy, cp, yp,
                                               what=f"sharded pair learning, tick {t}")
            ties, dv, dw = ties + tt, max(dv, tv), max(dw, tw)
        carry, g = nxt, g1
    return {"ties": ties, "dv": dv, "dw": dw,
            "w": g.w.cpu().numpy() if mesh.rank == 0 else None}


def sharded_pair_rank(mesh) -> dict:
    """A rank of the 4096-neuron world: every case of ``SHARD_CASES``, then
    the learning case tick by tick against the plain path."""
    out = {"exchange": mesh.exchange, "device": str(mesh.device),
           **{name: shard_run(mesh, mesh, opts) for name, opts in SHARD_CASES}}
    out["learning ticks"] = sharded_learning_ticks(mesh)
    return out


def sparse_event_tick(mesh, eng, params, carry, x1, card):
    """B3's row gather at snn-64k: ``carry`` with ``SHARD_SPARSE`` of the
    neurons spiking (under the spike budget, so the event arm runs), one
    tick of ``eng`` (``event``) against one of the ``jnp`` engine, bitwise.
    Returns the sparse carry, the arriving spikes and B3's launch timed
    alone (its device time, its bound, the live rows, the launches timed);
    raises unless B3 launched once."""
    import torch

    from repro_torch.core.engine import TickEngine
    from repro_torch.kernels import event_dispatch

    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(65)
    y = carry.state.lif.y
    y = (torch.rand(y.shape, generator=gen, device=mesh.device) < SHARD_SPARSE).to(y.dtype)
    lif = dataclasses.replace(carry.state.lif, y=y)
    sparse = dataclasses.replace(carry, state=dataclasses.replace(carry.state, lif=lif))
    before = kernel_launches()["event_dispatch_db"]
    calls = []
    real = event_dispatch.event_lif_dispatch_db

    def capture(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    event_dispatch.event_lif_dispatch_db = capture
    try:
        ev, ev_y = eng.chunk(params, sparse, x1, 1)
    finally:
        event_dispatch.event_lif_dispatch_db = real
    launched = kernel_launches()["event_dispatch_db"] - before
    plain = TickEngine(dataclasses.replace(eng.options, backend="jnp"))
    pj, pj_y = plain.chunk(params, sparse, x1, 1)
    arriving = int(mesh.all_reduce(y.sum()).item())
    if launched != 1 or not (torch.equal(ev_y, pj_y) and torch.equal(ev.state.lif.v, pj.state.lif.v)
                             and torch.equal(ev.state.lif.r, pj.state.lif.r)):
        raise AssertionError(f"sharded 64k: the event tick on {arriving} arriving spikes "
                             f"(B3 launched {launched} times) differs from jnp's")
    # B3 alone: the captured launch again, its kernel's own device time from
    # the profiler (the tick's host work and its other launches left out).
    args, kwargs = calls[0]
    rows = kernel_rows(lambda: [real(*args, **kwargs) for _ in range(SHARD_TIMED)])
    b3 = [(us, count) for us, count, name in rows if "event_dispatch_db" in name]
    b3_ms = b3[0][0] / b3[0][1] / 1e3 if b3 else None
    w, v = args[1], args[2]
    live = int(kwargs["counts"].sum().item())
    # bytes: the live rows of W once, v and r read, v, r and y written, the
    # drive read (when given) and the six per-neuron rows, in f32
    per_neuron = 5 + (args[4] is not None) + 6
    b3_bound = 4 * (live * w.shape[-1] + per_neuron * v.numel()) / card[0] * 1e3
    return sparse, arriving, (b3_ms, b3_bound, live, len(b3) and b3[0][1])


def sharded_64k_rank(mesh, card) -> dict:
    """A rank of a world at snn-64k FULL: ``serve_sharded_main`` on every
    backend of ``SHARD_64K`` (each builds its own ``W`` columns, rank-local),
    launches counted from 0 and the peak device memory from a reset for each;
    then a tick timed by CUDA events on the served fabric after a loud and
    after a silent tick (and, on ``event``, on a sparse tick that B3 gathers,
    first held against ``jnp``), and ``torch.matmul`` over the same ``W``
    alone. Rasters and potentials come back gathered to the global layout."""
    import argparse

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_bundle
    from repro_torch.core.dispatch_policy import resolve_k_active
    from repro_torch.launch.serve import serve_sharded_main

    one = torch.ones(1, device=mesh.device)
    dist.all_reduce(one, group=mesh.group)     # the process group answers
    cfg = get_bundle("snn-64k").model
    out = {"exchange": mesh.exchange, "backend": mesh.backend, "all_reduce": one.item(),
           "size": mesh.size}
    for backend in SHARD_64K:
        device_sync(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        zero_launches()
        t0 = time.perf_counter()
        stats = serve_sharded_main(dataclasses.replace(cfg, snn_backend=backend),
                                   argparse.Namespace(requests=SHARD_REQUESTS, device=None,
                                                      metrics_out=None))
        device_sync(mesh.device)
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        peak = torch.cuda.max_memory_allocated(mesh.device)
        res = stats.pop("results")
        eng, params, carry = res["engine"], res["params"], res["carry"]
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(64)
        x1 = (torch.rand((1, params.w_in.shape[0]), generator=gen, device=mesh.device)
              < cfg.snn_rate).to(torch.float32)
        # The fabric alternates loud ticks (every neuron out of refractoriness
        # fires) and silent ones: time a tick after each kind, and on event a
        # sparse one. The bound counts the rows of this rank's W the arm reads
        # (all of them on the dense arms, the arriving spikes' on the event
        # arm) and its w_in, once.
        carries = [carry, eng.chunk(params, carry, x1, 1)[0]]
        b3_library = None
        b3_alone = None
        if backend == "event":
            sparse, arriving, b3_alone = sparse_event_tick(mesh, eng, params, carry, x1, card)
            carries.append(sparse)
            # B3's library call at this shape: the dense product over the
            # same W (B1's 64k cell's call), on the sparse tick's spikes.
            s_sparse = mesh.all_gather(sparse.state.lif.y).reshape(1, -1)
            b3_library = (arriving, median_ms(lambda: torch.matmul(s_sparse, params.w),
                                              SHARD_TIMED))
            del sparse, s_sparse
        ticks = {}
        for c in carries:
            arriving = int(mesh.all_reduce(c.state.lif.y.sum()).item())
            dense = backend != "event" or arriving > resolve_k_active(
                cfg.n_neurons, eng.options.event_k_active)
            rows = params.w.shape[0] if dense else arriving
            nbytes = 4 * (rows * params.w.shape[1] + params.w_in.numel())
            ticks[arriving] = (median_ms(lambda: eng.chunk(params, c, x1, 1), SHARD_TIMED),
                               nbytes / card[0] * 1e3, "dense" if dense else "event")
        s = mesh.all_gather(carry.state.lif.y).reshape(1, -1)
        matmul_ms = median_ms(lambda: torch.matmul(s, params.w), SHARD_TIMED)
        out[backend] = {
            "stats": stats, "wall": wall, "launches": launches, "peak": peak,
            "w_bytes": params.w.numel() * params.w.element_size(),
            "rasters": np.stack([mesh.all_gather(r).cpu().numpy() > 0
                                 for r in res["rasters"]]),
            "v": mesh.all_gather(carry.state.lif.v).cpu().numpy(),
            "telemetry": res["telemetry"], "ticks": ticks, "matmul_ms": matmul_ms,
            "b3_library": b3_library, "b3_alone": b3_alone}
        del res, eng, params, carry, carries, c, s
        torch.cuda.empty_cache()
    return out


def check_64k_world(ranks, full, smi, card, add):
    """Hold a world's snn-64k runs (every rank's results) to their contract
    (stats, finite potentials, telemetry spikes == the rasters', every
    backend == ``jnp`` bitwise, its kernels and telemetry launched), add
    every rank's launches and log rank 0's figures."""
    import numpy as np

    big = ranks[0]
    for other in ranks[1:]:
        for name in SHARD_64K:
            add(other[name]["launches"])
    jnp_run = big["jnp"]
    d = big["size"]
    for name in SHARD_64K:
        run = big[name]
        st = run["stats"]
        if (st["recompiles_after_warmup"] or st["n_devices"] != d
                or st["n_neurons"] != full.n_neurons):
            raise AssertionError(f"sharded 64k on {name}: stats {st}")
        if not np.isfinite(run["v"]).all():
            raise AssertionError(f"sharded 64k on {name}: a potential is not finite")
        if run["telemetry"]["spikes"] != float(run["rasters"].sum()):
            raise AssertionError(f"sharded 64k on {name}: telemetry spikes "
                                 f"{run['telemetry']['spikes']} against the rasters' "
                                 f"{int(run['rasters'].sum())}")
        add(run["launches"])
    same = [k for k in jnp_run["telemetry"] if k not in ("overflow_ticks", "policy_dense_ticks")]
    for name in SHARD_64K[1:]:
        run = big[name]
        if not (np.array_equal(run["rasters"], jnp_run["rasters"])
                and np.array_equal(run["v"], jnp_run["v"])
                and all(run["telemetry"][k] == jnp_run["telemetry"][k] for k in same)):
            raise AssertionError(f"sharded 64k, {d} rank(s): the {name} run differs from jnp's")
    need = {"event": ("lif_step", "event_dispatch_db"), "pallas": ("lif_step",),
            "pallas_fused": ("tick_fused",)}
    for name in SHARD_64K:
        counts = big[name]["launches"]
        if min(counts[k] for k in need.get(name, ()) + ("telemetry",)) < 1:
            raise AssertionError(f"sharded 64k on {name}: launches {counts}")
    gib = 2 ** 30
    log(f"sharded 64k (snn-64k FULL: {full.n_neurons} neurons, c=None, a world of {d} "
        f"rank(s), {big['backend']}, all_reduce {big['all_reduce']:.0f}, exchange "
        f"{big['exchange']}): {SHARD_REQUESTS} chunks of 8 ticks after the warm-up on "
        + ", ".join(SHARD_64K) + f", recompiles 0; rasters "
        f"({int(jnp_run['rasters'].sum())} spikes in {jnp_run['rasters'].shape[0] * 8} ticks), "
        f"final potentials and telemetry of every backend == jnp bitwise (event overflow "
        f"ticks {big['event']['telemetry']['overflow_ticks']:.0f}); a sparse event tick "
        f"(B3 gathering the arriving spikes' rows) == jnp's bitwise; rank 0's launches "
        + "; ".join(f"{name} {big[name]['launches']}" for name in SHARD_64K))
    for name in SHARD_64K:
        run = big[name]
        log(f"sharded 64k {name}, {d} rank(s): peak device memory of rank 0 "
            f"{run['peak'] / gib:.2f} GiB (its W {run['w_bytes'] / gib:.2f} GiB), "
            f"serve_sharded_main wall {run['wall']:.2f} s (W built rank-local), ticks_per_s "
            f"{run['stats']['ticks_per_s']:.1f} over {run['stats']['ticks']} ticks, "
            f"synops_per_s {run['stats']['synops_per_s']:.4g}; telemetry "
            + ", ".join(f"{k}={v:.4g}" for k, v in run["telemetry"].items()))
        for arriving, (ms, bound, arm) in sorted(run["ticks"].items()):
            log(f"time sharded 64k tick ({name}, {d} rank(s), {arriving} spikes arriving, the "
                f"{arm} arm; a one-tick chunk, CUDA events on rank 0, median of "
                f"{SHARD_TIMED}): {ms:.4f} ms, bound {bound:.4f} ms (the rows of the rank's W "
                f"it reads and its w_in, over {card[0] / 1e12:.2f} TB/s), {bound / ms:.0%} of "
                f"it; torch.matmul(s, W) over the rank's W alone {run['matmul_ms']:.4f} ms; "
                f"card {smi}")
        if run.get("b3_alone") is not None:
            ms, bound, live, count = run["b3_alone"]
            ms_text = "not measured (no B3 kernel in the trace)" if ms is None else f"{ms:.4f} ms"
            log(f"time sharded 64k B3 alone ({name}, {d} rank(s), the sparse tick's launch "
                f"again: {live} live rows of the rank's W; profiler device time of the "
                f"event_dispatch_db kernel, mean of {count} launches): {ms_text}, bound "
                f"{bound:.4f} ms (those rows of W once, the LIF state read and written, over "
                f"{card[0] / 1e12:.2f} TB/s)"
                + ("" if ms is None else f", {bound / ms:.0%} of it") + f"; card {smi}")
        if run["b3_library"] is not None:
            arriving, ms = run["b3_library"]
            log(f"time sharded 64k B3 library ({name}, {d} rank(s)): torch.matmul(s, W) over "
                f"the rank's W with s the sparse tick's {arriving} arriving spikes (CUDA "
                f"events on rank 0, median of {SHARD_TIMED}; the call of B1's 64k cell) "
                f"{ms:.4f} ms; card {smi}")


def plain_opts(opts: dict) -> dict:
    """A case's options on the plain path: ``jnp``, and the plain plasticity
    pass when it learns."""
    out = {k: v for k, v in opts.items() if not k.startswith("event_")}
    out["backend"] = "jnp"
    if out.get("learning"):
        out["plasticity_backend"] = "jnp"
    return out


def run_sharded_phase(dev, card, smi):
    """The sharded fabric on the card: snn-64k FULL as a world of one rank
    (NCCL) through ``serve_sharded_main`` on every backend, bitwise equal to
    ``jnp``; then a world of two gloo ranks sharing the card at 4096 neurons
    with an explicit ``c``. Every frozen case is bitwise the world of one on
    ``jnp`` (the plain path) and on its own backend; the learning case is
    bitwise the world of one on its backend, and tick by tick the plain
    path's within counted ties. Returns the phase's launches, summed over
    its ranks and runs."""
    import numpy as np

    from repro_torch.configs import get_bundle
    from repro_torch.launch.mesh import run_world
    from repro_torch.obs.telemetry import FIELDS
    from repro_torch.parallel.mesh import SNNMesh

    total = dict.fromkeys(kernel_launches(), 0)
    full = get_bundle("snn-64k").model

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # -- snn-64k FULL ------------------------------------------------------------
    check_64k_world(run_world("chip_smoke:sharded_64k_rank", 1, card, device=dev,
                              backend="nccl" if dev.type == "cuda" else "gloo", timeout=600),
                    full, smi, card, add)

    # -- 4096 neurons, two gloo ranks sharing the card ---------------------------------
    pair = run_world("chip_smoke:sharded_pair_rank", 2, device=dev, backend="gloo",
                     timeout=600)
    one = SNNMesh(rank=0, size=1, device=dev)
    w0 = shard_inputs()[0].w.numpy()
    for name, opts in SHARD_CASES:
        want = shard_run(one, None, opts)
        plain = shard_run(one, None, plain_opts(opts))
        learning = want["w"] is not None
        if learning and float(np.abs(want["w"] - w0).sum()) == 0:
            raise AssertionError("sharded pair: the learning run learned nothing")
        refs = (("the world of one", want, ("raster", "v", "r", "w")),)
        if not learning:   # the dyadic grid: the plain path's sums are exact in any order
            refs += (("the plain path's world of one", plain, ("raster", "v", "r")),)
        for r, rank in enumerate(pair):
            got = rank[name]
            for what, ref, keys in refs:
                for key in keys:
                    if not (got[key] is None and ref[key] is None
                            or np.array_equal(got[key], ref[key])):
                        raise AssertionError(f"sharded pair {name}, rank {r}: {key} differs "
                                             f"from {what}")
                for f in FIELDS:
                    if ref is plain and f in ("overflow", "policy_dense"):
                        continue
                    a, b = got["telem"][f], ref["telem"][f]
                    tol = (0 if f in ("ticks", "spikes", "v_max", "overflow", "policy_dense")
                           else 1e-6 if f in ("v_sum", "ref_sum") else 1e-5)
                    if not np.allclose(a, b, rtol=tol, atol=0):
                        raise AssertionError(f"sharded pair {name}, rank {r}: telemetry {f} "
                                             f"{a} against {what}'s {b}")
            add(got["launches"])
        tail = ""
        if learning:
            lt = pair[0]["learning ticks"]
            if not np.array_equal(lt["w"], pair[0][name]["w"]):
                raise AssertionError("sharded pair learning: the one-tick chunks' w differs "
                                     "from the rollout's")
            tail = (f"; tick by tick against the plain path's world of one (jnp, plain "
                    f"plasticity pass) within rtol=1e-5, atol=1e-3: {lt['ties']} rounding "
                    f"ties, max |dv| {lt['dv']:.3g}, max |dw| {lt['dw']:.3g}; free-running "
                    f"against it {int((plain['raster'] != want['raster']).sum())} raster "
                    f"entries differ, max |dw| {np.abs(plain['w'] - want['w']).max():.3g}")
        arms = (want["telem"]["ticks"][0] - want["telem"]["overflow"][0],
                want["telem"]["overflow"][0])
        log(f"sharded pair {name} (n={SHARD_N}, {SHARD_ROWS} rows, {SHARD_TICKS} ticks, 2 "
            f"gloo ranks on {pair[0]['device']}, exchange {pair[0]['exchange']}): raster "
            f"({int(want['raster'].sum())} spikes), state"
            + (", learned w == the world of one bitwise" if learning else
               " == the world of one bitwise, on its backend and on jnp")
            + ", telemetry totals as the CPU tests hold them; launches "
            + ", ".join(f"rank {r} {p[name]['launches']}" for r, p in enumerate(pair))
            + f" (world of one {want['launches']}); walls {pair[0][name]['wall']:.3f} / "
            f"{want['wall']:.3f} s"
            + (f"; event arm {arms[0]} ticks, dense on overflow {arms[1]}"
               if opts.get("backend") == "event" else "") + tail)
        for kernel, plan in pair[0][name]["plans"].items():
            log(f"plan {kernel} (sharded pair {name}, rank 0): {plan}")
    for kernel in ("lif_step", "event_dispatch_db", "event_dispatch", "stdp_update",
                   "telemetry"):
        if total[kernel] < 1:
            raise AssertionError(f"sharded phase: {kernel} never launched ({total})")
    log(f"sharded phase launches (both worlds, every rank): {total}")
    return total


# -- 13. analysis ---------------------------------------------------------------------


def guard_loop(counts: dict, key: str):
    """Run ``TickEngine.tick_body`` (the tick loop's body, once a tick) under
    ``torch.cuda.set_sync_debug_mode("error")``, counting its calls under
    ``counts[key]``; returns the undo."""
    import torch

    from repro_torch.core.engine import TickEngine

    body = TickEngine.tick_body

    def guarded(self, *args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return body(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            counts[key[0]] = counts.get(key[0], 0) + 1

    TickEngine.tick_body = guarded
    return lambda: setattr(TickEngine, "tick_body", body)


def full_width_params(dev, gen):
    """An 8-slot snn-fused FULL fabric: u8-grid weights, 5 % masks, identity
    input weights, the reference's LIF rows, every leaf per slot."""
    import torch

    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network_types import SNNParams

    n, S = N, SLOTS
    w = torch.randint(0, 8, (S, n, n), generator=gen, device=dev).float() * 0.25
    c = (torch.rand((S, n, n), generator=gen, device=dev) < 0.05).float()
    w_in = torch.eye(n, device=dev).expand(S, n, n).contiguous()
    lif = LIFParams.make(n, v_th=1.0, leak=0.25, r_ref=1, device=dev)
    lif = dataclasses.replace(lif, **{f.name: getattr(lif, f.name).expand(S, n).contiguous()
                                      for f in dataclasses.fields(lif)})
    return SNNParams(w=w, c=c, w_in=w_in, lif=lif)


def run_tick_programs(dev, gen, extra) -> None:
    """Every tick program of the gate's registry at snn-fused FULL, with the
    tick loop under ``set_sync_debug_mode("error")`` (the read after the
    loop, ``event_overflow="strict"``'s, is not part of it). ``extra`` runs
    in the first profiled program's trace (a trace of a few launches alone
    has come back with no device activity at all)."""
    import torch

    from repro_torch.analysis import programs
    from repro_torch.core.engine import TickEngine
    from repro_torch.core.network_types import SNNState
    from repro_torch.plasticity.stdp import PlasticityState

    params = full_width_params(dev, gen)
    ext = (torch.rand((TICKS, SLOTS, N), generator=gen, device=dev) < 0.05).float()
    ticks = {}
    key = [None]
    undo = guard_loop(ticks, key)
    try:
        for name in programs.program_names():
            parts = name.split("/")
            if parts[0] != "tick" or parts[1] not in programs.BACKENDS:
                continue
            _, backend, tag, tel = parts
            learning = tag == "learning"
            engine = TickEngine(programs.tick_options(backend, learning, tel == "telem"))
            state = SNNState.zeros((SLOTS,), N, device=dev)
            key[0] = name

            def run():
                if learning:
                    pst = PlasticityState.zeros((), N, device=dev, slots=SLOTS)
                    return engine.learning_rollout(params, state, pst, ext, TICKS)
                return engine.rollout(params, state, ext, TICKS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if name in PROFILED_PROGRAMS:
                guarded = ticks[name]
                traced = run if name != PROFILED_PROGRAMS[0] else lambda: (run(), extra())
                profiled_launches(traced, runs=1)
                ticks[name] = guarded
            spikes = int(out[1].sum().item())
            if ticks.get(name) != TICKS:
                raise AssertionError(f"analysis {name}: {ticks.get(name)} ticks guarded, not "
                                     f"{TICKS}")
            log(f"analysis {name} at snn-fused FULL ({N} neurons, {SLOTS} slots, {TICKS} "
                f"ticks): {ticks[name]} ticks under set_sync_debug_mode('error'), no host "
                f"sync; {spikes} spikes; {wall:.3f} s")
    finally:
        undo()


# Tick programs whose launches at snn-fused FULL are profiled and held to their
# descriptors (B1, B2, B3, B5 and the telemetry kernel; the earlier phases
# profile these kernels at smaller shapes only).
PROFILED_PROGRAMS = ("tick/pallas/learning/telem", "tick/pallas_fused/frozen/telem",
                     "tick/event/frozen/notelem")


def profiled_launches(fn, runs: int = 3) -> None:
    """Run ``fn`` once, then ``runs`` times under the profiler, and hold its
    kernel launches to their descriptors; an empty trace is retaken once,
    then fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with launches_seen() as seen, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        if hold_trace(prof, seen):
            return
    raise AssertionError(f"analysis: the trace of {sorted({d.name for d in seen})} came back "
                         f"with no kernel events twice")


def run_serve_programs(dev) -> None:
    """The wave, chunk and refill programs of a ``jnp`` server at snn-fused
    FULL whose sparse demo tenants ride the event program, with every tick
    body and every refill under ``set_sync_debug_mode("error")``."""
    import torch

    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serve import SNNServer, make_demo_requests, make_demo_tenants

    cfg = serve_config()
    server = SNNServer(n_max=cfg.n_neurons, slots=SLOTS, max_ticks=cfg.n_ticks,
                       mode=cfg.snn_mode, backend="jnp", device=dev, event_density=0.2,
                       chunk_ticks=CONT_CHUNK)
    names = make_demo_tenants(server, SLOTS, seed=0)
    reqs = make_demo_requests(server, names, 2 * SLOTS, seed=1)
    ticks, key = {}, [None]
    fill = serve_mod._Resident.fill
    fills = {}

    def guarded_fill(res, i, t):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fill(res, i, t)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        name = f"serve/refill/{'jnp' if res.fan_idx is None else 'event'}"
        fills[name] = fills.get(name, 0) + 1

    run_wave, run_chunk = server.run_wave, server._run_chunk

    def wave(batch):
        key[0] = "serve/wave/" + server.tenants[batch[0].tenant].backend
        run_wave(batch)

    def chunk(res, engine, backend, *args, **kwargs):
        key[0] = f"serve/chunk/{backend}"
        run_chunk(res, engine, backend, *args, **kwargs)

    server.run_wave, server._run_chunk = wave, chunk
    undo = guard_loop(ticks, key)
    serve_mod._Resident.fill = guarded_fill
    try:
        t0 = time.perf_counter()
        server.serve(reqs)
        server.serve_continuous(make_demo_requests(server, names, 2 * SLOTS, seed=1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        undo()
        serve_mod._Resident.fill = fill
        del server.run_wave, server._run_chunk
    want = {"serve/wave/jnp", "serve/wave/event", "serve/chunk/jnp"}
    if not want <= set(ticks) or "serve/refill/jnp" not in fills:
        raise AssertionError(f"analysis: serve programs ran {ticks}, refills {fills}")
    for name, n in sorted(ticks.items()):
        log(f"analysis {name} at snn-fused FULL ({len(reqs)} demo requests, {SLOTS} slots): "
            f"{n} ticks under set_sync_debug_mode('error'), no host sync")
    for name, n in sorted(fills.items()):
        log(f"analysis {name} at snn-fused FULL: {n} refills under "
            f"set_sync_debug_mode('error'), no host sync")
    log(f"analysis: the serve programs (a wave serve, then a continuous serve) {wall:.3f} s")


def retry_traces() -> None:
    """Profile once more each call whose traces came back empty twice in
    ``device_ms``; an empty trace now fails the phase."""
    for fn in TRACES["retry"]:
        profiled_launches(fn)
    TRACES["retry"].clear()


def static_smem_line(build_log: str) -> str:
    """Each kernel's static shared memory in the compiler's report against its
    descriptors' (``-Xptxas=-v``: "Used N registers, M bytes smem")."""
    from repro_torch.analysis import programs
    from repro_torch.kernels import _stream, stdp_update

    want = {}
    plans = [_stream.stdp_plan(1, 1, 74, 74, rstdp=False), _stream.stdp_plan(1, 1, 128, 128,
                                                                            rstdp=True)]
    launches = [d for _, x in programs.kernel_launches()
                for d in (x if isinstance(x, tuple) else (x,))]
    launches += [stdp_update.stdp_launch(p, dw_stats=s) for p in plans for s in (False, True)]
    for d in launches:
        want.setdefault(d.symbol, set()).add(d.smem_static)
    got, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used \d+ registers", line)
        if m and name:
            m = re.search(r"(\d+) bytes smem", line)   # absent when there is none
            # longest symbol first: "stdp_update_kernel" is no part of the
            # element kernel's name, but be safe against prefixes
            sym = max((s for s in want if s in name), key=len, default=None)
            if sym is not None:
                got.setdefault(sym, set()).add(int(m.group(1)) if m else 0)
            name = None
    if got != want:
        raise AssertionError(f"analysis: static shared memory by kernel in the compiler's "
                             f"report {got} against the descriptors' {want}")
    return f"{ {k: sorted(v) for k, v in sorted(got.items())} }"


def run_analysis_phase(dev, gen, build_log: str) -> None:
    import torch

    from repro_torch.analysis import check
    from repro_torch.analysis.findings import ERROR, INFO, WARNING

    t0 = time.perf_counter()
    report = check.run(device=dev)
    counts = {sev: sum(1 for f in report.findings if f.severity == sev)
              for sev in (ERROR, WARNING, INFO)}
    log(f"analysis gate (--all on {dev}): {len(report.programs_checked)} programs, "
        f"findings {counts} in {time.perf_counter() - t0:.2f} s")
    for f in report.findings:
        if f.severity != INFO:
            log(f"analysis {f.severity.upper()} {f.program} {f.rule}: {f.message[:160]}")
    if not report.ok():
        raise AssertionError(f"analysis gate: {len(report.errors)} error(s)")
    # B6 on its stream-K split at 8 x 4096 x 4096 (timed by CUDA events
    # earlier), profiled inside a tick program's trace
    from repro_torch.kernels import spike_matmul

    s = (torch.rand((ROWS, N), generator=gen, device=dev) < 0.5).float()
    w = torch.rand((N, N), generator=gen, device=dev)
    c = (torch.rand((N, N), generator=gen, device=dev) < 0.5).float()
    run_tick_programs(dev, gen, lambda: spike_matmul.spike_matmul(s, w, c))
    del s, w, c
    run_serve_programs(dev)
    retry_traces()
    log(f"analysis: traces without the launches' kernel events: {TRACES['missing']}")
    if TRACES["bad"]:
        raise AssertionError("analysis: profiled launches against their descriptors: "
                             + "; ".join(TRACES["bad"][:5]))
    kinds = sorted({k[0] for k in TRACES["checked"]})
    names = {"lif_step_kernel", "tick_fused_kernel", "event_dispatch_db_kernel",
             "event_dispatch_kernel", "spike_matmul_kernel", "telemetry_kernel"}
    if not names <= set(kinds) or not any(k.startswith("stdp_update") for k in kinds):
        raise AssertionError(f"analysis: profiled launches held only of {kinds}")
    log(f"analysis: {TRACES['launches']} profiled launches of {len(TRACES['checked'])} "
        f"distinct descriptors ({', '.join(kinds)}) held to the descriptors their wrappers "
        f"built: grid, block and shared memory (static + dynamic) equal; "
        f"{TRACES['dropped']} launches left no kernel record in their traces")
    log(f"analysis: static shared memory by kernel (ptxas) == the descriptors': "
        f"{static_smem_line(build_log)}")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 15: LM serving (the serve CLI's default arch) and decode steps at FULL
# ---------------------------------------------------------------------------

LM_ARCHS = ("smollm-135m", "smollm-360m", "qwen3-0.6b", "starcoder2-15b", "musicgen-large")
LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW = 4, 64, 12   # the serve CLI's defaults
LM_LOGIT_TOL = 2.0 ** -3   # bf16: the cached decode against a no-cache forward, |logit| ~ 4
LM_TIE = 2 * LM_LOGIT_TOL  # a greedy choice whose forward top-2 gap is under this is a tie
LM_SMOKE_TOL = 1e-4        # f32 SMOKE logits, the card against the CPU (TF32 off)
LM_F32_TOL = 2.0 ** -5     # f32 FULL, cached against a no-cache forward: cuBLAS sums in
                           # another order at another batch shape, amplified through 24
                           # rwkv6 layers (measured 0.0096 on an H100)
LM_PROMPT = 8              # the timed decode step's prompt length (its position)
LM_TIMED = 20              # timed decode steps per FULL config
LM_PROFILED = 5            # decode steps under the profiler per FULL config


def lm_requests(cfg, n: int, max_new: int):
    """The serve CLI's requests: prompts of 4-11 tokens from numpy seed 0."""
    import numpy as np

    from repro_torch.launch.serve import ServeRequest

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, 12))
        shape = (plen, cfg.n_codebooks) if cfg.family == "audio" else (plen,)
        reqs.append(ServeRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size, shape)
                                 .astype(np.int32), max_new=max_new))
    return reqs


def lm_wave(cfg, params, reqs, dev, vision=None):
    """One wave replayed step by step as ``WaveServer.run_wave`` serves it (every
    request runs ``LM_MAX_NEW`` tokens): the padded prompt, and the f32 logits
    and greedy tokens of the prefill and of each decode step. ``vision`` (the
    vlm's ``vision_embeds``) goes to the prefill."""
    import torch

    from repro_torch.launch.serve import WaveServer
    from repro_torch.models import model as M

    server = WaveServer(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN, device=dev)
    toks = torch.from_numpy(server._pad_prompts(reqs)).to(dev)
    caches = M.init_cache(cfg, LM_SLOTS, LM_MAX_LEN, dev)
    batch = {"inputs": toks}
    if vision is not None:
        batch["vision_embeds"] = vision
    last, caches = M.prefill_fn(params, cfg, batch, caches)
    logits, tokens = [last.float()], [last.argmax(-1)]
    for i in range(LM_MAX_NEW - 1):
        last, caches = M.decode_fn(params, cfg, {"token": tokens[-1][:, None],
                                                 "pos": toks.shape[1] + i}, caches)
        logits.append(last.float())
        tokens.append(last.argmax(-1))
    return toks, torch.stack(logits, 1), torch.stack(tokens, 1)


def check_lm_wave(cfg, params, reqs, dev, served, smi) -> None:
    """The first wave's prefill and decode logits against one no-cache forward
    over the same prefix (bf16, within ``LM_LOGIT_TOL``); every greedy token
    equals that forward's argmax unless its top-2 gap is under ``LM_TIE``."""
    import torch

    from repro_torch.models import model as M

    toks, logits, tokens = lm_wave(cfg, params, reqs, dev)
    got = {r.rid: tokens[i, :8].cpu().tolist() for i, r in enumerate(reqs)}
    if got != {r.rid: served[r.rid] for r in reqs}:
        raise AssertionError(f"lm wave: the replay's tokens {got} are not the CLI's {served}")
    seq = torch.cat([toks.long(), tokens[:, :-1]], dim=1)
    plen = toks.shape[1]
    full = M.forward(params, cfg, seq, mode="train")[0][:, plen - 1:].float()
    err = float((full - logits).abs().max())
    if not err <= LM_LOGIT_TOL:
        raise AssertionError(f"lm wave: decode logits {err} from the no-cache forward "
                             f"(tolerance {LM_LOGIT_TOL})")
    top2 = full.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = full.argmax(-1) != tokens
    if bool((differ & (gap >= LM_TIE)).any()):
        raise AssertionError(f"lm wave: a greedy token differs from the no-cache forward's "
                             f"with a top-2 gap of at least {LM_TIE}")
    log(f"lm wave 1 of smollm-135m FULL (4 requests, prompts padded to {plen}, "
        f"{LM_MAX_NEW} tokens each) on {smi}: the replay's tokens == the CLI's; prefill "
        f"and {LM_MAX_NEW - 1} decode steps' logits against one no-cache forward over the "
        f"same prefix: max |err| {err:.4g} (bf16, tolerance {LM_LOGIT_TOL}, |logit| max "
        f"{float(full.abs().max()):.3g}); greedy tokens == its argmax at "
        f"{int((~differ).sum())} of {differ.numel()}, {int(differ.sum())} rounding ties "
        f"(top-2 gap under {LM_TIE}; smallest gap {float(gap.min()):.3g})")


def check_lm_smoke(dev, smi) -> None:
    """smollm-135m SMOKE in f32 from the same params on the card and the CPU:
    served tokens equal, logits within ``LM_SMOKE_TOL``."""
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M

    cfg = get_bundle("smollm-135m").smoke
    cpu = torch.device("cpu")
    host = M.init(cfg, torch.Generator().manual_seed(0), cpu)
    card_params = tree_to(host, dev)
    stats = {d: serve(cfg, p, lm_requests(cfg, 6, LM_MAX_NEW), slots=LM_SLOTS,
                      max_len=LM_MAX_LEN, device=d)
             for d, p in ((cpu, host), (dev, card_params))}
    outs = {d: [r.out for r in st["results"]] for d, st in stats.items()}
    if outs[cpu] != outs[dev]:
        raise AssertionError("lm smoke: the card's tokens differ from the CPU's")
    reqs = lm_requests(cfg, LM_SLOTS, LM_MAX_NEW)
    waves = {d: lm_wave(cfg, p, reqs, d) for d, p in ((cpu, host), (dev, card_params))}
    err = float((waves[dev][1].cpu() - waves[cpu][1]).abs().max())
    if not err <= LM_SMOKE_TOL or not torch.equal(waves[dev][2].cpu(), waves[cpu][2]):
        raise AssertionError(f"lm smoke: card logits {err} from the CPU's "
                             f"(tolerance {LM_SMOKE_TOL}) or tokens differ")
    log(f"lm smoke (smollm-135m SMOKE, f32, the same params) on {smi}: 6 requests served, "
        f"{stats[dev]['new_tokens']} tokens == the CPU's token for token; a wave's prefill "
        f"and decode logits max |card - CPU| {err:.3g} (tolerance {LM_SMOKE_TOL})")


def tree_to(tree, dev):
    from repro_torch.util import tree as tree_util

    return tree_util.map(lambda t: t.to(dev), tree)


def tree_bytes(tree) -> int:
    from repro_torch.util import tree as tree_util

    return sum(t.numel() * t.element_size() for t in tree_util.leaves(tree))


def state_bytes(caches) -> int:
    """The bytes of a cache's recurrent states (every leaf but the KV caches'):
    a decode step rewrites them whole."""
    if isinstance(caches, dict):
        return sum(state_bytes(v) for k, v in caches.items() if k != "kv")
    if isinstance(caches, (list, tuple)):
        return sum(state_bytes(v) for v in caches)
    return caches.numel() * caches.element_size()


def kernel_rows(fn) -> list:
    """``fn()`` under ``torch.profiler`` tracing the device alone (a train
    step's hundreds of thousands of host ops take minutes to parse):
    ``[(device us, count, kernel)]``, most device time first; kernels on one
    stream do not overlap, so their sum is the busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)


def time_lm_decode(arch: str, dev, card, smi) -> dict:
    """One decode step of ``arch`` FULL (bf16, the port's seeded draws) at the
    CLI's 4 slots and 64-token cache, position ``LM_PROMPT`` (:func:`time_decode`)."""
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.models import model as M

    cfg = get_bundle(arch).model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = M.init(cfg, gen, dev)
    torch.cuda.synchronize()
    out = time_decode(cfg, params, gen, dev, card, smi, f"{arch} FULL",
                      time.perf_counter() - t0)
    del params
    torch.cuda.empty_cache()
    return out


def time_decode(cfg, params, gen, dev, card, smi, label: str, init_s: float,
                vision=None) -> dict:
    """One decode step of ``cfg`` at the CLI's 4 slots and 64-token cache,
    position ``LM_PROMPT`` (a prompt drawn from ``gen``, ``vision`` to the
    prefill): the wall per step (host clock around a synchronised step,
    median of ``LM_TIMED``), its device time and device events
    (``torch.profiler`` over ``LM_PROFILED`` steps), against the byte bound:
    the parameters and the cache read once and the recurrent states written
    once. A MoE config also runs one step with its routing recorded
    (:func:`moe_routes`): the capacity drops and the bound over the experts
    routed to."""
    import math

    import torch

    from repro_torch.models import model as M

    caches = M.init_cache(cfg, LM_SLOTS, LM_MAX_LEN, dev)
    shape = (LM_SLOTS, LM_PROMPT) + ((cfg.n_codebooks,) if cfg.family == "audio" else ())
    prompt = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)
    batch = {"inputs": prompt}
    if vision is not None:
        batch["vision_embeds"] = vision
    last, caches = M.prefill_fn(params, cfg, batch, caches)
    token = last.argmax(-1)[:, None]

    def step():
        return M.decode_fn(params, cfg, {"token": token, "pos": LM_PROMPT}, caches)[0]

    timed = time_step(step, dev, label)
    n = M.n_params(cfg)
    moved = n * 2 + tree_bytes(caches) + state_bytes(caches)
    extra = ""
    if cfg.n_experts:
        routes = []
        with moe_routes(routes):
            step()
        extra = routed_text(routes, moved, card)
    peak = torch.cuda.max_memory_allocated(dev)
    del caches
    bound_ms = moved / card[0] * 1e3
    device, events, wall_ms = timed["device_ms"], timed["events"], timed["wall_ms"]
    share = "not measured" if device is None else f"{device / wall_ms:.3f}"
    dev_text = ("device time not measured (three traces without device activity)"
                if device is None else
                f"device {device:.4f} ms in {events:.0f} device events a step (busy {share} "
                f"of the wall; the bound is {bound_ms / device:.0%} of the device time)")
    log(f"lm decode step {label} ({n:,} params, bf16, {LM_SLOTS} slots, cache "
        f"{LM_MAX_LEN}, position {LM_PROMPT}) on {smi}: wall {wall_ms:.4f} ms (median of "
        f"{LM_TIMED}), {dev_text}; bound {bound_ms:.4f} ms ({moved / 1e6:.1f} MB of params "
        f"and cache over {card[0] / 1e12:.2f} TB/s){extra}; peak memory "
        f"{peak / 2**30:.2f} GiB; init {init_s:.2f} s")
    if not math.isfinite(wall_ms):
        raise AssertionError(f"lm decode {label}: no wall time")
    return {"wall_ms": wall_ms, "device_ms": device, "events": events, "bound_ms": bound_ms}


def time_step(step, dev, label: str) -> dict:
    """``step`` after 3 warm-up calls: the median wall of ``LM_TIMED``
    synchronised calls, and device time and events a call from the profiler
    over ``LM_PROFILED`` calls (None when three traces came back empty)."""
    import torch

    for _ in range(3):
        out = step()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"lm decode {label}: non-finite output")
    walls = []
    for _ in range(LM_TIMED):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    device, events = None, None
    for _ in range(3):   # the profiler has returned traces with no device activity
        rows = kernel_rows(lambda: [step() for _ in range(LM_PROFILED)])
        if rows:
            device = sum(r[0] for r in rows) / 1e3 / LM_PROFILED
            events = sum(r[1] for r in rows) / LM_PROFILED
            break
    return {"wall_ms": statistics.median(walls) * 1e3, "device_ms": device, "events": events}


def run_lm_phase(dev, card, smi) -> dict:
    """The LM serving path: ``python -m repro_torch.launch.serve`` with no
    arguments (smollm-135m FULL in bf16 on the card) served twice (cold, then
    warm), no hand-written kernel launched; its first wave replayed against a
    no-cache forward; the SMOKE config in f32 against the CPU; one decode step
    timed at each of the five FULL configs. Returns the decode timings."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as M

    torch.cuda.empty_cache()
    runs = []
    for which in ("cold", "warm"):
        buf = io.StringIO()
        torch.cuda.synchronize()
        zero_launches()
        with contextlib.redirect_stdout(buf):
            stats = serve_mod.main([])
        torch.cuda.synchronize()
        launches = kernel_launches()
        if any(launches.values()):
            raise AssertionError(f"lm serve: a hand-written kernel launched: {launches}")
        if (stats["n_requests"], stats["new_tokens"]) != (6, 6 * LM_MAX_NEW):
            raise AssertionError(f"lm serve: {stats['n_requests']} requests, "
                                 f"{stats['new_tokens']} tokens")
        runs.append(stats)
        log(f"lm serve ({which}; no arguments: smollm-135m FULL, bf16, 6 requests, --max-new "
            f"{LM_MAX_NEW}, {LM_SLOTS} slots, --max-len {LM_MAX_LEN}) on {smi}: "
            f"{stats['new_tokens']} new tokens in {stats['decode_steps']} decode steps, "
            f"tokens_per_s {stats['tokens_per_s']}, mean TTFT {stats['mean_ttft_s']} s, p99 "
            f"TTFT {stats['p99_ttft_s']} s, wall {stats['wall_s']} s; hand-written kernel "
            f"launches {launches} (none lies on this path)")
    if runs[0]["outputs"] != runs[1]["outputs"]:
        raise AssertionError("lm serve: the two runs' tokens differ")
    for line in buf.getvalue().splitlines():
        if line.strip():
            log(f"lm serve | {line}")
    cfg = get_bundle("smollm-135m").model
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init(cfg, gen, dev)
    reqs = lm_requests(cfg, 6, LM_MAX_NEW)[:LM_SLOTS]
    check_lm_wave(cfg, params, reqs, dev, runs[1]["outputs"], smi)
    del params
    check_lm_smoke(dev, smi)
    return {arch: time_lm_decode(arch, dev, card, smi) for arch in LM_ARCHS}



# ---------------------------------------------------------------------------
# phase 16: LM serving for the moe, hybrid, rwkv and vlm families
# ---------------------------------------------------------------------------

FAMILY_SERVED = ("moonshot-v1-16b-a3b", "rwkv6-1.6b")   # whole on the card, through the CLI
FAMILY_SMOKES = ("llama4-scout-17b-a16e", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
                 "llama-3.2-vision-90b", "rwkv6-1.6b")
FAMILY_CAPACITY = 8.0   # both sides of a MoE cached-against-uncached check (as the
                        # reference's tests/test_models.py)
SCOUT_LAYERS = 8        # scout FULL is 216.5 GB: 8 of its 48 layers at full width
VLM_GROUPS = 2          # llama-3.2-vision FULL is 175.4 GB: 2 of its 20 groups of 5


@contextlib.contextmanager
def moe_routes(records: list):
    """While open, every MoE FFN call also appends its routing to ``records``
    (:func:`repro_torch.models.ffn.route` on the same normed tokens, the
    same capacity): the claims dropped past capacity, the (row, position)
    of each token that lost one, the experts routed to, and the bytes of one
    expert's weights."""
    from repro_torch.models import ffn
    from repro_torch.models.common import rms_norm

    moe = ffn.moe_ffn

    def spy(x, p, cfg, cap_factor=None):
        b, s, d = x.shape
        g = min(ffn.MOE_GROUP_TOKENS, b * s)
        cap = ffn._capacity(cfg, g, cap_factor or cfg.capacity_factor)
        r = ffn.route(rms_norm(x, p["ln"]).reshape(b * s // g, g, d), p["router"], cfg, cap)
        lost = r.dropped().any(-1).reshape(b, s)
        records.append({
            "dropped": int(r.dropped().sum()), "lost": lost.nonzero().cpu().tolist(),
            "routed": int((r.expert_mask.amax(dim=(0, 1)) > 0).sum()),
            "experts": cfg.n_experts,
            "expert_bytes": sum(p[k][0].numel() * p[k][0].element_size()
                                for k in ("w_gate", "w_up", "w_down"))})
        return moe(x, p, cfg, cap_factor)

    ffn.moe_ffn = spy
    try:
        yield records
    finally:
        ffn.moe_ffn = moe


def routed_text(routes: list, moved: int, card) -> str:
    """The capacity drops of one recorded step and its bound over the experts
    routed to (every other expert's weights left out of ``moved``)."""
    unrouted = sum((r["experts"] - r["routed"]) * r["expert_bytes"] for r in routes)
    routed_ms = (moved - unrouted) / card[0] * 1e3
    mean = sum(r["routed"] for r in routes) / len(routes)
    return (f"; the dense dispatch reads all {routes[0]['experts']} experts of each of "
            f"{len(routes)} MoE layers, the step routed to {mean:.2f} on average: bound over "
            f"the routed experts {routed_ms:.4f} ms ({(moved - unrouted) / 1e6:.1f} MB); "
            f"decode capacity drops {sum(r['dropped'] for r in routes)} claim(s) in "
            f"{sum(1 for r in routes if r['dropped'])} of {len(routes)} layers")


def family_serve(arch: str, dev, smi) -> dict:
    """``python -m repro_torch.launch.serve --arch <arch>`` (FULL, bf16, the
    CLI's defaults) once, every kernel count at 0 before and after."""
    import contextlib
    import io

    import torch

    from repro_torch.launch import serve as serve_mod

    torch.cuda.empty_cache()
    buf = io.StringIO()
    torch.cuda.synchronize()
    zero_launches()
    with contextlib.redirect_stdout(buf):
        stats = serve_mod.main(["--arch", arch])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"lm serve {arch}: a hand-written kernel launched: {launches}")
    if (stats["n_requests"], stats["new_tokens"]) != (6, 6 * LM_MAX_NEW):
        raise AssertionError(f"lm serve {arch}: {stats['n_requests']} requests, "
                             f"{stats['new_tokens']} tokens")
    log(f"lm serve --arch {arch} (FULL, bf16, 6 requests, --max-new {LM_MAX_NEW}, "
        f"{LM_SLOTS} slots, --max-len {LM_MAX_LEN}) on {smi}: {stats['new_tokens']} new tokens "
        f"in {stats['decode_steps']} decode steps, tokens_per_s {stats['tokens_per_s']}, mean "
        f"TTFT {stats['mean_ttft_s']} s, p99 TTFT {stats['p99_ttft_s']} s, wall "
        f"{stats['wall_s']} s; hand-written kernel launches {launches} (none lies on this "
        f"path)")
    for line in buf.getvalue().splitlines():
        if line.strip():
            log(f"lm serve {arch} | {line}")
    return stats


def wave_against_forward(cfg, params, reqs, dev) -> dict:
    """A wave of ``cfg`` replayed (:func:`lm_wave`) and one no-cache forward
    over the same prefix, their MoE routing recorded: the logits' largest
    difference over the rows where neither run dropped a claim, and the
    greedy tokens against the forward's argmax there."""
    import torch

    from repro_torch.models import model as M

    routes = []
    with moe_routes(routes):
        toks, logits, tokens = lm_wave(cfg, params, reqs, dev)
        seq = torch.cat([toks.long(), tokens[:, :-1]], dim=1)
        plen = toks.shape[1]
        full = M.forward(params, cfg, seq, mode="train")[0][:, plen - 1:].float()
    keep = torch.ones(LM_SLOTS, dtype=torch.bool)
    for r in routes:
        for row, _ in r["lost"]:
            keep[row] = False
    if not bool(keep.any()):
        raise AssertionError(f"lm wave {cfg.name}: every row dropped a claim")
    keep = keep.to(dev)
    top2 = full.topk(2, dim=-1).values
    return {"err": float((full - logits)[keep].abs().max()), "plen": plen,
            "gap": (top2[..., 0] - top2[..., 1])[keep],
            "differ": (full.argmax(-1) != tokens)[keep],
            "dropped": sum(r["dropped"] for r in routes), "left_out": LM_SLOTS - int(keep.sum()),
            "logit_max": float(full.abs().max())}


def check_family_wave(cfg, params, reqs, dev, served, smi) -> None:
    """The first wave of ``cfg`` replayed as the CLI served it (its tokens ==
    the CLI's), then its prefill and decode logits against one no-cache
    forward over the same prefix (:func:`wave_against_forward`): within
    ``LM_LOGIT_TOL`` in bf16, every greedy token that forward's argmax unless
    its top-2 gap is under ``LM_TIE``. A MoE config runs both at
    ``FAMILY_CAPACITY`` (the prefill and the forward group their tokens
    differently, so at the config's factor they drop different claims), the
    rows that still dropped one left out. rwkv6 is held in f32
    (``LM_F32_TOL``, its own seeded f32 draws, 6.4 GB): its group norm
    amplifies the bf16 rounding of products taken at other batch shapes
    until the two bf16 runs part (the bf16 difference is printed, not
    held)."""
    import torch

    from repro_torch.models import model as M

    _, _, tokens = lm_wave(cfg, params, reqs, dev)
    got = {r.rid: tokens[i, :8].cpu().tolist() for i, r in enumerate(reqs)}
    if got != {r.rid: served[r.rid] for r in reqs}:
        raise AssertionError(f"lm wave {cfg.name}: the replay's tokens {got} are not the "
                             f"CLI's {served}")
    check = dataclasses.replace(cfg, capacity_factor=FAMILY_CAPACITY) if cfg.n_experts else cfg
    tol, tie, how, bf16_text = LM_LOGIT_TOL, LM_TIE, "bf16", ""
    run_params = params
    if cfg.family == "rwkv":
        bf16 = wave_against_forward(check, params, reqs, dev)
        bf16_text = (f"; in bf16 the two differ by {bf16['err']:.4g} (printed, not held: "
                     f"{int(bf16['differ'].sum())} of {bf16['differ'].numel()} greedy tokens "
                     f"differ)")
        check = dataclasses.replace(check, dtype="float32")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        run_params = M.init(check, gen, dev)
        tol, tie, how = LM_F32_TOL, 2 * LM_F32_TOL, "f32, the same seeded draws"
    res = wave_against_forward(check, run_params, reqs, dev)
    del run_params
    torch.cuda.empty_cache()
    if not res["err"] <= tol:
        raise AssertionError(f"lm wave {cfg.name}: decode logits {res['err']} from the no-cache "
                             f"forward ({how}, tolerance {tol})")
    differ, gap = res["differ"], res["gap"]
    if bool((differ & (gap >= tie)).any()):
        raise AssertionError(f"lm wave {cfg.name}: a greedy token differs from the no-cache "
                             f"forward's with a top-2 gap of at least {tie}")
    moe = (f" (capacity_factor {FAMILY_CAPACITY} on both sides; {res['dropped']} claim(s) "
           f"dropped, {res['left_out']} row(s) left out)" if cfg.n_experts else "")
    log(f"lm wave 1 of {cfg.name} FULL (4 requests, prompts padded to {res['plen']}, "
        f"{LM_MAX_NEW} tokens each) on {smi}: the replay's tokens == the CLI's; prefill and "
        f"{LM_MAX_NEW - 1} decode steps' logits against one no-cache forward over the same "
        f"prefix{moe}: max |err| {res['err']:.4g} ({how}, tolerance {tol}, |logit| max "
        f"{res['logit_max']:.3g}); greedy tokens == its argmax at {int((~differ).sum())} of "
        f"{differ.numel()}, {int(differ.sum())} rounding ties (top-2 gap under {tie}; "
        f"smallest gap {float(gap.min()):.3g}){bf16_text}")


def smoke_vision(cfg, dev):
    """Seeded ``vision_embeds`` for a vlm config in its dtype, made on the CPU
    (the same on every device), or None."""
    import torch

    from repro_torch.models import model as M

    if cfg.family != "vlm":
        return None
    gen = torch.Generator().manual_seed(16)
    shape = (LM_SLOTS, cfg.n_vision_tokens, cfg.d_vision)
    return torch.randn(shape, generator=gen).to(dev, M.dtype_of(cfg))


def check_family_smokes(dev, smi) -> None:
    """Each of the five archs' SMOKE configs in f32 from the same parameters
    on the card and the CPU: the served tokens equal (the vlm, which the
    server refuses, through ``prefill_fn`` / ``decode_fn`` with seeded
    ``vision_embeds``), a wave's logits within ``LM_SMOKE_TOL`` and its
    greedy tokens equal."""
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M

    cpu = torch.device("cpu")
    for arch in FAMILY_SMOKES:
        cfg = get_bundle(arch).smoke
        host = M.init(cfg, torch.Generator().manual_seed(0), cpu)
        on = {cpu: host, dev: tree_to(host, dev)}
        served = ""
        if cfg.family != "vlm":
            outs = {d: [r.out for r in serve(cfg, p, lm_requests(cfg, 6, LM_MAX_NEW),
                                             slots=LM_SLOTS, max_len=LM_MAX_LEN,
                                             device=d)["results"]]
                    for d, p in on.items()}
            if outs[cpu] != outs[dev]:
                raise AssertionError(f"lm smoke {arch}: the card's tokens differ from the "
                                     f"CPU's")
            served = f"6 requests served, {sum(map(len, outs[dev]))} tokens == the CPU's; "
        reqs = lm_requests(cfg, LM_SLOTS, LM_MAX_NEW)
        waves = {d: lm_wave(cfg, p, reqs, d, smoke_vision(cfg, d)) for d, p in on.items()}
        err = float((waves[dev][1].cpu() - waves[cpu][1]).abs().max())
        if not err <= LM_SMOKE_TOL or not torch.equal(waves[dev][2].cpu(), waves[cpu][2]):
            raise AssertionError(f"lm smoke {arch}: card logits {err} from the CPU's "
                                 f"(tolerance {LM_SMOKE_TOL}) or tokens differ")
        log(f"lm smoke {arch} ({cfg.name}, {cfg.family}, f32, the same params) on {smi}: "
            f"{served}a wave's prefill and {LM_MAX_NEW - 1} decode steps"
            + (" (seeded vision_embeds)" if cfg.family == "vlm" else "")
            + f": tokens equal, logits max |card - CPU| {err:.3g} (tolerance {LM_SMOKE_TOL})")


def time_jamba_layers(dev, card, smi) -> None:
    """One decode-mode ``_apply_layer`` of each of jamba FULL's layer kinds at
    full width (a group alone is about 88 GB): mamba + dense (index 0),
    mamba + MoE (1), attn + dense (4), each from its own seeded parameters
    and a zero cache at position ``LM_PROMPT``, timed as :func:`time_decode`
    times a step."""
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import init_params, zeros_params
    from repro_torch.util import tree as tree_util

    cfg = get_bundle("jamba-1.5-large-398b").model
    plan = tf.stage_plans(cfg)[0]
    for idx in (0, 1, cfg.attn_index):
        lp = plan.layers[idx]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(idx)
        t0 = time.perf_counter()
        p = init_params(tf._layer_specs(cfg, lp), gen, cfg.dtype, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cache = zeros_params(tf._layer_cache_specs(cfg, lp, LM_SLOTS, LM_MAX_LEN), cfg.dtype,
                             dev)
        x = torch.randn((LM_SLOTS, 1, cfg.d_model), generator=gen, device=dev)
        x = x.to(torch.bfloat16)
        positions = torch.full((LM_SLOTS, 1), LM_PROMPT, dtype=torch.int64, device=dev)

        def step():
            return tf._apply_layer(x, p, cfg, lp, mode="decode", positions=positions,
                                   cache_pos=LM_PROMPT, cache=cache, vision_proj=None)[0]

        timed = time_step(step, dev, f"jamba layer {idx}")
        n = sum(t.numel() for t in tree_util.leaves(p))
        moved = tree_bytes(p) + tree_bytes(cache or {}) + state_bytes(cache or {})
        extra = ""
        if lp.ffn == "moe":
            routes = []
            with moe_routes(routes):
                step()
            extra = routed_text(routes, moved, card)
        peak = torch.cuda.max_memory_allocated(dev)
        bound_ms = moved / card[0] * 1e3
        device = timed["device_ms"]
        dev_text = ("device time not measured (three traces without device activity)"
                    if device is None else
                    f"device {device:.4f} ms in {timed['events']:.0f} device events a step "
                    f"(busy {device / timed['wall_ms']:.3f} of the wall; the bound is "
                    f"{bound_ms / device:.0%} of the device time)")
        log(f"lm decode layer jamba-1.5-large-398b FULL layer {idx} ({lp.mixer} + {lp.ffn}, "
            f"{n:,} params, bf16, {LM_SLOTS} slots, position {LM_PROMPT}) on {smi}: wall "
            f"{timed['wall_ms']:.4f} ms (median of {LM_TIMED}), {dev_text}; bound "
            f"{bound_ms:.4f} ms ({moved / 1e6:.1f} MB of params and state over "
            f"{card[0] / 1e12:.2f} TB/s){extra}; peak memory {peak / 2**30:.2f} GiB; init "
            f"{init_s:.2f} s")
        del p, cache, x
    torch.cuda.empty_cache()


def time_family_decode(arch: str, dev, card, smi, params=None, init_s: float = 0.0,
                       **cut) -> None:
    """One decode step of ``arch`` FULL (its depth cut by ``cut``, e.g.
    ``n_layers``), from ``params`` when given (drawn from seed 0 otherwise,
    ``init_s`` the draw's seconds), timed by :func:`time_decode`; a vlm
    prefill takes seeded ``vision_embeds``."""
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.models import model as M

    full = get_bundle(arch).model
    cfg = dataclasses.replace(full, **cut)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if params is None:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = M.init(cfg, gen, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    label = f"{arch} FULL" + (f" ({cfg.n_layers} of its {full.n_layers} layers)"
                              if cfg.n_layers != full.n_layers else "")
    time_decode(cfg, params, gen, dev, card, smi, label, init_s, vision=smoke_vision(cfg, dev))
    del params
    torch.cuda.empty_cache()


def run_family_phase(dev, card, smi) -> None:
    """LM serving for the moe, hybrid, rwkv and vlm families:
    moonshot-v1-16b-a3b FULL (56.8 GB) and rwkv6-1.6b FULL served through the
    CLI, each first wave held against a no-cache forward; the five archs'
    SMOKE configs against the CPU; one decode step timed at each arch's
    width (scout at 8 of 48 layers, the vlm at 2 of 20 groups, jamba one
    layer of each kind)."""
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    for arch in FAMILY_SERVED:
        served = family_serve(arch, dev, smi)
        cfg = get_bundle(arch).model
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t1 = time.perf_counter()
        params = M.init(cfg, gen, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t1
        check_family_wave(cfg, params, lm_requests(cfg, 6, LM_MAX_NEW)[:LM_SLOTS], dev,
                          served["outputs"], smi)
        time_family_decode(arch, dev, card, smi, params=params, init_s=init_s)
        del params
        torch.cuda.empty_cache()
    check_family_smokes(dev, smi)
    time_family_decode("llama4-scout-17b-a16e", dev, card, smi, n_layers=SCOUT_LAYERS)
    vlm = get_bundle("llama-3.2-vision-90b").model
    time_family_decode("llama-3.2-vision-90b", dev, card, smi,
                       n_layers=VLM_GROUPS * vlm.group_size)
    time_jamba_layers(dev, card, smi)
    log(f"lm families phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: LM training (the train CLI at smollm-135m FULL, SMOKE steps on
# the card against the CPU, one step timed at three FULL widths)
# ---------------------------------------------------------------------------

TRAIN_SMOKES = ("smollm-135m", "musicgen-large", "moonshot-v1-16b-a3b",
                "llama4-scout-17b-a16e", "jamba-1.5-large-398b", "rwkv6-1.6b",
                "llama-3.2-vision-90b")
TRAIN_SMOKE_STEPS = 3
TRAIN_SMOKE_SHAPE = (16, 2)   # (seq_len, global batch): the CPU tests' shape
TRAIN_SMOKE_TOL = 1e-4        # loss, grad_norm and lr of a step, card against CPU, relative
TRAIN_RESUME_AT = 40          # the interrupted run's last step before it resumes
TRAIN_RESUME_TOL = 1e-3       # resumed losses against the uninterrupted run's, relative
TRAIN_SHAPE = (64, 8)         # the CLI's --seq-len / --global-batch in examples/train_lm.py
TRAIN_TIMED = ("smollm-135m", "rwkv6-1.6b", "moonshot-v1-16b-a3b")
MOONSHOT_TRAIN_LAYERS = 2     # moonshot FULL cut to its dense layer and its first MoE layer
TRAIN_TIMED_STEPS = 2         # timed steps per remat setting, after one warm-up step
# Dense bf16 tensor-core peaks (NVIDIA's data sheets, no sparsity), by card name.
BF16_PEAKS = {"H200": 989e12, "PCIe": 756e12, "NVL": 835e12}
H100_SXM_BF16 = 989e12


def bf16_peak(smi: str) -> float:
    return next((v for k, v in BF16_PEAKS.items() if k in smi), H100_SXM_BF16)


def leaf_max_diff(a_dir: Path, b_dir: Path) -> tuple:
    """Two checkpoint directories' files: (byte-equal, the largest |a - b|
    over every leaf read by its manifest dtype)."""
    import numpy as np

    from repro_torch.checkpoint import checkpointer

    meta = json.loads((a_dir / checkpointer.META).read_text())["manifest"]
    same, worst = True, 0.0
    for entry in meta.values():
        fa, fb = a_dir / entry["file"], b_dir / entry["file"]
        same = same and fa.read_bytes() == fb.read_bytes()
        ta = checkpointer._read_npy(str(fa), entry["dtype"]).float()
        tb = checkpointer._read_npy(str(fb), entry["dtype"]).float()
        worst = max(worst, float((ta - tb).abs().max()) if ta.numel() else 0.0)
    return same, worst


def loss_gap(a: list, b: list) -> float:
    """The largest relative difference between two loss lists."""
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def train_full_cli(work: Path, smi) -> dict:
    """``python -m repro_torch.examples.train_lm --full`` (smollm-135m FULL,
    bf16, 60 steps, checkpoints every 20 into its own temporary directory):
    its loss decreases and its checkpoints rotate to 3; its step-60
    checkpoint is kept under ``work``. Then the same CLI in a fresh
    directory stopped after ``TRAIN_RESUME_AT`` steps (its loop given 40 of
    the 60: a preempted job, the 60-step schedule) and run again to 60,
    which resumes at 40 from the bf16 checkpoint; its losses and final
    checkpoint against the uninterrupted run's."""
    import contextlib
    import io
    import shutil

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_bundle
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as M

    seen = {}
    real_main = train_mod.main

    def spy(argv):
        losses = real_main(argv)
        d = Path(argv[argv.index("--ckpt-dir") + 1])
        seen.update(argv=list(argv), steps=ckpt.all_steps(str(d)))
        shutil.copytree(d / "step_00000060", work / "whole")
        return losses

    buf = io.StringIO()
    t0 = time.perf_counter()
    train_mod.main = spy
    try:
        with contextlib.redirect_stdout(buf):
            whole = train_lm.main(["--full"])
    finally:
        train_mod.main = real_main
    whole_s = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        if line.strip():
            log(f"lm train | {line}")
    if seen["steps"] != [20, 40, 60] or len(whole) != 60 or not whole[-1] < whole[0]:
        raise AssertionError(f"lm train: checkpoints {seen['steps']}, {len(whole)} losses "
                             f"{whole[0]} -> {whole[-1]}")
    argv = seen["argv"]
    argv[argv.index("--ckpt-dir") + 1] = str(work / "resumed")
    real_loop = train_mod.ft.run_resilient_loop
    buf = io.StringIO()
    t0 = time.perf_counter()
    train_mod.ft.run_resilient_loop = lambda **kw: real_loop(**{**kw, "n_steps": TRAIN_RESUME_AT})
    try:
        with contextlib.redirect_stdout(buf):
            first = real_main(argv)
    finally:
        train_mod.ft.run_resilient_loop = real_loop
    if ckpt.all_steps(str(work / "resumed")) != [20, 40]:
        raise AssertionError(f"lm train: the interrupted run wrote "
                             f"{ckpt.all_steps(str(work / 'resumed'))}")
    with contextlib.redirect_stdout(buf):
        rest = real_main(argv)
    resumed_s = time.perf_counter() - t0
    for line in buf.getvalue().splitlines()[-2:]:
        log(f"lm train (resumed) | {line}")
    if len(first) != TRAIN_RESUME_AT or len(rest) != 60 - TRAIN_RESUME_AT:
        raise AssertionError(f"lm train: {len(first)} + {len(rest)} losses")
    same_files, param_err = leaf_max_diff(work / "whole", work / "resumed" / "step_00000060")
    gap_first, gap_rest = loss_gap(first, whole[:TRAIN_RESUME_AT]), loss_gap(
        rest, whole[TRAIN_RESUME_AT:])
    if not gap_rest <= TRAIN_RESUME_TOL:
        raise AssertionError(f"lm train: the resumed losses are {gap_rest} from the "
                             f"uninterrupted run's (tolerance {TRAIN_RESUME_TOL})")
    log(f"lm train (examples/train_lm --full: smollm-135m FULL, "
        f"{M.n_params(get_bundle('smollm-135m').model):,} params, bf16, "
        f"60 steps of {TRAIN_SHAPE[1]} x {TRAIN_SHAPE[0]} tokens, peak lr 1e-3) on {smi}: loss "
        f"{whole[0]:.4f} -> {whole[-1]:.4f}, decreased; checkpoints rotated to "
        f"{seen['steps']}; {whole_s:.1f} s with its checkpoints")
    log(f"lm train resume (a fresh directory: 40 steps of the 60-step schedule, then the CLI "
        f"to 60, resumed at 40 from the bf16 checkpoint; {resumed_s:.1f} s): the 20 resumed "
        f"losses against the uninterrupted run's: max relative difference {gap_rest:.3g}, "
        f"bitwise {rest == whole[TRAIN_RESUME_AT:]}; the first 40: {gap_first:.3g}, bitwise "
        f"{first == whole[:TRAIN_RESUME_AT]}; final checkpoint files byte for byte "
        f"{same_files}, largest leaf difference {param_err:.3g} (tolerance "
        f"{TRAIN_RESUME_TOL} relative on the losses)")
    return {"whole": whole, "bitwise": rest == whole[TRAIN_RESUME_AT:]}


def grad_determinism(dev, smi) -> None:
    """Two backward passes of smollm-135m FULL on the same state and batch:
    the gradient leaves that differ bitwise name the nondeterministic
    operation (an ``index_add_`` / ``index_put_`` backward with colliding
    indices adds in another order)."""
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.util import tree

    cfg = get_bundle("smollm-135m").model
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init(cfg, gen, dev)
    batch = pipeline.make_batch(cfg, ShapeConfig("t", "train", *TRAIN_SHAPE),
                                pipeline.PipelineState(17, 0), device=dev)
    runs = [steps._value_and_grad(params, cfg, batch, "block")[2] for _ in range(2)]
    differ = ["/".join(map(str, p)) for (p, a), b in zip(tree.flatten_with_paths(runs[0]),
                                                         tree.leaves(runs[1]))
              if not torch.equal(a, b)]
    log(f"lm train determinism (smollm-135m FULL, one batch, two backward passes) on {smi}: "
        f"{len(differ)} of {len(tree.leaves(runs[0]))} gradient leaves differ bitwise"
        + (f": {differ}" if differ else ""))


def train_smokes(dev, smi) -> None:
    """Every family's SMOKE config in f32 from the same parameters and
    batches on the card and the CPU, ``TRAIN_SMOKE_STEPS`` train steps under
    the CLI's knobs (jamba also at 2 microbatches, its bf16 optimizer state):
    loss, grad_norm and lr within ``TRAIN_SMOKE_TOL``."""
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models.common import torch_dtype
    from repro_torch.optim import adamw

    cpu = torch.device("cpu")
    shape = ShapeConfig("smoke", "train", *TRAIN_SMOKE_SHAPE)
    cases = [(a, 1) for a in TRAIN_SMOKES] + [("jamba-1.5-large-398b", 2)]
    for arch, micro in cases:
        bundle = get_bundle(arch)
        cfg = bundle.smoke
        pcfg = bundle.parallel_for("train_4k").replace(microbatches=micro)
        host = M.init(cfg, torch.Generator().manual_seed(0), cpu)
        worst = {"loss": 0.0, "grad_norm": 0.0, "lr": 0.0}
        seen = []
        for d in (cpu, dev):
            params = tree_to(host, d)
            state = steps.TrainState(params, adamw.init(params, torch_dtype(pcfg.opt_state_dtype)))
            step = steps.make_train_step(cfg, pcfg, peak_lr=1e-3, warmup_steps=1,
                                         total_steps=TRAIN_SMOKE_STEPS)
            pipe, out = pipeline.PipelineState(17, 0), []
            for _ in range(TRAIN_SMOKE_STEPS):
                state, metrics = step(state, pipeline.make_batch(cfg, shape, pipe, device=d))
                out.append({k: float(metrics[k]) for k in worst})
                pipe = pipeline.advance(pipe)
            seen.append(out)
        for c, g in zip(*seen):
            for k in worst:
                worst[k] = max(worst[k], abs(g[k] - c[k]) / max(abs(c[k]), 1e-30)
                               if c[k] else abs(g[k]))
        if max(worst.values()) > TRAIN_SMOKE_TOL:
            raise AssertionError(f"lm train smoke {arch} (micro {micro}): card against CPU "
                                 f"{worst} (tolerance {TRAIN_SMOKE_TOL})")
        log(f"lm train smoke {arch} ({cfg.name}, {cfg.family}, f32, {TRAIN_SMOKE_STEPS} steps "
            f"of {shape.global_batch} x {shape.seq_len} tokens, remat {pcfg.remat}, "
            f"microbatches {micro}, optimizer state {pcfg.opt_state_dtype}, grad accumulation "
            f"{pcfg.grad_accum_dtype}"
            + (", seeded vision_embeds" if cfg.family == "vlm" else "")
            + f") on {smi}: losses {[round(m['loss'], 5) for m in seen[1]]}; largest "
            f"relative |card - CPU|: loss {worst['loss']:.3g}, grad_norm "
            f"{worst['grad_norm']:.3g}, lr {worst['lr']:.3g} (tolerance {TRAIN_SMOKE_TOL})")


def train_flops_params(cfg) -> int:
    """The parameters one token's forward multiplies by: every parameter but
    the experts a token is not routed to."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf

    n = M.n_params(cfg)
    if not cfg.n_experts:
        return n
    per_expert = 3 * cfg.d_model * cfg.d_ff
    moe_layers = sum(st.n_groups * sum(lp.ffn == "moe" for lp in st.layers)
                     for st in tf.stage_plans(cfg))
    return n - moe_layers * (cfg.n_experts - cfg.top_k) * per_expert


def time_train_step(arch: str, dev, card, smi) -> dict:
    """One train step of ``arch`` FULL (bf16, the port's seeded draws; moonshot
    cut to ``MOONSHOT_TRAIN_LAYERS`` layers) at the CLI's shape, under remat
    ``none`` and ``block``: the wall a step (host clock around a synchronised
    step, median of ``TRAIN_TIMED_STEPS``), its device time and events (the
    profiler over one step), tokens/s and peak memory, against the FLOP bound
    (``8 * params * tokens`` with remat's second forward, ``6 *`` without,
    over the card's dense bf16 peak; a MoE counts the routed experts only)
    and the byte bound (parameters read 3 times, gradients 4 times, ``m`` and
    ``v`` read and written, parameters written, over the memory rate; for a
    MoE also with the parameter reads of unrouted experts left out)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    bundle = get_bundle(arch)
    full = bundle.model
    cfg = full if arch != "moonshot-v1-16b-a3b" else dataclasses.replace(
        full, n_layers=MOONSHOT_TRAIN_LAYERS)
    label = f"{arch} FULL" + (f" ({cfg.n_layers} of its {full.n_layers} layers)"
                              if cfg.n_layers != full.n_layers else "")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pcfg0 = bundle.parallel_for("train_4k").replace(microbatches=1)
    state = steps.init_train_state(cfg, pcfg0, gen, dev)
    shape = ShapeConfig("timed", "train", *TRAIN_SHAPE)
    batch = pipeline.make_batch(cfg, shape, pipeline.PipelineState(17, 0), device=dev)
    tokens = shape.seq_len * shape.global_batch
    n = M.n_params(cfg)
    p_bytes = tree_bytes(state.params)
    mv_bytes = tree_bytes(state.opt.m) + tree_bytes(state.opt.v)
    moved = 3 * p_bytes + 4 * p_bytes + 2 * mv_bytes + p_bytes
    byte_ms = moved / card[0] * 1e3
    routed_text_ = ""
    if cfg.n_experts:
        routes = []
        with moe_routes(routes), torch.no_grad():
            M.loss_fn(state.params, cfg, batch, remat="none")
        unrouted = sum((r["experts"] - r["routed"]) * r["expert_bytes"] for r in routes)
        routed_ms = (moved - 3 * unrouted) / card[0] * 1e3
        total = {k: sum(r[k] for r in routes) for k in ("routed", "experts", "dropped")}
        routed_text_ = (f"; the step routed to {total['routed']} of {total['experts']} experts "
                        f"({total['dropped']} claims dropped past capacity): byte bound over "
                        f"the routed experts {routed_ms:.4f} ms")
    out = {}
    for remat in ("none", "block"):
        step = steps.make_train_step(cfg, pcfg0.replace(remat=remat), peak_lr=1e-3,
                                     warmup_steps=1, total_steps=10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        s, metrics = step(state, batch)            # warm-up
        torch.cuda.synchronize()
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"lm train step {label}: non-finite loss")
        walls = []
        for _ in range(TRAIN_TIMED_STEPS):
            t0 = time.perf_counter()
            s, metrics = step(s, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
        device, events, rows = None, None, []
        for _ in range(3):   # the profiler has returned traces with no device activity
            rows = kernel_rows(lambda: step(s, batch))
            if rows:
                device, events = sum(r[0] for r in rows) / 1e3, sum(r[1] for r in rows)
                break
        del s, metrics
        wall_ms = statistics.median(walls) * 1e3
        flops = (8 if remat == "block" else 6) * train_flops_params(cfg) * tokens
        flop_ms = flops / bf16_peak(smi) * 1e3
        bound_ms = max(flop_ms, byte_ms)
        dev_text = ("device time not measured (three traces without device activity)"
                    if device is None else
                    f"device {device:.4f} ms in {events} device events (busy "
                    f"{device / wall_ms:.3f} of the wall; the bound is "
                    f"{bound_ms / device:.1%} of the device time; most device time: "
                    + ", ".join(f"{name[:48]} {us / 1e3:.2f} ms in {count}"
                                for us, count, name in rows[:3]) + ")")
        log(f"lm train step {label} ({n:,} params, bf16, f32 m/v, {shape.global_batch} x "
            f"{shape.seq_len} tokens, remat {remat}) on {smi}: wall {wall_ms:.4f} ms (median of "
            f"{TRAIN_TIMED_STEPS}), {tokens / wall_ms * 1e3:.1f} tokens/s, {dev_text}; FLOP "
            f"bound {flop_ms:.4f} ms ({flops / 1e12:.3f} TFLOP over "
            f"{bf16_peak(smi) / 1e12:.0f} TFLOP/s bf16), byte bound {byte_ms:.4f} ms "
            f"({moved / 1e9:.3f} GB over {card[0] / 1e12:.2f} TB/s){routed_text_}; peak "
            f"memory {peak / 2**30:.2f} GiB")
        out[remat] = {"wall_ms": wall_ms, "device_ms": device, "peak": peak}
    del state, batch
    torch.cuda.empty_cache()
    return out


def run_train_phase(dev, card, smi) -> None:
    """LM training: the train CLI at smollm-135m FULL (60 steps, rotation, a
    resumed run against the uninterrupted one), a determinism probe, every
    family's SMOKE train steps against the CPU, and one train step timed at
    smollm-135m, rwkv6-1.6b and moonshot (2 layers) FULL; no hand-written
    kernel launches."""
    import shutil

    import torch

    t0 = time.perf_counter()
    parts = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        fn(*args)
        parts[name] = time.perf_counter() - t

    torch.cuda.empty_cache()
    zero_launches()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        part("the CLI and its resume", train_full_cli, work, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    part("determinism", grad_determinism, dev, smi)
    part("smokes", train_smokes, dev, smi)
    for arch in TRAIN_TIMED:
        part(arch, time_train_step, arch, dev, card, smi)
    torch.cuda.synchronize()
    launches = kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"lm train: a hand-written kernel launched: {launches}")
    log(f"lm train phase: {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f"); hand-written kernel launches {launches} (none lies on the training path)")


# ---------------------------------------------------------------------------
# phase 18: the LM stack on a DeviceMesh (the sharding rules, the production
# meshes, a sharded checkpoint, the correctly rounded square root)
# ---------------------------------------------------------------------------

MESH_AXES = ("data", "model")
MESH_STEPS = 3                # train steps on each path
SQRT_DRAWS = 1 << 20          # float32 draws a scale for sqrt_rn
SQRT_SCALES = (1e-6, 1.0, 1e3)


def fake_production_meshes(device: str) -> dict:
    """The production meshes on the fake process group (run in a child
    process; the group never leaves it): for the (16, 16) and (2, 16, 16)
    meshes, their names, shape and, for every FULL arch, the placements of
    ``param_shardings`` at train_4k: leaves sharded over each mesh axis and
    every sharded dim that does not divide its axis."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ASSIGNED_ARCHS, get_bundle
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import steps
    from repro_torch.util import tree

    out = {}
    for multi, world in ((False, 256), (True, 512)):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        try:
            t0 = time.perf_counter()
            mesh = launch_mesh.make_production_mesh(multi_pod=multi, device=device)
            sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            archs = {}
            for arch in ASSIGNED_ARCHS:
                bundle = get_bundle(arch)
                rules = launch_mesh.make_rules(mesh, bundle.model, SHAPES["train_4k"],
                                               bundle.parallel_for("train_4k"), multi_pod=multi)
                shard = tree.leaves(steps.param_shardings(bundle.model, rules))
                shapes = [s.shape for s in tree.leaves(steps.params_structs(bundle.model))]
                per_axis = {name: 0 for name in mesh.mesh_dim_names}
                bad = []
                for sh, shape in zip(shard, shapes):
                    for name, p in zip(mesh.mesh_dim_names, sh.placements):
                        if p.is_shard():
                            per_axis[name] += 1
                            if shape[p.dim] % sizes[name]:
                                bad.append((arch, shape, p.dim, name))
                archs[arch] = {"leaves": len(shard), "sharded": per_axis, "indivisible": bad}
            out["multi" if multi else "single"] = {
                "names": list(mesh.mesh_dim_names), "shape": list(mesh.mesh.shape),
                "device": mesh.device_type, "seconds": time.perf_counter() - t0,
                "archs": archs}
        finally:
            dist.destroy_process_group()
    return out


def start_production_meshes(device: str = "cuda"):
    """(b), started: :func:`fake_production_meshes` in a child process on
    the card's device type, running while the parent trains."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import json, chip_smoke; "
            f"print(json.dumps(chip_smoke.fake_production_meshes({device!r})))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def check_production_meshes(child, smi) -> None:
    """(b), finished: the child's meshes; every FULL arch's model- and
    data-sharded dims divide."""
    t0 = time.perf_counter()
    try:
        out, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"lm mesh: the production meshes' child failed: {err[-3000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    for key, names, shape in (("single", ["data", "model"], [16, 16]),
                              ("multi", ["pod", "data", "model"], [2, 16, 16])):
        m = got[key]
        bad = [b for a in m["archs"].values() for b in a["indivisible"]]
        if m["names"] != names or m["shape"] != shape or bad:
            raise AssertionError(f"lm mesh: production mesh {key}: {m['names']} {m['shape']}, "
                                 f"indivisible {bad}")
        log(f"lm mesh production mesh {tuple(shape)} {tuple(names)} on the fake group "
            f"({math.prod(shape)} ranks, device type {m['device']}, a child process, "
            f"{m['seconds']:.2f} s): param_shardings of every FULL arch at train_4k, every "
            f"sharded dim divides its axis; leaves sharded by axis: "
            + "; ".join(f"{arch} {a['sharded']} of {a['leaves']}"
                        for arch, a in m["archs"].items()))
    log(f"lm mesh production meshes: waited {time.perf_counter() - t0:.1f} s for the child "
        f"process; card {smi}")


def check_sqrt_rn(dev, smi) -> None:
    """(d): ``sqrt_rn`` on the card against ``numpy.sqrt`` (correctly
    rounded) on ``SQRT_DRAWS`` float32 draws a scale: 0 misses."""
    import numpy as np
    import torch

    from repro_torch.util.numerics import sqrt_rn

    counts = {}
    for scale in SQRT_SCALES:
        x = (np.random.default_rng(0).random(SQRT_DRAWS, dtype=np.float32)
             * np.float32(scale)).astype(np.float32)
        got = sqrt_rn(torch.from_numpy(x).to(dev)).cpu().numpy()
        counts[scale] = int((got.view(np.int32) != np.sqrt(x).view(np.int32)).sum())
    if any(counts.values()):
        raise AssertionError(f"lm mesh: sqrt_rn on the card misses numpy.sqrt: {counts}")
    log(f"lm mesh sqrt_rn on the card (torch.sqrt on CUDA) against numpy.sqrt, "
        f"{SQRT_DRAWS} float32 draws a scale: misses {counts}; card {smi}")


def record_ops(fn) -> list:
    """``fn()`` under a torch-function recorder: ``(name, value)`` of every
    floating-point tensor a torch function returns, in call order, a
    DTensor's taken locally and the mesh's own calls left out."""
    import torch
    from torch.overrides import TorchFunctionMode

    from repro_torch.parallel.sharding import is_dtensor

    skip = {"redistribute", "from_local", "to_local", "full_tensor"}
    out = []

    class Recorder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", str(func))
            if isinstance(res, torch.Tensor) and res.is_floating_point() and name not in skip:
                local = res.to_local() if is_dtensor(res) else res
                out.append((name, local.detach().clone()))
            return res

    with Recorder():
        fn()
    return out


def first_differing_op(plain_fn, mesh_fn) -> str:
    """The first operation whose result differs between a forward on one
    device and the same forward on the mesh."""
    import torch

    a, b = record_ops(plain_fn), record_ops(mesh_fn)
    for i, ((na, ta), (nb, tb)) in enumerate(zip(a, b)):
        if na != nb or ta.shape != tb.shape:
            return f"the op sequences part at call {i}: {na} {tuple(ta.shape)} against {nb}"
        if not torch.equal(ta, tb):
            return (f"call {i} ({na}, {tuple(ta.shape)}): max |difference| "
                    f"{float((ta.float() - tb.float()).abs().max()):.3g}")
    return f"none of {min(len(a), len(b))} recorded calls ({len(a)} / {len(b)})"


def mesh_steps(step, state, batches, dev) -> dict:
    """``len(batches)`` train steps: each step's wall (host clock around a
    synchronised step), loss, and the final state; then the same steps again
    from ``state``, each under the profiler tracing the device alone: its
    device time and events; the unprofiled steps' peak memory above what was
    allocated before them."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    walls, losses, s = [], [], state
    for b in batches:
        t0 = time.perf_counter()
        s, m = step(s, b)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated(dev) - held
    device, events, top, p = [], [], [], state
    for b in batches:
        box = {}

        def one():
            box["out"] = step(p, b)

        rows = kernel_rows(one)
        p = box["out"][0]
        device.append(sum(r[0] for r in rows) / 1e3 if rows else None)
        events.append(sum(r[1] for r in rows) if rows else None)
        top.append(rows[:3])
    return {"state": s, "walls": walls, "losses": losses, "peak": peak, "device": device,
            "events": events, "top": top, "profiled_state": p}


def dtensor_results(step, state, batch) -> int:
    """One warm train step under a dispatch mode above DTensor: how many
    DTensors the ops it dispatched returned (each one of DTensor's own
    dispatches, whose host cost sets a mesh step's wall)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            count[0] += sum(isinstance(t, DTensor) for t in tree_flatten(out)[0])
            return out

    torch.cuda.synchronize()
    with Count():
        step(state, batch)
    torch.cuda.synchronize()
    return count[0]


def host_profile(step, state, batch) -> dict:
    """One warm train step under ``cProfile``: the host seconds in all, and
    those spent in DTensor's own Python (``torch/distributed/tensor``), in
    autograd's and checkpoint's, and in the port's, with DTensor's five
    costliest functions and who called each."""
    import cProfile
    import pstats

    import torch

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    step(state, batch)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    areas = {"torch/distributed/tensor": 0.0, "torch/autograd": 0.0,
             "torch/utils/checkpoint": 0.0, "repro_torch": 0.0}
    total, top = 0.0, []
    def short(path, name):
        return "/".join(path.split("/")[-2:]) + f":{name}"

    for (path, _, name), (_, calls, tt, cum, callers) in stats.items():
        total += tt
        for key in areas:
            if key in path:
                areas[key] += tt
        if "torch/distributed/tensor" in path:
            by = sorted(((c[3], short(p, n)) for (p, _, n), c in callers.items()), reverse=True)
            top.append((cum, tt, calls, short(path, name),
                        ", ".join(f"{who} {t:.3f} s" for t, who in by[:2])))
    return {"total": total, "areas": areas, "top": sorted(top, reverse=True)[:5]}


def mesh_train(dev, smi) -> dict:
    """(a) and (c): smollm-135m FULL at 8 x 64 tokens (bf16, AdamW with f32
    moments, remat ``block``), ``MESH_STEPS`` steps on one device (``--mesh
    none``) and on a (1, 1) ``("data", "model")`` DeviceMesh over a world of
    one rank on NCCL (state by ``state_shardings``, batches by
    ``batch_shardings``, rules active); losses and gathered states compared
    bitwise. Then the mesh state saved (``full_tensor()``) and restored with
    ``shardings=`` onto the mesh."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_bundle
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import gather, is_dtensor, use_rules
    from repro_torch.util import tree

    bundle = get_bundle("smollm-135m")
    cfg = bundle.model
    pcfg = bundle.parallel_for("train_4k").replace(microbatches=1)
    shape = ShapeConfig("mesh", "train", *TRAIN_SHAPE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    init = steps.init_train_state(cfg, pcfg, gen, dev)
    step = steps.make_train_step(cfg, pcfg, peak_lr=1e-3, warmup_steps=1, total_steps=10)
    plain_batches = [pipeline.make_batch(cfg, shape, pipeline.PipelineState(17, i), device=dev)
                     for i in range(MESH_STEPS)]
    plain = mesh_steps(step, init, plain_batches, dev)

    mesh = launch_mesh.make_mesh((1, 1), MESH_AXES, device=dev)
    backend = dist.get_backend()
    rules = launch_mesh.make_rules(mesh, cfg, shape, pcfg)
    state_sh = steps.state_shardings(cfg, rules, pcfg)
    t0 = time.perf_counter()
    placed = steps.place_state(init, state_sh)
    torch.cuda.synchronize()
    place_ms = (time.perf_counter() - t0) * 1e3
    bsh = steps.batch_shardings(cfg, shape, rules)
    mesh_batches = [pipeline.make_batch(cfg, shape, pipeline.PipelineState(17, i), device=dev,
                                        shardings=bsh) for i in range(MESH_STEPS)]
    with use_rules(rules):
        meshed = mesh_steps(step, placed, mesh_batches, dev)
        host_mesh = host_profile(step, meshed["state"], mesh_batches[-1])
        results = dtensor_results(step, meshed["state"], mesh_batches[-1])
    host_plain = host_profile(step, plain["state"], plain_batches[-1])
    if not all(is_dtensor(x) for x in tree.leaves(meshed["state"])):
        raise AssertionError("lm mesh: a leaf of the mesh state is not a DTensor")
    placements = {str(tuple(x.placements)) for x in tree.leaves(meshed["state"])}
    full = tree.map(gather, meshed["state"])
    leaves = list(zip(tree.leaves(full), tree.leaves(plain["state"])))
    differ = sum(not torch.equal(a, b) for a, b in zip(*(
        tree.leaves(x) for x in (full, plain["state"]))))
    loss_bits = [a == b for a, b in zip(meshed["losses"], plain["losses"])]
    bitwise = all(loss_bits) and differ == 0
    profiled_same = all(torch.equal(gather(a), b) for a, b in zip(
        tree.leaves(meshed["profiled_state"]), tree.leaves(plain["profiled_state"])))
    err = max(float((a.float() - b.float()).abs().max()) for a, b in leaves)
    first = "not looked for (bitwise)"
    if not bitwise:
        with torch.no_grad():
            first = first_differing_op(
                lambda: M.loss_fn(init.params, cfg, plain_batches[0], remat="none"),
                lambda: _under(rules, lambda: M.loss_fn(placed.params, cfg, mesh_batches[0],
                                                        remat="none")))
    if not all(math.isfinite(x) for x in meshed["losses"]) or err > 0.05:
        raise AssertionError(f"lm mesh: losses {meshed['losses']} against {plain['losses']}, "
                             f"largest state difference {err}")
    n = M.n_params(cfg)
    tokens = shape.seq_len * shape.global_batch
    log(f"lm mesh (a) smollm-135m FULL ({n:,} params, bf16, AdamW f32 m/v, remat block, "
        f"{shape.global_batch} x {shape.seq_len} tokens, {MESH_STEPS} steps) on a (1, 1) "
        f"{MESH_AXES} DeviceMesh over a world of one rank on {backend}, state by "
        f"state_shardings ({len(placements)} placement kinds {sorted(placements)}), batches "
        f"by batch_shardings, rules active, against --mesh none: losses "
        f"{meshed['losses']} / {plain['losses']}, bitwise {loss_bits}; {differ} of "
        f"{len(leaves)} state leaves differ (largest |difference| {err:.3g}); bitwise "
        f"{bitwise}; first differing op: {first}; the profiled repeat bitwise "
        f"{profiled_same}; placing the state {place_ms:.1f} ms; card {smi}")
    for i in range(MESH_STEPS):
        def dev_text(r):
            if r["device"][i] is None:
                return "device time not measured (no device activity in the trace)"
            return (f"device {r['device'][i]:.4f} ms in {r['events'][i]} events (busy "
                    f"{r['device'][i] / r['walls'][i]:.3f})")
        log(f"lm mesh step {i} (smollm-135m FULL, {tokens} tokens, remat block): mesh wall "
            f"{meshed['walls'][i]:.1f} ms, {dev_text(meshed)}; --mesh none wall "
            f"{plain['walls'][i]:.1f} ms, {dev_text(plain)}; wall ratio "
            f"{meshed['walls'][i] / plain['walls'][i]:.2f}; card {smi}")
    log(f"lm mesh peak memory of the 3 steps above what they were given: mesh "
        f"{meshed['peak'] / 2**30:.2f} GiB, --mesh none {plain['peak'] / 2**30:.2f} GiB; most "
        f"device time on the mesh's last step: "
        + ", ".join(f"{name[:48]} {us / 1e3:.2f} ms in {count}"
                    for us, count, name in meshed["top"][-1]))
    log(f"lm mesh DTensor results of one warm step on the (1, 1) mesh (ops dispatched to "
        f"DTensor, counted above it): {results:,} (DTensor wrapped 15,329 results a "
        f"step while attention gathered its heads)")
    log(f"lm mesh host profile (cProfile, one warm step; the profiler's own cost included): "
        f"mesh {host_mesh['total']:.3f} s of host Python and C calls, of which "
        + ", ".join(f"{k} {v:.3f} s" for k, v in host_mesh["areas"].items())
        + f"; --mesh none {host_plain['total']:.3f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in host_plain["areas"].items())
        + "); DTensor's costliest (time inside, and in itself): "
        + "; ".join(f"{name} {cum:.3f} s ({tt:.3f} s) in {calls} calls from {by}"
                    for cum, tt, calls, name, by in host_mesh["top"]))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        t0 = time.perf_counter()
        ckpt.save(str(work / "mesh"), MESH_STEPS, meshed["state"])
        save_s = time.perf_counter() - t0
        ckpt.save(str(work / "plain"), MESH_STEPS, plain["state"])
        t0 = time.perf_counter()
        restored, meta = ckpt.restore(str(work / "mesh"), meshed["state"], shardings=state_sh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same_place = all(is_dtensor(r) and tuple(r.placements) == tuple(sh.placements)
                         for r, sh in zip(tree.leaves(restored), tree.leaves(state_sh)))
        same = all(torch.equal(gather(r), a) for r, a in zip(tree.leaves(restored),
                                                             tree.leaves(full)))
        names = sorted(os.listdir(work / "mesh" / f"step_{MESH_STEPS:08d}"))
        files_same = names == sorted(os.listdir(work / "plain" / f"step_{MESH_STEPS:08d}")) and all(
            (work / "mesh" / f"step_{MESH_STEPS:08d}" / f).read_bytes()
            == (work / "plain" / f"step_{MESH_STEPS:08d}" / f).read_bytes() for f in names)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if not (same and same_place and meta["step"] == MESH_STEPS):
        raise AssertionError(f"lm mesh (c): the restored state equal {same}, placements "
                             f"{same_place}")
    log(f"lm mesh (c) checkpoint of the mesh state ({len(names) - 1} leaves, saved whole by "
        f"full_tensor() in {save_s:.2f} s) restored with shardings= onto the (1, 1) mesh in "
        f"{restore_s:.2f} s: every leaf bitwise {same}, placements as state_shardings "
        f"{same_place}; files byte for byte the --mesh none state's save {files_same}")
    del init, placed, plain, meshed, full, restored
    torch.cuda.empty_cache()
    return {"bitwise": bitwise}


def _under(rules, fn):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel.sharding import use_rules

    with use_rules(rules), implicit_replication():
        return fn()


def run_mesh_phase(dev, card, smi) -> None:
    """The LM stack on a DeviceMesh: (a) smollm-135m FULL trained on a
    (1, 1) mesh against --mesh none, (b) the production meshes on the fake
    process group, (c) a checkpoint of (a) restored with ``shardings=``,
    (d) ``sqrt_rn`` on the card. No hand-written kernel launches."""
    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    parts = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    torch.cuda.empty_cache()
    zero_launches()
    child = start_production_meshes()
    try:
        part("train on the mesh", mesh_train, dev, smi)
    except BaseException:
        child.kill()
        child.wait()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    part("production meshes", check_production_meshes, child, smi)
    part("sqrt_rn", check_sqrt_rn, dev, smi)
    torch.cuda.synchronize()
    launches = kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"lm mesh: a hand-written kernel launched: {launches}")
    log(f"lm mesh phase: {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f"); hand-written kernel launches {launches} (none lies on this path); NCCL across "
        f"cards untried (one card); torch {torch.__version__}")


# ---------------------------------------------------------------------------
# phase 19: the dry run and its cost model

DRYRUN_CELLS = (("qwen3-0.6b", "decode_32k", False), ("qwen3-0.6b", "decode_32k", True),
                ("smollm-135m", "train_4k", False), ("moonshot-v1-16b-a3b", "decode_32k", False),
                ("qwen3-0.6b", "prefill_32k", False), ("snn-64k", None, False),
                ("moonshot-v1-16b-a3b", "prefill_32k", False),
                ("jamba-1.5-large-398b", "prefill_32k", False),
                ("qwen3-0.6b", "train_4k", False))
# The reference's per-device FLOPs of four cells on (16, 16) (its dry run on
# the CPU; the port's one-device step at 1 x 4096 tokens traces smollm's
# the same), and how far the port's may lie from each.
REF_FLOPS = {("smollm-135m", "train_4k", "16x16"): (12_710_955_712_512, 1.25),
             ("qwen3-0.6b", "train_4k", "16x16"): (32_926_293_032_960, 1.25),
             ("moonshot-v1-16b-a3b", "prefill_32k", "16x16"): (100_437_810_216_960, 1.10),
             ("jamba-1.5-large-398b", "prefill_32k", "16x16"): (901_631_747_031_040, 1.10)}
# The reference's temp_size_in_bytes of the traced train cells (its dry run on
# the CPU, jax 0.9.0), and how far above it the port's temp (the step's
# outputs left out, as XLA's) may lie.
REF_TEMP = {("smollm-135m", "train_4k", "16x16"): 4_028_648_352,
            ("qwen3-0.6b", "train_4k", "16x16"): 11_673_815_856}
TEMP_SLACK = 1.5
DRYRUN_TWICE = ("smollm-135m", "train_4k", False)   # traced again: the counts must repeat
DRYRUN_TIMEOUT = 360          # seconds a dry-run child may take
MEMORY_TOLERANCE = 0.10       # the traced peak against max_memory_allocated
CHUNKED_SEQ = 4096            # tokens of the trip-count check: 8 query chunks of attention


def start_dryrun_cells(out_dir: str) -> list:
    """(a), started: one dry-run child per cell, all at once, on the card's
    device type (the CLI's default)."""
    from repro_torch.launch.dryrun import cell_name

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    children = []
    for arch, shape, multi, tag in [c + ("",) for c in DRYRUN_CELLS] + [DRYRUN_TWICE + ("again",)]:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--out", out_dir]
        cmd += ["--shape", shape] if shape else []
        cmd += ["--multi-pod"] if multi else []
        cmd += ["--tag", tag] if tag else []
        name = cell_name(arch, shape or "tick_rollout_b256_t8", multi) + (f".{tag}" if tag else "")
        proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        children.append((name, proc, time.perf_counter()))
    return children


def check_dryrun_cells(children, out_dir: str, smi) -> None:
    """(a), finished: every child's artifact ``ok``; a child that fails or
    outlasts ``DRYRUN_TIMEOUT`` fails the phase, naming its cell. The cell
    traced twice must give the same counts and peak both times."""
    from repro_torch.launch.dryrun import cell_name

    failed, done = [], {}
    for name, proc, t0 in children:
        try:
            out, err = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT - (
                time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            failed.append(f"{name}: no end within {DRYRUN_TIMEOUT} s")
            continue
        wall = time.perf_counter() - t0
        path = Path(out_dir) / f"{name}.json"
        if proc.returncode != 0 or not path.exists():
            failed.append(f"{name}: rc {proc.returncode}: {err[-2500:]}")
            continue
        rec = json.loads(path.read_text())
        hc, mem = rec["hlo_cost"], rec["memory_analysis"]
        if rec["status"] != "ok":
            failed.append(f"{name}: status {rec['status']}")
            continue
        done[name] = (hc, mem["temp_size_in_bytes"])
        layout = rec.get("layout", {}).get("departures", {})
        log(f"dry run {name} (device {rec['device']}, {rec['n_chips']} fake ranks, torch "
            f"{_torch_version()}): status {rec['status']}; per device {hc['flops_per_device']:,.0f}"
            f" FLOPs, {hc['dot_bytes_per_device']:,.0f} dot bytes, collectives "
            f"{ {k: int(v) for k, v in hc['collective_bytes_per_device'].items()} } (summed "
            f"{hc['total_collective_bytes_per_device']:,.0f} B); argument "
            f"{mem['argument_size_in_bytes']:,} B, temp {mem['temp_size_in_bytes']:,} B (traced "
            f"peak with the outputs {mem['traced_peak_in_bytes']:,} B); first "
            f"product over its share: {departure_text(layout)}; trace "
            f"{rec['timings']['trace_s']:.1f} s, child wall {wall:.1f} s; card {smi}")
        if rec["kind"] == "train":
            log(f"dry run {name}: alive at the temp's peak: " + "; ".join(
                f"{a['nbytes']:,} B {a['dtype']}{a['shape']} {a['op']} at {a['frame']}"
                for a in rec["layout"]["temp_at_peak"]))
        failed += layout_faults(name, rec)
    twice = cell_name(*DRYRUN_TWICE)
    if twice in done and twice + ".again" in done:
        same = done[twice] == done[twice + ".again"]
        log(f"dry run {twice} traced twice in two processes: FLOPs, dot bytes, collective "
            f"bytes and temp {'the same' if same else 'DIFFER'}")
        if not same:
            failed.append(f"{twice}: two traces differ: {done[twice]} against "
                          f"{done[twice + '.again']}")
    if failed:
        raise AssertionError("dry run: " + "; ".join(failed))


def departure_text(departures: dict) -> str:
    """``layout.departures`` in a line: the first product over its even
    share (op, its innermost model frame, times its share), or none, then
    every site over its share."""
    if not departures:
        return "not recorded (snn cell)"
    if not departures.get("matched"):
        return (f"unmatched ({departures['local_products']} local products against "
                f"{departures['global_products']} global)")
    from repro_torch.launch.hlo_cost import model_frame

    first = departures.get("first")
    if first is None:
        return f"none of {departures['products']} products"
    return (f"{first['op']} at {model_frame(first['stack'])} x{first['times_share']:.3g} "
            f"({departures['over_share']} of {departures['products']} products over); sites "
            + "; ".join(site_text(s) for s in departures.get("sites", [])))


def site_text(site: dict) -> str:
    return (f"{site['op']} at {site['frame']} x{site['times_share']:.3g} "
            f"({site['products']} products, {site['excess_flops']:.3g} FLOPs above)")


def allowed_site(rec: dict, site: dict) -> bool:
    """The products over their even share that the reference's own layout
    computes as well (ROADMAP §C): a decode step's one row of K/V projected
    on every ``model`` rank (C.13), and rwkv6's LoRA and receptance
    products against weights the rules replicate (C.16)."""
    frame = site["frame"]
    if rec["kind"] == "decode" and "models/attention.py" in frame and frame.endswith(
            "_project_kv"):
        return True
    return "models/rwkv.py" in frame and frame.endswith(("rwkv_time_mix", "rwkv_channel_mix"))


def layout_faults(name: str, rec: dict) -> list:
    """The layout's checks on one artifact: every site whose products
    compute more than their even share (``layout.departures.sites``) is one
    the reference's layout has too (:func:`allowed_site`), and the FLOPs a
    device of the cells in ``REF_FLOPS`` lie within their slack of the
    reference's."""
    faults = []
    dep = rec.get("layout", {}).get("departures", {})
    if dep and not dep.get("matched"):
        faults.append(f"{name}: departures unmatched {dep}")
    for site in (dep or {}).get("sites", []):
        if not allowed_site(rec, site):
            faults.append(f"{name}: a product over its share: {site_text(site)}")
    ref = REF_FLOPS.get((rec["arch"], rec["shape"], rec["mesh"]))
    if ref is not None:
        ratio = rec["hlo_cost"]["flops_per_device"] / ref[0]
        log(f"dry run {name}: FLOPs a device {ratio:.4f}x the reference's {ref[0]:,}")
        if not 1 / ref[1] <= ratio <= ref[1]:
            faults.append(f"{name}: FLOPs a device {ratio:.4f}x the reference's")
    ref_temp = REF_TEMP.get((rec["arch"], rec["shape"], rec["mesh"]))
    if ref_temp is not None:
        ratio = rec["memory_analysis"]["temp_size_in_bytes"] / ref_temp
        log(f"dry run {name}: temp {ratio:.4f}x the reference's {ref_temp:,} B "
            f"(tolerance {TEMP_SLACK}x)")
        if not 0 < ratio <= TEMP_SLACK:
            faults.append(f"{name}: temp {ratio:.4f}x the reference's")
    return faults


def _torch_version() -> str:
    import torch

    return torch.__version__


def check_cost_model(dev, smi) -> None:
    """(b): smollm-135m FULL's train step at ``TRAIN_SHAPE`` (remat
    ``block``, one device) traced on fake tensors against the same step run
    on the card: the recorder's full peak (arguments + every storage the
    step allocated, its outputs included: ``peak_bytes``) within
    ``MEMORY_TOLERANCE`` of ``max_memory_allocated`` less the bytes resident
    before the step that are not its arguments, and the traced FLOPs equal
    to those of the real step's ops (the recorder pushed as a dispatch mode
    over the real tensors). Then the trip counts on the card's torch: the
    step at ``CHUNKED_SEQ`` tokens traced with the shortcut and with every
    loop step, the same FLOPs."""
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import dryrun, hlo_cost, steps

    bundle = get_bundle("smollm-135m")
    cfg = bundle.model
    pcfg = bundle.parallel_for("train_4k").replace(microbatches=1, remat="block")
    shape = ShapeConfig("timed", "train", *TRAIN_SHAPE)
    step = steps.make_train_step(cfg, pcfg, peak_lr=1e-3, warmup_steps=1, total_steps=10)
    t0 = time.perf_counter()
    structs = (steps.state_structs(cfg, pcfg, None), steps.batch_structs(cfg, shape, None))
    _, traced, fake_args = dryrun.trace(step, structs, dev)
    arg_bytes = sum(t.numel() * t.element_size() for t in hlo_cost.tensors(fake_args))
    traced_peak = arg_bytes + traced.peak_bytes
    traced_flops = hlo_cost.analyze(traced).flops
    trace_s = time.perf_counter() - t0

    # The trip counts on this torch: the step at 8 query chunks a layer
    # (remat's recomputation on autograd's device thread), the shortcut
    # against every chunk traced.
    t1 = time.perf_counter()
    chunked = ShapeConfig("chunked", "train", CHUNKED_SEQ, 1)
    mode = hlo_cost.FakeRecorder()
    cargs = tuple(dryrun._fake_tree(st, mode, dev) for st in (
        steps.state_structs(cfg, pcfg, None), steps.batch_structs(cfg, chunked, None)))
    chunk_flops = [hlo_cost.analyze(hlo_cost.record(step, *cargs, fake_mode=mode,
                                                    shortcut=shortcut)[1]).flops
                   for shortcut in (True, False)]
    log(f"dry run trip counts (smollm-135m FULL, 1 x {CHUNKED_SEQ} tokens, remat block, one "
        f"device, fake tensors on {dev.type}, torch {torch.__version__}): FLOPs with the "
        f"shortcut {chunk_flops[0]:,.0f}, every step traced {chunk_flops[1]:,.0f}: "
        f"{'equal' if chunk_flops[0] == chunk_flops[1] else 'DIFFERENT'} "
        f"({time.perf_counter() - t1:.1f} s)")
    if chunk_flops[0] != chunk_flops[1]:
        raise AssertionError(f"dry run trip counts: {chunk_flops[0]} with the shortcut "
                             f"against {chunk_flops[1]} for every step")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = steps.init_train_state(cfg, pcfg, gen, dev)
    batch = pipeline.make_batch(cfg, shape, pipeline.PipelineState(17, 0), device=dev)
    real_args = sum(t.numel() * t.element_size() for t in hlo_cost.tensors((state, batch)))
    step(state, batch)                       # warm-up: the libraries' workspaces
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    del out
    real_peak = peak - (before - real_args)
    _, real = hlo_cost.record(step, state, batch)
    torch.cuda.synchronize()
    real_flops = hlo_cost.analyze(real).flops
    ratio = traced_peak / real_peak
    log(f"dry run cost model (smollm-135m FULL, {shape.global_batch} x {shape.seq_len} tokens, "
        f"bf16, AdamW, remat block, one device, {smi}): traced peak {traced_peak:,} B "
        f"(arguments {arg_bytes:,} + traced peak {traced.peak_bytes:,}, of which temp without "
        f"the outputs {traced.temp_bytes:,}; traced in "
        f"{trace_s:.1f} s) against max_memory_allocated {peak:,} B less {before - real_args:,} B "
        f"resident beside the arguments ({real_args:,} B) = {real_peak:,} B: ratio {ratio:.4f} "
        f"(tolerance {MEMORY_TOLERANCE:.0%}); the recorder over the real step's ops: peak "
        f"{real_args + real.peak_bytes:,} B; FLOPs traced {traced_flops:,.0f}, the real step's "
        f"{real_flops:,.0f} ({len(real.records)} products, {sum(real.op_counts.values())} ops)")
    if traced_flops != real_flops or abs(ratio - 1) > MEMORY_TOLERANCE:
        raise AssertionError(f"dry run cost model: FLOPs {traced_flops} against {real_flops}, "
                             f"peak ratio {ratio:.4f}")
    del state, batch
    torch.cuda.empty_cache()


def run_dryrun_phase(dev, card, smi) -> None:
    """The dry run on the card's torch: (a) nine cells in child processes,
    (b) the cost model against a real step. No hand-written kernel
    launches."""
    import torch

    t0 = time.perf_counter()
    zero_launches()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out_dir:
        children = start_dryrun_cells(out_dir)
        try:
            check_cost_model(dev, smi)
            t_model = time.perf_counter() - t0
            check_dryrun_cells(children, out_dir, smi)
        finally:
            for _, proc, _ in children:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    torch.cuda.synchronize()
    launches = kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"dry run: a hand-written kernel launched: {launches}")
    log(f"dry run phase: {time.perf_counter() - t0:.1f} s (cost model {t_model:.1f} s, the "
        f"children ran beside it); hand-written kernel launches {launches}; card {smi}")


def ptxas_kernels(text: str) -> list:
    """``(kernel, registers, spill store bytes)`` for each entry function in
    the compiler's ``-Xptxas=-v`` report."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


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

    start = time.perf_counter()
    seconds = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    dev = port_device.resolve(None)
    smi = nvidia_smi()
    card = peaks(smi)
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    phase("cuda init", lambda: torch.zeros(1, device=dev).sum().item())   # the context
    build = phase("build", _build.build)
    log(f"build: {build.path.parent.name} in {seconds['build']:.2f} s")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", build.log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", build.log))
    if regs:
        log(f"ptxas: {len(regs)} kernels for sm_90a, {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes spilled")
        product = [k for k in ptxas_kernels(build.log)
                   if "lif_step_kernel" in k[0] or "tick_fused_kernel" in k[0]]
        spilled = [k for k in product if k[2]]
        log(f"ptxas B1/B2: {len(product)} instantiations, "
            f"{min(k[1] for k in product)}-{max(k[1] for k in product)} registers, "
            f"{sum(k[2] for k in product)} bytes spilled"
            + "".join(f"; {name}: {r} registers, {sp} bytes spilled"
                      for name, r, sp in spilled))
        for label, key in (("B5", "stdp_update"), ("B6", "spike_matmul"),
                           ("B3/B4", "event_dispatch"), ("telemetry", "telemetry_kernel")):
            found = [k for k in ptxas_kernels(build.log) if key in k[0]]
            log(f"ptxas {label}: " + "; ".join(f"{name}: {r} registers, {sp} bytes spilled"
                                                 for name, r, sp in found))
        b5 = {key: r for key, want in B5_REGISTERS.items()
              for name, r, _ in ptxas_kernels(build.log) if key in name}
        log(f"ptxas B5 without statistics: {b5} registers, before the statistics "
            f"{B5_REGISTERS}: "
            + ("the same" if b5 == B5_REGISTERS else "DIFFERENT"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = phase("kernels", run_kernel_phase, dev, gen)
    errs["stdp_update"] = phase("stdp", run_stdp_kernel_phase, dev, gen)
    timed, b2_streamed_ms = phase("timing", time_kernels, dev, gen, card)
    timed["stdp_update"] = phase("timing", time_stdp, dev, gen, card)
    b1_launches = phase("rollout", run_rollout_phase, dev, gen)
    learn_launches = phase("learning", run_learning_phase, dev, gen)
    launches, frozen_launches = phase("serve", run_serve_phase, dev)
    launches["lif_step"] = b1_launches
    cont_launches = phase("continuous", run_continuous_phase, dev)
    event_errs = phase("event", run_event_kernel_phase, dev, gen)
    errs["lif_step"] = max(errs["lif_step"], event_errs.pop("lif_step"))
    errs.update(event_errs)
    timed.update(phase("event", time_event, dev, gen, card))
    launches["event_dispatch_db"], launches["event_dispatch"] = phase(
        "event", run_event_rollout_phase, dev, gen)
    phase("event", run_event_slots_phase, dev, gen)
    event_learn = phase("event", run_event_learning, dev, gen)
    event_waves = phase("event", run_event_serve_phase, dev)
    tgen = torch.Generator(device=dev)   # its own stream: the later phases' data as before
    tgen.manual_seed(18)
    errs["telemetry"] = phase("telemetry", run_telemetry_kernel_phase, dev, tgen)
    phase("telemetry", run_b5_stats_phase, dev, tgen)
    timed["telemetry"] = phase("telemetry", time_telemetry, dev, tgen, card)
    phase("telemetry", run_telemetry_overhead, dev)
    errs["spike_matmul"] = phase("spike_matmul", run_spike_matmul_phase, dev, gen)
    timed["spike_matmul"] = phase("spike_matmul", time_spike_matmul, dev, gen, card)
    launches["spike_matmul"] = phase("classifiers", run_classifier_phase, dev)
    workload, workload_errs = phase("learning workload", run_learning_workload_phase, dev,
                                    gen, card)
    for name, err in workload_errs.items():
        errs[name] = max(errs[name], err)
    reconf = phase("reconfigure", run_reconfigure_phase, dev)
    agen = torch.Generator(device=dev)
    agen.manual_seed(22)
    phase("analysis", run_analysis_phase, dev, agen, build.log)
    sharded = phase("sharded", run_sharded_phase, dev, card, smi)
    for name, count in sharded.items():
        launches[name] += count
    phase("lm", run_lm_phase, dev, card, smi)
    phase("lm families", run_family_phase, dev, card, smi)
    phase("lm train", run_train_phase, dev, card, smi)
    phase("lm mesh", run_mesh_phase, dev, card, smi)
    phase("dry run", run_dryrun_phase, dev, card, smi)
    if min(launches.values()) < 1 or min(learn_launches.values()) < 1 \
            or frozen_launches["tick_fused"] < 1 or min(event_learn.values()) < 1 \
            or min(cont_launches[k] for k in ("tick_fused", "stdp_update", "telemetry")) < 1 \
            or min(workload["fast/pallas"][k] for k in ("lif_step", "stdp_update")) < 1 \
            or min(workload["fast/pallas_fused"][k] for k in ("tick_fused", "stdp_update")) < 1 \
            or reconf["tick_fused"] < 1:
        raise AssertionError(f"a kernel of a path never launched: serve and rollouts "
                             f"{launches}, frozen serve {frozen_launches}, learning "
                             f"rollouts {learn_launches}, event learning {event_learn}, "
                             f"learning workload {workload}, reconfiguration {reconf}")

    sources = {
        "tick_fused": ("src/repro_torch/csrc/tick_fused.cu", "src/repro/kernels/tick_fused.py:66"),
        "lif_step": ("src/repro_torch/csrc/lif_step.cu", "src/repro/kernels/lif_step.py:93"),
        "stdp_update": ("src/repro_torch/csrc/stdp_update.cu",
                        "src/repro/kernels/stdp_update.py:100"),
        "event_dispatch_db": ("src/repro_torch/csrc/event_dispatch.cu",
                              "src/repro/kernels/event_dispatch.py:300"),
        "event_dispatch": ("src/repro_torch/csrc/event_dispatch.cu",
                           "src/repro/kernels/event_dispatch.py:187"),
        "spike_matmul": ("src/repro_torch/csrc/spike_matmul.cu",
                         "src/repro/kernels/spike_matmul.py:26"),
        # the port's own kernel: the reference's step is an XLA reduce, no Pallas kernel
        "telemetry": ("src/repro_torch/csrc/telemetry.cu", "src/repro/obs/telemetry.py:112"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": errs[name],
                        **timed[name]})
    log(f"kernels launched: tick_fused {launches['tick_fused']} (serve), stdp_update "
        f"{launches['stdp_update']} (serve), telemetry {launches['telemetry']} (serve), "
        f"lif_step {launches['lif_step']} (pallas "
        f"rollouts), event_dispatch_db {launches['event_dispatch_db']} (snn-event topk "
        f"rollout), event_dispatch {launches['event_dispatch']} (snn-event topk rollout on "
        f"B4), spike_matmul {launches['spike_matmul']} (one per predict_int, Iris and "
        f"MNIST); frozen-only serve {frozen_launches}; continuous serve {cont_launches}; "
        f"learning rollouts {learn_launches}; "
        f"event learning {event_learn}; event serve waves {event_waves}; learning workload "
        f"{workload}; reconfiguration {reconf}; sharded fabric (added to each) {sharded}; "
        f"B2 streaming w and c {b2_streamed_ms:.4f} ms")
    log(f"seconds: {time.perf_counter() - start:.1f} in all; "
        + ", ".join(f"{name} {s:.1f}" for name, s in seconds.items()))
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
