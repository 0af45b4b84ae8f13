"""Batched serving: the LM wave server and multi-tenant SNN serving.

Counterpart of ``repro.launch.serve``. :class:`WaveServer` and :func:`serve`
serve the LM model zoo (``repro_torch.models``): requests are grouped into
waves of ``slots``, each wave's prompts are left-padded to a common length
and prefilled in one batched call, then all slots decode greedily in
lock-step. It is the CLI's default (``--arch smollm-135m``, as the
reference's). The dense, audio, moe, hybrid and rwkv families are served;
the recurrent ones carry the left-pad zeros through their state, as the
reference does. The vlm family is refused (:data:`VLM_REFUSAL`): the
reference's server passes its model no vision inputs and fails.

:class:`SNNServer` serves the SNN processor itself, frozen and plastic
tenants. S independent networks -- each its own ``W/C/thresholds/leak`` register
image, loaded through :func:`repro_torch.core.network.params_from_registers`
and zero-padded onto the ``n_max`` fabric -- ride one tick loop with a slot
axis written out: every state leaf is ``(S, n_max)`` and the kernels take S
as a launch-grid dimension. Swapping a tenant in is rewriting a slot's
registers; nothing is rebuilt.

A wave that holds a plastic tenant runs the learning rollout for every
slot: a frozen slot's ``learn_until`` is 0, which closes kernel B5's gate
for it (its weights come back bit-identical and its mask is never read),
and the plastic tenant's learned weights are written back after the wave.
A wave of frozen tenants only runs the frozen rollout (``W*C`` hoisted),
which gives the same rasters; the reference runs every wave through the
learning tick. At most one request per plastic tenant rides a wave.

With ``event_density`` set, a tenant whose topology is at most that dense
and whose fan-in fits ``event_cap`` rides a second resident program, the
event backend's fan-in gather (the reference's event program): admission
plans it with :func:`repro_torch.core.dispatch_policy.plan` and keeps its
padded fan-in lists, and waves are backend-homogeneous, one queue per
program.

Telemetry is on by default, as in the reference: every wave carries a
per-slot :class:`~repro_torch.obs.telemetry.TickTelemetry` through its tick
loop (one telemetry kernel launch per tick, no host sync), read once after
the wave into the server's :class:`~repro_torch.obs.metrics.MetricsRegistry`
(the reference's counters, gauges and histograms, under its names) and the
per-tenant ledger behind :meth:`SNNServer.tenant_report`.

:meth:`SNNServer.serve_continuous` is the reference's continuous admission:
the fabric runs in chunks of ``chunk_ticks`` ticks, a slot whose request has
run its budget retires after a chunk and is refilled from the queue at once,
so a short request no longer waits for the longest one of its wave. The
group keeps its slots' registers and carry resident on the device and
downloads one tenant's image into one slot in place (a fixed set of copies,
no host sync); counts accumulate on the device and are read once per retire
round. The slots share one tick counter, so a plastic slot's learning bound
is put on that clock (its fill tick plus its budget). A chunk runs the
learning tick only while a plastic request is resident, otherwise the
premasked frozen tick on a resident ``W*C`` stack, as frozen-only waves do.
:mod:`repro_torch.launch.serve_async` puts the asyncio front-end on it.

:func:`serve_sharded_main` is the other end of the scale axis: one network
too large for one device (``--arch snn-64k``), its fabric sharded by
destination columns over the ranks of the world the CLI was started in.

Usage (on a machine with an NVIDIA GPU):
  PYTHONPATH=src python -m repro_torch.launch.serve        # smollm-135m FULL, 6 requests
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch snn-fused [--continuous]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch snn --smoke --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.serve --arch snn-64k
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.configs import get_bundle
from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
from repro_torch.core.lif import LIFParams
from repro_torch.core.network_types import SNNParams, SNNState, masked_weights
from repro_torch.kernels import event_dispatch, lif_step, stdp_update, telemetry, tick_fused
from repro_torch.kernels.ops import EventFanIn, fan_in_edges
from repro_torch.models import model as M
from repro_torch.obs import MetricsRegistry, log_event, span, tracing
from repro_torch.obs.telemetry import TickTelemetry
from repro_torch.plasticity import PlasticityParams, PlasticityState


@dataclasses.dataclass
class ServeRequest:
    """One request type for both servers, the reference's fields in its
    order. The LM :class:`WaveServer` reads ``prompt``/``max_new``; the
    :class:`SNNServer` reads ``ext``/``n_ticks``/``rewards``. ``t_submit`` is
    the enqueue time (a caller that queues stamps it; the servers stamp it
    only while it is 0). The result fields are filled in place."""

    rid: int
    # -- LM fields
    prompt: Optional[np.ndarray] = None   # (S,) or (S, K) int32
    max_new: int = 0
    # -- SNN fields
    tenant: str = ""
    ext: Optional[np.ndarray] = None      # (T_req, n_in) input spike train
    n_ticks: int = 0                      # tick budget for this request
    rewards: Optional[np.ndarray] = None  # (T_req,) dopamine (R-STDP)
    # -- result fields (filled by the servers)
    out: List = dataclasses.field(default_factory=list)   # LM: generated ids
    counts: Optional[np.ndarray] = None   # (n_out,) rate-decoded counts
    pred: Optional[int] = None            # argmax over output neurons
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """Immutable completion record, one per served request; ``ttft_s`` runs
    from enqueue (``t_submit``). A request refused at admission gets one too,
    with ``rejected`` set and the ``reason``."""

    rid: int
    tenant: str = ""
    out: tuple = ()                       # LM: generated token ids
    counts: Optional[np.ndarray] = None   # SNN: rate-decoded counts
    pred: Optional[int] = None
    rejected: bool = False
    reason: str = ""                      # admission-rejection reason
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def ttft_s(self) -> float:
        if self.t_first is None:
            return 0.0
        return max(0.0, self.t_first - self.t_submit)

    @classmethod
    def of(cls, r: ServeRequest) -> "ServeResult":
        return cls(rid=r.rid, tenant=r.tenant, out=tuple(r.out), counts=r.counts,
                   pred=r.pred, t_submit=r.t_submit, t_first=r.t_first, t_done=r.t_done)

    @classmethod
    def rejection(cls, r: ServeRequest, reason: str) -> "ServeResult":
        now = time.time()
        return cls(rid=r.rid, tenant=r.tenant, rejected=True, reason=reason,
                   t_submit=r.t_submit or now, t_first=None, t_done=now)


VLM_REFUSAL = (
    "the vlm family is not served: the reference's WaveServer prefills with "
    "{'inputs': ...} alone (src/repro/launch/serve.py:174), so its cross layers get "
    "vision_proj None and fail in project_vision_kv (src/repro/models/attention.py:255, "
    "AttributeError: 'NoneType' object has no attribute 'shape'); the port serves only "
    "what the reference serves and runs the vlm model through forward / prefill_fn / "
    "decode_fn with vision_embeds")


def check_servable(cfg) -> None:
    """Raise ``NotImplementedError`` for a config the LM server refuses (vlm)."""
    if cfg.family == "vlm":
        raise NotImplementedError(f"{cfg.name}: {VLM_REFUSAL}")


class WaveServer:
    """The LM server: requests are grouped into waves of ``slots``; a wave's
    prompts are left-padded with token 0 to a common length (the pads are
    attended to, as in the reference), prefilled in one batched call, then
    every slot decodes greedily in lock-step until its ``max_new`` tokens or
    position ``max_len - 1``. A wave's KV cache is made once and written in
    place by every step."""

    def __init__(self, cfg, params, *, slots: int, max_len: int, device=None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = _device.resolve(device)

    def _pad_prompts(self, reqs: List[ServeRequest]) -> np.ndarray:
        plen = max(len(r.prompt) for r in reqs)
        shape = (self.slots, plen) + (
            (self.cfg.n_codebooks,) if self.cfg.family == "audio" else ())
        toks = np.zeros(shape, np.int32)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad with 0
        return toks

    def run_wave(self, reqs: List[ServeRequest]) -> int:
        """Prefill + decode one wave to completion; returns decode steps. The
        greedy token stays on the device as the next step's input; each step
        copies it to the host once for the requests' outputs."""
        cfg = self.cfg
        toks = self._pad_prompts(reqs)
        plen = toks.shape[1]
        caches = M.init_cache(cfg, self.slots, self.max_len, self.device)
        last, caches = M.prefill_fn(
            self.params, cfg, {"inputs": torch.from_numpy(toks).to(self.device)}, caches)
        nxt = last.argmax(-1)                          # (slots,) or (slots, K)
        cur = nxt.cpu().numpy()
        now = time.time()
        for r_i, r in enumerate(reqs):
            r.t_first = now
            r.out.append(int(np.atleast_1d(cur[r_i]).flat[0]))

        steps = 0
        pos = plen
        active = {i for i, r in enumerate(reqs) if len(r.out) < r.max_new}
        for r_i, r in enumerate(reqs):
            if r_i not in active:
                r.t_done = now
        max_new = max(r.max_new for r in reqs)
        while active and pos < self.max_len - 1 and steps < max_new:
            logits, caches = M.decode_fn(self.params, cfg, {"token": nxt[:, None], "pos": pos},
                                         caches)
            nxt = logits.argmax(-1)
            cur = nxt.cpu().numpy()
            steps += 1
            pos += 1
            now = time.time()
            for r_i in list(active):
                r = reqs[r_i]
                r.out.append(int(np.atleast_1d(cur[r_i]).flat[0]))
                if len(r.out) >= r.max_new:
                    r.t_done = now
                    active.discard(r_i)
        now = time.time()
        for r in reqs:
            if r.t_done is None:
                r.t_done = now
        return steps


def serve(cfg, params, requests: List[ServeRequest], *, slots: int = 4,
          max_len: int = 64, device=None) -> Dict:
    """Serve LM requests in waves on ``device`` (None: the card), where
    ``params`` live; the reference's stats keys. A vlm config is refused
    (:func:`check_servable`)."""
    check_servable(cfg)
    if not requests:
        # Empty queue: a well-formed zero report, never np.mean([]).
        return {"n_requests": 0, "requests_served": 0, "decode_steps": 0,
                "new_tokens": 0, "wall_s": 0.0, "tokens_per_s": 0.0,
                "mean_ttft_s": 0.0, "p99_ttft_s": 0.0, "outputs": {},
                "results": []}
    server = WaveServer(cfg, params, slots=slots, max_len=max_len, device=device)
    now = time.time()
    for r in requests:
        # TTFT counts from enqueue: keep a caller-stamped submit time.
        if not r.t_submit:
            r.t_submit = now
    done: List[ServeRequest] = []
    steps = 0
    queue = list(requests)
    while queue:
        wave = queue[:slots]
        queue = queue[slots:]
        # pad the wave with dummy clones so the batch shape is static
        while len(wave) < slots:
            wave.append(ServeRequest(rid=-1, prompt=wave[0].prompt, max_new=1))
        steps += server.run_wave(wave)
        done.extend(r for r in wave if r.rid >= 0)

    total_new = sum(len(r.out) for r in done)
    t0 = min(r.t_submit for r in done)
    t1 = max(r.t_done for r in done)
    ttfts = [r.t_first - r.t_submit for r in done]
    return {
        "n_requests": len(done),
        "requests_served": len(done),
        "decode_steps": steps,
        "new_tokens": total_new,
        "wall_s": round(t1 - t0, 3),
        "tokens_per_s": round(total_new / max(1e-9, t1 - t0), 2),
        "mean_ttft_s": round(float(np.mean(ttfts)), 3),
        "p99_ttft_s": round(float(np.percentile(ttfts, 99)), 4),
        "outputs": {r.rid: r.out[:8] for r in done},
        "results": [ServeResult.of(r) for r in done],
    }


_PAD_VTH = 1e30  # padded neurons can never reach threshold


@dataclasses.dataclass
class Tenant:
    """One resident network: a register image padded onto the fabric
    (neurons past ``n`` carry an unreachable threshold and a zero mask).
    A plastic tenant learns on its connection list ``params.c``.

    ``backend`` is the program the tenant rides: the server's default, or
    ``"event"`` when its topology clears the server's ``event_density``;
    ``fan_idx`` / ``fan_mask`` then hold its padded fan-in lists,
    ``(n_max, event_cap)`` so that every event slot stacks to one shape, and
    ``plan`` the admission's :class:`~repro_torch.core.dispatch_policy.DispatchPlan`."""

    name: str
    n: int
    n_in: int
    n_out: int
    plastic: bool
    params: SNNParams          # fabric-shaped (n_max, ...) on the server's device
    density: float = 1.0
    backend: str = "jnp"
    fan_idx: Optional[torch.Tensor] = None    # (n_max, event_cap) int32
    fan_mask: Optional[torch.Tensor] = None   # (n_max, event_cap) float32
    plan: Optional[object] = None


def pad_tenant_params(params: SNNParams, n_max: int) -> SNNParams:
    """Zero-pad an ``(n, n)`` register image onto the ``n_max`` fabric."""
    n = params.w.shape[0]
    if n > n_max:
        raise ValueError(f"tenant has {n} neurons; fabric holds {n_max}")
    p2 = lambda a: F.pad(a, (0, n_max - a.shape[1], 0, n_max - a.shape[0]))
    p1 = lambda a, v=0.0: F.pad(a, (0, n_max - n), value=v)
    lif = LIFParams(
        v_th=p1(params.lif.v_th, _PAD_VTH),
        leak=p1(params.lif.leak),
        r_ref=p1(params.lif.r_ref, 0),
        gain=p1(params.lif.gain, 1.0),
        i_bias=p1(params.lif.i_bias),
        v_reset=p1(params.lif.v_reset),
    )
    return SNNParams(w=p2(params.w), c=p2(params.c), w_in=p2(params.w_in), lif=lif)


def _stack(trees: List[SNNParams]) -> SNNParams:
    """Slot-stack S fabric-shaped register images: every leaf gains axis S."""
    lif = LIFParams(**{f.name: torch.stack([getattr(t.lif, f.name) for t in trees])
                       for f in dataclasses.fields(LIFParams)})
    return SNNParams(w=torch.stack([t.w for t in trees]),
                     c=torch.stack([t.c for t in trees]),
                     w_in=torch.stack([t.w_in for t in trees]), lif=lif)


class SNNServer:
    """Slot-batched multi-tenant serving of frozen and plastic tenants.

    Every wave runs S slots x ``max_ticks`` ticks of one engine, with
    static shapes ``(S, n_max)``; per-request tick budgets are runtime masks
    at decode and bound each slot's learning (``learn_until``), and tenant
    swaps only change array values. Nothing is traced: ``compiles`` counts
    the programs put into use under the keys the reference counts its
    traces under (``<backend>`` for a wave program, ``chunk/<backend>`` for
    each chunk size a backend has run, ``fill/<backend>`` once a slot has
    been refilled), so it equals the reference's after the same calls, and
    ``recompiles_after_warmup`` counts a key used past its first program.
    """

    def __init__(self, *, n_max: int, slots: int = 8, max_ticks: int = 32,
                 mode: str = "fixed_leak", backend: str = "jnp", plasticity=None,
                 event_density: Optional[float] = None, event_cap: Optional[int] = None,
                 telemetry: bool = True, registry: Optional[MetricsRegistry] = None,
                 options: Optional[EngineOptions] = None,
                 chunk_ticks: Optional[int] = None, device=None):
        """``device=None`` serves on the CUDA card (raising without one).
        ``plasticity`` is the learning rule of plastic tenants (default: the
        reference's STDP, ``a_plus=0.5, a_minus=0.25`` on ``[0, 255]``).
        ``event_density``: tenants at most this dense whose fan-in fits
        ``event_cap`` (default ``n_max // 4``, the width of every event
        slot's fan-in lists) ride the event program; None disables it.
        ``telemetry`` carries the tick telemetry through every wave (feeding
        :meth:`tenant_report` and the spike, overflow and weight-delta
        metrics); False serves without it, launching no telemetry kernel.
        ``registry``: the :class:`~repro_torch.obs.metrics.MetricsRegistry`
        to report into (default: a fresh private one, ``server.registry``).
        ``options`` supersedes ``mode``, ``backend``, ``plasticity`` and
        ``telemetry``. ``chunk_ticks``: the chunk size of
        :meth:`serve_continuous` (default ``max(1, min(8, max_ticks //
        4))``)."""
        if options is not None:
            mode, backend, telemetry = options.mode, options.backend, options.telemetry
            plasticity = options.plasticity if plasticity is None else plasticity
        self.device = _device.resolve(device)
        self.n_max = int(n_max)
        self.slots = int(slots)
        self.max_ticks = int(max_ticks)
        self.backend = backend
        self.event_density = event_density
        self.event_cap = int(event_cap or max(1, self.n_max // 4))
        self.telemetry = bool(telemetry)
        self.chunk_ticks = self._check_chunk(
            max(1, min(8, self.max_ticks // 4)) if chunk_ticks is None else chunk_ticks)
        if (self.device.type == "cuda" and self.device.index is None):
            # The explicit card, so a worker thread never relies on its own
            # current device.
            self.device = torch.device("cuda", torch.cuda.current_device())
        if plasticity is None:
            plasticity = PlasticityParams.make(
                "stdp", a_plus=0.5, a_minus=0.25, w_min=0.0, w_max=255.0)
        self._mk_engine = lambda b: TickEngine(EngineOptions(
            mode=mode, backend=b, plasticity=plasticity, telemetry=self.telemetry))
        self.engine = self._mk_engine(backend)
        self._engines = {backend: self.engine}
        self.tenants: Dict[str, Tenant] = {}
        self._compiles: Dict[str, int] = {}   # programs in use, under the reference's keys
        self._chunk_sizes: Dict[str, set] = {}
        self._reset_stages()
        self.requests_rejected = 0
        self._tenant_obs: Dict[str, Dict] = {}   # accumulated telemetry
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._c_requests = r.counter(
            "snn_requests_total", "requests served to completion")
        self._c_rejected = r.counter(
            "snn_requests_rejected_total", "requests refused at admission")
        self._c_rej_reason = r.counter(
            "snn_admission_rejections_total",
            "admission rejections, by reason", ("reason",))
        self._c_waves = r.counter(
            "snn_waves_total", "waves run, by resident program", ("backend",))
        self._c_chunks = r.counter(
            "snn_chunks_total",
            "continuous-admission chunks run, by resident program",
            ("backend",))
        self._c_spikes = r.counter(
            "snn_spikes_out_total", "rate-decoded output spikes")
        self._c_slot_ticks = r.counter(
            "snn_slot_ticks_total", "slot-ticks executed (slots x ticks)")
        self._c_useful_ticks = r.counter(
            "snn_useful_slot_ticks_total",
            "slot-ticks inside a live request's budget (goodput numerator)")
        self._c_overflow = r.counter(
            "snn_event_overflow_ticks_total",
            "event-backend ticks that overflowed k_active to dense fallback")
        self._c_policy = r.counter(
            "snn_event_policy_dense_ticks_total",
            "event-backend ticks the adaptive knee routed dense for speed")
        self._c_dw = r.counter(
            "snn_weight_delta_l1_total", "summed |dw| applied by plasticity")
        self._g_queue = r.gauge("snn_queue_depth", "requests awaiting a wave")
        self._g_busy = r.gauge(
            "snn_slots_busy", "slots holding a live request right now")
        self._g_goodput = r.gauge(
            "snn_slot_ticks_per_s", "raw slot-tick rate of the last serve call")
        self._g_useful_goodput = r.gauge(
            "snn_goodput_slot_ticks_per_s",
            "useful (in-budget) slot-ticks per second of the last serve call")
        self._h_ttft = r.histogram(
            "snn_ttft_seconds", "enqueue-to-first-output latency")
        self._h_wave = r.histogram(
            "snn_wave_seconds", "wave wall time, by resident program",
            ("backend",))
        self._h_chunk = r.histogram(
            "snn_chunk_seconds", "chunk wall time, by resident program",
            ("backend",))

    @property
    def compiles(self) -> int:
        """Programs in use, summed over the reference's trace keys."""
        return sum(self._compiles.values())

    # Running ``[seconds, count]`` of the continuous loop's timed stage spans.
    _STAGES = ("fill", "assemble", "dispatch", "readback", "retire")

    def _reset_stages(self) -> None:
        self._stages: Dict[str, List[float]] = {k: [0.0, 0] for k in self._STAGES}

    @property
    def host_time(self) -> Dict[str, List[float]]:
        """Host seconds and counts per stage of the last
        :meth:`serve_continuous` call, summed from its stage spans: ``fill``
        (``snn/fill``, per refill), ``assemble`` (``snn/assemble``, the
        ``snn/upload`` inside it; per chunk), ``dispatch``
        (``snn/chunk/<backend>``, per chunk) and ``retire`` (``snn/readback``
        and the ``snn/retire`` spans of its round; per retire round)."""
        st = self._stages
        return {"fill": list(st["fill"]), "assemble": list(st["assemble"]),
                "dispatch": list(st["dispatch"]),
                "retire": [st["readback"][0] + st["retire"][0], st["readback"][1]]}

    def _check_chunk(self, chunk) -> int:
        chunk = int(chunk)
        if not 1 <= chunk <= self.max_ticks:
            raise ValueError(f"chunk_ticks must lie in [1, max_ticks={self.max_ticks}], "
                             f"got {chunk}")
        return chunk

    # -- tenant registry ---------------------------------------------------

    def add_tenant(self, name: str, bank, *, n_in: int, n_out: int,
                   plastic: bool = False) -> Tenant:
        """Register a tenant from its :class:`RegisterBank` image."""
        from repro_torch.core.network import params_from_registers

        params = params_from_registers(bank, device=self.device)
        return self.add_tenant_params(name, params, n_in=n_in, n_out=n_out,
                                      plastic=plastic)

    def add_tenant_params(self, name: str, params: SNNParams, *, n_in: int, n_out: int,
                          plastic: bool = False) -> Tenant:
        n = params.w.shape[0]
        if not (0 < n_in <= n and 0 < n_out <= n):
            raise ValueError(
                f"tenant {name!r}: n_in={n_in}, n_out={n_out} must lie in "
                f"[1, {n}] (the tenant's live neuron count)")
        density = float(params.c.sum()) / max(1, n * n)
        padded = pad_tenant_params(params, self.n_max)
        backend, fan_idx, fan_mask, plan = self.backend, None, None, None
        if self.event_density is not None and density <= self.event_density:
            from repro_torch.core import dispatch_policy

            # Admission-time plan, on the host, as the reference plans it:
            # vmap_safe keeps the spike list out of the multi-slot program, and
            # prefer_density is the operator's contract -- at or below the
            # threshold a fabric whose fan-in fits the shared cap rides the
            # event program whatever the modeled cost.
            plan = dispatch_policy.plan(padded.c, w_in=padded.w_in, cap=self.event_cap,
                                        vmap_safe=True, prefer_density=self.event_density)
            if plan.strategy == "fan_in":
                backend = "event"
                fan_idx, fan_mask = plan.neighbors.idx, plan.neighbors.mask
        t = Tenant(name=name, n=n, n_in=n_in, n_out=n_out, plastic=plastic,
                   params=padded, density=density, backend=backend,
                   fan_idx=fan_idx, fan_mask=fan_mask, plan=plan)
        self.tenants[name] = t
        return t

    # -- one wave ------------------------------------------------------------

    def _assemble(self, reqs: List[ServeRequest]):
        """Slot-stacked params, ``(T, S, N)`` drive, ``(S,)`` budgets, and for a
        wave that learns the ``(S,)`` learning bounds (the budget for a plastic
        slot, 0 for a frozen one) and ``(T, S)`` rewards (None otherwise)."""
        S, T, N = self.slots, self.max_ticks, self.n_max
        tenants = [self.tenants[r.tenant] for r in reqs]
        params = _stack([t.params for t in tenants])
        ext = np.zeros((T, S, N), np.float32)
        rew = np.zeros((T, S), np.float32)
        budget = np.zeros((S,), np.int32)
        until = np.zeros((S,), np.int32)
        for i, r in enumerate(reqs):
            t = min(r.ext.shape[0], T)
            ext[:t, i, : r.ext.shape[1]] = r.ext[:t]
            if r.rewards is not None:
                rew[: min(len(r.rewards), T), i] = r.rewards[:T]
            budget[i] = 0 if r.rid < 0 else min(r.n_ticks, T)
            until[i] = budget[i] if tenants[i].plastic else 0
        dev = self.device
        learn_until = rewards = None
        if any(t.plastic for t in tenants):
            learn_until = torch.from_numpy(until).to(dev)
            rewards = torch.from_numpy(rew).to(dev)
        return (params, torch.from_numpy(ext).to(dev), torch.from_numpy(budget).to(dev),
                learn_until, rewards)

    def _fan_in(self, reqs: List[ServeRequest]) -> Optional[EventFanIn]:
        """The ``(S, n_max, event_cap)`` fan-in lists of an event wave's slots
        (None for a wave of the default program)."""
        tenants = [self.tenants[r.tenant] for r in reqs]
        if tenants[0].backend != "event":
            return None
        return EventFanIn(idx=torch.stack([t.fan_idx for t in tenants]),
                          mask=torch.stack([t.fan_mask for t in tenants]))

    def _wave_fn(self, params: SNNParams, ext_seq: torch.Tensor, budget: torch.Tensor,
                 learn_until: Optional[torch.Tensor] = None,
                 rewards: Optional[torch.Tensor] = None, *, backend: Optional[str] = None,
                 neighbors: Optional[EventFanIn] = None):
        """``((S, N) rate-decoded spike counts, (S, N, N) learned weights or
        None, per-slot telemetry or None)`` of one wave on ``backend``'s
        program (default: the server's); ticks at or past a slot's budget run
        but do not count, and a slot learns (on its ``params.c``) only before
        its ``learn_until``; None runs the frozen rollout. An event wave
        passes its slots' fan-in lists. The telemetry, with the server's
        ``telemetry`` on, has shape ``(S,)`` and covers all ``max_ticks``
        ticks (those past a budget run, they just do not count or learn)."""
        T, N, S = self.max_ticks, self.n_max, self.slots
        engine = self._engine_for(backend or self.backend)
        st = SNNState.zeros((S,), N, device=self.device)
        if learn_until is None:
            w2 = None
            out = engine.rollout(params, st, ext_seq, T, neighbors=neighbors)
            raster = out[1]                                               # (T, S, N)
        else:
            pst = PlasticityState.zeros((), N, device=self.device, slots=S)
            out = engine.learning_rollout(
                params, st, pst, ext_seq, T, rewards=rewards, learn_until=learn_until,
                neighbors=neighbors)
            (_, _, w2), raster = out[:2]
        telem = out[2] if self.telemetry else None
        ticks = torch.arange(T, device=self.device)
        tmask = (ticks[:, None] < budget[None, :]).to(raster.dtype)  # (T, S)
        return (raster * tmask[:, :, None]).sum(dim=0), w2, telem

    def _engine_for(self, backend: str) -> TickEngine:
        if backend not in self._engines:
            self._engines[backend] = self._mk_engine(backend)
        return self._engines[backend]

    def run_wave(self, reqs: List[ServeRequest]) -> None:
        """One wave: S register images in, S rate-decoded outputs out, and
        for plastic tenants the learned weights written back. A wave is
        backend-homogeneous: it runs one of the resident programs."""
        backends = {self.tenants[r.tenant].backend for r in reqs}
        if len(backends) != 1:
            raise ValueError(f"wave mixes backends {sorted(backends)}")
        backend = backends.pop()
        with span(f"snn/wave/{backend}", histogram=self._h_wave, backend=backend):
            counts, w2, telem = self._wave_fn(*self._assemble(reqs), backend=backend,
                                              neighbors=self._fan_in(reqs))
            counts = counts.cpu().numpy()       # waits for the wave
        self._compiles.setdefault(backend, 1)
        self._c_waves.inc(backend=backend)
        self._c_slot_ticks.inc(self.slots * self.max_ticks)
        tel = None
        if telem is not None:
            tel = telem.numpy()
            self._c_overflow.inc(float(tel["overflow"].sum()))
            self._c_policy.inc(float(tel["policy_dense"].sum()))
            self._c_dw.inc(float(tel["dw_l1"].sum()))
        now = time.time()
        for i, r in enumerate(reqs):
            if r.rid < 0:
                continue
            t = self.tenants[r.tenant]
            out = counts[i, t.n - t.n_out: t.n]
            r.counts = out
            r.pred = int(out.argmax())
            r.t_first = r.t_done = now
            if tel is not None:
                self._observe_slot(t, tel, i)
            if t.plastic:
                # Register write-back: the tenant's next wave starts from what
                # this one learned (a copy, so the wave's stack can be freed).
                t.params = dataclasses.replace(t.params, w=w2[i].clone())

    def _observe_slot(self, t: Tenant, tel: Dict[str, np.ndarray], i: int) -> None:
        """Fold slot ``i`` of a wave's telemetry (on the host) into the tenant
        ledger."""
        o = self._tenant_obs.setdefault(t.name, {
            "requests": 0, "ticks": 0, "spikes": 0.0, "v_max": 0.0,
            "ref_sum": 0.0, "overflow_ticks": 0, "policy_dense_ticks": 0,
            "dw_l1": 0.0})
        o["requests"] += 1
        o["ticks"] += int(tel["ticks"][i])
        o["spikes"] += float(tel["spikes"][i])
        o["v_max"] = max(o["v_max"], float(tel["v_max"][i]))
        o["ref_sum"] += float(tel["ref_sum"][i])
        o["overflow_ticks"] += int(tel["overflow"][i])
        o["policy_dense_ticks"] += int(tel["policy_dense"][i])
        o["dw_l1"] += float(tel["dw_l1"][i])

    def tenant_report(self) -> Dict[str, Dict]:
        """Per-tenant activity from the accumulated wave telemetry, field for
        field the reference's.

        ``spike_rate`` is spikes per live-neuron-tick (padded fabric neurons
        carry an unreachable threshold, so every spike belongs to one of the
        tenant's ``n`` live neurons); the refractory occupancy is rescaled
        from the fabric axis to live neurons the same way. Empty when the
        server was built with ``telemetry=False`` or has served nothing yet.
        """
        rep: Dict[str, Dict] = {}
        for name in sorted(self._tenant_obs):
            o, t = self._tenant_obs[name], self.tenants[name]
            ticks = o["ticks"]
            rescale = self.n_max / max(1, t.n)
            rep[name] = {
                "requests": o["requests"],
                "ticks": ticks,
                "spikes": o["spikes"],
                "spike_rate": round(o["spikes"] / max(1, ticks * t.n), 4),
                "v_max": round(o["v_max"], 4),
                "refractory_occupancy": round(o["ref_sum"] / max(1, ticks) * rescale, 4),
                "overflow_ticks": o["overflow_ticks"],
                "policy_dense_ticks": o["policy_dense_ticks"],
                "dw_l1": round(o["dw_l1"], 3),
                "plastic": t.plastic,
                "backend": t.backend,
                "dispatch": t.plan.strategy if t.plan is not None else None,
            }
        return rep

    # -- the request loop ------------------------------------------------------

    def _stats(self, *, mode: str, done: List[ServeRequest], n_rejected: int,
               waves: int = 0, chunks: int = 0, ticks: int = 0, slot_ticks: int = 0,
               wall_s: float = 0.0) -> Dict:
        """The reference's stats schema, key for key."""
        wall = max(1e-9, wall_s)
        ttfts = [r.t_first - r.t_submit for r in done]
        useful = sum(min(int(r.n_ticks), self.max_ticks) for r in done)
        total_spikes = float(sum(r.counts.sum() for r in done)) if done else 0.0
        return {
            "mode": mode,
            "n_requests": len(done),
            "requests_served": len(done),
            "requests_rejected": n_rejected,
            "n_tenants": len({r.tenant for r in done}),
            "waves": waves,
            "chunks": chunks,
            "ticks": ticks,
            "useful_slot_ticks": useful,
            "spikes_out": total_spikes,
            "wall_s": round(wall_s, 3),
            "spikes_per_s": round(total_spikes / wall, 1) if done else 0.0,
            "slot_ticks_per_s": round(slot_ticks / wall, 1) if done else 0.0,
            "goodput_slot_ticks_per_s": round(useful / wall, 1) if done else 0.0,
            "mean_ttft_s": round(float(np.mean(ttfts)), 4) if done else 0.0,
            "p99_ttft_s": round(float(np.percentile(ttfts, 99)), 4) if done else 0.0,
            "compiles": self.compiles,
            "recompiles_after_warmup": sum(max(0, c - 1) for c in self._compiles.values()),
            "backends": {
                b: sum(1 for r in done if self.tenants[r.tenant].backend == b)
                for b in sorted({self.tenants[r.tenant].backend for r in done})},
            "preds": {r.rid: r.pred for r in done},
            "results": [ServeResult.of(r) for r in done],
        }

    def _empty_stats(self, rejected: int, mode: str = "wave") -> Dict:
        """A well-formed zero report: nothing ran, nothing was served."""
        return self._stats(mode=mode, done=[], n_rejected=rejected)

    def _reject_unknown(self, requests: List[ServeRequest]):
        """Split off (counted, logged) the requests naming an unregistered
        tenant; returns ``(admitted, rejected)``."""
        rejected = [r for r in requests if r.tenant not in self.tenants]
        if rejected:
            self.requests_rejected += len(rejected)
            self._c_rejected.inc(len(rejected))
            self._c_rej_reason.inc(len(rejected), reason="unknown_tenant")
            log_event("snn_requests_rejected", n=len(rejected),
                      tenants=sorted({r.tenant for r in rejected}))
        return [r for r in requests if r.tenant in self.tenants], rejected

    def serve(self, requests: List[ServeRequest]) -> Dict:
        """Wave admission over a request queue; returns the stats dict.

        Requests naming an unregistered tenant are rejected and counted
        (``requests_rejected``), never a KeyError mid-wave. The queue splits
        by the tenants' programs (in sorted order, as the reference's does)
        and each program's queue runs in waves of up to ``slots`` requests in
        queue order, but at most ONE request per plastic tenant: two slots
        learning from the same registers would race on the write-back. A
        deferred duplicate rides a later wave, which starts from the weights
        this one learned. A short wave is padded with budget-0 slots of the
        same program.
        """
        requests, rejected = self._reject_unknown(requests)
        if not requests:
            return self._empty_stats(len(rejected))
        now = time.time()
        for r in requests:
            if not r.t_submit:   # TTFT from enqueue: keep the caller's stamp
                r.t_submit = now
        done: List[ServeRequest] = []
        waves = 0
        for backend in sorted({self.tenants[r.tenant].backend for r in requests}):
            queue = [r for r in requests if self.tenants[r.tenant].backend == backend]
            while queue:
                self._g_queue.set(len(queue))
                wave, deferred, plastic_in_wave = [], [], set()
                for r in queue:
                    t = self.tenants[r.tenant]
                    if len(wave) < self.slots and not (
                            t.plastic and r.tenant in plastic_in_wave):
                        wave.append(r)
                        if t.plastic:
                            plastic_in_wave.add(r.tenant)
                    else:
                        deferred.append(r)
                queue = deferred
                while len(wave) < self.slots:
                    wave.append(ServeRequest(rid=-1, tenant=wave[0].tenant,
                                             ext=np.zeros((1, 1), np.float32), n_ticks=0))
                self.run_wave(wave)
                done.extend(r for r in wave if r.rid >= 0)
                waves += 1
        self._g_queue.set(0)
        t0 = min(r.t_submit for r in done)
        t1 = max(r.t_done for r in done)
        stats = self._stats(mode="wave", done=done, n_rejected=len(rejected), waves=waves,
                            ticks=waves * self.max_ticks,
                            slot_ticks=waves * self.max_ticks * self.slots, wall_s=t1 - t0)
        self._c_requests.inc(len(done))
        self._c_spikes.inc(stats["spikes_out"])
        self._c_useful_ticks.inc(stats["useful_slot_ticks"])
        self._g_goodput.set(stats["slot_ticks_per_s"])
        self._g_useful_goodput.set(stats["goodput_slot_ticks_per_s"])
        for r in done:
            self._h_ttft.observe(r.t_first - r.t_submit)
        return stats

    # -- continuous admission (per-slot refill, not per-wave) ----------------

    @staticmethod
    def _next_admittable(pending: Deque[ServeRequest], busy_plastic: set,
                         tenants: Dict[str, Tenant]) -> Optional[ServeRequest]:
        """Pop the first queued request whose tenant is not a resident
        *plastic* tenant (two slots learning from the same registers would
        race on the write-back: the wave path's one-plastic-request-per-wave
        rule, per slot)."""
        for idx, r in enumerate(pending):
            if tenants[r.tenant].plastic and r.tenant in busy_plastic:
                continue
            del pending[idx]
            return r
        return None

    def _route(self, r: ServeRequest, pending_map: Dict[str, Deque[ServeRequest]],
               rejected: List[ServeRequest]) -> None:
        """Admit one feeder-supplied request into its program's queue,
        stamping its enqueue time if the caller did not."""
        if not r.t_submit:
            r.t_submit = time.time()
        admitted, refused = self._reject_unknown([r])
        rejected.extend(refused)
        for r in admitted:
            pending_map.setdefault(self.tenants[r.tenant].backend, deque()).append(r)

    def serve_continuous(
        self,
        requests: Optional[List[ServeRequest]] = None,
        *,
        chunk_ticks: Optional[int] = None,
        feeder: Optional[Callable[[], Optional[ServeRequest]]] = None,
        on_complete: Optional[Callable[[ServeRequest], None]] = None,
    ) -> Dict:
        """Per-slot continuous admission, with the reference's semantics.

        The fabric runs in chunks of ``chunk_ticks`` ticks (default the
        server's); after each chunk the slots whose request has run its
        budget retire (decode, write back learned weights, complete) and are
        refilled from the queue. A request's latency is its own budget plus
        at most ``chunk_ticks - 1`` ticks. The queue splits by program, and
        the program whose queue holds the oldest waiting request runs next;
        at most one request per plastic tenant is resident at a time; a
        zero-budget request completes without a tick.

        Args:
          requests: the initial queue (any mix of tenants and programs).
          feeder: optional non-blocking callable, polled once per chunk (and
            once more before returning) for late arrivals; None means none
            right now. This is how the async front-end streams admissions in.
          on_complete: optional callback, called in this thread with each
            request as it retires.

        Returns :meth:`serve`'s stats with ``mode="continuous"`` and the
        chunk accounting. ``host_time`` then holds this call's host seconds
        and counts per stage: ``fill`` (per refill), ``assemble`` and
        ``dispatch`` (per chunk), ``retire`` (per retire round).

        Each stage is a :class:`~repro_torch.obs.tracing.span`, recorded
        while a profiler runs (asked once per chunk): ``snn/serve`` around
        the call, and inside it ``snn/feed`` (a feeder poll and its
        routing), ``snn/fill`` (``rid``, ``slot``), ``snn/assemble`` (with
        ``snn/upload``), ``snn/chunk/<backend>`` (the dispatch),
        ``snn/readback`` (the round's one wait for the device) and
        ``snn/retire`` (``rid``; ``on_complete`` inside it).
        """
        chunk = self._check_chunk(self.chunk_ticks if chunk_ticks is None else chunk_ticks)
        with span("snn/serve"):
            t_start = time.time()
            self._reset_stages()
            requests, rejected = self._reject_unknown(list(requests or []))
            for r in requests:
                if not r.t_submit:
                    r.t_submit = t_start
            pending_map: Dict[str, Deque[ServeRequest]] = {}
            for r in requests:
                pending_map.setdefault(self.tenants[r.tenant].backend, deque()).append(r)
            done: List[ServeRequest] = []
            chunks = 0
            while True:
                live = [b for b, q in pending_map.items() if q]
                if not live:
                    if feeder is None:
                        break
                    # One more poll: a request may have arrived since the last chunk.
                    n_before, got = len(rejected), False
                    with span("snn/feed"):
                        while (r := feeder()) is not None:
                            self._route(r, pending_map, rejected)
                            got = True
                    if not got and len(rejected) == n_before:
                        break
                    continue
                # FIFO across programs: the oldest waiting request's program runs.
                backend = min(live, key=lambda b: pending_map[b][0].t_submit)
                chunks += self._continuous_group(backend, pending_map, rejected, chunk, feeder,
                                                 on_complete, done)
            self._g_queue.set(0)
            self._g_busy.set(0)
            if not done:
                return self._empty_stats(len(rejected), mode="continuous")
            t0 = min(r.t_submit for r in done)
            t1 = max(r.t_done for r in done)
            stats = self._stats(mode="continuous", done=done, n_rejected=len(rejected),
                                chunks=chunks, ticks=chunks * chunk,
                                slot_ticks=chunks * chunk * self.slots, wall_s=t1 - t0)
            self._c_spikes.inc(stats["spikes_out"])
            self._g_goodput.set(stats["slot_ticks_per_s"])
            self._g_useful_goodput.set(stats["goodput_slot_ticks_per_s"])
            return stats

    def _continuous_group(self, backend: str, pending_map: Dict[str, Deque[ServeRequest]],
                          rejected: List[ServeRequest], chunk: int, feeder, on_complete,
                          done: List[ServeRequest]) -> int:
        """Run one program's chunks until its queue drains; returns the
        number of chunks run.

        Which request holds a slot, its tick offset and budget live on the
        host; the registers, carry and running counts live on the device in
        a :class:`_Resident`, which a refill rewrites one slot of. The slots
        share one tick counter, which starts at 0 for the group (a fresh
        carry), so a plastic slot's learning bound is its fill tick plus its
        budget on that clock (``clock`` mirrors it on the host), and 0 for a
        frozen slot."""
        S, N = self.slots, self.n_max
        pending = pending_map.setdefault(backend, deque())
        engine = self._engine_for(backend)
        slot_req: List[Optional[ServeRequest]] = [None] * S
        slot_tenant: List[Optional[Tenant]] = [None] * S
        busy_plastic: set = set()
        res: Optional[_Resident] = None
        offset = np.zeros((S,), np.int64)    # ticks each request has run
        budget = np.zeros((S,), np.int32)
        until = np.zeros((S,), np.int32)     # learning bounds on the shared clock
        clock = 0
        chunks = 0
        st = self._stages
        on = False   # whether a profiler records, asked once a round

        def fill(i: int, r: ServeRequest) -> None:
            nonlocal res
            with span("snn/fill", total=st["fill"], on=on, rid=r.rid, slot=i):
                t = self.tenants[r.tenant]
                slot_req[i], slot_tenant[i] = r, t
                offset[i] = 0
                budget[i] = min(int(r.n_ticks), self.max_ticks)
                until[i] = clock + budget[i] if t.plastic else 0
                if t.plastic:
                    busy_plastic.add(t.name)
                if res is None:
                    # The first fill seeds every slot with this image; idle slots
                    # ride along at budget 0, like the wave path's padding.
                    res = _Resident(self, backend, t)
                else:
                    res.fill(i, t)
                    self._compiles.setdefault(f"fill/{backend}", 1)

        def retire(i: int, now: float, row: Optional[np.ndarray] = None,
                   tel: Optional[Dict[str, np.ndarray]] = None, total=None) -> None:
            # ``total``: the round's retires count into ``host_time``; a
            # zero-budget request's (retired at its fill) does not.
            r, t = slot_req[i], slot_tenant[i]
            with span("snn/retire", total=total, on=on, rid=r.rid):
                if row is None:   # a request that ran no tick: its row is still zero
                    row = np.zeros((N,), np.float32)
                out = row[t.n - t.n_out: t.n]
                r.counts = out
                r.pred = int(out.argmax())
                r.t_first = r.t_done = now
                if tel is not None and offset[i] > 0:
                    self._observe_slot(t, tel, i)
                    self._c_overflow.inc(float(tel["overflow"][i]))
                    self._c_policy.inc(float(tel["policy_dense"][i]))
                    self._c_dw.inc(float(tel["dw_l1"][i]))
                if t.plastic:
                    # Register write-back: the tenant's next request starts from
                    # what this one learned (a copy: the slot's row is reused).
                    t.params = dataclasses.replace(t.params, w=res.w[i].clone())
                    busy_plastic.discard(t.name)
                until[i] = 0
                slot_req[i] = slot_tenant[i] = None
                done.append(r)
                self._c_requests.inc()
                self._c_useful_ticks.inc(int(budget[i]))
                self._h_ttft.observe(r.t_done - r.t_submit)
                if on_complete is not None:
                    on_complete(r)

        while True:
            on = tracing.profiling()
            if feeder is not None:
                with span("snn/feed", on=on):
                    while (r := feeder()) is not None:
                        self._route(r, pending_map, rejected)
            # Refill free slots in queue order; a zero-budget request
            # completes without running a tick (zero counts, nothing learned).
            for i in range(S):
                if slot_req[i] is None and pending:
                    r = self._next_admittable(pending, busy_plastic, self.tenants)
                    if r is not None:
                        fill(i, r)
                if slot_req[i] is not None and budget[i] <= offset[i]:
                    retire(i, time.time())
            busy = [i for i in range(S) if slot_req[i] is not None]
            self._g_queue.set(sum(len(q) for q in pending_map.values()))
            self._g_busy.set(len(busy))
            if not busy:
                if pending:
                    continue   # a plastic tenant was freed: admit again
                break
            # The learning tick only while a plastic request is resident.
            self._run_chunk(res, engine, backend, chunk, [slot_req[i] for i in range(S)],
                            offset, budget, until, learning=bool(busy_plastic))
            sizes = self._chunk_sizes.setdefault(backend, set())
            sizes.add(chunk)
            self._compiles[f"chunk/{backend}"] = len(sizes)
            chunks += 1
            clock += chunk
            self._c_chunks.inc(backend=backend)
            self._c_slot_ticks.inc(S * chunk)
            for i in busy:
                offset[i] += chunk
            due = [i for i in busy if offset[i] >= budget[i]]
            if due:
                # One (S, N) read (and one telemetry pull) serves every retire
                # of the round: the only time the host waits for the device.
                with span("snn/readback", total=st["readback"], on=on):
                    rows = res.counts.to("cpu", copy=True).numpy()   # a copy on the CPU too
                    tel = res.telem.numpy() if res.telem is not None else None
                now = time.time()
                for i in due:
                    retire(i, now, rows[i], tel, st["retire"])
        return chunks

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the server's device without waiting for it: on the
        card from pinned memory, asynchronously (a pageable copy would
        synchronize the stream)."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _run_chunk(self, res: "_Resident", engine: TickEngine, backend: str, chunk: int,
                   slot_req: List[Optional[ServeRequest]], offset: np.ndarray,
                   budget: np.ndarray, until: np.ndarray, *, learning: bool) -> None:
        """One chunk of every slot from its carried state: assemble the
        ``(chunk, S, N)`` drive (and ``(chunk, S)`` rewards when learning) on
        the host, upload it, run ``TickEngine.chunk`` on the resident stacks
        (which it updates in place) and add the in-budget spikes to the
        device counts. Nothing here waits for the device.

        The count mask compares each absolute tick ``offset + t`` with the
        budget, so the partial counts add up to the wave path's masked sum
        exactly (small integers in f32)."""
        on = tracing.profiling()   # once for the chunk's spans
        S, N = self.slots, self.n_max
        with span("snn/assemble", total=self._stages["assemble"], on=on):
            ext = np.zeros((chunk, S, N), np.float32)
            rew = np.zeros((chunk, S), np.float32) if learning else None
            for i, r in enumerate(slot_req):
                if r is None:
                    continue
                o = int(offset[i])
                if r.ext is not None and o < r.ext.shape[0]:
                    seg = np.asarray(r.ext[o:o + chunk], np.float32)
                    ext[:seg.shape[0], i, :seg.shape[1]] = seg
                if learning and r.rewards is not None and o < len(r.rewards):
                    seg = np.asarray(r.rewards[o:o + chunk], np.float32)
                    rew[:seg.shape[0], i] = seg
            meta = np.stack([offset.astype(np.int32), budget, until])    # (3, S)
            with span("snn/upload", on=on):
                ext_d, meta_d = self._upload(ext), self._upload(meta)
                rew_d = None if rew is None else self._upload(rew)
        with span(f"snn/chunk/{backend}", histogram=self._h_chunk,
                  total=self._stages["dispatch"], on=on, backend=backend):
            params = SNNParams(w=res.w, c=res.c, w_in=res.w_in, lif=res.lif)
            fan = None if res.fan_idx is None else EventFanIn(idx=res.fan_idx, mask=res.fan_mask)
            if learning:
                carry = TickCarry(state=res.state, plast=res.plast, w=res.w, telem=res.telem)
                carry, raster = engine.chunk(params, carry, ext_d, chunk, rewards=rew_d,
                                             learn_until=meta_d[2], neighbors=fan, owned=True)
                res.w, res.plast = carry.w, carry.plast
            else:
                carry, raster = engine.chunk(params, TickCarry(state=res.state, telem=res.telem),
                                             ext_d, chunk, neighbors=fan, wc=res.wc,
                                             w_edges=res.w_edges, owned=True)
            res.state, res.telem = carry.state, carry.telem
            t_abs = meta_d[0][None, :] + res.ticks[:chunk, None]           # (chunk, S)
            tmask = (t_abs < meta_d[1][None, :]).to(raster.dtype)
            res.counts += (raster * tmask[:, :, None]).sum(dim=0)


class _Resident:
    """One continuous group's program inputs, resident on the device: the
    slots' register images (weights, connection list, the premasked ``W*C``
    the frozen tick reads on every program but ``pallas`` -- whose kernel
    masks per tile --, input weights, LIF rows; on the event program the
    fan-in lists and the per-edge weights of the frozen tick), their carry
    (state, traces and eligibility, telemetry) and their running counts.
    The state's tick counter is shared by the slots. Chunks update the
    stacks in place (the learning ones through an owned carry); a refill
    rewrites one slot."""

    def __init__(self, server: SNNServer, backend: str, t: Tenant):
        S, N, dev = server.slots, server.n_max, server.device
        self.rstdp = server.engine.options.plasticity.rule == "rstdp"

        def seed(a: torch.Tensor, dtype=None) -> torch.Tensor:
            """Every slot starts from this image."""
            return a.unsqueeze(0).expand((S,) + tuple(a.shape)).to(dtype or a.dtype).clone()

        p = t.params
        self.w, self.c, self.w_in = seed(p.w), seed(p.c), seed(p.w_in)
        self.lif = LIFParams(**{f.name: seed(getattr(p.lif, f.name))
                                for f in dataclasses.fields(LIFParams)})
        self.wc = None if backend == "pallas" else seed(masked_weights(p))
        self.fan_idx = self.fan_mask = self.w_edges = None
        if backend == "event":
            # int64 ids: the event arm indexes with them, once per chunk.
            self.fan_idx, self.fan_mask = seed(t.fan_idx, torch.int64), seed(t.fan_mask)
            self.w_edges = fan_in_edges(self.wc, EventFanIn(idx=self.fan_idx,
                                                            mask=self.fan_mask))
        self.state = SNNState.zeros((S,), N, device=dev)
        self.plast = PlasticityState.zeros((), N, device=dev, slots=S)
        self.telem = TickTelemetry.zeros((S,), device=dev) if server.telemetry else None
        self.counts = torch.zeros((S, N), dtype=torch.float32, device=dev)
        self.ticks = torch.arange(server.max_ticks, device=dev)

    @property
    def fill_copies(self) -> int:
        """The writes :meth:`fill` makes: the register image (``w``, ``c``,
        ``w_in`` and 6 LIF rows), 3 state rows, 2 trace rows and the counts
        row; ``W*C`` on every program but ``pallas``, the eligibility row
        under R-STDP, the telemetry row with telemetry on, and the fan-in
        lists and per-edge weights on the event program."""
        return (15 + (self.wc is not None) + self.rstdp + (self.telem is not None)
                + 3 * (self.fan_idx is not None))

    def fill(self, i: int, t: Tenant) -> None:
        """The register download: tenant ``t``'s image into slot ``i``, with
        a fresh state, traces, telemetry and counts. Every write goes into
        the resident stacks in place (:attr:`fill_copies` of them), with no
        host sync. The delay line (depth 1) is never written, so it stays
        zero, and the server arms no knee, so there is no hysteresis bit."""
        p = t.params
        self.w[i].copy_(p.w)
        self.c[i].copy_(p.c)
        self.w_in[i].copy_(p.w_in)
        for f in dataclasses.fields(LIFParams):
            getattr(self.lif, f.name)[i].copy_(getattr(p.lif, f.name))
        if self.wc is not None:
            torch.mul(p.w, p.c, out=self.wc[i])          # masked_weights, bit for bit
        if self.fan_idx is not None:
            self.fan_idx[i].copy_(t.fan_idx)
            self.fan_mask[i].copy_(t.fan_mask)
            self.w_edges[i].copy_(fan_in_edges(
                self.wc[i], EventFanIn(idx=self.fan_idx[i], mask=self.fan_mask[i])))
        lif = self.state.lif
        for x in (lif.v, lif.r, lif.y, self.plast.x_pre, self.plast.x_post, self.counts):
            x[i].zero_()
        if self.rstdp:
            self.plast.elig[i].zero_()
        if self.telem is not None:
            self.telem.buf[:, i].zero_()


def make_demo_tenants(server: SNNServer, n_tenants: int = 8, *, seed: int = 0) -> List[str]:
    """Register ``n_tenants`` heterogeneous networks on the fabric: layered /
    ring / sparse-random / all-to-all topologies with per-tenant thresholds
    and leaks, and one plastic (STDP) tenant, the last -- all through the
    byte-exact RegisterBank format."""
    from repro_torch.core import connectivity
    from repro_torch.core.registers import RegisterBank, WeightLayout

    rng = np.random.default_rng(seed)
    names: List[str] = []
    n_max = server.n_max
    for i in range(n_tenants):
        kind = ("layered", "ring", "sparse", "dense")[i % 4]
        n = int(rng.integers(max(6, n_max // 3), n_max + 1))
        if kind == "layered":
            n_in = max(2, n // 3)
            n_out = max(2, n // 4)
            hidden = n - n_in - n_out
            sizes = [n_in, hidden, n_out] if hidden > 0 else [n_in, n_out]
            c = connectivity.layered(sizes)
        elif kind == "ring":
            c = connectivity.ring(n, k=1 + i % 2)
            n_in, n_out = n, n
        elif kind == "sparse":
            c = connectivity.sparse_random(n, 0.1, seed=seed + i)
            n_in, n_out = n, n
        else:
            c = connectivity.all_to_all(n)
            n_in, n_out = n, n
        bank = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
        bank.set_connection_list(c)
        bank.set_weights((rng.integers(40, 200, (n, n)) * c).astype(np.uint8))
        bank.set_thresholds(rng.integers(60, 160, (n,)).astype(np.uint8))
        bank.set_leak(int(rng.integers(0, 8)))
        bank.set_refractory(int(rng.integers(0, 3)))
        name = f"{kind}-{i}"
        server.add_tenant(name, bank, n_in=n_in, n_out=n_out,
                          plastic=(i == n_tenants - 1))
        names.append(name)
    return names


def make_demo_requests(server: SNNServer, names: List[str], n_requests: int, *,
                       seed: int = 0) -> List[ServeRequest]:
    """Requests with u8-magnitude impulse drive (paper Fig. 5) and tick
    budgets in ``[4, max_ticks]`` -- the reference's generator, draw for draw."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        t = server.tenants[names[i % len(names)]]
        ticks = int(rng.integers(4, server.max_ticks + 1))
        ext = ((rng.random((ticks, t.n_in)) < 0.3)
               * rng.integers(80, 255, (ticks, t.n_in))).astype(np.float32)
        reqs.append(ServeRequest(rid=i, tenant=t.name, ext=ext, n_ticks=ticks))
    return reqs


def device_profile(fn: Callable[[], object], device: torch.device):
    """Run ``fn()`` under ``torch.profiler``; returns ``(its result, wall
    seconds, device-busy seconds, [(device us, count, name)] by kernel, the
    profiler)``. Kernels on one stream do not overlap, so their summed device
    time is the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels and copies): the CPU ops that launched
    # them carry the same device time and would count it twice, and so do the
    # tick scopes ("tick/...") on the device timeline (the stage spans' records
    # stay on the host's). (By name: the profiler's user-annotation flag left
    # B4's kernel out of a device-time sum on the card.)
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("tick/")), reverse=True)
    return out, wall, sum(r[0] for r in rows) / 1e6, rows, prof


def profiled_serve(server: SNNServer, reqs: List[ServeRequest], out_dir=None, *,
                   continuous: bool = False) -> Dict:
    """Serve ``reqs`` (``continuous``: through :meth:`SNNServer.serve_continuous`)
    under ``torch.profiler``; print device time by kernel, the device's busy
    share of the wall time and, for the continuous loop, its host time per
    stage. ``out_dir`` also receives a Chrome trace."""
    run = server.serve_continuous if continuous else server.serve
    stats, wall, busy_s, rows, prof = device_profile(lambda: run(reqs), server.device)
    print(f"profile: wall {wall:.6f} s, device busy {busy_s:.6f} s "
          f"({busy_s / wall:.4f} of wall), by kernel:")
    for us, count, key in rows[:12]:
        print(f"  {us / 1e3:10.3f} ms  {count:6d}x  {key[:90]}")
    if continuous:
        print(f"host time under the profiler, {stats['chunks']} chunks: " + ", ".join(
            f"{stage} {sec * 1e6:.1f} us in {n}" for stage, (sec, n) in server.host_time.items()))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "serve_trace.json"))
    return stats


def serve_snn_main(cfg, args) -> Dict:
    # The dense default program plus the event program for sparse tenants:
    # tenants at or below 20 % density ride the fan-in gather, as the
    # reference's CLI serves them.
    backend = "jnp" if cfg.snn_backend == "event" else cfg.snn_backend
    server = SNNServer(n_max=cfg.n_neurons, slots=args.slots, max_ticks=cfg.n_ticks,
                       mode=cfg.snn_mode, backend=backend, event_density=0.2,
                       chunk_ticks=max(1, min(cfg.snn_chunk_ticks, cfg.n_ticks)),
                       device=args.device)
    names = make_demo_tenants(server, max(8, args.slots))
    on_event = [n for n in names if server.tenants[n].backend == "event"]
    print(f"serving SNN fabric n_max={server.n_max} on {server.device}: {len(names)} "
          f"resident tenants, {args.slots} slots, backend {server.backend}; "
          f"event program (fan-in cap {server.event_cap}) for {on_event}")
    n_req = max(args.requests, len(names))
    run = server.serve_continuous if args.continuous else server.serve
    if args.profile:
        run(make_demo_requests(server, names, n_req, seed=1))   # warm-up
    reqs = make_demo_requests(server, names, n_req)
    lif_step.launches = tick_fused.launches = stdp_update.launches = 0
    event_dispatch.launches = event_dispatch.launches_db = telemetry.launches = 0
    if args.profile:
        stats = profiled_serve(server, reqs, args.profile, continuous=args.continuous)
    else:
        stats = run(reqs)
    for k, v in stats.items():
        if k != "results":
            print(f"{k}: {v}")
    print(f"kernel launches: tick_fused={tick_fused.launches} "
          f"lif_step={lif_step.launches} stdp_update={stdp_update.launches} "
          f"event_dispatch_db={event_dispatch.launches_db} "
          f"event_dispatch={event_dispatch.launches} telemetry={telemetry.launches}")
    report = server.tenant_report()
    if report:
        print("\nper-tenant activity (wave telemetry):")
        for name, row in report.items():
            print(f"  {name}: " + ", ".join(f"{k}={v}" for k, v in row.items()))
    print("\nmetrics exposition:")
    print(server.registry.to_prometheus())
    if args.metrics_out:
        import json

        with open(args.metrics_out, "w") as fh:
            json.dump(server.registry.to_dict(), fh, indent=1, sort_keys=True)
        print(f"wrote metrics JSON to {args.metrics_out}")
    if stats["recompiles_after_warmup"]:
        raise AssertionError("a tenant swap or slot refill put a new program into use")
    return stats


def _plan_misses() -> int:
    """Rebuilds and new launch plans so far (every kernel's plan cache): what
    a retrace is to the reference."""
    from repro_torch.kernels import _build, _event_plan, _plan, _stream

    return sum(f.cache_info().misses for f in (
        _build.build, _plan.plan, _stream.stdp_plan, _stream.spike_matmul_plan,
        _event_plan.event_plan))


def serve_sharded_main(cfg, args) -> Dict:
    """Serve a sharded fabric: ONE network over every rank of this world.

    The slotted :class:`SNNServer` time-shares one small fabric between many
    tenants; this is the other end of the scale axis (DESIGN.md §15): a
    single network whose ``(n, n)`` weight matrix is partitioned by
    destination columns over the mesh, each rank building only its own
    columns. The serving loop is the chunk contract: ``TickEngine.chunk``
    calls threading the rank-resident carry, no new launch plan after the
    warm-up chunk (``recompiles_after_warmup`` counts them). Above 4096
    neurons the topology is the implicit all-to-all (``c=None``): ``W*C`` is
    ``W`` itself and no second 16 GiB buffer exists. Every backend serves it,
    the kernels B1 and B2 on ``W`` alone (the reference's Pallas kernels
    refuse ``c=None`` and its CLI serves them on ``jnp`` there; ROADMAP §C).

    The world is the one this process was started in (:func:`~repro_torch.
    launch.mesh.init_world`): a lone process is a world of one rank, and
    ``torchrun --nproc-per-node D`` gives D. The reference simulates
    ``cfg.snn_mesh`` devices in one process; the port serves on the ranks it
    has and prints D. Every rank builds the same drive from the same seed;
    rank 0 prints. The returned stats hold, under ``"results"``, this rank's
    rasters of every chunk (the warm-up first), its final carry, the
    telemetry summary, and the engine and this rank's parameters it served.
    """
    from repro_torch.core import connectivity
    from repro_torch.launch.mesh import init_world
    from repro_torch.parallel import snn_sharding
    from repro_torch.parallel.mesh import make_snn_mesh

    import torch.distributed as dist

    joined = not dist.is_initialized()
    init_world(args.device)
    joined = joined and dist.is_initialized()
    mesh = make_snn_mesh(None, device=args.device)
    n, n_dev = cfg.n_neurons, mesh.size
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    if n_dev != cfg.snn_mesh:
        say(f"config {cfg.name!r} names a {cfg.snn_mesh}-device mesh; this world has "
            f"{n_dev} rank(s), and the fabric shards over those")
    backend = cfg.snn_backend
    use_implicit = n > 4096          # c=None: no (n, n) mask at scale
    engine = TickEngine(EngineOptions(mode=cfg.snn_mode, backend=backend, telemetry=True,
                                      mesh=mesh))

    # -- the fabric: W rank-local from the start, the small leaves cut --------
    w = snn_sharding.make_sharded_dyadic_weights(n, mesh)
    c = None
    if not use_implicit:
        c_np = connectivity.sparse_random(n, cfg.snn_density, seed=0)
        sstats = connectivity.shard_stats(c_np, n_dev)
        say(f"topology: density={cfg.snn_density}, edge imbalance across {n_dev} "
            f"shards = {connectivity.shard_imbalance(sstats):.3f}")
        c = torch.from_numpy(c_np.astype(np.float32))
    n_in = min(n, 256)
    rng = np.random.default_rng(7)
    w_in = torch.from_numpy(rng.integers(0, 8, (n_in, n)).astype(np.float32) * 0.25)
    lif = LIFParams.make(n, v_th=1.0, leak=0.25, r_ref=1, device="cpu")
    specs = snn_sharding.params_specs(snn_sharding.snn_rules(mesh.axis),
                                      SNNParams(w=w, c=c, w_in=w_in, lif=lif))
    params = SNNParams(w=w, c=snn_sharding.place(c, specs.c, mesh),
                       w_in=snn_sharding.place(w_in, specs.w_in, mesh),
                       lif=snn_sharding.place(lif, specs.lif, mesh))
    carry = TickCarry(state=SNNState.zeros((), n // n_dev, device=mesh.device),
                      telem=TickTelemetry.zeros((), device=mesh.device))

    chunk_ticks = max(1, cfg.snn_chunk_ticks)
    n_chunks = max(2, args.requests)

    def _ext():
        spikes = rng.random((chunk_ticks, n_in)) < cfg.snn_rate
        return torch.from_numpy(spikes.astype(np.float32)).to(mesh.device)

    def _sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    say(f"serving sharded SNN fabric n={n} on a {n_dev}-rank mesh of {mesh.device} "
        f"(spike exchange: {mesh.exchange}; {backend} backend, {chunk_ticks}-tick "
        f"chunks, {n_chunks} chunks)")
    rasters = []
    carry, raster = engine.chunk(params, carry, _ext(), chunk_ticks, owned=True)  # warm-up
    rasters.append(raster)
    _sync()
    warm = _plan_misses()
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        carry, raster = engine.chunk(params, carry, _ext(), chunk_ticks, owned=True)
        rasters.append(raster)
    _sync()
    dt = time.perf_counter() - t0

    ticks = n_chunks * chunk_ticks
    tel = carry.telem.summary(n)
    stats = {
        "mode": "sharded",
        "n_neurons": n,
        "n_devices": n_dev,
        "ticks": ticks,
        "ticks_per_s": ticks / dt,
        "synops_per_s": ticks / dt * float(n) * float(n),
        "recompiles_after_warmup": _plan_misses() - warm,
    }
    for k, v in stats.items():
        say(f"{k}: {v}")
    say("telemetry: " + ", ".join(f"{k}={v:.4g}" for k, v in tel.items()))
    if args.metrics_out and mesh.rank == 0:
        import json

        with open(args.metrics_out, "w") as fh:
            json.dump({**stats, "telemetry": tel}, fh, indent=1, sort_keys=True)
        say(f"wrote metrics JSON to {args.metrics_out}")
    if stats["recompiles_after_warmup"]:
        raise AssertionError("the chunk loop put a new launch plan into use")
    stats["results"] = {"rasters": rasters, "carry": carry, "telemetry": tel,
                        "engine": engine, "params": params}
    if joined:   # the world this call joined ends with it
        dist.destroy_process_group()
    return stats


def serve_lm_main(cfg, args) -> Dict:
    """The LM branch of the CLI: parameters drawn from a seeded generator on
    the device, ``--requests`` random prompts of 4-11 tokens (numpy seed 0,
    as the reference's), served in waves. ``--profile`` serves once to warm
    up, then serves under ``torch.profiler`` and prints device time by
    kernel. A vlm config exits before anything is drawn (:data:`VLM_REFUSAL`)."""
    try:
        check_servable(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"{args.arch}: {e}") from None
    print(f"serving {cfg.name}: {M.n_params(cfg):,} params, "
          f"{args.slots} slots, {args.requests} requests")
    dev = _device.resolve(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init(cfg, gen, dev)

    def requests():
        rng = np.random.default_rng(0)
        reqs = []
        for i in range(args.requests):
            plen = int(rng.integers(4, 12))
            if cfg.family == "audio":
                prompt = rng.integers(0, cfg.vocab_size, (plen, cfg.n_codebooks))
            else:
                prompt = rng.integers(0, cfg.vocab_size, (plen,))
            reqs.append(ServeRequest(rid=i, prompt=prompt.astype(np.int32),
                                     max_new=args.max_new))
        return reqs

    run = lambda: serve(cfg, params, requests(), slots=args.slots, max_len=args.max_len,
                        device=dev)
    if args.profile:
        run()   # warm-up
        stats, wall, busy_s, rows, prof = device_profile(run, dev)
        print(f"profile: wall {wall:.6f} s, device busy {busy_s:.6f} s "
              f"({busy_s / wall:.4f} of wall), {sum(r[1] for r in rows)} device events, "
              f"by kernel:")
        for us, count, key in rows[:12]:
            print(f"  {us / 1e3:10.3f} ms  {count:6d}x  {key[:90]}")
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "serve_trace.json"))
    else:
        stats = run()
    for k, v in stats.items():
        if k != "results":
            print(f"{k}: {v}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--continuous", action="store_true",
                    help="per-slot continuous admission in chunks of the config's "
                         "snn_chunk_ticks instead of synchronous waves (SNN server only)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="serve once to warm up, then serve under torch.profiler: "
                         "print device time by kernel, write a Chrome trace to DIR")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="write the metrics registry as JSON to PATH (SNN server only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host, "
                         "the kernels as their plain twins)")
    args = ap.parse_args(argv)
    bundle = get_bundle(args.arch)
    cfg = bundle.smoke if args.smoke else bundle.model
    if cfg.family != "snn":
        return serve_lm_main(cfg, args)
    if cfg.snn_mesh:
        return serve_sharded_main(cfg, args)
    return serve_snn_main(cfg, args)


if __name__ == "__main__":
    main()
