"""Crossover policy for event dispatch: which formulation wins, where.

Counterpart of ``repro.core.dispatch_policy``, in numpy: the plan reads
the connection list on the host once, at plan time, whether it arrives as
a numpy array or as a tensor on either device. Every constant and every
cost formula is the reference's, so a plan equals the reference's field
for field; ``GATHER_PENALTY["gpu"]`` has not been measured on an H100 yet
(the port's crossover measurement is in PERF.md).

The event backend has three ways to compute a tick's synaptic input,
and none of them wins everywhere:

* **dense** -- the plain masked product ``s @ (W*C)``.  ``2*B*n*n``
  FLOPs regardless of activity, but those FLOPs run at GEMM throughput,
  the fastest arithmetic any platform offers.
* **fan_in** -- the padded fan-in gather (:class:`~repro_torch.kernels.ops.
  EventFanIn`): every postsynaptic neuron reads exactly its ``cap``
  in-edges.  ``2*B*n*cap`` FLOPs, activity-independent, vmap-safe --
  but gathers run well below GEMM throughput, so the FLOP reduction
  must clear a platform-dependent *gather penalty* before it pays.
* **topk** -- the spike-list gather (top-k spiking rows steer the
  weight DMA).  ``2*B*k*n`` FLOPs; on the card this is kernel B3
  (``csrc/event_dispatch.cu``), which reads only the spiking rows'
  fan-out slices from device memory.  Cost scales with the *spike budget* ``k``,
  which makes it the one formulation a per-tick spike count can
  arbitrate (the adaptive knee below).

This module is the ONE place those trade-offs live.  Before it, the
fallback trigger ``k = min(k_active or n//8, n)`` was derived twice
in the reference (its engine and ``ops.event_synaptic_input``) and could drift;
:func:`resolve_k_active` is now the single source both import.  The
knee model is calibrated against the Table-I-style cost model in
the reference's ``benchmarks/bench_snn_scale.py`` (same FLOP counts).

Two decision levels:

* **Trace time** (:func:`plan`): from concrete connectivity (and the
  input-weight structure), pick the strategy, the fan-in lists, the
  spike budget and the knee.  Runs on the host, once, before the
  rollout -- topology is runtime data the tick loop never branches on.
* **Tick time** (the knee): for the ``topk`` strategy the engine
  measures the tick's spike count on the device and gates the
  spike-list kernel off and the dense kernel on above :func:`knee_spikes`, with hysteresis so the
  branch doesn't thrash when activity hovers at the knee.  Both arms
  are bit-exact, so the branch choice is pure policy, never semantics.

A structural observation the policy also exploits: the external drive
``ext @ w_in`` is a *second* dense ``n x n`` GEMM every tick, and on
the paper's datapath ``w_in`` is diagonal (impulse registers are
per-neuron -- ``network.params_from_registers`` builds ``w_in = I``).
:func:`plan` detects diagonal ``w_in`` and the engine then computes the
drive as an elementwise ``ext * diag(w_in)`` -- identical bits (adding
exact zeros is a no-op in f32), one full GEMM gone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

# Gather penalty: how many dense MACs one gathered+accumulated element
# costs, per platform.  Calibrated from bench_snn_scale.py runs: on CPU
# (XLA:CPU scalarizes row gathers while Eigen runs the GEMM at full
# vector width) a gathered element costs ~20 dense MACs; on TPU the
# event kernel's DMA-steered gathers stream at memory speed, so the
# penalty is small.  These are *policy* constants -- both arms of every
# choice are bit-exact, so a miscalibration costs speed, never bits.
GATHER_PENALTY: Dict[str, float] = {"cpu": 20.0, "gpu": 6.0, "tpu": 2.0}

# Fixed per-tick overhead of the topk path (the top_k sort itself),
# in dense-MAC-equivalents per presynaptic row scanned.
TOPK_SORT_PENALTY = 4.0

# Hysteresis: the dense->event release threshold as a fraction of the
# event->dense knee.  Activity must fall this far below the knee before
# the engine switches back, so a spike count hovering at the knee
# doesn't flip the branch every tick.
DEFAULT_HYSTERESIS = 0.75


def _platform(platform: Optional[str] = None) -> str:
    """The cost model's platform: ``"gpu"`` when a CUDA card is visible,
    else ``"cpu"`` (the reference asks ``jax.default_backend()``)."""
    if platform is not None:
        return platform
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


def gather_penalty(platform: Optional[str] = None) -> float:
    return GATHER_PENALTY.get(_platform(platform), GATHER_PENALTY["cpu"])


def resolve_k_active(n: int, k_active: Optional[int] = None) -> int:
    """THE spike-budget trigger: ``min(k_active or n//8 (floor 8), n)``.

    Single source of truth for the event backend's top-k slot count --
    ``ops.event_synaptic_input``'s internal trigger, the engine's
    telemetry mirror, and the Pallas kernel bridge all call this, so
    the thresholds cannot drift (they once were derived independently
    in two modules).
    """
    if k_active is None:
        k_active = min(n, max(8, n // 8))
    return min(int(k_active), int(n))


def knee_spikes(n: int, *, platform: Optional[str] = None) -> int:
    """The spike count above which the dense product is the cheaper arm.

    The topk arm pays ``~penalty`` dense-MAC-equivalents per gathered
    weight-row element; the dense arm pays ``n`` rows regardless.  They
    cross where ``spikes * penalty == n``: on CPU (penalty ~20) the
    knee sits near ``n/20``; on TPU near ``n/2``.  Floored at 1 so the
    knee is always a usable threshold.
    """
    return max(1, int(n / gather_penalty(platform)))


# -- cost model (dense-MAC-equivalents per tick) ----------------------------


def dense_cost(n: int, batch: int, *, n_ext_gemms: int = 0) -> float:
    """Masked product ``B*n*n`` MACs (+ any full input-drive GEMMs)."""
    return float(batch) * n * n * (1 + n_ext_gemms)


def fanin_cost(n: int, batch: int, cap: int,
               *, platform: Optional[str] = None) -> float:
    """Padded fan-in gather: ``B*n*cap`` gathered elements."""
    return float(batch) * n * cap * gather_penalty(platform)


def topk_cost(n: int, batch: int, k: int,
              *, platform: Optional[str] = None) -> float:
    """Spike-list gather: ``B*k*n`` gathered elements + the top-k scan."""
    return (float(batch) * k * n * gather_penalty(platform)
            + float(batch) * n * TOPK_SORT_PENALTY)


# -- the trace-time plan ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """What :func:`plan` decided for one fabric.

    ``strategy`` is the synaptic-input formulation ("fan_in" | "topk" |
    "dense" -- "dense" is still the *event backend*: it keeps the
    diagonal-drive elimination and the adaptive machinery, it just
    computes the synaptic product densely because the topology is past
    the gather knee on this platform).  ``neighbors`` holds the
    :class:`~repro_torch.kernels.ops.EventFanIn` lists when the strategy is
    "fan_in" (runtime data -- same-cap topology swaps never retrace).
    ``knee`` is the per-tick adaptive switch threshold for the "topk"
    strategy (None = no in-scan switching).  ``ext_diag`` records that
    ``w_in`` is diagonal, enabling the elementwise drive.
    ``costs`` is the modeled cost of every candidate (for logs/benches).
    """

    strategy: str
    k_active: int
    knee: Optional[int]
    hysteresis: float
    neighbors: Optional[Any]
    ext_diag: bool
    cap: Optional[int]
    costs: Dict[str, float]

    def engine_kwargs(self) -> Dict[str, Any]:
        """Static kwargs for :class:`~repro_torch.core.engine.TickEngine`.

        ``neighbors`` is runtime data -- pass it to the rollout call,
        not the engine constructor.
        """
        return dict(
            backend="event",
            event_dispatch=self.strategy,
            event_k_active=self.k_active,
            event_knee=self.knee,
            event_hysteresis=self.hysteresis,
            event_ext_diag=self.ext_diag,
        )

    def engine_options(self, **overrides):
        """This plan as a validated
        :class:`~repro_torch.core.engine.EngineOptions`; ``overrides``
        layer non-event options on top, e.g.
        ``plan.engine_options(mode="euler")``."""
        from repro_torch.core.engine import EngineOptions

        kw = self.engine_kwargs()
        kw.update(overrides)
        return EngineOptions(**kw)


def _host(a) -> np.ndarray:
    """A numpy copy of ``a`` (a tensor on any device, or array-like)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def is_diagonal(w_in) -> bool:
    """True when the input matrix routes each input only to its own
    neuron (the paper's per-neuron impulse registers)."""
    if w_in is None:
        return False
    a = _host(w_in)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        return False
    return bool(np.count_nonzero(a - np.diag(np.diagonal(a))) == 0)


def plan(
    c,
    *,
    w_in=None,
    batch: int = 1,
    rate: Optional[float] = None,
    k_active: Optional[int] = None,
    cap: Optional[int] = None,
    platform: Optional[str] = None,
    vmap_safe: bool = False,
    adaptive: bool = True,
    prefer_density: Optional[float] = None,
    device=None,
) -> DispatchPlan:
    """Pick the event backend's dispatch strategy for one concrete fabric.

    Host-side: ``c`` (and ``w_in``) are read into numpy once, here, so a
    tensor on the card costs one copy at plan time and none in the tick
    loop (which never branches on topology; the *plan* does, once, at
    admission or build time).

    Args:
      c: ``(n, n)`` connectivity (bool/0-1), numpy or a tensor.
      w_in: input matrix, numpy or a tensor; diagonal ``w_in`` enables
        the elementwise drive (see module docstring).
      batch: batch size the rollout will run at (cost-model input).
      rate: expected spike rate; tightens the topk budget to
        ``2*rate*n`` instead of the safe default ``n//8`` (the adaptive
        knee + overflow fallback keep any underestimate exact).
      k_active: explicit spike budget (overrides ``rate``).
      cap: force the fan-in list width (serving uses one shared cap so
        every tenant's lists stack to a static shape); None = tightest.
      platform: cost-model platform override (default: the running one).
      vmap_safe: exclude the "topk" strategy, as the reference's
        multi-tenant server does (its slots share one program under
        ``vmap``; the port's server follows it so both route alike).
      adaptive: arm the per-tick knee for the "topk" strategy.
      prefer_density: operator override -- at or below this density a
        fabric whose fan-in fits ``cap`` takes "fan_in" regardless of
        the modeled cost (the server's ``event_density`` contract: the
        operator knows the fleet better than the cost model).
      device: where the fan-in lists go (default: ``c``'s device when it
        is a tensor, else the card).
    """
    from repro_torch.core import connectivity

    if device is None:
        device = getattr(c, "device", None)
    c_np = _host(c) > 0
    n = c_np.shape[0]
    st = connectivity.stats(c_np)
    if cap is not None and st.max_fan_in > cap:
        # Never truncate: a fabric whose fan-in exceeds the forced cap
        # simply can't take the fan_in strategy.
        cap_eff = None
    else:
        cap_eff = int(cap if cap is not None else max(1, st.max_fan_in))

    if rate is not None and k_active is None:
        k_active = max(8, int(2 * rate * n))
    k = resolve_k_active(n, k_active)

    costs: Dict[str, float] = {
        "dense": dense_cost(n, batch),
        "topk": topk_cost(n, batch, k, platform=platform),
    }
    if cap_eff is not None:
        costs["fan_in"] = fanin_cost(n, batch, cap_eff, platform=platform)

    allowed = ["dense"]
    if cap_eff is not None:
        allowed.append("fan_in")
    if not vmap_safe:
        allowed.append("topk")
    strategy = min(allowed, key=lambda s: costs[s])
    if (prefer_density is not None and st.density <= prefer_density
            and cap_eff is not None):
        strategy = "fan_in"

    neighbors = None
    if strategy == "fan_in":
        from repro_torch.kernels.ops import EventFanIn

        neighbors = EventFanIn.from_padded(
            connectivity.padded_fan_in(c_np, cap_eff), device=device)

    knee = None
    if strategy == "topk" and adaptive:
        knee = min(knee_spikes(n, platform=platform), k)

    return DispatchPlan(
        strategy=strategy,
        k_active=k,
        knee=knee,
        hysteresis=DEFAULT_HYSTERESIS,
        neighbors=neighbors,
        ext_diag=is_diagonal(None if w_in is None else _host(w_in)),
        cap=cap_eff,
        costs=costs,
    )
