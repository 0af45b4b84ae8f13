"""The program registry: every program the port ships, as an analyzable spec.

Counterpart of ``repro.analysis.programs``. A :class:`Program` bundles what
the rules need: a ``run`` that executes the program once at a small
operating point (recorded by :mod:`repro_torch.analysis.op_rules`; eager
PyTorch has no trace to take without running), the ``W*C`` hoist
expectation, the :class:`~repro_torch.core.engine.EngineOptions` factory (for
the new-plan hazard rules), and the launch descriptors of its kernels (for
the kernel lint). :func:`program_names` lists the shipped matrix, under the
reference's names:

* tick programs -- 4 backends x frozen/learning x telemetry on/off (16), the
  event knee on the frozen event programs so both device-gated arms run;
  and ``tick/sharded/frozen/notelem`` and ``tick/sharded/learning/telem``:
  the tick loop a rank of a sharded world runs (the engine given its mesh
  as ``gather``), in a world of one as ``serve_sharded_main`` makes a lone
  process one;
* serve programs -- the wave program (dense and event), the continuous
  chunk, and the slot refill (the register download);
* kernel launches -- each kernel's descriptor at a representative shape
  (the reference's) and at the shapes the port really launches: snn-fused
  FULL (4096 neurons, 8 slots), snn-event FULL, B5 served and fully
  plastic, B6 at 8 x 4096 x 4096 and at Iris / MNIST, the telemetry kernel at
  8 x 4096, the learning workload's 128 and 74 neurons, and B1/B2/B5 at
  ``N = n/D`` and B4 at a narrow ``N`` for D in {1, 2, 4, 8} at 4096 and
  65,536 neurons (the sharded fabric). Plans are pure host Python, so these
  lint on the CPU too.

The tick and serve programs run at ``n <= 24`` and a handful of ticks, on
``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import op_rules
from repro_torch.kernels.launch_spec import KernelLaunch

# Small but non-degenerate: n is the fabric width the hoist rule looks for,
# chosen to collide with nothing else (ticks, delay depth, batch).
_N = 24
_TICKS = 5


@dataclasses.dataclass
class Program:
    """One analyzable program (see the module docstring). ``ticks``: the tick
    loop's length (the per-tick rules); ``sharded``: the mesh size of a
    sharded tick program (0 otherwise); ``k_split``: the severity of the K
    split rule over ``launches`` (B1 at ``N = n/D``), or empty."""

    name: str
    run: Optional[Callable[[], Any]] = None
    ticks: int = 0
    n: int = _N
    hoist: str = op_rules.HOIST_SKIP
    options_factory: Optional[Callable[[], Any]] = None
    launches: Tuple[KernelLaunch, ...] = ()
    sharded: int = 0
    k_split: str = ""


# ---------------------------------------------------------------------------
# Tick programs
# ---------------------------------------------------------------------------

def snn_params(n: int, device):
    """The reference's analysis fabric: uniform weights on [0, 2), 30 %
    random connectivity, identity input weights."""
    from repro_torch.core import connectivity
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network_types import SNNParams

    rng = np.random.default_rng(0)
    c = connectivity.sparse_random(n, 0.3, seed=0)
    return SNNParams(
        w=torch.as_tensor(rng.uniform(0, 2.0, (n, n)), dtype=torch.float32, device=device),
        c=torch.as_tensor(c, dtype=torch.float32, device=device),
        w_in=torch.eye(n, dtype=torch.float32, device=device),
        lif=LIFParams.make(n, v_th=1.0, leak=0.25, r_ref=1, device=device))


def ext_seq(n: int, ticks: int, device):
    rng = np.random.default_rng(1)
    return torch.as_tensor(rng.random((ticks, n)) < 0.3, dtype=torch.float32, device=device)


def tick_options(backend: str, learning: bool, telemetry: bool, mesh=None):
    from repro_torch.core.engine import EngineOptions
    from repro_torch.plasticity.stdp import PlasticityParams

    kw: dict = dict(backend=backend, telemetry=telemetry, mesh=mesh)
    if learning:
        kw["plasticity"] = PlasticityParams.make("stdp", a_plus=0.05, a_minus=0.05)
    elif backend == "event":
        # The frozen event programs ship with the adaptive knee on, so both
        # device-gated arms (B1 and the event kernel) run every tick.
        kw["event_knee"] = 4
    return EngineOptions(**kw)


def _tick_hoist(backend: str, learning: bool) -> str:
    if backend == "pallas":
        # w and c stream into kernel B1, which masks per tile: the contract
        # is only that no dense W*C leaked into the loop.
        return op_rules.HOIST_KERNEL
    if learning:
        return (op_rules.HOIST_IN_LOOP if backend in ("jnp", "event")
                else op_rules.HOIST_KERNEL)
    return op_rules.HOIST_HOISTED


def _rollout(engine, learning: bool, device):
    from repro_torch.core.network_types import SNNState
    from repro_torch.plasticity.stdp import PlasticityState

    params = snn_params(_N, device)
    state = SNNState.zeros((), _N, device=device)
    ext = ext_seq(_N, _TICKS, device)
    if learning:
        pst = PlasticityState.zeros((), _N, device=device)
        return lambda: engine.learning_rollout(params, state, pst, ext, _TICKS)
    return lambda: engine.rollout(params, state, ext, _TICKS)


def _tick_program(backend: str, learning: bool, telemetry: bool, device) -> Program:
    from repro_torch.core.engine import TickEngine

    engine = TickEngine(tick_options(backend, learning, telemetry))
    tag = "learning" if learning else "frozen"
    tel = "telem" if telemetry else "notelem"
    return Program(
        name=f"tick/{backend}/{tag}/{tel}", run=_rollout(engine, learning, device),
        ticks=_TICKS, hoist=_tick_hoist(backend, learning),
        options_factory=functools.partial(tick_options, backend, learning, telemetry))


def _mesh(device):
    from repro_torch.parallel.mesh import make_snn_mesh

    return make_snn_mesh(None, device=device)


def _tick_sharded_program(learning: bool, telemetry: bool, device) -> Program:
    """The tick loop of one rank: the engine given its mesh as ``gather``,
    which all-gathers the arriving spikes every tick, on this rank's
    operands. ``sharded_scan`` runs exactly this inside a world of D > 1; a
    world of one runs the plain engine (no exchange), so the registry gives
    the inner engine the world-of-one mesh itself, where the exchange moves
    nothing but is still the one collective of the tick."""
    from repro_torch.core.engine import TickEngine

    mesh = _mesh(device)
    opts = tick_options("jnp", learning, telemetry)
    engine = TickEngine(opts, gather=mesh)
    tag = "learning" if learning else "frozen"
    tel = "telem" if telemetry else "notelem"
    return Program(
        name=f"tick/sharded/{tag}/{tel}", run=_rollout(engine, learning, device),
        ticks=_TICKS,
        hoist=op_rules.HOIST_IN_LOOP if learning else op_rules.HOIST_HOISTED,
        options_factory=lambda: tick_options("jnp", learning, telemetry, mesh=_mesh(device)),
        sharded=mesh.size)


# ---------------------------------------------------------------------------
# Serve programs (wave / chunk / refill)
# ---------------------------------------------------------------------------

def demo_server(event: bool, device):
    """A 2-slot server with one resident demo tenant (dense, or sparse enough
    to ride the event program), as the reference's registry builds it."""
    from repro_torch.core import connectivity
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network_types import SNNParams
    from repro_torch.launch.serve import SNNServer

    n_max, n = 16, 12
    server = SNNServer(n_max=n_max, slots=2, max_ticks=4, backend="jnp",
                       event_density=0.2 if event else None, chunk_ticks=2, device=device)
    rng = np.random.default_rng(2)
    c = (connectivity.sparse_random(n, 0.08, seed=3) if event
         else connectivity.all_to_all(n))
    params = SNNParams(
        w=torch.as_tensor(rng.uniform(0, 2.0, (n, n)), dtype=torch.float32, device=device),
        c=torch.as_tensor(c, dtype=torch.float32, device=device),
        w_in=torch.eye(n, dtype=torch.float32, device=device),
        lif=LIFParams.make(n, v_th=1.0, leak=0.25, r_ref=1, device=device))
    t = server.add_tenant_params("demo", params, n_in=n, n_out=n, plastic=False)
    if event and t.backend != "event":
        raise RuntimeError("demo tenant did not route to the event program; the serve "
                           "registry is mis-built")
    return server, t


def _requests(server, t):
    from repro_torch.launch.serve import ServeRequest

    return [ServeRequest(rid=i, tenant="demo",
                         ext=np.ones((server.max_ticks, t.n_in), np.float32),
                         n_ticks=server.max_ticks)
            for i in range(server.slots)]


def _serve_wave_program(event: bool, device) -> Program:
    server, t = demo_server(event, device)
    reqs = _requests(server, t)

    def run():
        return server._wave_fn(*server._assemble(reqs), backend=t.backend,
                               neighbors=server._fan_in(reqs))
    # The wave's W*C products carry a slot axis: the rank-2 hoist rule does
    # not apply (the tick programs pin the contract for each backend).
    return Program(name=f"serve/wave/{t.backend}", run=run, ticks=server.max_ticks,
                   n=server.n_max)


def _serve_chunk_program(device) -> Program:
    from repro_torch.launch.serve import _Resident

    server, t = demo_server(False, device)
    reqs = _requests(server, t)
    res = _Resident(server, "jnp", t)
    S, chunk = server.slots, server.chunk_ticks
    offset = np.zeros((S,), np.int64)
    budget = np.full((S,), server.max_ticks, np.int32)
    until = np.zeros((S,), np.int32)

    def run():
        server._run_chunk(res, server._engine_for("jnp"), "jnp", chunk, reqs, offset,
                          budget, until, learning=False)
    return Program(name="serve/chunk/jnp", run=run, ticks=chunk, n=server.n_max)


def _serve_refill_program(device) -> Program:
    from repro_torch.launch.serve import _Resident

    server, t = demo_server(False, device)
    res = _Resident(server, "jnp", t)
    return Program(name="serve/refill/jnp", run=lambda: res.fill(1, t), n=server.n_max)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

SHARD_WIDTHS = ((4096, 8, True), (65536, 1, False))   # n, batch rows, learns (has c)
SHARD_DEVICES = (1, 2, 4, 8)


@functools.lru_cache(maxsize=None)
def kernel_launches() -> Tuple[Tuple[str, Any], ...]:
    """``(registry name, launch or tuple of launches)`` for every kernel
    entry: the reference's representative shapes first, then the shapes
    the port launches. A tuple is one family: B1/B2/B5/B4 at ``N = n/D``
    for each D (the K split of B1 must not change with N)."""
    from repro_torch.kernels import (_event_plan, _plan, _stream, event_dispatch, lif_step,
                                     spike_matmul, stdp_update, telemetry, tick_fused)

    def b1(S, B, K, N, *, has_c, **kw):
        return lif_step.lif_launch(_plan.plan(S, B, K, N, has_c=has_c), **kw)

    def b2(S, B, K, N, *, has_c, n_read=1, delays=False, ring="", **kw):
        p = _plan.plan(S, B, K, N, has_c=has_c, delays=delays, n_read=n_read)
        return tick_fused.tick_launch(p, n_read=n_read, delays=delays, ring=ring,
                                      n_ring=n_read if ring else 0, **kw)

    def b4(S, B, k, N, Kw, rate, **kw):
        return event_dispatch.event_launch(
            _event_plan.event_plan(S, B, k, N, Kw),
            lists=event_dispatch.spike_lists(S, B, k, Kw - 1, rate), **kw)

    def b5(S, B, K, N, *, rstdp=False, slotted=True, **kw):
        st = K * N if slotted else 0
        strides = (st, st, st if rstdp else 0)
        return stdp_update.stdp_launch(_stream.stdp_plan(S, B, K, N, rstdp=rstdp,
                                                         strides=strides),
                                       slotted_w=slotted, **kw)

    def b6(B, K, N, s_bytes=4, w_bytes=4):
        return spike_matmul.matmul_launch(_stream.spike_matmul_plan(
            B, K, N, s_bytes=s_bytes, w_bytes=w_bytes))

    full, slots, rows = 4096, 8, 8
    served = dict(slotted_w=True, slotted_rows=True)
    gated = dict(gate="shared", out=True)
    entries = [
        # the reference's representative launches
        ("lif_step", b1(1, 128, 512, 256, has_c=True)),
        ("tick_fused/frozen", b2(1, 128, 512, 512, has_c=False, n_read=4, ring="in_place")),
        ("tick_fused/learning", b2(1, 128, 512, 512, has_c=True, n_read=4, delays=True,
                                   ring="separate")),
        ("event_dispatch", b4(1, 8, 128, 256, 1025, 0.05)),
        ("event_dispatch_db", event_dispatch.event_db_launch(1, 8, 128, 256, 1024)),
        ("stdp_update", b5(1, 128, 128, 128, slotted=False)),
        ("spike_matmul", b6(8, 512, 256)),
        ("telemetry", telemetry.telemetry_launch(8, 256)),
        # snn-fused FULL: a served wave of 8 slots, premasked (frozen) and
        # with w and c streamed (learning); the pallas rollout and the event
        # tick's dense arm on shared weights
        ("tick_fused/snn-fused/premasked", b2(slots, 1, full, full, has_c=False, **served)),
        ("tick_fused/snn-fused/streamed", b2(slots, 1, full, full, has_c=True, **served)),
        ("tick_fused/snn-fused/rollout", b2(1, rows, full, full, has_c=False)),
        ("lif_step/snn-fused/streamed", b1(slots, 1, full, full, has_c=True, **served)),
        ("lif_step/snn-fused/rollout", b1(1, rows, full, full, has_c=True)),
        ("lif_step/snn-event/dense-arm", b1(1, 16, full, full, has_c=False, **gated)),
        # snn-event FULL: 16 rows, a spike budget of 409 at a 5 % rate
        ("event_dispatch/snn-event", b4(1, 16, 409, full, full + 1, 0.05, **gated)),
        ("event_dispatch_db/snn-event",
         event_dispatch.event_db_launch(1, 16, 409, full, full + 1, **gated)),
        # B5: the served learning wave (one slot learns), fully plastic STDP
        # and R-STDP, the learning rollout on a shared mask
        ("stdp_update/served", b5(slots, 1, full, full, slotted_c=True, gate="slot",
                                  dw_stats=True, open_slots=(False,) * 7 + (True,))),
        ("stdp_update/plastic", b5(slots, 1, full, full, slotted_c=True)),
        ("stdp_update/rstdp", b5(slots, 1, full, full, rstdp=True, slotted_c=True,
                                 slotted_reward=True)),
        ("stdp_update/rollout", b5(1, rows, full, full, slotted=False)),
        # B6: the wide product and predict_int's Iris and MNIST products
        ("spike_matmul/8x4096x4096", b6(rows, full, full)),
        ("spike_matmul/8x4096x4096/bf16", b6(rows, full, full, 2, 2)),
        ("spike_matmul/iris", b6(45, 4, 3)),
        ("spike_matmul/mnist", b6(80, 64, 10)),
        # the telemetry kernel: a served wave frozen, learning (B5's partials),
        # and the event tick's flags
        ("telemetry/snn-fused", telemetry.telemetry_launch(slots, full)),
        ("telemetry/snn-fused/learning", telemetry.telemetry_launch(
            slots, full, dw=slots, parts=_stream.stdp_plan(slots, 1, full, full,
                                                           rstdp=False).blocks)),
        ("telemetry/snn-event", telemetry.telemetry_launch(16, full, over=1, dense=1)),
    ]
    # the learning workload (mnist-stdp): 128 neurons in stage 1, 74 in stage 2
    for n in (128, 74):
        entries += [
            (f"lif_step/mnist-stdp-{n}", b1(1, 1, n, n, has_c=True)),
            (f"lif_step/mnist-stdp-{n}/batch", b1(1, 32, n, n, has_c=False)),
            (f"tick_fused/mnist-stdp-{n}", b2(1, 1, n, n, has_c=True)),
            (f"stdp_update/mnist-stdp-{n}", b5(1, 1, n, n, slotted=False)),
        ]
    # the sharded fabric: each rank's launch at N = n/D
    for n, B, learns in SHARD_WIDTHS:
        k = max(8, n // 8)
        entries += [
            (f"lif_step/shard-{n}", tuple(b1(1, B, n, n // D, has_c=learns)
                                          for D in SHARD_DEVICES)),
            (f"tick_fused/shard-{n}", tuple(b2(1, B, n, n // D, has_c=learns)
                                            for D in SHARD_DEVICES)),
            (f"stdp_update/shard-{n}", tuple(b5(1, B, n, n // D, slotted=False)
                                             for D in SHARD_DEVICES)),
            (f"event_dispatch/shard-{n}", tuple(b4(1, B, k, n // D, n + 1, 1 / 32)
                                                for D in SHARD_DEVICES)),
        ]
    return tuple(entries)


def _kernel_program(name: str, launch) -> Program:
    launches = launch if isinstance(launch, tuple) else (launch,)
    k_split = ""
    if name.startswith("lif_step/shard-"):
        # Sharded learning is bitwise the single-device run on the card only
        # while every rank splits K as one device does: an error at the
        # width that learns (4096), a warning at the frozen 64k fabric,
        # whose u8-grid sums are exact in any order.
        n = int(name.rsplit("-", 1)[1])
        k_split = "error" if dict((w, l) for w, _, l in SHARD_WIDTHS)[n] else "warning"
    return Program(name=f"kernel/{name}", launches=launches, k_split=k_split)


# ---------------------------------------------------------------------------
# The static surface
# ---------------------------------------------------------------------------

def planner_registry():
    """``(planner or descriptor function, args, kwargs)`` for every planner a kernel
    wrapper calls and every launch descriptor function, at a main-path shape."""
    from repro_torch.kernels import (_event_plan, _plan, _stream, event_dispatch, lif_step,
                                     spike_matmul, stdp_update, telemetry, tick_fused)

    p = _plan.plan(8, 1, 4096, 4096, has_c=True)
    ep = _event_plan.event_plan(1, 16, 409, 4096, 4097)
    sp = _stream.stdp_plan(8, 1, 4096, 4096, rstdp=False, strides=(4096 * 4096,) * 2 + (0,))
    mp = _stream.spike_matmul_plan(8, 4096, 4096)
    return (
        (_plan.plan, (8, 1, 4096, 4096), dict(has_c=True)),
        (_event_plan.event_plan, (1, 16, 409, 4096, 4097), dict(w_slot=0)),
        (_stream.stdp_plan, (8, 1, 4096, 4096),
         dict(rstdp=False, strides=(4096 * 4096,) * 2 + (0,))),
        (_stream.spike_matmul_plan, (8, 4096, 4096), dict(s_bytes=4, w_bytes=4)),
        (lif_step.lif_launch, (p,), dict(slotted_w=True)),
        (tick_fused.tick_launch, (p,), dict(slotted_w=True)),
        (event_dispatch.event_launch, (ep,), dict(gate="shared", out=True)),
        (event_dispatch.event_db_launch, (1, 16, 409, 4096, 4097), dict(gate="shared")),
        (stdp_update.stdp_launch, (sp,), dict(slotted_c=True, dw_stats=True)),
        (spike_matmul.matmul_launch, (mp,), {}),
        (telemetry.telemetry_launch, (8, 4096), dict(dw=8, parts=sp.blocks)),
    )


def demo_dispatch_plan(device="cpu"):
    """A representative admission-time dispatch plan (sparse topology at the
    serve cap) for the DispatchPlan static rules."""
    from repro_torch.core import connectivity, dispatch_policy

    c = np.asarray(connectivity.sparse_random(_N, 0.08, seed=5)) > 0
    return dispatch_policy.plan(c, w_in=np.eye(_N, dtype=np.float32), cap=8, vmap_safe=True,
                                prefer_density=0.2, device=device)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

BACKENDS = ("jnp", "pallas", "pallas_fused", "event")
SERVE = ("serve/wave/jnp", "serve/wave/event", "serve/chunk/jnp", "serve/refill/jnp")


def program_names() -> Tuple[str, ...]:
    names = [f"tick/{b}/{t}/{tel}" for b in BACKENDS for t in ("frozen", "learning")
             for tel in ("notelem", "telem")]
    names += ["tick/sharded/frozen/notelem", "tick/sharded/learning/telem"]
    names += list(SERVE)
    names += [f"kernel/{reg}" for reg, _ in kernel_launches()]
    return tuple(names)


def build_program(name: str, device="cpu") -> Program:
    """Build one program by name; nothing runs until a rule asks for the
    recording."""
    parts = name.split("/")
    if parts[0] == "tick" and len(parts) == 4:
        _, backend, tag, tel = parts
        if backend == "sharded":
            return _tick_sharded_program(tag == "learning", tel == "telem", device)
        if backend in BACKENDS:
            return _tick_program(backend, tag == "learning", tel == "telem", device)
    if name == "serve/wave/jnp":
        return _serve_wave_program(False, device)
    if name == "serve/wave/event":
        return _serve_wave_program(True, device)
    if name == "serve/chunk/jnp":
        return _serve_chunk_program(device)
    if name == "serve/refill/jnp":
        return _serve_refill_program(device)
    if parts[0] == "kernel":
        reg = "/".join(parts[1:])
        for key, launch in kernel_launches():
            if key == reg:
                return _kernel_program(key, launch)
    raise KeyError(f"unknown program {name!r}")
