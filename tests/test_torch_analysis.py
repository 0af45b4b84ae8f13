"""repro_torch.analysis: the port's static-analysis gate, held to its teeth and
to the reference's ``repro.analysis``.

Every rule class must FIRE on a deliberately broken fixture and PASS the
shipped programs and kernel descriptors (a gate that cannot fail is not a
gate; one that cries wolf gets disabled). Parity with the reference: the
findings' text and JSON, the program names, the ``(n, n)`` multiply counts
of every tick program per tick, and the dispatch-plan findings. Everything
runs on the CPU in seconds; the one card test skips here.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.analysis import findings as ref_findings
from repro.analysis import jaxpr_rules as ref_jaxpr
from repro.analysis import programs as ref_programs
from repro.analysis import static_rules as ref_static
from repro_torch.analysis import (check, findings, launch_rules, op_rules, programs,
                                  sharding_rules, static_rules)
from repro_torch.kernels import (_event_plan, _plan, _stream, event_dispatch, launch_spec,
                                 lif_step, spike_matmul, stdp_update, telemetry, tick_fused)
from repro_torch.kernels.launch_spec import IN, OUT, Alias, KernelLaunch, Operand

F32 = torch.float32
CPU = torch.device("cpu")


def _rules(found):
    return {f.rule for f in found}


def _errors(found):
    return [f for f in found if f.severity == findings.ERROR]


# ---------------------------------------------------------------------------
# Rule class 1: hot-loop purity (the op recorder)
# ---------------------------------------------------------------------------

def _record_jnp_learning(monkeypatch, leak):
    """A learning jnp rollout whose tick body runs ``leak(params)`` (inside
    the loop: the tick body forms W*C every tick)."""
    from repro_torch.core import engine as engine_mod

    real = engine_mod.masked_weights

    def leaky(p):
        leak(p)
        return real(p)

    monkeypatch.setattr(engine_mod, "masked_weights", leaky)
    prog = programs.build_program("tick/jnp/learning/notelem", CPU)
    return op_rules.record(prog.run)


SYNCS = {
    "item": lambda p: p.w.sum().item(),
    "bool": lambda p: bool(p.w.sum() > 0),
    "nonzero": lambda p: torch.nonzero(p.c),
    "boolean index": lambda p: p.w[p.c > 0],
    "masked_select": lambda p: torch.masked_select(p.w, p.c > 0),
    "unique": lambda p: torch.unique(p.c),
    "repeat_interleave": lambda p: torch.repeat_interleave(p.c[0].long()),
}


class TestPurityTeeth:
    @pytest.mark.parametrize("kind", sorted(SYNCS))
    def test_host_sync_inside_the_tick_loop_fires(self, monkeypatch, kind):
        recs = _record_jnp_learning(monkeypatch, SYNCS[kind])
        found = op_rules.check_hot_loop_purity(recs, "fixture")
        assert "purity.sync_in_loop" in _rules(found), kind
        assert all(f.severity == findings.ERROR for f in found
                   if f.rule == "purity.sync_in_loop")

    def test_repeat_interleave_with_output_size_passes(self, monkeypatch):
        recs = _record_jnp_learning(
            monkeypatch, lambda p: torch.repeat_interleave(
                torch.ones(3, dtype=torch.long), output_size=3))
        assert op_rules.check_hot_loop_purity(recs, "fixture") == []

    def test_strict_overflow_read_after_the_loop_is_a_warning(self):
        """``event_overflow="strict"`` reads its device flag once, after the
        last tick (``core/engine.py``): outside the loop, a WARNING."""
        from repro_torch.core.engine import EngineOptions, TickEngine

        engine = TickEngine(EngineOptions(backend="event", event_overflow="strict",
                                          event_k_active=24))
        prog = programs.build_program("tick/event/frozen/notelem", CPU)
        prog.run = programs._rollout(engine, False, CPU)
        found = op_rules.check_hot_loop_purity(op_rules.record(prog.run), "fixture")
        assert _rules(found) == {"purity.sync"}
        assert all(f.severity == findings.WARNING for f in found)

    def test_custom_op_fires_host_custom_call(self):
        lib = torch.library.Library("repro_analysis_fixture", "FRAGMENT")
        lib.define("host_callback(Tensor x) -> Tensor")
        lib.impl("host_callback", lambda x: x.clone(), "CompositeExplicitAutograd")
        found = op_rules.check_hot_loop_purity(op_rules.record(
            lambda: torch.ops.repro_analysis_fixture.host_callback(torch.ones(3))), "fixture")
        assert "purity.host_custom_call" in _rules(found)

    def test_clean_tick_program_passes(self):
        prog = programs.build_program("tick/jnp/frozen/notelem", CPU)
        assert op_rules.check_hot_loop_purity(op_rules.record(prog.run), "fixture") == []

    def test_records_carry_loop_and_scope(self):
        prog = programs.build_program("tick/jnp/frozen/telem", CPU)
        recs = op_rules.record(prog.run)
        body = "repro_torch.core.engine.tick_body"
        loop = [r for r in recs if r.in_loop]
        assert loop and len(loop) < len(recs)
        assert all(body in r.scope for r in loop)
        assert not any(body in r.scope for r in recs if not r.in_loop)
        assert {r.inside for r in recs} == {None, "telemetry"}


# ---------------------------------------------------------------------------
# Rule class 2: dtype discipline
# ---------------------------------------------------------------------------

def decode_u8(b):
    """A register-decode boundary: where u8 widens by design."""
    return b.to(F32)


class TestDtypeTeeth:
    def test_float64_fires(self):
        found = op_rules.check_dtype_discipline(
            op_rules.record(lambda: torch.zeros(3, dtype=torch.float64) + 1), "fixture")
        assert "dtype.x64" in _rules(found)

    def test_float64_hidden_behind_a_narrower_result_fires(self):
        """A 0-d float64 operand does not promote an f32 tensor: the result
        hides it, as a lowering can introduce f64 a program never names."""
        x = torch.ones(3)
        found = op_rules.check_dtype_discipline(
            op_rules.record(lambda: x * torch.tensor(2.0, dtype=torch.float64)), "fixture")
        assert "dtype.x64_lowered" in _rules(found)

    def test_int64_is_allowed(self):
        assert op_rules.ALLOWED_64BIT == ("int64",)
        found = op_rules.check_dtype_discipline(op_rules.record(
            lambda: torch.topk(torch.arange(8.0), 3).indices + torch.arange(3)), "fixture")
        assert found == []

    def test_u8_upcast_outside_a_sanctioned_scope_fires(self):
        b = torch.zeros(4, dtype=torch.uint8)
        found = op_rules.check_dtype_discipline(op_rules.record(lambda: b.to(F32) * 2),
                                                "fixture")
        assert "dtype.u8_upcast" in _rules(found)

    def test_u8_upcast_under_the_decode_scope_passes(self):
        b = torch.zeros(4, dtype=torch.uint8)
        assert op_rules.check_dtype_discipline(
            op_rules.record(lambda: decode_u8(b) * 2), "fixture") == []

    def test_register_download_passes(self):
        from repro_torch.core.network import params_from_registers
        from repro_torch.core.registers import RegisterBank

        bank = RegisterBank(8)
        found = op_rules.check_dtype_discipline(
            op_rules.record(lambda: params_from_registers(bank, device="cpu")), "fixture")
        assert _errors(found) == []


# ---------------------------------------------------------------------------
# Rule class 3: hoist contract (both directions)
# ---------------------------------------------------------------------------

_N = 6


def _tick(carry, w, c, wc=None):
    return carry @ (w * c if wc is None else wc)


def _unhoisted(w, c, x):
    for _ in range(3):
        x = _tick(x, w, c)          # (n, n) product per tick: the bug
    return x


def _hoisted(w, c, x):
    wc = w * c                       # once per rollout
    for _ in range(3):
        x = _tick(x, w, c, wc)
    return x


class TestHoistTeeth:
    def _record(self, fn):
        rng = np.random.default_rng(0)
        w, c = (torch.as_tensor(rng.random((_N, _N)), dtype=F32) for _ in range(2))
        return op_rules.record(lambda: fn(w, c, torch.zeros(_N)),
                               loop_codes=(_tick.__code__,))

    def test_frozen_expectation_catches_in_loop_recompute(self):
        rules = _rules(op_rules.check_hoist(self._record(_unhoisted), "fixture", n=_N,
                                            expect=op_rules.HOIST_HOISTED))
        assert "hoist.wc_in_loop" in rules
        assert "hoist.wc_missing" in rules

    def test_learning_expectation_catches_stale_hoist(self):
        assert "hoist.wc_not_in_loop" in _rules(op_rules.check_hoist(
            self._record(_hoisted), "fixture", n=_N, expect=op_rules.HOIST_IN_LOOP))

    def test_kernel_expectation_catches_a_leak(self):
        assert "hoist.wc_in_loop" in _rules(op_rules.check_hoist(
            self._record(_unhoisted), "fixture", n=_N, expect=op_rules.HOIST_KERNEL))

    def test_matching_expectations_pass(self):
        assert op_rules.check_hoist(self._record(_hoisted), "fixture", n=_N,
                                    expect=op_rules.HOIST_HOISTED) == []
        assert op_rules.check_hoist(self._record(_unhoisted), "fixture", n=_N,
                                    expect=op_rules.HOIST_IN_LOOP) == []


# ---------------------------------------------------------------------------
# Rule class 4: new-plan hazards (statics and planners)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _MutableStatic:
    knobs: object


class _UnstableHash:
    def __eq__(self, other):
        return isinstance(other, _UnstableHash)

    def __hash__(self):
        return id(self)


@dataclasses.dataclass(frozen=True)
class _HashablePlanFixture:
    """A DispatchPlan look-alike that (wrongly) hashes."""
    strategy: str = "fan_in"

    def engine_kwargs(self):
        return {"backend": "event", "event_dispatch": self.strategy}


class _LeakyCache:
    """Claims a cache but misses on every call."""
    misses = 0

    def __call__(self, n):
        self.misses += 1
        return (n,)

    def cache_info(self):
        return type("Info", (), {"misses": self.misses})()


class TestStaticTeeth:
    def test_unhashable_static_fires(self):
        assert "static.unhashable" in _rules(static_rules.check_hashable_static(
            {"k": 1}, "fixture", name="opts"))

    def test_mutable_field_in_frozen_static_fires(self):
        class _Knobs:
            pass

        assert "static.mutable_field" in _rules(static_rules.check_hashable_static(
            _MutableStatic(knobs=_Knobs()), "fixture", name="opts"))

    def test_plainly_unhashable_static_fires(self):
        assert "static.unhashable" in _rules(static_rules.check_hashable_static(
            _MutableStatic(knobs=[1, 2]), "fixture", name="opts"))

    def test_unstable_hash_across_instances_fires(self):
        assert "static.unstable_hash" in _rules(static_rules.check_hash_stability(
            _UnstableHash, "fixture", name="opts"))

    def test_uncached_planner_fires(self):
        assert "static.uncached_planner" in _rules(static_rules.check_planner(
            lambda n: (n,), (4,), {}, "fixture"))

    def test_planner_with_a_mutable_argument_fires(self):
        assert "static.mutable_field" in _rules(static_rules.check_planner(
            _plan.plan, ([1], 1, 8, 8), dict(has_c=True), "fixture"))

    def test_planner_that_misses_its_cache_fires(self):
        assert "static.new_plan" in _rules(static_rules.check_planner(
            _LeakyCache(), (4,), {}, "fixture"))

    def test_hashable_dispatch_plan_fires(self):
        assert "static.plan_hashable" in _rules(static_rules.check_dispatch_plan(
            _HashablePlanFixture(), "fixture"))

    def test_engine_options_pass(self):
        from repro_torch.core.engine import EngineOptions

        make = lambda: EngineOptions(backend="event", event_k_active=4)
        assert static_rules.check_hashable_static(make(), "fixture") == []
        assert static_rules.check_hash_stability(make, "fixture") == []

    def test_shipped_planners_and_descriptor_functions_pass(self):
        report = findings.Report()
        check.check_static_surface(report)
        assert report.ok(), report.table()
        assert len(programs.planner_registry()) >= 11

    def test_real_dispatch_plan_passes(self):
        plan = programs.demo_dispatch_plan()
        with pytest.raises(TypeError):
            hash(plan)
        assert static_rules.check_dispatch_plan(plan, "fixture") == []


# ---------------------------------------------------------------------------
# Rule class 5: the CUDA launch lint
# ---------------------------------------------------------------------------

def _tiny(**over):
    """Two blocks, each writing its own 128 columns of a (4, 256) output."""
    cols = lambda block, rank, ex: [((0, 4), (block[0] * 128, block[0] * 128 + 128))]
    base = dict(name="fixture", symbol="fixture_kernel", grid=(2, 1, 1), block=(128, 1, 1),
                operands=(Operand("x", (4, 256), "float32", IN, cols),
                          Operand("y", (4, 256), "float32", OUT, cols)))
    base.update(over)
    return KernelLaunch(**base)


def _ops(*seq):
    return [(kind, stage, tile, tile) for kind, stage, tile in seq]


class TestLaunchTeeth:
    def test_tiny_launch_passes(self):
        assert launch_rules.check_launch(_tiny(), "fixture") == []

    def test_out_of_bounds_column_tile_fires(self):
        over = lambda block, rank, ex: [((0, 4), (block[0] * 128 + 64, block[0] * 128 + 192))]
        bad = _tiny(operands=(Operand("x", (4, 256), "float32", IN, over),))
        assert "launch.oob" in _rules(launch_rules.check_oob(bad, "fixture"))
        checked = _tiny(operands=(Operand("x", (4, 256), "float32", IN, over, (1,)),))
        assert launch_rules.check_oob(checked, "fixture") == []

    def test_output_written_twice_or_never_fires(self):
        twice = lambda block, rank, ex: [((0, 4), (0, 128))]
        assert "launch.cover" in _rules(launch_rules.check_cover(
            _tiny(operands=(Operand("y", (4, 256), "float32", OUT, twice),)), "fixture"))

    def test_k_row_summed_twice_fires(self):
        p = _plan.plan(1, 8, 1000, 256, has_c=True)
        good = lif_step.lif_launch(p)
        bad = dataclasses.replace(good, sums=lambda block, rank, ex: [
            (box, (0, k1)) for box, (k0, k1) in good.sums(block, rank, ex)])
        assert launch_rules.check_cover(good, "fixture") == []
        assert "launch.cover" in _rules(launch_rules.check_cover(bad, "fixture"))

    def test_dynamic_smem_over_the_opt_in_limit_fires(self):
        found = launch_rules.check_smem(_tiny(smem_dynamic=232_449), "fixture")
        assert any(f.rule == "launch.smem" and f.severity == findings.ERROR for f in found)

    def test_smem_near_the_budget_is_a_warning(self):
        found = launch_rules.check_smem(_tiny(smem_dynamic=200_000), "fixture")
        assert [f.severity for f in found] == [findings.WARNING]

    @pytest.mark.parametrize("grid,cluster,block", [
        ((32, 1, 1), (16, 1, 1), (128, 1, 1)),    # past the portable 8
        ((30, 1, 1), (4, 1, 1), (128, 1, 1)),     # does not divide grid.x
        ((2, 70_000, 1), (1, 1, 1), (128, 1, 1)),  # grid.y past 65,535
        ((2, 1, 1), (1, 1, 1), (2048, 1, 1)),      # past 1024 threads
    ])
    def test_bad_launch_shape_fires(self, grid, cluster, block):
        assert "launch.shape" in _rules(launch_rules.check_shape(
            _tiny(grid=grid, cluster=cluster, block=block), "fixture"))

    def test_alias_with_mismatched_dtype_fires(self):
        cols = _tiny().operands[0].footprint
        bad = _tiny(operands=(Operand("x", (4, 256), "int32", IN, cols),
                              Operand("y", (4, 256), "float32", OUT, cols)),
                    aliases=(Alias("x", "y"),))
        assert "launch.alias" in _rules(launch_rules.check_aliasing(bad, "fixture"))

    def test_ring_read_and_written_on_one_plane_fires(self):
        p = _plan.plan(1, 8, 256, 256, has_c=False)
        good = tick_fused.tick_launch(p, n_read=4, ring="in_place", n_ring=4)
        bad = tick_fused.tick_launch(p, n_read=4, ring="in_place", n_ring=4,
                                     examples=((2, 2),))
        assert good.examples == ((0, 1), (1, 2), (2, 3), (3, 0))
        assert launch_rules.check_aliasing(good, "fixture") == []
        assert "launch.alias" in _rules(launch_rules.check_aliasing(bad, "fixture"))

    @pytest.mark.parametrize("ops,rule", [
        (_ops(("issue", 0, 0), ("consume", 0, 0)), "launch.stage.consume_before_wait"),
        (_ops(("wait", 0, 0)), "launch.stage.wait_without_issue"),
        (_ops(("issue", 0, 0), ("issue", 0, 1)), "launch.stage.issue_unreleased"),
        (_ops(("issue", 0, 0), ("wait", 0, 0), ("consume", 0, 0), ("issue", 0, 1)),
         "launch.stage.issue_unreleased"),
        (_ops(("issue", 0, 0)), "launch.stage.dangling"),
        (_ops(("issue", 0, 0), ("wait", 0, 0), ("consume", 0, 0), ("consume", 0, 0),
              ("release", 0, 0)), "launch.stage.tile_count"),
    ])
    def test_stage_schedule_violations_fire(self, ops, rule):
        assert rule in {r for r, _ in launch_rules.simulate_stage_schedule(ops, tiles=1)}

    def test_dropped_tile_fires(self):
        ops = [op for op in launch_spec.ring_schedule(4, 2) if op[2] != 2 or op[0] == "issue"]
        launch = _tiny(stage_schedule=lambda block, rank, ex: (ops, 4))
        assert "launch.stage.tile_count" in _rules(
            launch_rules.check_stage_schedule(launch, "fixture"))

    def test_shipped_rings_pass(self):
        for n, stages in ((0, 2), (1, 2), (7, 2), (9, 3)):
            assert launch_rules.simulate_stage_schedule(
                launch_spec.ring_schedule(n, stages), n) == []
            assert launch_rules.simulate_stage_schedule(
                stdp_update.stdp_schedule(n, stages), n) == []

    def test_silent_list_that_issues_copies_fires(self):
        loud = lambda: [("issue", 0, 0, (5, 9)), ("wait", 0, 0, None),
                        ("consume", 0, 0, None), ("release", 0, 0, None)]
        launch = _tiny(stage_schedule=lambda block, rank, ex: ((), 0), quiet_schedule=loud,
                       quiet_allows=frozenset({9}))
        assert "launch.stage.quiet_row" in _rules(
            launch_rules.check_stage_schedule(launch, "fixture"))

    def test_b4_silent_list_stages_the_sentinel_row_only(self):
        """At ``counts == 0`` every slot names the sentinel row: B4 stages that
        one row and nothing else (the kernel's union holds it); an empty K
        range issues nothing on B1/B2/B5/B6."""
        p = _event_plan.event_plan(1, 16, 409, 4096, 4097)
        b4 = event_dispatch.event_launch(p)
        issues = [op for op in b4.quiet_schedule() if op[0] == "issue"]
        assert [op[3] for op in issues] == [(4096,)]
        assert launch_rules.check_stage_schedule(b4, "fixture") == []
        b1 = lif_step.lif_launch(_plan.plan(1, 8, 256, 256, has_c=True))
        b5 = stdp_update.stdp_launch(_stream.stdp_plan(2, 1, 256, 256, rstdp=False))
        b6 = spike_matmul.matmul_launch(_stream.spike_matmul_plan(8, 4096, 4096))
        for launch in (b1, b5, b6):
            assert launch.quiet_schedule() == ()

    def test_k_split_that_changes_with_n_fires(self):
        a = lif_step.lif_launch(_plan.plan(1, 1, 65536, 65536, has_c=False))
        b = lif_step.lif_launch(_plan.plan(1, 1, 65536, 8192, has_c=False))
        assert a.plan.ks != b.plan.ks
        assert "launch.k_split" in _rules(launch_rules.check_k_split((a, b), "fixture"))
        same = [lif_step.lif_launch(_plan.plan(1, 8, 4096, 4096 // D, has_c=True))
                for D in (1, 2, 4, 8)]
        assert launch_rules.check_k_split(same, "fixture") == []


# ---------------------------------------------------------------------------
# The descriptors restate the C side's launches
# ---------------------------------------------------------------------------

class TestDescriptors:
    @pytest.mark.parametrize("S,B,K,N,has_c", [(8, 1, 4096, 4096, False),
                                                (1, 8, 4096, 2048, True), (1, 1, 74, 74, True)])
    def test_b1_b2_take_the_plan(self, S, B, K, N, has_c):
        p = _plan.plan(S, B, K, N, has_c=has_c)
        for d in (lif_step.lif_launch(p), tick_fused.tick_launch(p)):
            assert d.grid == (math.ceil(N / 128) * p.ks, math.ceil(B / p.bb), S) == p.grid
            assert d.block == (128, 1, 1) and d.cluster == (p.ks, 1, 1)
            assert d.smem_dynamic == p.smem and d.plan_args == p.args()

    def test_b3_b4(self):
        p = _event_plan.event_plan(1, 16, 409, 4096, 4097)
        b4 = event_dispatch.event_launch(p)
        assert b4.grid == (4096 // 32, math.ceil(16 / p.rows), 1)
        assert b4.block == (p.rows * 32, 1, 1) and b4.smem_dynamic == p.smem
        assert b4.plan_args == p.args()
        b3 = event_dispatch.event_db_launch(1, 16, 409, 4096, 4096)
        assert b3.grid == (32, 16, 1) and b3.block == (128, 1, 1)
        assert b3.smem_dynamic == 0 and b3.smem_static == 2048 and b3.plan_args == (0,) * 6

    def test_b5_b6_telemetry(self):
        sp = _stream.stdp_plan(8, 1, 4096, 4096, rstdp=False)
        b5 = stdp_update.stdp_launch(sp)
        assert b5.grid == (sp.blocks, 1, 1) and b5.block == (256, 1, 1)
        assert b5.smem_dynamic == sp.smem and b5.plan_args == sp.args()
        assert b5.symbol == "stdp_update_kernel"
        el = stdp_update.stdp_launch(_stream.stdp_plan(1, 1, 74, 74, rstdp=False))
        assert el.symbol == "stdp_update_element_kernel" and el.smem_dynamic == 0
        mp = _stream.spike_matmul_plan(8, 4096, 4096)
        b6 = spike_matmul.matmul_launch(mp)
        assert b6.grid == (mp.blocks, 1, 1) and b6.smem_dynamic == mp.smem
        small = spike_matmul.matmul_launch(_stream.spike_matmul_plan(45, 4, 3))
        assert small.symbol == "spike_matmul_small_kernel" and small.smem_dynamic == 0
        tel = telemetry.telemetry_launch(8, 4096)
        assert tel.grid == (8, 1, 1) and tel.block == (1024, 1, 1) and tel.smem_dynamic == 0

    def test_descriptor_functions_are_cached(self):
        p = _plan.plan(8, 1, 4096, 4096, has_c=True)
        assert lif_step.lif_launch(p) is lif_step.lif_launch(p)


# ---------------------------------------------------------------------------
# Rule class 6: sharding
# ---------------------------------------------------------------------------

def _gather_tick(mesh, w, s):
    return mesh.all_gather(s) @ w


def _w_gather_tick(mesh, w, s):
    return s @ mesh.all_gather(w)


class TestShardingTeeth:
    N = 8

    def _mesh(self):
        from repro_torch.parallel.mesh import SNNMesh

        return SNNMesh(rank=0, size=1, device=CPU)

    def _record(self, tick, hoist=False):
        mesh, n = self._mesh(), self.N
        w, s = torch.zeros(n, n), torch.zeros(n)

        def run():
            w_full = mesh.all_gather(w) if hoist else w
            for _ in range(3):
                tick(mesh, w_full, s)
        return op_rules.record(run, loop_codes=(tick.__code__,))

    def test_w_gather_in_loop_fires(self):
        recs = self._record(_w_gather_tick)
        assert "sharding.w_gather_in_loop" in _rules(
            sharding_rules.check_no_w_gather_in_loop(recs, "fixture", n=self.N))

    def test_spike_gather_in_loop_passes(self):
        recs = self._record(_gather_tick)
        assert sharding_rules.check_no_w_gather_in_loop(recs, "fixture", n=self.N) == []
        assert sharding_rules.check_one_collective_per_tick(recs, "fixture", ticks=3) == []

    def test_hoisted_w_gather_outside_loop_passes(self):
        recs = self._record(_gather_tick, hoist=True)
        assert sharding_rules.check_no_w_gather_in_loop(recs, "fixture", n=self.N) == []

    def test_a_tick_without_its_exchange_fires(self):
        from repro_torch.core.engine import TickEngine

        prog = programs.build_program("tick/sharded/frozen/notelem", CPU)
        plain = TickEngine(programs.tick_options("jnp", False, False))
        recs = op_rules.record(programs._rollout(plain, False, CPU))
        assert "sharding.collectives_per_tick" in _rules(
            sharding_rules.check_one_collective_per_tick(recs, "fixture", ticks=prog.ticks))
        assert sharding_rules.check_one_collective_per_tick(
            op_rules.record(prog.run), "fixture", ticks=prog.ticks) == []

    def test_c10d_collective_is_recorded(self):
        """A gloo world of one in the process: the all-gather dispatches a
        c10d op, recorded as a collective."""
        import torch.distributed as dist

        started = not dist.is_initialized()
        if started:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        try:
            x, out = torch.ones(4), torch.empty(4)
            gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
            recs = op_rules.record(lambda: gather(out, x))
        finally:
            if started:
                dist.destroy_process_group()
        coll = [r for r in recs if r.collective]
        assert coll and all(r.name.startswith("c10d.") for r in coll)

    def test_mesh_carrying_options_pass_static_rules(self):
        from repro_torch.core.engine import EngineOptions

        make = lambda: EngineOptions(mesh=self._mesh())
        assert static_rules.check_hashable_static(make(), "fixture") == []
        assert static_rules.check_hash_stability(make, "fixture") == []


# ---------------------------------------------------------------------------
# The kernel wrappers stay opaque to the recorder on the CPU
# ---------------------------------------------------------------------------

def test_cpu_twin_of_a_kernel_wrapper_stays_opaque():
    n = 24
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, dtype=F32)
    s, w, c = t(rng.random((2, n)) < 0.5), t(rng.random((n, n))), t(rng.random((n, n)) < 0.3)
    v, r = torch.zeros(2, n), torch.zeros(2, n, dtype=torch.int32)
    rows = [torch.ones(n), torch.full((n,), 0.25), torch.ones(n, dtype=torch.int32),
            torch.ones(n), torch.zeros(n), torch.zeros(n)]
    recs = op_rules.record(lambda: lif_step.fused_lif_step(s, w, c, v, r, None, *rows))
    assert recs and {r.inside for r in recs} == {"lif_step"}
    assert op_rules.square_muls(recs, n) == (0, 0)
    from repro_torch.kernels import _build

    assert _build.twin_running() is None


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

def _sample_findings(mod):
    return [mod.Finding(rule="pallas.oob", severity=mod.ERROR, program="tick/jnp/frozen/telem",
                        message="index map selects block (2, 0)", location="lif_step:s"),
            mod.Finding(rule="purity.io_callback", severity=mod.WARNING, program="serve/wave/jnp",
                        message="io_callback outside the loop"),
            mod.Finding(rule="hoist.note", severity=mod.INFO, program="kernel/lif_step",
                        message="info")]


def test_findings_text_and_json_equal_the_reference():
    from repro.obs.log import get_event_log as ref_log
    from repro_torch.obs.log import get_event_log as port_log

    reports = []
    for mod in (ref_findings, findings):
        rep = mod.Report()
        for f in _sample_findings(mod):
            rep.mark_checked(f.program)
            rep.add(f)
        reports.append(rep)
    ref, port = reports
    for include_info in (False, True):
        assert ref.table(include_info=include_info) == port.table(include_info=include_info)
    assert ref.summary() == port.summary() and ref.exit_code() == port.exit_code() == 1
    for log in (ref_log(), port_log()):
        log.clear()
    ref.emit_json()
    port.emit_json()
    strip = lambda events: [{k: v for k, v in e.items() if k != "ts"} for e in events]
    assert strip(ref_log().events()) == strip(port_log().events())
    with pytest.raises(ValueError):
        findings.Finding(rule="x", severity="fatal", program="p", message="m")


def test_program_names_equal_the_reference():
    ref = [n for n in ref_programs.program_names() if not n.startswith("kernel/")]
    port = [n for n in programs.program_names() if not n.startswith("kernel/")]
    assert port == ref and len(port) == 22


# (port per tick in the loop, hoisted), (the reference's) where they differ
# on purpose: the port's event backend runs its plasticity pass on kernel B5
# (opaque), the reference's on its jnp pass, whose dw * c is a second
# in-loop (n, n) multiply.
PINNED = {
    "tick/event/learning/notelem": ((1, 0), (2, 0)),
    "tick/event/learning/telem": ((1, 0), (2, 0)),
}
# The reference's sharded learning program does not trace under the installed
# jax (shard_map rejects its scan carry: ROADMAP.md); the port's is held to
# the reference's single-device jnp learning program, which it runs per rank.
STAND_INS = {"tick/sharded/learning/telem": "tick/jnp/learning/telem"}
TICK_PROGRAMS = [n for n in programs.program_names() if n.startswith("tick/")]


@pytest.mark.parametrize("name", TICK_PROGRAMS)
def test_square_mul_counts_per_tick_equal_the_reference(name):
    prog = programs.build_program(name, CPU)
    in_loop, hoisted = op_rules.square_muls(op_rules.record(prog.run), prog.n)
    port = (in_loop / prog.ticks, hoisted)
    ref_name = name
    try:
        rp = ref_programs.build_program(ref_name)
        cj = ref_jaxpr.closed_jaxpr_of(rp.fn, *rp.args)
    except Exception:
        if name not in STAND_INS:
            raise
        ref_name = STAND_INS[name]
        rp = ref_programs.build_program(ref_name)
        cj = ref_jaxpr.closed_jaxpr_of(rp.fn, *rp.args)
    ref = ref_jaxpr._square_muls(cj, rp.n)
    assert prog.hoist == rp.hoist
    if name in PINNED:
        assert (port, ref) == PINNED[name]
    else:
        assert port == ref, (name, ref_name)


def test_dispatch_plan_findings_equal_the_reference():
    ref = ref_static.check_dispatch_plan(ref_programs.demo_dispatch_plan(), "p")
    port = static_rules.check_dispatch_plan(programs.demo_dispatch_plan(), "p")
    assert [(f.rule, f.location) for f in ref] == [(f.rule, f.location) for f in port] == []
    fixture = _HashablePlanFixture()
    assert ([f.rule for f in ref_static.check_dispatch_plan(fixture, "p")]
            == [f.rule for f in static_rules.check_dispatch_plan(fixture, "p")])


# ---------------------------------------------------------------------------
# The shipped registry passes clean; the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", programs.program_names())
def test_shipped_program_passes_clean(name):
    report = check.run([name], include_static=False, device="cpu")
    assert report.ok(), report.table()


def test_registry_covers_every_kernel_at_full_width():
    names = set(programs.program_names())
    for kernel in ("lif_step", "tick_fused/frozen", "tick_fused/learning", "event_dispatch",
                   "event_dispatch_db", "stdp_update", "spike_matmul", "telemetry"):
        assert f"kernel/{kernel}" in names
    for full in ("tick_fused/snn-fused/premasked", "tick_fused/snn-fused/streamed",
                 "event_dispatch/snn-event", "event_dispatch_db/snn-event",
                 "stdp_update/served", "stdp_update/plastic", "spike_matmul/8x4096x4096",
                 "spike_matmul/iris", "spike_matmul/mnist", "telemetry/snn-fused",
                 "lif_step/mnist-stdp-128", "lif_step/mnist-stdp-74",
                 "lif_step/shard-4096", "lif_step/shard-65536",
                 "stdp_update/shard-65536", "event_dispatch/shard-4096"):
        assert f"kernel/{full}" in names, full
    fam = dict(programs.kernel_launches())["lif_step/shard-4096"]
    assert [d.plan.N for d in fam] == [4096, 2048, 1024, 512]


def test_sharded_b1_keeps_its_k_split_where_it_learns():
    report = check.run(["kernel/lif_step/shard-4096", "kernel/lif_step/shard-65536"],
                       include_static=False, device="cpu")
    assert report.ok()
    assert [f.rule for f in report.warnings] == ["launch.k_split"]
    assert report.warnings[0].program == "kernel/lif_step/shard-65536"


def test_full_gate_exits_zero(capsys):
    assert check.main(["--all", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "analysis: PASS" in out
    assert f"{len(programs.program_names()) + 2} program(s)" in out


def test_cli_list_and_single_program(capsys):
    assert check.main(["--list"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert "tick/jnp/frozen/notelem" in listed and "static/plan-surface" in listed
    assert {n for n in ref_programs.program_names() if not n.startswith("kernel/")} <= set(listed)
    assert check.main(["--program", "kernel/lif_step", "--device", "cpu"]) == 0
    assert "PASS" in capsys.readouterr().out


def test_cli_rejects_unknown_program():
    with pytest.raises(SystemExit) as e:
        check.main(["--program", "no/such/program", "--device", "cpu"])
    assert e.value.code != 0


@pytest.mark.cuda
def test_cuda_gate_runs_clean_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tick programs run on the card")
    assert check.run(device="cuda").ok()
