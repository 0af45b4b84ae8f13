"""The port's cost model (``repro_torch.launch.hlo_cost``) against known counts.

Counterparts of ``tests/test_hlo_cost.py``: one product counts 2*D^3, a
loop counts its body times its trip count (and the recorder's shortcut, one
middle step counted ``n - 2`` times, equals running every step), nested
loops multiply, a loop equals its unrolled form, a gradient costs about
three forwards, dot bytes are the operands' and the output's, and a
collective in a loop of 16 on a fake world of 8 counts 16 times. Then the
shortcut on the loops it serves (jamba SMOKE's mamba and rwkv6 SMOKE's
WKV, at 2 and at 5 chunks, forward and backward; attention's query
chunks; the train step's microbatches) is exact, and the peak of the storages a step allocates is
the same traced on fake tensors as recorded over the real ones.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_bundle
from repro_torch.launch import hlo_cost
from repro_torch.models import model as TM
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models import ssm as t_ssm
from repro_torch.util import trips, tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 64


def _x(*shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(0))


def _flops(fn, *args, **kw):
    return hlo_cost.analyze(hlo_cost.record(fn, *args, **kw)[1]).flops


def _chain(x, ws, n):
    return trips.scan(lambda c, t: (c @ ws[t], None), x, n)[0]


class TestKnownCounts:
    def test_single_matmul(self):
        assert _flops(lambda a, b: a @ b, _x(D, D), _x(D, D)) == 2 * D ** 3

    @pytest.mark.parametrize("shortcut", [True, False], ids=["shortcut", "every-step"])
    def test_loop_multiplies_by_trip_count(self, shortcut):
        n = 8
        s = hlo_cost.analyze(hlo_cost.record(_chain, _x(D, D), _x(n, D, D), n,
                                             shortcut=shortcut)[1])
        assert s.flops == n * 2 * D ** 3
        assert s.dot_bytes == n * 3 * D * D * 4

    def test_shortcut_runs_three_steps(self):
        _, rec = hlo_cost.record(_chain, _x(D, D), _x(8, D, D), 8)
        assert [r.trips for r in rec.records] == [1, 6, 1]

    def test_nested_loop(self):
        ws = _x(4, 8, D, D)

        def nested(x):
            return trips.scan(lambda c, i: (_chain(c, ws[i], 8), None), x, 4)[0]

        assert _flops(nested, _x(D, D)) == 32 * 2 * D ** 3
        assert _flops(nested, _x(D, D), shortcut=False) == 32 * 2 * D ** 3

    def test_matches_unrolled(self):
        ws = _x(4, D, D)

        def unrolled(x):
            for i in range(4):
                x = x @ ws[i]
            return x

        assert _flops(unrolled, _x(D, D)) == _flops(_chain, _x(D, D), ws, 4)

    def test_grad_flops_about_3x(self):
        """Backward of y = sum(x @ w) costs about 2 extra products."""
        a, b = _x(D, D).requires_grad_(True), _x(D, D).requires_grad_(True)
        fwd = _flops(lambda p, q: (p @ q).sum(), a, b)
        grad = _flops(lambda p, q: torch.autograd.grad((p @ q).sum(), (p, q)), a, b)
        assert 1.9 <= grad / fwd <= 3.1

    def test_loop_backward_counts_its_trips(self):
        """The shortcut's backward counts as every step's: the middle step's
        autograd nodes carry its trip count."""
        ws = _x(8, D, D).requires_grad_(True)

        def loss(x, w):
            return torch.autograd.grad(_chain(x, w, 8).sum(), (x, w))

        x = _x(D, D).requires_grad_(True)
        assert _flops(loss, x, ws) == _flops(loss, x, ws, shortcut=False) == 3 * 8 * 2 * D ** 3

    def test_dot_bytes(self):
        s = hlo_cost.analyze(hlo_cost.record(lambda a, b: a @ b, _x(D, D), _x(D, D))[1])
        assert s.dot_bytes == 3 * D * D * 4

    def test_outside_a_recording_the_loop_is_plain(self):
        x, ws = _x(D, D), _x(8, D, D)
        want = x
        for i in range(8):
            want = want @ ws[i]
        assert torch.equal(_chain(x, ws, 8), want)
        assert not trips.recording()

    def test_a_recomputation_keeps_its_loop_to_its_thread(self):
        """A checkpointed loop recomputed in a backward on another thread (as
        autograd runs the backward of CUDA tensors) while this thread
        dispatches a product in no loop: that product counts once, and the
        shortcut counts what every step counts."""
        import threading

        mode = hlo_cost.FakeRecorder()
        with mode:
            x = torch.empty(D, D).requires_grad_(True)
            w = torch.empty(D, D)

        def run(shortcut):
            inside, done = threading.Event(), threading.Event()

            def body(c, t):
                if t == 1 and torch._C._current_autograd_node() is not None:
                    inside.set()          # the middle step, recomputed in the backward
                    done.wait(10)
                return c @ w, None

            def step(x, w):
                y = trips.checkpoint(lambda c: trips.scan(body, c, 8)[0], x,
                                     use_reentrant=False)
                other = threading.Thread(target=lambda: torch.autograd.grad(y.sum(), x))
                other.start()
                assert inside.wait(10)
                w @ w
                done.set()
                other.join()

            return _flops(step, x, w, fake_mode=mode, shortcut=shortcut)

        # forward 8, the recomputation up to 8, backward 8, and the one product
        assert run(True) == run(False) >= 17 * 2 * D ** 3


def test_a_recomputation_runs_under_the_forwards_rules():
    """A checkpointed body recomputed in a backward on another thread (as
    autograd recomputes CUDA graphs) sees the sharding rules the forward
    saw: the rules are per thread, and a recomputation without them lays a
    layer out otherwise on a mesh (the card's trace of smollm-135m train_4k
    then recomputed every head's scores where the forward kept one)."""
    import threading

    from repro_torch.parallel.sharding import BASE_RULES, AxisRules, current_rules, use_rules

    rules, seen = AxisRules(BASE_RULES), []

    def body(x):
        seen.append(current_rules())
        return (x * x).sin()

    x = torch.ones(3, requires_grad=True)
    with use_rules(rules):
        y = trips.checkpoint(body, x, use_reentrant=False)
    other = threading.Thread(target=lambda: torch.autograd.grad(y.sum(), x))
    other.start()
    other.join()
    assert seen == [rules, rules]


def test_cost_dict_normalises_its_inputs():
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        _x(D, D) @ _x(D, D)
    assert hlo_cost.cost_dict(counter) == {"flops": 2.0 * D ** 3}
    assert hlo_cost.cost_dict(None) == {}
    assert hlo_cost.cost_dict([{"flops": 1.0}]) == {"flops": 1.0}


def test_departures_name_every_site_over_its_share():
    """On a recording of four products on 4 ranks, two sites compute more
    than their even share: a ``bmm`` of the MoE FFN twice (x2, and x3 in a
    loop of 2) and a ``mm`` of the mamba block once (x2). ``sites`` keys
    them by op and innermost ``models/`` frame, the most FLOPs above the
    shares first; ``first`` stays the first product over its share, and a
    product at its share or a collective is in no site."""
    ffn = ("repro_torch/launch/steps.py:90 step", "repro_torch/models/ffn.py:160 moe_ffn",
           "repro_torch/parallel/sharding.py:390 folded_bmm")
    ssm = ("repro_torch/models/ssm.py:144 mamba_block", "repro_torch/parallel/sharding.py:420 dot")

    def dot(op, flops, stack, n=1):
        return hlo_cost.OpRecord(op, "dot", flops, 0.0, n, "(1,) x (1,)", stack)

    records = [dot("aten::mm", 100.0, ffn),                      # its share: 400 / 4
               dot("aten::bmm", 200.0, ffn),                     # x2, 100 above
               hlo_cost.OpRecord("_c10d_functional::all_reduce", "all-reduce", 0.0, 8.0, 1,
                                 "(2,)", ffn),
               dot("aten::bmm", 150.0, ffn, n=2),                # x3, 200 above
               dot("aten::mm", 400.0, ssm)]                      # x2, 200 above
    products = [(400.0, "a"), (400.0, "b"), (400.0, "c"), (800.0, "d")]
    dep = hlo_cost.departures(records, products, 4)
    assert dep["matched"] and dep["products"] == 4 and dep["over_share"] == 3
    assert dep["excess_flops"] == 500.0
    assert dep["first"]["op"] == "aten::bmm" and dep["first"]["times_share"] == 2.0
    assert dep["first"]["global_shapes"] == "b" and dep["first"]["stack"] == list(ffn)
    assert dep["sites"] == [
        {"op": "aten::bmm", "frame": ffn[1], "products": 2, "times_share": 3.0,
         "excess_flops": 300.0},
        {"op": "aten::mm", "frame": ssm[0], "products": 1, "times_share": 2.0,
         "excess_flops": 200.0}]
    assert hlo_cost.departures(records[:2], products, 4)["matched"] is False
    assert hlo_cost.departures(records[:1], products[:1], 4)["sites"] == []


_COLLECTIVE_CHILD = r"""
import json
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import hlo_cost
from repro_torch.parallel.mesh import make_snn_mesh
from repro_torch.util import trips

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
width, n = 1024, 16
mode = hlo_cost.FakeRecorder()
with mode:
    v = torch.empty(width // 8)
mesh = make_snn_mesh(8, device="cpu")

def once(c):
    return c + funcol.all_gather_tensor(c, 0, dist.group.WORLD).sum()

def looped(c):
    return trips.scan(lambda x, t: (once(x), None), c, n)[0]

def fabric(c):
    return trips.scan(lambda x, t: (x + mesh.all_gather(x).sum() + mesh.all_reduce(x), None),
                      c, n)[0]

out = {}
for name, fn in (("once", once), ("looped", looped), ("fabric", fabric)):
    for shortcut in (True, False):
        s = hlo_cost.analyze(hlo_cost.record(fn, v, fake_mode=mode, shortcut=shortcut)[1])
        out[f"{name}/{shortcut}"] = s.collective_bytes
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_collective_bytes_counted_with_trips():
    """The sharded tick's one collective per tick, looped: an all-gather of
    a rank's f32 slice counts its operand once per trip, on the fake world
    of 8 ranks (a child process: the fake group must not outlive it), for
    ``_c10d_functional``'s gather and the SNN fabric's ``c10d`` ones."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _COLLECTIVE_CHILD], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    per_gather = (1024 // 8) * 4
    assert got["once/True"] == {"all-gather": per_gather}
    for shortcut in ("True", "False"):
        assert got[f"looped/{shortcut}"] == {"all-gather": 16 * per_gather}
        assert got[f"fabric/{shortcut}"] == {"all-gather": 16 * per_gather,
                                             "all-reduce": 16 * per_gather}


# ---------------------------------------------------------------------------
# the shortcut on the models' scans


def _train_grads(arch, seq):
    cfg = get_bundle(arch).smoke
    params = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, seq), generator=g)
             for k in ("inputs", "targets")}

    def step(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss, _ = TM.loss_fn(tree.unflatten(params, leaves), cfg, batch)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    return step, params, batch


@pytest.mark.parametrize("chunks", [2, 5])
@pytest.mark.parametrize("arch,mod,chunk", [("jamba-1.5-large-398b", t_ssm, "SSM_CHUNK"),
                                            ("rwkv6-1.6b", t_rwkv, "WKV_CHUNK")],
                         ids=["jamba", "rwkv6"])
def test_shortcut_equals_the_full_loop(monkeypatch, arch, mod, chunk, chunks):
    """A train step (forward, checkpointed chunks recomputed in the
    backward) and a prefill: FLOPs and dot bytes exact, chunks of 8 steps."""
    monkeypatch.setattr(mod, chunk, 8)
    step, params, batch = _train_grads(arch, 8 * chunks)
    full = hlo_cost.analyze(hlo_cost.record(step, params, batch, shortcut=False)[1])
    short = hlo_cost.analyze(hlo_cost.record(step, params, batch)[1])
    assert short == full
    cfg = get_bundle(arch).smoke
    caches = TM.init_cache(cfg, 2, 8 * chunks, "cpu")

    def prefill(params, inputs):
        return TM.prefill_fn(params, cfg, {"inputs": inputs}, caches)

    full = hlo_cost.analyze(hlo_cost.record(prefill, params, batch["inputs"],
                                            shortcut=False)[1])
    assert hlo_cost.analyze(hlo_cost.record(prefill, params, batch["inputs"])[1]) == full


def test_query_chunk_shortcut_equals_every_chunk(monkeypatch):
    """Attention's loop over query chunks (5 chunks of 4), in a smollm-135m
    SMOKE train step and prefill: exact."""
    from repro_torch.models import attention as t_attn

    monkeypatch.setattr(t_attn, "Q_CHUNK", 4)
    step, params, batch = _train_grads("smollm-135m", 20)
    full = hlo_cost.analyze(hlo_cost.record(step, params, batch, shortcut=False)[1])
    assert hlo_cost.analyze(hlo_cost.record(step, params, batch)[1]) == full
    cfg = get_bundle("smollm-135m").smoke
    caches = TM.init_cache(cfg, 2, 20, "cpu")
    out, rec = hlo_cost.record(TM.prefill_fn, params, cfg, {"inputs": batch["inputs"]},
                               caches)
    full_out, full_rec = hlo_cost.record(TM.prefill_fn, params, cfg,
                                         {"inputs": batch["inputs"]}, caches, shortcut=False)
    assert hlo_cost.analyze(rec) == hlo_cost.analyze(full_rec)
    assert out[0].shape == full_out[0].shape


def test_microbatch_loop_shortcut_equals_every_microbatch():
    """The train step's microbatch loop (the reference's scan) at 5
    microbatches: three of them counted, as all five are."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import steps

    bundle = get_bundle("smollm-135m")
    cfg = bundle.smoke
    pcfg = bundle.parallel_for("train_4k").replace(microbatches=5)
    shape = ShapeConfig("t", "train", 8, 10)
    state = steps.init_train_state(cfg, pcfg, torch.Generator().manual_seed(0), "cpu")
    batch = pipeline.make_batch(cfg, shape, pipeline.PipelineState(17, 0), device="cpu")
    step = steps.make_train_step(cfg, pcfg)
    full = hlo_cost.analyze(hlo_cost.record(step, state, batch, shortcut=False)[1])
    short = hlo_cost.analyze(hlo_cost.record(step, state, batch)[1])
    assert short == full and full.flops > 0


def test_fake_trace_peak_equals_the_real_recording():
    """A smollm-135m SMOKE train step traced on fake tensors from its structs
    (the dry run's ``trace``) and recorded over real tensors: the same
    FLOPs, and the same peak of allocated storages but for what the step
    makes from no tensor."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import dryrun, steps

    bundle = get_bundle("smollm-135m")
    cfg = bundle.smoke
    pcfg = bundle.parallel_for("train_4k").replace(microbatches=1)
    shape = ShapeConfig("t", "train", 16, 4)
    step = steps.make_train_step(cfg, pcfg)
    structs = (steps.state_structs(cfg, pcfg, None), steps.batch_structs(cfg, shape, None))
    _, fake, _ = dryrun.trace(step, structs, "cpu")
    state = steps.init_train_state(cfg, pcfg, torch.Generator().manual_seed(0), "cpu")
    batch = pipeline.make_batch(cfg, shape, pipeline.PipelineState(17, 0), device="cpu")
    _, real = hlo_cost.record(step, state, batch)
    assert hlo_cost.analyze(fake) == hlo_cost.analyze(real)
    # The tensors the step makes from no tensor (positions, rope tables,
    # masks, zeros) are real ones in a fake trace, outside its record: of
    # them only one 0-d f32 is alive at the peak.
    assert 0 <= real.peak_bytes - fake.peak_bytes <= 4


def test_peak_follows_allocations_and_frees():
    n = 1000

    def fn(x):
        a = x * 2           # n floats
        b = a + 1           # 2n live
        del a
        c = b * 3           # 2n live again
        return c.sum()      # and the 0-d sum beside them

    _, rec = hlo_cost.record(fn, torch.ones(n))
    assert rec.peak_bytes == 2 * n * 4 + 4
    assert rec.live_bytes == 4       # the 0-d result


def test_temp_leaves_out_the_outputs():
    """The temp is XLA's: the peak of the storages that are neither
    arguments nor outputs; the full peak keeps the outputs. The storages
    alive at the temp's peak are named, largest first, with their op."""
    n = 1000

    def fn(x):
        out = x + 1          # an output: n floats
        t = out * 2          # a temporary beside it
        u = t[: n // 2] * 3  # and a smaller one
        return out, (t.sum() + u.sum())

    (out, _), rec = hlo_cost.record(fn, torch.ones(n))
    # out, t, u, and the two 0-d sums beside their sum (an output)
    assert rec.peak_bytes == 2 * n * 4 + n // 2 * 4 + 3 * 4
    assert rec.temp_bytes == n * 4 + n // 2 * 4 + 2 * 4
    assert [(a.nbytes, a.shape, a.op) for a in rec.at_peak[:2]] == [
        (n * 4, (n,), "aten::mul"), (n // 2 * 4, (n // 2,), "aten::mul")]
    assert "# temp bytes" in rec.text()


def test_temp_of_a_step_names_its_frames():
    """A smollm-135m SMOKE train step: its new parameters and moments are
    outputs, so the temp lies below the full peak by at least the bytes
    that outlive the step; the storages alive at the temp's peak carry the
    port's frames."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import steps

    bundle = get_bundle("smollm-135m")
    cfg = bundle.smoke
    pcfg = bundle.parallel_for("train_4k").replace(microbatches=1)
    state = steps.init_train_state(cfg, pcfg, torch.Generator().manual_seed(0), "cpu")
    batch = pipeline.make_batch(cfg, ShapeConfig("t", "train", 16, 4),
                                pipeline.PipelineState(17, 0), device="cpu")
    out, rec = hlo_cost.record(steps.make_train_step(cfg, pcfg), state, batch)
    outputs = sum(t.numel() * t.element_size() for t in hlo_cost.tensors(out))
    assert rec.temp_bytes + outputs >= rec.peak_bytes > rec.temp_bytes > 0
    assert rec.at_peak and all(a.frame.startswith("repro_torch/") for a in rec.at_peak)


def test_adamw_computes_each_leaf_in_place():
    """The update of one leaf of n float32 elements allocates its new
    parameter and moments and, beside them, at most 12 bytes an element:
    one float32 temporary of its size and, on the CPU, the correctly
    rounded root's float64 copy (the expression on new tensors peaked at
    24 bytes an element here)."""
    from repro_torch.optim import adamw

    n = 1 << 16
    p, g = _x(n), _x(n)
    st = adamw.init({"w": p})
    _, rec = hlo_cost.record(lambda g, st, p: adamw.update(g, st, p, lr=1e-3),
                             {"w": g}, st, {"w": p})
    assert rec.temp_bytes <= 4 * n + 8 * n + 64, rec.temp_bytes
    assert rec.peak_bytes >= rec.temp_bytes + 2 * 4 * n      # the new moments beside them
