"""The port's continuous admission against the JAX package's.

The counterparts of ``tests/test_serve_continuous.py`` (its deprecated
request shims have no type in the port), each held against the reference's
``SNNServer`` on the same RegisterBank images and requests: n_max 24, 4
slots, 12 ticks, ``event_density=0.2``, the 8 demo tenants of seed 0 (the
last plastic; the ring and sparse ones ride the event program), the port on
``jnp``, ``pallas`` and ``pallas_fused`` (their kernels' plain twins on the
CPU). Tolerances:

* counts and predictions bitwise (u8 weights and drive: exact sums);
* learned weights within ``rtol=atol=1e-5`` of the reference's, its own
  tolerance between its learning backends, and bitwise equal to the port's
  own wave path (the same kernels on the same values, tick for tick);
* the stats key set, ``compiles``, the registry's counts and
  ``tenant_report`` as the reference's after the same calls (floats of the
  report to ``rel=1e-6``, ``dw_l1`` to ``rel=1e-5``).

Then the port's own contracts, each a deliberate difference of ROADMAP §C:
the shared tick clock with per-slot learning bounds, frozen chunks on the
resident premasked stack, the owned learning carry, and a refill that makes
a fixed number of writes into the resident stacks.
"""
from __future__ import annotations

import copy
import subprocess
import sys
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.launch import serve as j_serve
from repro.plasticity import PlasticityParams as JPP
from repro_torch.core.engine import EngineOptions, TickEngine
from repro_torch.core.network_types import SNNState
from repro_torch.launch import serve as t_serve
from repro_torch.plasticity import PlasticityParams, PlasticityState

ROOT = Path(__file__).resolve().parents[1]
KW = dict(n_max=24, slots=4, max_ticks=12, event_density=0.2)
BACKENDS = ("jnp", "pallas", "pallas_fused")
RSTDP = dict(a_plus=0.5, a_minus=0.25, lr_reward=2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref(**kw):
    server = j_serve.SNNServer(**{**KW, **kw})
    return server, j_serve.make_demo_tenants(server, 8, seed=0)


def _port(backend="jnp", **kw):
    server = t_serve.SNNServer(backend=backend, device="cpu", **{**KW, **kw})
    return server, t_serve.make_demo_tenants(server, 8, seed=0)


def _reqs(mod, server, names, n, seed):
    return mod.make_demo_requests(server, names, n, seed=seed)


def _same_counts(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.rid == b.rid
        np.testing.assert_array_equal(b.counts, a.counts, err_msg=str(b.rid))
        assert b.pred == a.pred, b.rid


def _weights(server, names):
    return {n: np.asarray(server.tenants[n].params.w) for n in names}


@pytest.fixture(scope="module")
def ref_continuous():
    """The reference's continuous serve of 16 demo requests (seed 1)."""
    server, names = _ref()
    reqs = _reqs(j_serve, server, names, 16, 1)
    stats = server.serve_continuous(reqs)
    return server, names, reqs, stats


# -- the wave oracle ---------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_counts_preds_weights_bit_exact_vs_wave(ref_continuous, backend):
    """Continuous equals the port's wave path bitwise (counts, predictions,
    learned weights) and the reference's continuous path (counts and
    predictions bitwise, weights within 1e-5); the same chunk count."""
    j_server, names, j_reqs, j_stats = ref_continuous
    sw, _ = _port(backend)
    sc, _ = _port(backend)
    reqs_w = _reqs(t_serve, sw, names, 16, 1)
    reqs_c = _reqs(t_serve, sc, names, 16, 1)
    sw.serve(reqs_w)
    stats = sc.serve_continuous(reqs_c)
    _same_counts(reqs_w, reqs_c)
    _same_counts(j_reqs, reqs_c)
    assert stats["chunks"] == j_stats["chunks"] and stats["preds"] == j_stats["preds"]
    plastic = [n for n in names if sc.tenants[n].plastic]
    want = _weights(j_server, names)
    for n in names:
        w_c = sc.tenants[n].params.w.numpy()
        np.testing.assert_array_equal(w_c, sw.tenants[n].params.w.numpy(), err_msg=n)
        np.testing.assert_allclose(w_c, want[n], rtol=1e-5, atol=1e-5, err_msg=n)
    assert np.abs(want[plastic[0]] - np.asarray(
        j_server.tenants[plastic[0]].params.w)).max() == 0.0


@pytest.fixture(scope="module")
def ref_wave_seed3():
    server, names = _ref()
    reqs = _reqs(j_serve, server, names, 8, 3)
    server.serve(reqs)
    return names, reqs, _weights(server, names)


@pytest.mark.parametrize("chunk", (1, 5, 12))
@pytest.mark.parametrize("backend", BACKENDS)
def test_exact_across_chunk_sizes(ref_wave_seed3, backend, chunk):
    """Every chunk size gives the port's wave path bitwise, learned weights
    included, and the reference's wave counts."""
    names, j_reqs, j_w = ref_wave_seed3
    sw, _ = _port(backend)
    reqs_w = _reqs(t_serve, sw, names, 8, 3)
    sw.serve(reqs_w)
    sc, _ = _port(backend)
    reqs_c = _reqs(t_serve, sc, names, 8, 3)
    stats = sc.serve_continuous(reqs_c, chunk_ticks=chunk)
    assert stats["ticks"] == stats["chunks"] * chunk
    _same_counts(reqs_w, reqs_c)
    _same_counts(j_reqs, reqs_c)
    for n in names:
        np.testing.assert_array_equal(sc.tenants[n].params.w.numpy(),
                                      sw.tenants[n].params.w.numpy(), err_msg=n)
        np.testing.assert_allclose(sc.tenants[n].params.w.numpy(), j_w[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)


@pytest.fixture(scope="module")
def ref_mixed():
    server, names = _ref()
    reqs = _reqs(j_serve, server, names, 12, 2)
    return names, reqs, server.serve_continuous(reqs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mixed_dense_and_event_tenants(ref_mixed, backend):
    names, j_reqs, j_stats = ref_mixed
    sc, _ = _port(backend)
    assert {sc.tenants[n].backend for n in names} == {backend, "event"}
    reqs = _reqs(t_serve, sc, names, 12, 2)
    stats = sc.serve_continuous(reqs)
    assert stats["requests_served"] == j_stats["requests_served"] == 12
    assert set(stats["backends"]) == {backend, "event"}
    assert stats["backends"]["event"] == j_stats["backends"]["event"]
    _same_counts(j_reqs, reqs)


# -- programs in use -----------------------------------------------------------


SEQUENCES = {"refills": ((4, 9), (20, 1)), "second_batch": ((8, 1), (8, 2))}


@pytest.fixture(scope="module")
def ref_compiles():
    """The reference's ``compiles`` after each call of each sequence, and
    after a wave serve, a continuous serve and one at another chunk size."""
    out = {}
    for name, seq in SEQUENCES.items():
        server, names = _ref()
        out[name] = []
        for n, seed in seq:
            stats = server.serve_continuous(_reqs(j_serve, server, names, n, seed))
            out[name].append((server.compiles, stats["recompiles_after_warmup"]))
    server, names = _ref()
    calls = [lambda s, n: s.serve(_reqs(j_serve, s, n, 4, 1)),
             lambda s, n: s.serve_continuous(_reqs(j_serve, s, n, 6, 2)),
             lambda s, n: s.serve_continuous(_reqs(j_serve, s, n, 6, 3), chunk_ticks=5)]
    out["mixed"] = []
    for call in calls:
        stats = call(server, names)
        out["mixed"].append((server.compiles, stats["recompiles_after_warmup"],
                             dict(server._compiles)))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_slot_refills_never_retrace(ref_compiles, backend):
    sc, names = _port(backend)
    got = []
    for n, seed in SEQUENCES["refills"]:
        stats = sc.serve_continuous(_reqs(t_serve, sc, names, n, seed))
        got.append((sc.compiles, stats["recompiles_after_warmup"]))
    assert got == ref_compiles["refills"]
    assert got[1][0] == got[0][0] and got[1][1] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_second_batch_reuses_programs(ref_compiles, backend):
    sc, names = _port(backend)
    got = []
    for n, seed in SEQUENCES["second_batch"]:
        sc.serve_continuous(_reqs(t_serve, sc, names, n, seed))
        got.append(sc.compiles)
    assert got == [c for c, _ in ref_compiles["second_batch"]]
    assert got[0] == got[1]


def test_compile_accounting_keys_match_reference(ref_compiles):
    """After a wave serve, a continuous serve and one at another chunk size,
    the port counts its programs under the reference's keys, the second chunk
    size as a recompile, as the reference's trace does."""
    sc, names = _port("jnp")
    calls = [lambda: sc.serve(_reqs(t_serve, sc, names, 4, 1)),
             lambda: sc.serve_continuous(_reqs(t_serve, sc, names, 6, 2)),
             lambda: sc.serve_continuous(_reqs(t_serve, sc, names, 6, 3), chunk_ticks=5)]
    got = []
    for call in calls:
        stats = call()
        got.append((sc.compiles, stats["recompiles_after_warmup"], dict(sc._compiles)))
    assert got == ref_compiles["mixed"]
    assert got[-1][1] >= 1


# -- admission edges -------------------------------------------------------------


def test_zero_tick_budget_completes_without_running():
    sc, names = _port("pallas_fused")
    t = sc.tenants[names[0]]
    r = t_serve.ServeRequest(rid=0, tenant=names[0], ext=np.zeros((1, t.n_in), np.float32),
                             n_ticks=0)
    stats = sc.serve_continuous([r])
    assert stats["requests_served"] == 1 and stats["chunks"] == 0
    assert r.t_done is not None and r.counts.shape == (t.n_out,)
    np.testing.assert_array_equal(r.counts, np.zeros_like(r.counts))
    j_server, _ = _ref()
    jr = j_serve.ServeRequest(rid=0, tenant=names[0],
                              ext=np.zeros((1, t.n_in), np.float32), n_ticks=0)
    j_stats = j_server.serve_continuous([jr])
    np.testing.assert_array_equal(r.counts, jr.counts)
    assert stats["compiles"] == j_stats["compiles"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_unknown_tenant_rejected_and_counted(backend):
    sc, names = _port(backend)
    bad = t_serve.ServeRequest(rid=0, tenant="ghost", ext=np.zeros((2, 4), np.float32),
                               n_ticks=2)
    ok = _reqs(t_serve, sc, names, 2, 1)
    stats = sc.serve_continuous([bad] + ok)
    assert stats["requests_rejected"] == 1 and stats["requests_served"] == 2
    assert bad.counts is None
    assert sc.registry.get("snn_admission_rejections_total").value(
        reason="unknown_tenant") == 1


@pytest.fixture(scope="module")
def ref_feeder():
    server, names = _ref()
    late = deque(_reqs(j_serve, server, names, 6, 4))
    first = _reqs(j_serve, server, names, 2, 5)
    completed = []
    stats = server.serve_continuous(first, feeder=lambda: late.popleft() if late else None,
                                    on_complete=completed.append)
    return names, completed, stats


@pytest.mark.parametrize("backend", BACKENDS)
def test_feeder_streams_late_arrivals(ref_feeder, backend):
    """The feeder is polled once per chunk (and once more at the end): the
    same requests complete in the same order as the reference's, with the
    same counts, and ``on_complete`` sees each one."""
    names, j_completed, j_stats = ref_feeder
    sc, _ = _port(backend)
    late = deque(_reqs(t_serve, sc, names, 6, 4))
    polls = []

    def feeder():
        polls.append(len(late))
        return late.popleft() if late else None

    completed = []
    stats = sc.serve_continuous(_reqs(t_serve, sc, names, 2, 5), feeder=feeder,
                                on_complete=completed.append)
    assert stats["requests_served"] == 8 == len(completed) and not late
    assert stats["chunks"] == j_stats["chunks"]
    assert [r.rid for r in completed] == [r.rid for r in j_completed]
    _same_counts(j_completed, completed)
    assert polls[-1] == 0


def test_chunk_ticks_validated():
    sc, _ = _port()
    for bad in (0, sc.max_ticks + 1):
        with pytest.raises(ValueError, match="chunk_ticks"):
            sc.serve_continuous([], chunk_ticks=bad)
        with pytest.raises(ValueError, match="chunk_ticks"):
            t_serve.SNNServer(chunk_ticks=bad, device="cpu", **KW)
    j_server, _ = _ref()
    for max_ticks in (1, 12, 32, 64):
        assert (t_serve.SNNServer(n_max=8, max_ticks=max_ticks, device="cpu").chunk_ticks
                == j_serve.SNNServer(n_max=8, max_ticks=max_ticks).chunk_ticks)


# -- the stats schema ------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_schema():
    sw, names = _ref()
    wave = sw.serve(_reqs(j_serve, sw, names, 4, 1))
    sc, _ = _ref()
    cont = sc.serve_continuous(_reqs(j_serve, sc, names, 4, 1))
    return wave, cont, sc.serve_continuous([])


def test_same_keys_wave_continuous_and_empty(ref_schema):
    j_wave, j_cont, j_empty = ref_schema
    sw, names = _port("pallas_fused")
    sc, _ = _port("pallas_fused")
    wave = sw.serve(_reqs(t_serve, sw, names, 4, 1))
    cont = sc.serve_continuous(_reqs(t_serve, sc, names, 4, 1))
    empty = sc.serve_continuous([])
    assert set(wave) == set(cont) == set(empty) == set(j_wave) == set(j_cont) == set(j_empty)
    assert (wave["mode"], cont["mode"], empty["mode"]) == ("wave", "continuous", "continuous")
    assert empty["requests_served"] == 0 and empty["p99_ttft_s"] == 0.0
    for key in ("n_requests", "chunks", "ticks", "useful_slot_ticks", "spikes_out", "preds"):
        assert cont[key] == j_cont[key], key
    assert sorted(cont["backends"].values()) == sorted(j_cont["backends"].values())
    assert {k: v for k, v in empty.items() if k not in ("compiles",)} == {
        k: v for k, v in j_empty.items() if k not in ("compiles",)}


def test_ttft_measured_from_enqueue_not_wave_start():
    sc, names = _port()
    reqs = _reqs(t_serve, sc, names, 2, 1)
    for r in reqs:
        r.t_submit = 1.0   # an epoch stamp far in the past
    stats = sc.serve_continuous(reqs)
    assert stats["mean_ttft_s"] > 1e6


def test_results_are_serve_results():
    sc, names = _port()
    stats = sc.serve_continuous(_reqs(t_serve, sc, names, 3, 1))
    assert len(stats["results"]) == 3
    for res in stats["results"]:
        assert isinstance(res, t_serve.ServeResult)
        assert not res.rejected and res.reason == "" and res.ttft_s >= 0.0
    r = t_serve.ServeRequest(rid=5, tenant="ghost")
    rej = t_serve.ServeResult.rejection(r, "queue_full")
    j_rej = j_serve.ServeResult.rejection(j_serve.ServeRequest(rid=5, tenant="ghost"),
                                          "queue_full")
    assert (rej.rid, rej.tenant, rej.rejected, rej.reason, rej.t_first, rej.counts) == (
        j_rej.rid, j_rej.tenant, j_rej.rejected, j_rej.reason, j_rej.t_first, j_rej.counts)
    assert rej.t_done >= rej.t_submit > 0 and rej.ttft_s == 0.0


# -- observability -----------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_tenant_report_and_registry_match_reference(ref_continuous, backend):
    """After the same ``serve_continuous``: ``tenant_report`` field for field
    (telemetry per slot, folded in at retire; the dense tenants' program
    named by the port's backend) and every instrument's count, the chunk
    counter and the chunk histogram included."""
    j_server = ref_continuous[0]
    sc, names = _port(backend)
    sc.serve_continuous(_reqs(t_serve, sc, names, 16, 1))
    want, got = j_server.tenant_report(), sc.tenant_report()
    assert list(got) == list(want) and len(got) == 8
    relabel = lambda b: "default" if b != "event" else b
    for name, row in want.items():
        assert list(got[name]) == list(row), name
        for k, v in row.items():
            if k == "backend":
                assert relabel(got[name][k]) == relabel(v)
            elif isinstance(v, float):
                tol = 1e-5 if k == "dw_l1" else 1e-6
                assert got[name][k] == pytest.approx(v, rel=tol, abs=1e-9), (name, k)
            else:
                assert got[name][k] == v, (name, k)
    assert got[names[-1]]["dw_l1"] > 0
    jd, td = j_server.registry.to_dict(), sc.registry.to_dict()
    # The port's own: no CUDA graph on the CPU, and none in the reference.
    assert sorted(set(td) - set(jd)) == list(t_serve.GRAPH_COUNTERS)
    for name in t_serve.GRAPH_COUNTERS:
        assert not td.pop(name)["values"], name
    assert sorted(jd) == sorted(td)
    for name, want_i in jd.items():
        got_i = td[name]
        labels = [k.replace(f'backend="{backend}"', 'backend="jnp"') for k in got_i["values"]]
        assert labels == list(want_i["values"]), name
        for (lg, g), (lw, w) in zip(got_i["values"].items(), want_i["values"].items()):
            if want_i["type"] == "histogram":
                assert g["count"] == w["count"], (name, lw)
            elif name not in ("snn_slot_ticks_per_s", "snn_goodput_slot_ticks_per_s"):
                assert g == pytest.approx(w, rel=1e-5), (name, lw)
    assert td["snn_chunks_total"]["values"]


# -- the port's own contracts (ROADMAP §C) -----------------------------------------


def _recorded(server):
    """Record each chunk's kind, the slots' budgets and learning bounds on
    the shared clock, and the frozen hoist it was handed."""
    log = []
    run = server._run_chunk

    def wrapped(res, engine, backend, chunk, slot_req, offset, budget, until, *, learning):
        log.append(dict(backend=backend, learning=learning, budget=budget.copy(),
                        until=until.copy(),
                        plastic=[r is not None and server.tenants[r.tenant].plastic
                                 for r in slot_req], wc=res.wc))
        return run(res, engine, backend, chunk, slot_req, offset, budget, until,
                   learning=learning)

    server._run_chunk = wrapped
    return log


def _with_rewards(reqs, names, mod, seed):
    """The demo requests with R-STDP rewards on the plastic tenant's."""
    rng = np.random.default_rng(seed)
    for r in reqs:
        if r.tenant == names[-1]:
            r.rewards = rng.uniform(-1, 1, r.n_ticks).astype(np.float32)
    return reqs


@pytest.fixture(scope="module", params=("stdp", "rstdp"))
def ref_refill(request):
    rule = request.param
    pp = None if rule == "stdp" else JPP.make("rstdp", **RSTDP)
    server, names = _ref(plasticity=pp)
    reqs = _with_rewards(_reqs(j_serve, server, names, 20, 6), names, j_serve, 7)
    server.serve_continuous(reqs, chunk_ticks=2)
    return rule, names, reqs, np.asarray(server.tenants[names[-1]].params.w)


@pytest.mark.parametrize("backend", BACKENDS)
def test_plastic_slot_refilled_mid_group_learns_the_reference(ref_refill, backend):
    """The shared tick clock: a plastic request filled at tick > 0 of its
    group learns until its fill tick plus its budget on that clock, which is
    what the reference's per-slot counter, restarted at 0, gives. Learned
    weights within 1e-5 of the reference's and bitwise the wave path's;
    frozen slots carry a bound of 0."""
    rule, names, j_reqs, j_w = ref_refill
    pp = None if rule == "stdp" else PlasticityParams.make("rstdp", **RSTDP)
    sc, _ = _port(backend, plasticity=pp)
    log = _recorded(sc)
    reqs = _with_rewards(_reqs(t_serve, sc, names, 20, 6), names, t_serve, 7)
    sc.serve_continuous(reqs, chunk_ticks=2)
    _same_counts(j_reqs, reqs)
    mid = [(c["until"][i], c["budget"][i]) for c in log for i in range(4)
           if c["plastic"][i] and c["until"][i] > c["budget"][i]]
    assert mid, "no plastic request was filled after its group's first tick"
    assert all(c["until"][i] == 0 for c in log for i in range(4) if not c["plastic"][i])
    w = sc.tenants[names[-1]].params.w.numpy()
    np.testing.assert_allclose(w, j_w, rtol=1e-5, atol=1e-5)
    sw, _ = _port(backend, plasticity=pp)
    sw.serve(_with_rewards(_reqs(t_serve, sw, names, 20, 6), names, t_serve, 7))
    np.testing.assert_array_equal(w, sw.tenants[names[-1]].params.w.numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_frozen_chunks_run_the_premasked_stack(backend):
    """A chunk runs the learning tick only while a plastic request is
    resident; every other chunk runs the frozen tick on the resident ``W*C``
    stack (none on ``pallas``, whose kernel masks per tile), and the counts
    are those of the wave path."""
    sc, names = _port(backend)
    sw, _ = _port(backend)
    log = _recorded(sc)
    reqs = _reqs(t_serve, sc, names, 16, 1)
    sc.serve_continuous(reqs)
    waves = _reqs(t_serve, sw, names, 16, 1)
    sw.serve(waves)
    _same_counts(waves, reqs)
    assert {c["learning"] for c in log} == {True, False}
    for c in log:
        assert c["learning"] == any(c["plastic"])
        assert (c["wc"] is None) == (c["backend"] == "pallas")
    assert {c["backend"] for c in log} == {backend, "event"}


def test_plan_records_whether_c_is_streamed():
    """The B1/B2 plan says whether ``c`` is streamed, which is how a chip run
    tells a frozen chunk's premasked launch from a learning chunk's."""
    from repro_torch.kernels import _plan

    frozen = _plan.plan(4, 1, 4096, 4096, has_c=False)
    learning = _plan.plan(4, 1, 4096, 4096, has_c=True)
    assert not frozen.has_c and learning.has_c


def test_chunk_never_writes_the_callers_carry_unless_owned():
    """``TickEngine.chunk`` clones the learning carry's ``w``, ``elig`` and
    telemetry (the caller's stay as they were); ``owned=True`` updates them
    in their buffers, with the same result."""
    rng = np.random.default_rng(0)
    S, n = 2, 16
    w = torch.as_tensor(rng.integers(40, 200, (S, n, n)).astype(np.float32))
    c = torch.as_tensor((rng.random((S, n, n)) < 0.5).astype(np.float32))
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network_types import SNNParams
    from repro_torch.core.engine import TickCarry

    lif = LIFParams.make(n, v_th=100.0, leak=1.0, r_ref=1, device="cpu")
    lif = LIFParams(**{k: v.expand(S, n).clone() for k, v in vars(lif).items()})
    params = SNNParams(w=w, c=c, w_in=torch.eye(n).expand(S, n, n).clone(), lif=lif)
    ext = torch.as_tensor((rng.random((6, S, n)) < 0.4) * 150.0, dtype=torch.float32)
    for rule in ("stdp", "rstdp"):
        eng = TickEngine(EngineOptions(backend="pallas_fused", telemetry=True,
                                       plasticity=PlasticityParams.make(rule, a_plus=0.5,
                                                                        a_minus=0.25)))

        def carry():
            from repro_torch.obs.telemetry import TickTelemetry

            return TickCarry(state=SNNState.zeros((S,), n, device="cpu"),
                             plast=PlasticityState.zeros((), n, device="cpu", slots=S),
                             w=w.clone(), telem=TickTelemetry.zeros((S,), device="cpu"))

        rew = torch.ones((6, S))
        mine = carry()
        before = (mine.w.clone(), mine.plast.elig.clone(), mine.telem.buf.clone())
        out, raster = eng.chunk(params, mine, ext, 6, rewards=rew)
        assert torch.equal(mine.w, before[0]) and torch.equal(mine.plast.elig, before[1])
        assert torch.equal(mine.telem.buf, before[2])
        owned = carry()
        out2, raster2 = eng.chunk(params, owned, ext, 6, rewards=rew, owned=True)
        assert out2.w is owned.w and out2.telem is owned.telem
        assert torch.equal(out2.w, out.w) and torch.equal(raster2, raster)
        assert not torch.equal(out2.w, before[0])
        assert torch.equal(out2.telem.buf, out.telem.buf)
        if rule == "rstdp":
            assert out2.plast.elig is owned.plast.elig
            assert torch.equal(out2.plast.elig, out.plast.elig)


class _Writes(TorchDispatchMode):
    """Count the ops that write into an argument (in place or ``out=``)."""

    def __init__(self):
        super().__init__()
        self.writes, self.ops = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        self.writes += func._schema.is_mutable
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("program,rule,telemetry", [
    ("jnp", "stdp", True), ("pallas", "stdp", True), ("pallas_fused", "rstdp", True),
    ("pallas_fused", "stdp", False), ("event", "stdp", True)])
def test_refill_makes_its_stated_writes_in_place(program, rule, telemetry):
    """One register download writes :attr:`fill_copies` times into the
    resident stacks (no more), reallocates none of them, and leaves every
    other slot as it was."""
    pp = None if rule == "stdp" else PlasticityParams.make("rstdp", **RSTDP)
    backend = "jnp" if program == "event" else program
    sc, names = _port(backend, plasticity=pp, telemetry=telemetry)
    tenants = [t for t in sc.tenants.values() if (t.backend == "event") == (program == "event")]
    res = t_serve._Resident(sc, tenants[0].backend, tenants[0])
    leaves = {"w": res.w, "c": res.c, "w_in": res.w_in, "wc": res.wc, "v": res.state.lif.v,
              "x_pre": res.plast.x_pre, "elig": res.plast.elig, "counts": res.counts,
              "fan_idx": res.fan_idx, "w_edges": res.w_edges,
              "telem": None if res.telem is None else res.telem.buf}
    ptrs = {k: v.data_ptr() for k, v in leaves.items() if v is not None}
    for v in (res.state.lif.v, res.counts, res.plast.x_pre):
        v.fill_(3.0)
    others = {k: v[[0, 2, 3]].clone() for k, v in leaves.items() if v is not None
              and k != "telem"}
    with _Writes() as mode:
        res.fill(1, tenants[1])
    assert mode.writes == res.fill_copies, mode.ops
    assert {k: v.data_ptr() for k, v in leaves.items() if v is not None} == ptrs
    for k, v in others.items():
        assert torch.equal(leaves[k][[0, 2, 3]], v), k
    p = tenants[1].params
    assert torch.equal(res.w[1], p.w) and torch.equal(res.c[1], p.c)
    assert torch.equal(res.state.lif.v[1], torch.zeros_like(p.lif.v_th))
    assert not res.counts[1].any() and not res.plast.x_pre[1].any()
    if res.wc is not None:
        assert torch.equal(res.wc[1], p.w * p.c)


@pytest.mark.parametrize("backend", BACKENDS)
def test_resident_state_keeps_its_buffers_across_refills(backend):
    """Every chunk reads and leaves the group's state, drive and budgets in
    the resident's own buffers (what a CUDA graph of the chunk records):
    ``v``, ``r``, ``y`` and ``tick`` keep their addresses from chunk to
    chunk across refills mid-group, learning chunks included, and the
    results stay bitwise the wave path's."""
    sc, names = _port(backend)
    sw, _ = _port(backend)
    seen, fills, held = {}, [], []
    run, fill = sc._run_chunk, t_serve._Resident.fill

    def leaves(res):
        st = res.state
        return tuple(x.data_ptr() for x in (st.lif.v, st.lif.r, st.lif.y, st.tick,
                                            res.ext, res.meta, res.counts))

    def wrapped(res, *args, **kw):
        held.append(res)   # no resident's id is reused within the call
        seen.setdefault(id(res), set()).add(leaves(res))
        run(res, *args, **kw)
        seen[id(res)].add(leaves(res))

    def counted(res, i, t):
        fills.append(id(res) in seen)   # after the group's first chunk
        fill(res, i, t)

    sc._run_chunk = wrapped
    t_serve._Resident.fill = counted
    try:
        reqs = _reqs(t_serve, sc, names, 16, 1)
        sc.serve_continuous(reqs, chunk_ticks=2)
    finally:
        t_serve._Resident.fill = fill
    waves = _reqs(t_serve, sw, names, 16, 1)
    sw.serve(waves)
    _same_counts(waves, reqs)
    assert any(fills), "no refill mid-group"
    assert all(len(ptrs) == 1 for ptrs in seen.values()), seen


def _resident_leaves(res):
    """Every tensor a resident holds, by name (None where its program has none)."""
    st, pl = res.state, res.plast
    out = {"w": res.w, "c": res.c, "w_in": res.w_in, "wc": res.wc, "fan_idx": res.fan_idx,
           "fan_mask": res.fan_mask, "w_edges": res.w_edges, "v": st.lif.v, "r": st.lif.r,
           "y": st.lif.y, "delay_buf": st.delay_buf, "tick": st.tick, "x_pre": pl.x_pre,
           "x_post": pl.x_post, "elig": pl.elig, "counts": res.counts, "ext": res.ext,
           "meta": res.meta, "telem": None if res.telem is None else res.telem.buf}
    out.update({f"lif.{k}": v for k, v in vars(res.lif).items()})
    return {k: v for k, v in out.items() if v is not None}


@pytest.mark.parametrize("backend", BACKENDS)
def test_later_groups_reseed_the_programs_resident_in_place(backend):
    """The server keeps each program's resident from group to group: a
    later call's group reseeds it in place, so the buffers a frozen chunk
    reads (what a CUDA graph of it records) keep their addresses, to
    exactly what a new resident seeded from the same tenant holds (but the
    drive and budget rows, which every chunk overwrites), and every call's
    results stay bitwise the wave path's."""
    sc, names = _port(backend)
    sw, _ = _port(backend)
    reseed, checked = t_serve._Resident.reseed, []

    def spy(res, t):
        reseed(res, t)
        program = next(b for b, r in sc._residents.items() if r is res)
        fresh = _resident_leaves(t_serve._Resident(sc, program, t))
        got = _resident_leaves(res)
        assert sorted(got) == sorted(fresh)
        for k in set(got) - {"ext", "meta"}:
            assert got[k].dtype == fresh[k].dtype and torch.equal(got[k], fresh[k]), (program, k)
        checked.append(program)

    ptrs = {}
    t_serve._Resident.reseed = spy
    try:
        for seed in (1, 2, 3):
            reqs = _reqs(t_serve, sc, names, 12, seed)
            sc.serve_continuous(reqs, chunk_ticks=2)
            waves = _reqs(t_serve, sw, names, 12, seed)
            sw.serve(waves)
            _same_counts(waves, reqs)
            for program, res in sc._residents.items():
                # A learning chunk may hand back new weights and traces (which
                # drops the graphs; no frozen chunk reads the traces).
                ptrs.setdefault(program, set()).add(tuple(
                    (k, x.data_ptr()) for k, x in sorted(_resident_leaves(res).items())
                    if k not in ("w", "x_pre", "x_post", "elig")))
    finally:
        t_serve._Resident.reseed = reseed
    assert sorted(sc._residents) == sorted({backend, "event"})
    assert sorted(set(checked)) == sorted(sc._residents) and len(checked) >= 4
    assert all(len(p) == 1 for p in ptrs.values()), {
        b: set.union(*map(set, p)) - set.intersection(*map(set, p)) for b, p in ptrs.items()}


def test_chunk_graph_counters_exist_and_stay_zero_on_the_cpu():
    """The capture and replay counters are registered with the chunk
    counter and stay 0 on the CPU, where every chunk runs eager."""
    sc, names = _port("pallas_fused")
    stats = sc.serve_continuous(_reqs(t_serve, sc, names, 16, 1))
    reg = sc.registry
    assert stats["chunks"] > 0
    for name in t_serve.GRAPH_COUNTERS:
        counter = reg.get(name)
        assert counter is not None and counter.labelnames == ("backend",), name
        assert all(counter.value(backend=b) == 0 for b in ("pallas_fused", "event")), name
        assert not reg.to_dict()[name]["values"], name
    assert sum(reg.get("snn_chunks_total").value(backend=b)
               for b in ("pallas_fused", "event")) == stats["chunks"]


@pytest.mark.parametrize("learning", (False, True))
@pytest.mark.parametrize("backend", BACKENDS + ("event",))
@pytest.mark.parametrize("device", ("cpu", "cuda"))
def test_chunk_graph_engages_on_frozen_dense_chunks_on_the_card(device, backend, learning):
    """The rule itself: a CUDA graph for a frozen chunk of ``jnp``,
    ``pallas`` or ``pallas_fused`` on the card; never a learning chunk,
    never the event program, never the CPU."""
    engaged = {("cuda", b, False) for b in ("jnp", "pallas", "pallas_fused")}
    got = t_serve.chunk_graph_engages(torch.device(device), backend, learning)
    assert got == ((device, backend, learning) in engaged)


def test_cli_serves_continuously(capsys):
    stats = t_serve.main(["--arch", "snn", "--smoke", "--device", "cpu", "--requests", "9",
                          "--slots", "8", "--continuous"])
    out = capsys.readouterr().out
    assert stats["mode"] == "continuous" and stats["n_requests"] == 9
    assert stats["chunks"] > 0 and stats["recompiles_after_warmup"] == 0
    assert "snn_chunks_total" in out and "mode: continuous" in out


def test_example_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_multi_tenant", "--fast",
         "--device", "cpu"], capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""}, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PASS - one tick program served" in out.stdout
    assert "continuous admission: served 12 more requests" in out.stdout


def test_refills_never_write_a_tenants_registers():
    """A refill copies a tenant's image into the stacks and the write-back
    copies the learned slot out, so the chunks' in-place updates never reach
    a tenant's registers: frozen tenants' weights are unchanged and the
    plastic tenant's written-back weights survive later chunks."""
    sc, names = _port("pallas_fused")
    frozen0 = {n: copy.deepcopy(sc.tenants[n].params.w) for n in names[:-1]}
    seen = []
    sc.serve_continuous(_reqs(t_serve, sc, names, 12, 1),
                        on_complete=lambda r: seen.append(
                            (r.tenant, sc.tenants[r.tenant].params.w.clone())))
    for n, w in frozen0.items():
        assert torch.equal(sc.tenants[n].params.w, w), n
    learned = [w for t, w in seen if t == names[-1]]
    assert learned and torch.equal(learned[-1], sc.tenants[names[-1]].params.w)
