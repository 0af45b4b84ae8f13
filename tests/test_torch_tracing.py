"""The serving loop's stage spans (``repro_torch.obs.tracing.span``) on the CPU.

With no profiler running a span opens no ``record_function`` and records
nothing; under ``torch.profiler`` every stage of
``SNNServer.serve_continuous`` is recorded on the profiler's clock, nested
under ``snn/serve``, and ``host_time`` is the sum of its stage spans.
"""
from __future__ import annotations

import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve as t_serve
from repro_torch.obs import MetricsRegistry, get_span_log, span, tracing
from repro_torch.obs.tracing import SpanLog

SERVE = dict(n_max=32, slots=4, max_ticks=10, chunk_ticks=3)
STAGES = ("snn/feed", "snn/fill", "snn/assemble", "snn/upload", "snn/chunk/jnp",
          "snn/readback", "snn/retire")
HOST_KEYS = ["fill", "assemble", "dispatch", "retire"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _serve(profiled: bool):
    """The demo tenants' 12 requests through ``serve_continuous``: four
    queued, the rest fed one a poll; returns ``(server, stats, requests,
    span records, profiler events as (name, start ns, end ns))``."""
    server = t_serve.SNNServer(backend="jnp", device="cpu", **SERVE)
    names = t_serve.make_demo_tenants(server, 8, seed=0)
    reqs = t_serve.make_demo_requests(server, names, 12, seed=1)
    late = list(reversed(reqs[4:]))

    def feeder():
        return late.pop() if late else None

    log = get_span_log()
    log.clear()
    events = []
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # A profiler's first record on a thread takes about a millisecond
            # to open; the spans are timed after it.
            with torch.profiler.record_function("warm-up"):
                pass
            stats = server.serve_continuous(reqs[:4], feeder=feeder)
        events = [(e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()]
    else:
        stats = server.serve_continuous(reqs[:4], feeder=feeder)
    records = log.records()
    log.clear()
    return server, stats, reqs, records, events


@pytest.fixture(scope="module")
def profiled():
    return _serve(True)


def test_off_opens_no_record_function_and_records_nothing(monkeypatch):
    opened = []

    def counting(real):
        def opens(name, *a, **kw):
            opened.append(name)
            return real(name, *a, **kw)
        return opens

    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(torch._C._profiler._RecordFunctionFast))
    server, stats, reqs, records, _ = _serve(False)
    assert not tracing.profiling()
    assert opened == []
    assert records == [] and get_span_log().dropped == 0
    assert stats["requests_served"] == len(reqs)
    assert server.host_time["dispatch"][1] == stats["chunks"] > 0


def test_every_stage_nests_under_serve(profiled):
    _, _, _, records, _ = profiled
    tops = [i for i, r in enumerate(records) if r.parent == -1]
    assert [records[i].name for i in tops] == ["snn/serve"]
    names = Counter(r.name for r in records)
    assert set(names) == {"snn/serve", *STAGES}
    for r in records:
        if r.name == "snn/upload":
            assert records[r.parent].name == "snn/assemble"
        elif r.name != "snn/serve":
            assert r.parent == tops[0], r
        assert 0 < r.start_ns <= r.end_ns
        outer = records[r.parent] if r.parent >= 0 else r
        assert outer.start_ns <= r.start_ns and r.end_ns <= outer.end_ns


def test_one_dispatch_span_per_chunk(profiled):
    server, stats, _, records, _ = profiled
    chunks = [r for r in records if r.name.startswith("snn/chunk/")]
    assert len(chunks) == stats["chunks"] > 0
    assert all(r.attrs == {"backend": "jnp"} for r in chunks)
    assert sum(r.name == "snn/assemble" for r in records) == stats["chunks"]
    assert server.registry.get("snn_chunk_seconds").count(backend="jnp") == stats["chunks"]


def test_each_request_has_one_fill_and_one_retire(profiled):
    _, _, reqs, records, _ = profiled
    for stage in ("snn/fill", "snn/retire"):
        rids = Counter(r.attrs["rid"] for r in records if r.name == stage)
        assert rids == Counter(r.rid for r in reqs), stage
    slots = {r.attrs["slot"] for r in records if r.name == "snn/fill"}
    assert slots <= set(range(SERVE["slots"]))


def test_spans_sit_on_the_profilers_clock(profiled):
    """Each record starts and ends within 1 ms of the profiler's own event of
    the same name (matched in order)."""
    _, _, _, records, events = profiled
    by_name = {}
    for name, s, e in sorted(events, key=lambda ev: ev[1]):
        by_name.setdefault(name, []).append((s, e))
    seen = Counter()
    for r in sorted(records, key=lambda r: r.start_ns):
        s, e = by_name[r.name][seen[r.name]]
        seen[r.name] += 1
        assert abs(s - r.start_ns) < 1_000_000 and abs(e - r.end_ns) < 1_000_000, r
    assert all(seen[n] == len(by_name[n]) for n in seen)
    # The tick loop's scopes sit inside the dispatch spans in the same trace.
    assert "tick/jnp" in by_name


def test_host_time_is_the_sum_of_its_stage_spans(profiled):
    server, stats, reqs, records, _ = profiled
    host = server.host_time
    assert list(host) == HOST_KEYS

    def total(*names):
        return sum(r.seconds for r in records if r.name in names)

    def count(name):
        return sum(r.name == name for r in records)

    assert host["fill"] == [pytest.approx(total("snn/fill"), abs=1e-9), len(reqs)]
    assert host["assemble"] == [pytest.approx(total("snn/assemble"), abs=1e-9), stats["chunks"]]
    assert host["dispatch"] == [pytest.approx(total("snn/chunk/jnp"), abs=1e-9), stats["chunks"]]
    assert host["retire"] == [pytest.approx(total("snn/readback", "snn/retire"), abs=1e-9),
                              count("snn/readback")]
    # The upload is inside the assemble stage, the readback inside retire's.
    assert total("snn/upload") < host["assemble"][0]


def test_host_time_counts_do_not_depend_on_the_profiler(profiled):
    server, stats, *_ = profiled
    off, off_stats, *_ = _serve(False)
    assert off_stats["chunks"] == stats["chunks"]
    assert ({k: n for k, (_, n) in off.host_time.items()}
            == {k: n for k, (_, n) in server.host_time.items()})
    assert all(sec > 0 for sec, _ in off.host_time.values())


def test_a_zero_budget_request_retires_outside_host_time():
    server = t_serve.SNNServer(backend="jnp", device="cpu", **SERVE)
    names = t_serve.make_demo_tenants(server, 8, seed=0)
    reqs = t_serve.make_demo_requests(server, names, 3, seed=1)
    reqs[1].n_ticks = 0
    log = get_span_log()
    log.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        server.serve_continuous(reqs)
    records = log.records()
    log.clear()
    retired = [r.attrs["rid"] for r in records if r.name == "snn/retire"]
    assert sorted(retired) == [r.rid for r in reqs]
    in_rounds = sum(r.seconds for r in records
                    if r.name in ("snn/readback", "snn/retire")
                    and r.attrs.get("rid") != reqs[1].rid)
    assert server.host_time["retire"][0] == pytest.approx(in_rounds, abs=1e-9)


def test_run_chunk_alone_still_runs():
    """The static-analysis gate runs ``_run_chunk`` outside ``serve_continuous``."""
    from repro_torch.analysis import programs
    from repro_torch.launch.serve import _Resident

    programs._serve_chunk_program(torch.device("cpu")).run()
    server, t = programs.demo_server(False, torch.device("cpu"))
    res = _Resident(server, "jnp", t)
    S = server.slots
    offset, until = np.zeros((S,), np.int64), np.zeros((S,), np.int32)
    budget = np.full((S,), server.max_ticks, np.int32)
    for _ in range(2):
        server._run_chunk(res, server._engine_for("jnp"), "jnp", server.chunk_ticks,
                          programs._requests(server, t), offset, budget, until, learning=False)
    host = server.host_time
    assert host["assemble"][1] == host["dispatch"][1] == 2
    assert host["fill"][1] == host["retire"][1] == 0
    assert float(res.counts.sum()) > 0


def test_profiled_serve_trace_shows_the_stage_spans(tmp_path, capsys):
    """The serve CLI's ``--profile`` path: the Chrome trace carries each stage
    span and the tick loop's scopes."""
    server = t_serve.SNNServer(backend="jnp", device="cpu", **SERVE)
    names = t_serve.make_demo_tenants(server, 8, seed=0)
    reqs = t_serve.make_demo_requests(server, names, 6, seed=1)
    t_serve.profiled_serve(server, reqs, str(tmp_path), continuous=True)
    trace = (tmp_path / "serve_trace.json").read_text()
    for name in ("snn/serve", "snn/fill", "snn/assemble", "snn/upload", "snn/chunk/jnp",
                 "snn/readback", "snn/retire", "tick/jnp"):
        assert f'"{name}"' in trace, name
    assert "host time under the profiler" in capsys.readouterr().out
    get_span_log().clear()


def test_span_sinks_when_off():
    reg = MetricsRegistry()
    h = reg.histogram("t_seconds", "a span", ("backend",))
    total = [0.0, 0]
    log = get_span_log()
    log.clear()
    for _ in range(3):
        with span("unit/off", histogram=h, total=total, on=False, backend="x"):
            pass
    with span("unit/nothing", on=False):
        pass
    assert total[1] == 3 and total[0] >= 0.0 and h.count(backend="x") == 3
    assert log.records() == []


def test_a_span_note_rides_on_the_record_and_the_labels_stay_checked():
    """``note`` goes onto the record only: the histogram is labelled by the
    attributes alone, and an attribute that is not one of its labels still
    raises."""
    reg = MetricsRegistry()
    h = reg.histogram("t_seconds", "a span", ("backend",))
    log = get_span_log()
    log.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("unit/noted", histogram=h, on=True, note={"graph": 1}, backend="x"):
            pass
    assert h.count(backend="x") == 1
    assert [(r.name, r.attrs) for r in log.records()] == [
        ("unit/noted", {"backend": "x", "graph": 1})]
    log.clear()
    with pytest.raises(ValueError, match="expected labels"):
        with span("unit/typo", histogram=h, on=False, bakend="x"):
            pass


def test_span_log_keeps_the_first_records_and_counts_the_rest():
    log = SpanLog(max_records=3)
    a = log.open("a", 10, {})
    b = log.open("b", 11, {"rid": 1})
    c = log.open("c", 12, {})
    d = log.open("d", 13, {})
    assert (a, b, c, d) == (0, 1, 2, -1) and log.dropped == 1
    for i, end in ((d, 14), (c, 15), (b, 16), (a, 17)):
        log.close(i, end)
    recs = log.records()
    assert [(r.name, r.parent, r.end_ns) for r in recs] == [("a", -1, 17), ("b", 0, 16),
                                                            ("c", 1, 15)]
    log.clear()
    assert log.records() == [] and log.dropped == 0


def test_span_log_parents_hold_across_threads():
    """Threads record at once (a short switch interval, more threads than a
    small host's cores): every inner record's parent is its own thread's
    outer one, and none is lost."""
    log = get_span_log()
    log.clear()
    n_threads, n_spans = 12, 150
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for j in range(n_spans):
                with span("t/outer", on=True, thread=k, j=j):
                    with span("t/inner", on=True, thread=k, j=j):
                        pass

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    recs = log.records()
    log.clear()
    assert len(recs) == 2 * n_threads * n_spans
    inner = [r for r in recs if r.name == "t/inner"]
    assert len(inner) == n_threads * n_spans
    for r in inner:
        outer = recs[r.parent]
        assert outer.name == "t/outer" and outer.attrs == r.attrs
        assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
    assert all(r.parent == -1 for r in recs if r.name == "t/outer")
    assert np.all([r.end_ns > 0 for r in recs])
