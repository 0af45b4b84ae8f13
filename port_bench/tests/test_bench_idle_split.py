"""The idle split of ``idle_split.py``: on hand-made gaps and spans it
splits the idle time exactly, by overlap; on a CPU window of the serving
cell the program's dispatch spans match the profiler's events; and an
untraced run still reports the cell's metric set."""
import time

import pytest

from port_bench import idle_split
from port_bench.tests.conftest import SMALL, small_run


class Rec:
    """A span record as the program's ``SpanLog`` keeps it."""

    def __init__(self, name, start_us, end_us, parent=-1):
        self.name, self.parent = name, parent
        self.start_ns, self.end_ns = int(start_us * 1e3), int(end_us * 1e3)


def test_gaps_are_the_window_less_the_device_union():
    dev = [(10, 20, "a"), (15, 30, "b"), (40, 45, "c"), (44, 50, "d")]
    assert idle_split.device_gaps(dev, (0, 60)) == [(0, 10), (30, 40), (50, 60)]
    assert idle_split.device_gaps(dev, (10, 50)) == [(30, 40)]


def test_split_by_overlap_is_exact():
    """Gaps of 10 + 10 + 10 us over 2 chunks; the dispatch spans cover 4 us
    of the first gap and 7 of the second (one span across two gaps)."""
    gaps = [(0, 10), (30, 40), (50, 60)]
    records = [Rec("snn/serve", 0, 60),
               Rec("snn/fill", 0, 2, 0),
               Rec("snn/chunk/pallas_fused", 6, 33, 0),
               Rec("snn/readback", 33, 36, 0),
               Rec("snn/chunk/jnp", 36, 40, 0),
               Rec("snn/retire", 52, 55, 0)]
    got = idle_split.split(gaps, records, chunks=2)
    assert got["idle_in_dispatch_ms_per_chunk"] == pytest.approx((4 + 3 + 4) / 1e3 / 2)
    assert got["idle_outside_dispatch_ms_per_chunk"] == pytest.approx((30 - 11) / 1e3 / 2)
    assert sum(got.values()) == pytest.approx(30 / 1e3 / 2)
    stages = idle_split.by_stage(gaps, records)
    assert stages["snn/fill"] == pytest.approx(2e-6)
    assert stages["snn/readback"] == pytest.approx(3e-6)
    assert stages["snn/retire"] == pytest.approx(3e-6)
    assert stages["snn/serve"] == pytest.approx((30 - 2 - 11 - 3 - 3) * 1e-6)
    assert stages["outside"] == 0.0
    assert sum(stages.values()) == pytest.approx(30e-6)


def test_nested_spans_give_their_idle_to_the_innermost():
    gaps = [(0, 100)]
    records = [Rec("snn/assemble", 10, 50), Rec("snn/upload", 30, 40, 0),
               Rec("snn/chunk/jnp", 50, 70)]
    stages = idle_split.by_stage(gaps, records)
    assert stages == pytest.approx({"snn/assemble": 30e-6, "snn/upload": 10e-6,
                                    "snn/chunk/jnp": 20e-6, "outside": 40e-6})
    assert idle_split.split(gaps, records, 1)["idle_in_dispatch_ms_per_chunk"] == \
        pytest.approx(0.02)


def test_match_and_python_share():
    records = [Rec("snn/chunk/jnp", 10, 20), Rec("snn/chunk/jnp", 30, 41)]
    host = [(10.5, 19.9, "snn/chunk/jnp"), (30.2, 40.0, "snn/chunk/jnp"),
            (0, 100, "snn/serve")]
    m = idle_split.match(records, host, idle_split.DISPATCH)
    assert (m["matched"], m["recorded"], m["events"]) == (2, 2, 2)
    assert m["start_max_us"] == pytest.approx(0.5) and m["end_max_us"] == pytest.approx(1.0)
    assert m["end_p50_us"] == pytest.approx(0.55) and m["share_within"] == 1.0
    assert idle_split.match(records, host, "snn/chunk/", within_us=0.8)["share_within"] == 0.5
    assert idle_split.python_share([("python", 1.0), ("snn/fill", 3.0)]) == 0.25
    assert idle_split.python_share([]) == 0.0


def test_a_cpu_window_records_one_dispatch_span_per_chunk():
    """The serving cell's driver at the tests' size under the CPU profiler:
    the program's dispatch spans are the window's chunks and sit within 1 ms
    of the profiler's events of the same name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench import harness
    from port_bench.drivers.snn_server import Driver
    from repro_torch.obs.tracing import get_span_log

    bench = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    cell, cfg, mix = harness.resolve(bench, "snn-fused.dense-sat", harness.HERE.parent)
    drv = Driver({**cfg, **SMALL[cell["name"]]}, mix, 2**33 + 11, torch.device("cpu"))
    drv.setup()
    log = get_span_log()
    log.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        record = drv.window(0.3)
    records = log.records()
    log.clear()
    host = [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()]
    m = idle_split.match(records, host, idle_split.DISPATCH)
    assert m["matched"] == m["recorded"] == m["events"] == record["chunks"] > 0
    assert m["start_p50_us"] < 1e3 and m["end_p50_us"] < 1e3
    assert sum(r.name == "snn/serve" for r in records) == 1
    assert all(v <= lim for _, v, lim in drv.check())


def test_an_untraced_run_reports_the_same_metric_set():
    """The parent's set on the CPU (``tick_mfu.sat`` reads no peak there; the
    device-trace metrics need a traced run)."""
    t0 = time.perf_counter()
    out = small_run("snn-fused.dense-sat", read_layers=True)
    assert set(out["metrics"]) == {"setup_s", "goodput_slot_ticks_per_s",
                                   "host_ms_per_chunk.sat", "slot_occupancy.sat"}
    assert out["correct"] and time.perf_counter() - t0 < 120
