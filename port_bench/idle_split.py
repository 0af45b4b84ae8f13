"""Where the device waits in the serving loop: its idle time split by the
stage span the program's host was in.

    python3 port_bench/idle_split.py --workload snn-fused.dense-sat \\
        --seed <n> --seconds <s> [--out split.json]

One set-up and one window of the cell under ``torch.profiler`` on the card,
as a ``--trace 1`` run makes it. The program records each stage of its
continuous serving loop on the profiler's clock while a profiler runs
(``repro_torch.obs.tracing.get_span_log``). The device's idle gaps (the
window less the union of its operations, as ``trace.reduce`` computes them)
are split by interval overlap with those spans:

* ``idle_in_dispatch_ms_per_chunk``: idle time inside a ``snn/chunk/*``
  span (the device waiting while the host launches a chunk), over chunks;
* ``idle_outside_dispatch_ms_per_chunk``: the rest (the device waiting on
  the host's work between chunks), over the same chunks; the two sum to
  the idle time a chunk;
* ``idle_s_by_stage``: idle seconds under each stage's innermost span.

It also prints the share of idle time the ``trace.idle_gaps`` labels give
to ``python`` (no profiled op at a gap's middle: that of the longest gaps
only; ``idle_s_by_stage["outside"]`` is all idle time with no program span
open), how far the recorded
dispatch spans lie from the profiler's own events of the same name, and
the answers' check. One JSON line; ``--out`` writes it to a file too.
"""
from __future__ import annotations

import argparse
import bisect
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
DISPATCH = "snn/chunk/"

Interval = Tuple[float, float]


def device_gaps(dev: Iterable[Tuple[float, float, str]], window: Interval) -> List[Interval]:
    """The idle intervals (us) of ``window``: what ``trace.reduce`` computes
    from the same device events."""
    merged: List[List[float]] = []
    for s, e in sorted((s, e) for s, e, _ in dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [window[0]] + [x for se in merged for x in se] + [window[1]]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def overlap(gaps: Sequence[Interval], spans: Iterable[Interval]) -> float:
    """Length of ``gaps`` (disjoint) covered by the union of ``spans``."""
    starts = [a for a, _ in gaps]
    total, merged = 0.0, []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(gaps) and gaps[i][0] < e:
            total += max(0.0, min(e, gaps[i][1]) - max(s, gaps[i][0]))
            i += 1
    return total


def us(rec) -> Interval:
    """A span record's interval in microseconds (the profiler's unit)."""
    return rec.start_ns / 1e3, rec.end_ns / 1e3


def split(gaps: Sequence[Interval], records, chunks: int) -> Dict[str, float]:
    """The two metrics (ms a chunk): idle inside the dispatch spans, and the rest."""
    idle = sum(b - a for a, b in gaps)
    inside = overlap(gaps, [us(r) for r in records if r.name.startswith(DISPATCH)])
    return {"idle_in_dispatch_ms_per_chunk": inside / 1e3 / chunks,
            "idle_outside_dispatch_ms_per_chunk": (idle - inside) / 1e3 / chunks}


def by_stage(gaps: Sequence[Interval], records) -> Dict[str, float]:
    """Idle seconds under each span name's innermost records (a name's own
    time, its children's taken out; ``outside`` where no span was open)."""
    kids: Dict[int, list] = {}
    for i, r in enumerate(records):
        kids.setdefault(r.parent, []).append(i)
    out: Dict[str, float] = {}
    names = sorted({r.name for r in records})
    for name in names:
        own = [i for i, r in enumerate(records) if r.name == name]
        mine = overlap(gaps, [us(records[i]) for i in own])
        inner = overlap(gaps, [us(records[j]) for i in own for j in kids.get(i, [])])
        out[name] = (mine - inner) / 1e6
    idle = sum(b - a for a, b in gaps)
    tops = [us(r) for r in records if r.parent == -1]
    out["outside"] = (idle - overlap(gaps, tops)) / 1e6
    return out


def match(records, host: Iterable[Tuple[float, float, str]], prefix: str,
          within_us: float = 50.0) -> Dict[str, float]:
    """The recorded spans named ``prefix...`` against the profiler's host
    events of the same name, in order: how many matched, the median, 99th
    percentile and largest start and end differences (us), and the share of
    records whose start and end both lie within ``within_us``."""
    events: Dict[str, List[Interval]] = {}
    for s, e, name in sorted(h for h in host if h[2].startswith(prefix)):
        events.setdefault(name, []).append((s, e))
    seen: Dict[str, int] = {}
    ds, de = [], []
    for r in sorted((r for r in records if r.name.startswith(prefix)), key=lambda r: r.start_ns):
        k = seen.get(r.name, 0)
        seen[r.name] = k + 1
        if k >= len(events.get(r.name, [])):
            continue
        s, e = events[r.name][k]
        a, b = us(r)
        ds.append(abs(s - a))
        de.append(abs(e - b))
    out = {"matched": len(ds), "recorded": sum(seen.values()),
           "events": sum(len(v) for v in events.values())}
    if ds:
        d0, d1 = np.array(ds), np.array(de)
        for key, d in (("start", d0), ("end", d1)):
            p50, p99 = np.percentile(d, [50, 99])
            out.update({f"{key}_p50_us": float(p50), f"{key}_p99_us": float(p99),
                        f"{key}_max_us": float(d.max())})
        out["share_within"] = float(np.mean((d0 <= within_us) & (d1 <= within_us)))
    return out


def python_share(labels: Sequence[Tuple[str, float]]) -> float:
    total = sum(s for _, s in labels)
    return sum(s for k, s in labels if k == "python") / total if total else 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="snn-fused.dense-sat")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from port_bench import harness, trace
    from repro_torch.obs.tracing import get_span_log

    t_start = time.perf_counter()
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, cfg, mix = harness.resolve(bench, args.workload, ROOT)
    dev = harness.device_for(cell, None)
    harness.one_thread()
    drv = importlib.import_module(f"port_bench.drivers.{cfg['driver']}").Driver(
        cfg, mix, args.seed, dev)
    drv.setup()
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    log = get_span_log()
    log.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(trace.WINDOW):
            record = drv.window(args.seconds)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    records, dropped = log.records(), log.dropped
    log.clear()
    devs, host, window = [], [], None
    for name, on_device, s, e in trace._events(prof, DeviceType.CUDA):
        if on_device:
            if not name.startswith(trace.ANNOTATIONS):
                devs.append((s, e, name))
        elif name == trace.WINDOW:
            window = (s, e)
        else:
            host.append((s, e, name))
    del prof
    tr = trace.reduce(devs, host, window, wall)
    gaps = device_gaps(devs, window)
    chunks = record["chunks"]
    out = split(gaps, records, chunks)
    idle_s = sum(b - a for a, b in gaps) / 1e6
    out.update({
        "workload": args.workload, "seed": args.seed, "setup_s": setup_s,
        "window_s": tr.window_s, "busy_s": tr.busy_s,
        "device_idle_share": 100.0 * (1.0 - tr.busy_s / tr.window_s),
        "idle_s": idle_s, "chunks": chunks,
        "idle_ms_per_chunk_from_share": (1.0 - tr.busy_s / tr.window_s) * tr.window_s
        * 1e3 / chunks,
        "host_ms_per_chunk": 1e3 * (record["host_s"]["assemble"] + record["host_s"]["dispatch"])
        / chunks,
        "goodput_slot_ticks_per_s": record["useful_slot_ticks"] / record["window_s"],
        "idle_s_by_stage": by_stage(gaps, records),
        "python_share_of_labelled_idle": python_share(tr.idle_gaps),
        "labelled_idle_s": sum(s for _, s in tr.idle_gaps),
        "idle_gaps": [[k, s] for k, s in tr.idle_gaps[:trace.TOP]],
        "dispatch_spans_vs_profiler": match(records, host, DISPATCH),
        "spans": len(records), "spans_dropped": dropped,
        "device": torch.cuda.get_device_name(dev),
    })
    drv.release()
    out["checks"] = {name: [v, lim] for name, v, lim in drv.check()}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
