"""The sweep that finds the highest rate the server sustains.

    python3 port_bench/sweep.py --config snn-fused --traffic dense-rate \\
        --seed <n> --seconds 6 --rates 500 600 700 ...

One set-up, then one open-loop window a rate, each served to the end: the
requests offered, their latency quantiles, and the median latency of the
last fifth of the window against the first fifth (a growing backlog shows
as a ratio well above 1). Run once, when a rate cell is defined; its rate
goes into the cell's mix file (``mixes/dense-rate.json`` holds the rate
the sweep found for the open-loop cell that PERF.md lists as pending). One
JSON line a rate.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True, help="a mix with poisson arrivals")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import importlib

    import torch

    from port_bench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cfg, mix = harness.parts(bench, args.config, args.traffic, ROOT)
    cell = {"name": f"{args.config}.{args.traffic}", "chips": 1}
    harness.one_thread()
    drv = importlib.import_module(f"port_bench.drivers.{cfg['driver']}").Driver(
        cfg, dict(mix), args.seed, harness.device_for(cell, None))
    drv.setup()
    for rate in args.rates:
        drv.mix["rate_per_s"] = rate
        drv.fed.clear()
        t0 = time.perf_counter()
        rec = drv.window(args.seconds)
        lat = np.array(rec["latencies_s"]) * 1e3
        fifth = max(1, len(lat) // 5)
        print(json.dumps({
            "rate_per_s": rate, "offered": len(lat), "failed": rec["failed"],
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)), "max_ms": float(lat.max()),
            "growth": float(np.median(lat[-fifth:]) / np.median(lat[:fifth])),
            "goodput": rec["useful_slot_ticks"] / rec["window_s"],
            "served_s": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
