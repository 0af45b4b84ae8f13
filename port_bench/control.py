"""The control of the correctness check: the plain reference put in the
program's place, computed one precision down, has to come out wrong.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--precision tf32 bf16] [--chunks <n>]

For each seed and precision it makes the cell's inputs as a run does,
answers them with the reference at that precision (a serving cell: every
request of the pool; the stream: ``--chunks`` chunks from the zero state,
by default as many as a run compares, kept as a window keeps them) and
hands the answers to the cell's own check, which compares them with the
reference in float32. One JSON line per reading. It does not run the
program; the benchmark's runs never run it.
"""
import argparse
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def serving(drv, precision: str) -> None:
    from port_bench.reference import snn as ref

    nets = [ref.Tenant(t.payload, t.n, t.n_in, t.n_out, t.leak, t.refractory, drv.device)
            for t in drv.targets]
    ids = list(range(len(drv.entries)))
    got = ref.answers_of(nets, drv.entries, ids, precision)
    drv.fed = [(j, types.SimpleNamespace(counts=got[j], pred=int(ref.pred(got[j]))))
               for j in ids]


def streaming(drv, precision: str, chunks: int) -> None:
    import torch

    from port_bench.drivers import snn_stream
    from port_bench.reference import snn as ref

    c = drv.cfg
    n = c["n_neurons"]
    w, w_in = snn_stream.weights(c, drv.seed, drv.device)
    state = (torch.zeros(n, device=drv.device), torch.zeros(n, dtype=torch.int32,
                                                            device=drv.device),
             torch.zeros(n, device=drv.device))
    runs = []
    for i in range(chunks):
        raster, after = ref.stream(w, w_in, c["v_th"], c["leak"], c["r_ref"], state,
                                   drv.ext[i], precision)
        runs.append((i, state, raster, after))
        state = after
    del w, w_in
    drv.start, drv.kept = runs[0], runs[1:]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", nargs="+", default=["tf32", "bf16"])
    p.add_argument("--chunks", type=int, default=None,
                   help="the stream's chunks; by default as many as a run compares")
    p.add_argument("--device", default="cuda", help="tests: cpu")
    p.add_argument("--overrides", default="{}", help="JSON: configuration keys to replace")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import importlib

    import torch

    from port_bench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, cfg, mix = harness.resolve(bench, args.workload, ROOT)
    cfg = {**cfg, **json.loads(args.overrides)}
    mod = importlib.import_module(f"port_bench.drivers.{cfg['driver']}")
    for seed in args.seeds:
        for precision in args.precision:
            t0 = time.perf_counter()
            drv = mod.Driver(cfg, mix, seed, torch.device(args.device))
            drv.inputs()
            if cfg["driver"] == "snn_stream":
                streaming(drv, precision, args.chunks or 1 + int(cfg["check_chunks"]))
            else:
                serving(drv, precision)
            checks = drv.check()
            print(json.dumps({"workload": args.workload, "seed": seed, "precision": precision,
                              "checks": {k: {"value": v, "limit": lim} for k, v, lim in checks},
                              "fails": any(v > lim for _, v, lim in checks),
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
