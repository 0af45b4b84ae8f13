"""The benchmark's one command.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It loads, warms up, measures for
``--seconds`` and prints one JSON line last on standard output; the numbers
the correctness check compared, each beside its limit, are the last lines
on standard error. It exits non-zero and prints no result when the cell's
CUDA devices are missing, when JAX or the JAX package was loaded, or when a
traced run recorded no device activity.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # One host thread for OpenMP's CPU ops too (see harness.one_thread).
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    # Caches inside the checkout, at fixed paths: only a cell's first run builds.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from port_bench import harness, trace

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=T_START, root=ROOT)
    except (harness.Refused, trace.NoDeviceActivity) as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
