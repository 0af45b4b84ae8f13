"""One run of one cell: resolve it from ``BENCHMARK.json``, set up, measure,
check, and build the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``configs/<config>.json`` (which names its driver,
``drivers/<driver>.py``), ``mixes/<traffic>.json``, and for each metric
``metrics/<name>.py`` or, failing that, ``metrics/<stem>.py`` with the stem
the name up to its first dot (``device_idle_share.rate`` is read by
``device_idle_share.py``). A reader's ``read(run)`` returns a number, or
None when the run holds nothing for it to read; the metric is then left out
of the line.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """The run cannot produce a result (no card, a forbidden module, no trace)."""


@dataclasses.dataclass
class Run:
    """What a metric reader sees: the cell, its configuration and mix, the
    driver's record of the window, the set-up time and, in a traced run, the
    trace and the card's name."""

    cell: dict
    config: dict
    mix: dict
    record: dict
    setup_s: float
    kind: str
    trace: Optional[object] = None


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def resolve(bench: dict, workload: str, root: Path):
    """``(cell, config, mix)`` of the cell named ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    return (cell,) + parts(bench, cell["config"], cell["traffic"], root)


def parts(bench: dict, config: str, traffic: str, root: Path):
    """``(config, mix)``: a configuration of ``bench`` by name and a mix file
    by name (the sweep pairs them before a cell exists)."""
    configs = {c["name"]: c for c in bench["configs"]}
    return load_json(root / configs[config]["file"]), load_json(HERE / "mixes" / f"{traffic}.json")


def metrics_of(bench: dict, cell: dict, trace: bool) -> List[dict]:
    """The metrics this cell reports: with ``trace`` the per-layer ones, else
    the end-to-end ones; a metric with ``workloads`` only in those cells, one
    without it (per-layer) wherever the end-to-end metric it moves is
    reported."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str):
    """The ``read`` function of metric ``name`` (its own file, else its stem's)."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for metric {name!r} under {HERE / 'metrics'}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_forbidden(preloaded: set, during: str) -> None:
    """``Refused`` when a forbidden module beyond ``preloaded`` is loaded."""
    found = sorted(set(forbidden_modules()) - preloaded)
    if found:
        raise Refused(f"loaded by the end of {during}: {', '.join(found)}")


def device_for(cell: dict, device: Optional[str]):
    """The card to run on; ``Refused`` when the cell's chips are not there.
    ``device`` set (tests) skips the look for a card."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        raise Refused(f"cell {cell['name']} needs {cell['chips']} CUDA device(s); "
                      f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return torch.device("cuda", 0)


def one_thread() -> None:
    """One host thread for PyTorch's CPU ops (a pool of four halved the
    host-bound serving loop part-way through runs on the card)."""
    import torch

    torch.set_num_threads(1)


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        root: Path = HERE.parent, device: Optional[str] = None,
        overrides: Optional[dict] = None, read_layers: bool = False) -> Dict:
    """One run; returns the result object. The tests' keywords: ``device``
    skips the look for a card (and the module check then counts only what
    the run itself loads, since the test process may hold the JAX package
    already), ``overrides`` replaces keys of the
    configuration (small sizes), ``read_layers`` also reads the per-layer
    metrics in an untraced run (those that need the trace read nothing)."""
    import torch

    from port_bench import trace as tracing

    preloaded = set(forbidden_modules()) if device is not None else set()
    bench = load_json(root / "BENCHMARK.json")
    cell, config, mix = resolve(bench, workload, root)
    config = {**config, **(overrides or {})}
    dev = device_for(cell, device)
    one_thread()
    drv = importlib.import_module(f"port_bench.drivers.{config['driver']}").Driver(
        config, mix, seed, dev)
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # What set-up made lives on: keep the collector from walking it in the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    tr = None
    if trace:
        if dev.type != "cuda":
            raise Refused("a traced run needs the card")
        record, tr = tracing.traced(lambda: drv.window(seconds))
    else:
        record = drv.window(seconds)
    refuse_forbidden(preloaded, "the window")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    drv.release()
    checks = drv.check()
    run_view = Run(cell=cell, config=config, mix=mix, record=record, setup_s=setup_s,
                   kind=kind, trace=tr)
    metrics = {}
    wanted = metrics_of(bench, cell, trace)
    if read_layers and not trace:
        wanted += metrics_of(bench, cell, True)
    for m in wanted:
        value = reader(m["name"])(run_view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    # The check and the readers (loaded by path) ran after the window: look again.
    refuse_forbidden(preloaded, "the check or the metric readers")
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": int(record["attempted"]), "failed": int(record["failed"]),
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result
