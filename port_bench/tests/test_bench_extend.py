"""A later change adds a cell with new files and BENCHMARK.json entries
only, and edits no file of the harness: a new configuration, mix and
per-layer metric; or a cell of files that are here already (the open-loop
rate cell that waits under PERF.md's open questions)."""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "src"


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "port_bench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def new_files(tmp: Path, bench: dict) -> tuple:
    """A new configuration, mix and per-layer metric, as files and entries."""
    cfg = json.loads((tmp / "port_bench/configs/snn-fused.json").read_text())
    cfg.update(name="snn-tiny", n_neurons=128, tenants=8, slots=4)
    (tmp / "port_bench/configs/snn-tiny.json").write_text(json.dumps(cfg))
    mix = {"kinds": ["dense", "ring"], "pool": 48, "short_share": 0.5, "short_ticks": [1, 3],
           "long_ticks": 16, "density": 0.5, "magnitude": [100, 200], "arrival": "backlog",
           "backlog": 2, "warmup": 8}
    (tmp / "port_bench/mixes/tiny-mixed.json").write_text(json.dumps(mix))
    (tmp / "port_bench/metrics/answers_per_s.py").write_text(
        "def read(run):\n    r = run.record\n    return r['attempted'] / r['window_s']\n")
    bench["configs"].append({"name": "snn-tiny", "source": "https://arxiv.org/abs/2512.10180",
                             "file": "port_bench/configs/snn-tiny.json", "reduced": [],
                             "why": "a test's fabric"})
    cell = "snn-tiny.mixed"
    bench["workloads"].append({"name": cell, "config": "snn-tiny", "traffic": "tiny-mixed",
                               "chips": 1, "why": "a test's cell"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "goodput_slot_ticks_per_s")["workloads"].append(cell)
    bench["per_layer"].append({"name": "answers_per_s.sat", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "scheduler",
                               "moves": "goodput_slot_ticks_per_s", "workloads": [cell]})
    return cell, {}, {"setup_s", "goodput_slot_ticks_per_s", "answers_per_s.sat"}


def rate_cell(tmp: Path, bench: dict) -> tuple:
    """The open-loop cell from the files that are here: entries only."""
    cell = "snn-fused.dense-rate"
    bench["workloads"].append({"name": cell, "config": "snn-fused", "traffic": "dense-rate",
                               "chips": 1, "why": "a test's cell"})
    for name in ("latency_p95_ms", "latency_p50_ms"):
        bench["end_to_end"].append({"name": name, "unit": "ms", "better": "lower",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": [cell]})
    bench["per_layer"].append({"name": "device_idle_share.rate", "unit": "%",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "latency_p95_ms",
                               "workloads": [cell]})
    return cell, {"n_neurons": 256, "tenants": 8}, {"setup_s", "latency_p95_ms",
                                                    "latency_p50_ms"}


@pytest.mark.parametrize("add", [new_files, rate_cell], ids=lambda f: f.__name__)
def test_a_cell_from_files_and_entries_only(tmp_path, add):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell, overrides, metrics = add(tmp_path, bench)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json, sys, time; sys.path[:0] = ['.', %r]; from port_bench import harness; "
            "print(json.dumps(harness.run(%r, 2**34 + 1, 0.3, False, t_start=time.perf_counter(), "
            "device='cpu', overrides=%r, read_layers=True)))" % (str(SRC), cell, overrides))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == metrics
    after = digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
