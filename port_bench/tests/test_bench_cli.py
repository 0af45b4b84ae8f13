"""The command's refusals: no result line without the cell's card, and none
from a directory that holds only BENCHMARK.json and the benchmark's files."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "snn-fused.dense-sat", "--seed", str(2**33 + 5), "--seconds", "0.2",
        "--trace", "0"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(ROOT / "port_bench/run.py"), *ARGS],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import json, sys, time; sys.path[:0] = ['.']; from port_bench import harness; "
            "print(json.dumps(harness.run('snn-fused.dense-sat', 5, 0.2, False, "
            "t_start=time.perf_counter(), device='cpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, str(ROOT / "port_bench/run.py"), *ARGS],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
