"""The control at the tests' size: the reference one precision down, put in
the program's place, fails the cell's check, and at the stated precision
passes it. The serving cells' u8 grid is exact in TF32 and in bfloat16 (a
membrane below threshold stays below 256), so their control that fails is
float8; the stream's fails in bfloat16."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench.tests.conftest import SMALL

ROOT = Path(__file__).resolve().parents[2]


def control(cell: str, precisions, seeds=(2**33 + 11, 2**33 + 12, 2**33 + 13), chunks=8):
    out = subprocess.run(
        [sys.executable, str(ROOT / "port_bench/control.py"), "--workload", cell,
         "--seeds", *map(str, seeds), "--precision", *precisions, "--device", "cpu",
         "--chunks", str(chunks), "--overrides", json.dumps(SMALL[cell])],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(line) for line in out.stdout.splitlines()]


@pytest.mark.parametrize("cell,low", [("snn-fused.dense-sat", "fp8"),
                                      ("snn-64k.stream", "bf16")])
def test_control_fails_and_stated_precision_passes(cell, low):
    rows = control(cell, ["f32", low])
    assert all(r["fails"] for r in rows if r["precision"] == low)
    assert not any(r["fails"] for r in rows if r["precision"] == "f32")


def test_bf16_is_exact_on_the_u8_grid():
    rows = control("snn-fused.dense-sat", ["bf16"], seeds=(2**33 + 11,))
    assert not rows[0]["fails"]


@pytest.mark.cuda
def test_tf32_control_on_the_card(cuda_device):
    rows = control("snn-64k.stream", ["tf32", "bf16"], seeds=(2**33 + 11,))
    by = {r["precision"]: r["fails"] for r in rows}
    assert by == {"tf32": False, "bf16": True}
