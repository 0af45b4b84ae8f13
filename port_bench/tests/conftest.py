"""The benchmark's own tests: ``python -m pytest port_bench/tests`` from the
root of the checkout. Tests marked ``cuda`` need the card and skip without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The tests' sizes: the program on the CPU, the reference beside it.
SMALL = {
    "snn-fused.dense-sat": {"n_neurons": 256, "tenants": 8},
    "snn-64k.stream": {"n_neurons": 256, "check_chunks": 4},
}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def small_run(cell: str, seed: int = 2**33 + 7, seconds: float = 0.4, **kw):
    """One run of ``cell`` at the tests' size on the CPU."""
    import time

    from port_bench import harness

    return harness.run(cell, seed, seconds, False, t_start=time.perf_counter(),
                       device="cpu", overrides=SMALL[cell], **kw)
