"""The port stands alone: it never imports JAX or the reference package, and
its entry points never fall back to the CPU silently."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)", re.M)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    mods = _port_modules()
    assert {"repro_torch.launch.serve", "repro_torch.kernels.tick_fused",
            "repro_torch.kernels.lif_step", "repro_torch.kernels._build",
            "repro_torch.kernels.stdp_update", "repro_torch.plasticity.stdp",
            "repro_torch.plasticity.rules", "repro_torch.plasticity.traces",
            "repro_torch.kernels.event_dispatch", "repro_torch.core.dispatch_policy",
            "repro_torch.configs.snn_event", "repro_torch.kernels.spike_matmul",
            "repro_torch.core.classifier", "repro_torch.core.quant",
            "repro_torch.core.surrogate", "repro_torch.data.iris", "repro_torch.data.mnist",
            "repro_torch.configs.iris_snn", "repro_torch.configs.mnist_snn",
            "repro_torch.examples.quickstart", "repro_torch.examples.mnist_snn",
            "repro_torch.launch.serve_async",
            "repro_torch.examples.serve_multi_tenant", "repro_torch.configs.mnist_stdp",
            "repro_torch.examples.online_learning",
            "repro_torch.examples.reconfigure_runtime"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"the port imported {out.stdout.strip()}"


def test_no_source_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert offenders == []
    assert FORBIDDEN.search("from repro.core import x") and FORBIDDEN.search("import jax\n")
    assert not FORBIDDEN.search("from repro_torch.core import x")


def test_entry_points_default_to_the_card():
    """``device=None`` means cuda: without a GPU it raises, naming the GPU."""
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network import SNNState, params_from_registers
    from repro_torch.core.registers import RegisterBank
    from repro_torch.examples import online_learning, reconfigure_runtime, serve_multi_tenant
    from repro_torch.launch import serve_async
    from repro_torch.launch.serve import SNNServer

    calls = [lambda: SNNServer(n_max=8), lambda: params_from_registers(RegisterBank(4)),
             lambda: SNNState.zeros((1,), 4), lambda: LIFParams.make(4),
             lambda: serve_async.main(["--smoke"]),
             lambda: serve_multi_tenant.main(["--fast"]),
             lambda: online_learning.main([]), lambda: reconfigure_runtime.main([])]
    if torch.cuda.is_available():
        assert SNNState.zeros((1,), 4).tick.device.type == "cuda"
        assert SNNServer(n_max=8).device.index is not None
        assert not torch.backends.cuda.matmul.allow_tf32
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            call()


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs for real there")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path, env={"PATH": os.environ.get("PATH", "")})
    assert out.returncode != 0 and '"ok"' not in out.stdout
