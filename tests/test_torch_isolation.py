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
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro|ml_dtypes)(?:\.|\s|$)", re.M)


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
            "repro_torch.examples.reconfigure_runtime", "repro_torch.parallel.snn_sharding",
            "repro_torch.launch.mesh", "repro_torch.parallel.mesh",
            "repro_torch.configs.snn_64k", "repro_torch.kernels.launch_spec",
            "repro_torch.analysis", "repro_torch.analysis.findings",
            "repro_torch.analysis.launch_rules", "repro_torch.analysis.op_rules",
            "repro_torch.analysis.sharding_rules", "repro_torch.analysis.static_rules",
            "repro_torch.analysis.programs", "repro_torch.analysis.check",
            "repro_torch.models", "repro_torch.models.common", "repro_torch.models.attention",
            "repro_torch.models.ffn", "repro_torch.models.transformer",
            "repro_torch.models.model", "repro_torch.models.ssm", "repro_torch.models.rwkv",
            "repro_torch.examples.serve_lm",
            "repro_torch.configs.smollm_135m", "repro_torch.configs.smollm_360m",
            "repro_torch.configs.qwen3_0_6b", "repro_torch.configs.starcoder2_15b",
            "repro_torch.configs.musicgen_large", "repro_torch.configs.llama4_scout_17b_a16e",
            "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.jamba_1_5_large_398b",
            "repro_torch.configs.llama_3_2_vision_90b",
            "repro_torch.configs.rwkv6_1_6b",
            "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.adafactor",
            "repro_torch.optim.clip", "repro_torch.optim.schedule",
            "repro_torch.optim.compression", "repro_torch.data.synthetic",
            "repro_torch.data.pipeline", "repro_torch.checkpoint",
            "repro_torch.checkpoint.checkpointer", "repro_torch.runtime",
            "repro_torch.runtime.fault_tolerance", "repro_torch.runtime.straggler",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.examples.train_lm", "repro_torch.util.tree",
            "repro_torch.parallel.sharding", "repro_torch.runtime.elastic",
            "repro_torch.util.numerics"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.')\n"
        "             or m == 'ml_dtypes' or m.startswith('ml_dtypes.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"the port imported {out.stdout.strip()}"


def test_the_core_engine_imports_no_launch_layer():
    """The engine checks a mesh by the collectives it calls, so importing it,
    and giving it a mesh, loads no launcher module (the mesh lives in
    ``repro_torch.parallel``)."""
    code = (
        "import sys\n"
        "from repro_torch.core.engine import EngineOptions\n"
        "before = sorted(m for m in sys.modules if m.startswith(('repro_torch.launch',\n"
        "                                                          'repro_torch.parallel')))\n"
        "from repro_torch.parallel.mesh import make_snn_mesh\n"
        "EngineOptions(mesh=make_snn_mesh(1, device='cpu'), backend='pallas_fused')\n"
        "after = sorted(m for m in sys.modules if m.startswith('repro_torch.launch'))\n"
        "print(','.join(before + after))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"the engine loaded {out.stdout.strip()}"


def test_no_source_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert offenders == []
    assert FORBIDDEN.search("from repro.core import x") and FORBIDDEN.search("import jax\n")
    assert not FORBIDDEN.search("from repro_torch.core import x")
    assert FORBIDDEN.search("import ml_dtypes\n")


def test_entry_points_default_to_the_card():
    """``device=None`` means cuda: without a GPU it raises, naming the GPU."""
    from repro_torch.analysis import check
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network import SNNState, params_from_registers
    from repro_torch.core.registers import RegisterBank
    from repro_torch.configs import get_bundle
    from repro_torch.examples import (online_learning, reconfigure_runtime, serve_lm,
                                      serve_multi_tenant)
    from repro_torch.launch import serve as t_serve
    from repro_torch.launch import serve_async
    from repro_torch.launch.serve import SNNServer, WaveServer
    from repro_torch.models import model as M
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.examples import train_lm
    from repro_torch.launch import dryrun, steps, train

    lm = get_bundle("smollm-135m").smoke
    calls = [lambda: SNNServer(n_max=8), lambda: params_from_registers(RegisterBank(4)),
             lambda: SNNState.zeros((1,), 4), lambda: LIFParams.make(4),
             lambda: serve_async.main(["--smoke"]),
             lambda: serve_multi_tenant.main(["--fast"]),
             lambda: online_learning.main([]), lambda: reconfigure_runtime.main([]),
             lambda: check.main(["--program", "tick/jnp/frozen/notelem"]),
             lambda: t_serve.main([]), lambda: serve_lm.main([]),
             lambda: M.init(lm, torch.Generator()), lambda: M.init_cache(lm, 1, 8),
             lambda: WaveServer(lm, {}, slots=1, max_len=8),
             lambda: t_serve.serve(lm, {}, [t_serve.ServeRequest(rid=0)]),
             lambda: train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"]),
             lambda: train_lm.main([]),
             lambda: pipeline.make_batch(lm, ShapeConfig("t", "train", 4, 1),
                                         pipeline.PipelineState(17, 0)),
             lambda: steps.init_train_state(lm, get_bundle("smollm-135m").parallel["*"],
                                            torch.Generator()),
             lambda: dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k"])]
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
