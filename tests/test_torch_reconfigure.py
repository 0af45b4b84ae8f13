"""Runtime reconfiguration (the ``reconfigure_runtime`` example) and the
``mnist-stdp`` fabric served through the CLI, against the JAX package.

The reference example is loaded from ``examples/reconfigure_runtime.py``.
Its programs are integer data (u8 weights, u8 thresholds, 0/1 drive), so the
port's rasters must equal the reference's bitwise on every backend (the
kernel backends run their kernels' plain twins on the CPU).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.lif import LIFParams as JLIFParams
from repro.core.network import SNNParams as JSNNParams
from repro.core.network import SNNState as JSNNState
from repro.core.network import params_from_registers as j_params_from_registers
from repro.launch import serve as j_serve
from repro_torch.core.engine import EngineOptions, TickEngine
from repro_torch.examples import reconfigure_runtime as rc
from repro_torch.launch import serve as t_serve

ROOT = Path(__file__).resolve().parents[1]
TOTALS = [2344.0, 2288.0, 2344.0]   # the reference's spike totals on the CPU


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference_example("reconfigure_runtime")


def _reference_rasters():
    """The reference example's three programs, its tick program unrolled: a
    4-tick frozen rollout over 8 rows on its ``jnp`` engine."""
    bank = ref.make_bank()
    rasters = []
    for program in (ref.program_iris, ref.program_mnist, ref.program_iris):
        program(bank)
        p = j_params_from_registers(bank)
        lif = JLIFParams.make(ref.N, v_th=1.0)
        lif = JLIFParams(v_th=p.lif.v_th, leak=lif.leak, r_ref=lif.r_ref, gain=lif.gain,
                         i_bias=lif.i_bias, v_reset=lif.v_reset)
        params = JSNNParams(w=p.w, c=p.c, w_in=jnp.eye(ref.N), lif=lif)
        ext = jnp.zeros((4, 8, ref.N)).at[0, :, :4].set(1.0)
        _, raster = ref.ENGINE.rollout(params, JSNNState.zeros((8,), ref.N), ext, 4)
        rasters.append(np.asarray(raster))
    return rasters


def test_banks_are_the_reference_banks():
    for t_prog, j_prog in ((rc.program_iris, ref.program_iris),
                           (rc.program_mnist, ref.program_mnist)):
        tb, jb = rc.make_bank(), ref.make_bank()
        t_prog(tb)
        j_prog(jb)
        assert tb.serialize() == jb.serialize()
    assert rc.N == ref.N == 74


@pytest.mark.parametrize("backend", ["jnp", "pallas", "pallas_fused"])
def test_rasters_are_bitwise_the_reference(backend):
    want = _reference_rasters()
    assert [float(r.sum()) for r in want] == TOTALS
    out = rc.reconfigure(TickEngine(EngineOptions(backend=backend)), "cpu")
    for task, got, exp in zip(rc.TASKS, out["rasters"], want):
        assert got.shape == exp.shape == (4, 8, rc.N)
        np.testing.assert_array_equal(got, exp, err_msg=task)
    assert out["spikes"] == TOTALS
    assert out["programs"] == 1 and out["programs_so_far"] == [1, 1, 1]
    assert out["new_plans"] == 0 and "rebuilds" not in out


def test_main_runs_on_the_fused_kernel_backend_and_prints_one_program(capsys):
    """Deliberate difference: the port's example runs ``pallas_fused``
    (kernel B2 on the card); the reference's engine is ``jnp``. "One trace"
    is one program in use and no new launch plan."""
    assert rc.BACKEND == "pallas_fused"
    assert ref.ENGINE.options.backend == "jnp"
    out = rc.main(["--device", "cpu"])
    text = capsys.readouterr().out
    for total in TOTALS:
        assert f"{total:.0f} spikes, programs so far: 1" in text
    assert "ONE program, 0 new launch plans after the first" in text
    assert out["spikes"] == TOTALS


def test_serve_cli_serves_mnist_stdp_as_the_reference(capsys):
    argv = ["--arch", "mnist-stdp", "--slots", "4", "--requests", "8"]
    j_stats = j_serve.main(argv)
    t_stats = t_serve.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert "serving SNN fabric n_max=128" in text
    assert t_stats["preds"] == j_stats["preds"]
    assert t_stats["preds"] == {0: 0, 1: 1, 2: 9, 3: 0, 4: 0, 5: 1, 6: 1, 7: 2}
    assert t_stats["recompiles_after_warmup"] == j_stats["recompiles_after_warmup"] == 0
    assert t_stats["compiles"] == j_stats["compiles"]
    assert t_stats["backends"] == j_stats["backends"]
    by_rid = {r.rid: r for r in j_stats["results"]}
    assert len(t_stats["results"]) == len(by_rid) == 8
    for r in t_stats["results"]:
        np.testing.assert_array_equal(r.counts, by_rid[r.rid].counts, err_msg=str(r.rid))
