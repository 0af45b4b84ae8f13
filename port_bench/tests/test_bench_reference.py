"""The port against the plain reference at small sizes, on the CPU."""
import numpy as np
import pytest
import torch

from port_bench import tenants
from port_bench.drivers import snn_stream
from port_bench.reference import snn as ref
from port_bench.tests.conftest import SMALL, small_run


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_correct_at_small_size(cell):
    res = small_run(cell, read_layers=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "checks"


def test_register_decode_matches_the_program():
    from repro_torch.core.network import params_from_registers
    from repro_torch.core.registers import RegisterBank, WeightLayout

    for img in tenants.make_images(2**40 + 3, 96, 8):
        bank = RegisterBank(img.n, weight_layout=WeightLayout.PER_SYNAPSE)
        bank.load_bytes(img.payload)
        p = params_from_registers(bank, device="cpu")
        c, th, w = ref.decode(img.payload, img.n)
        assert np.array_equal(p.c.numpy(), c.astype(np.float32))
        assert np.array_equal(p.w.numpy(), w.astype(np.float32))
        assert np.array_equal(p.lif.v_th.numpy(), th.astype(np.float32))
        assert int(c.sum()) == img.nnz


def test_every_seed_gets_the_same_sizes():
    a = sorted((t.kind, t.n) for t in tenants.make_images(1, 512, 16))
    b = sorted((t.kind, t.n) for t in tenants.make_images(2**35, 512, 16))
    assert a == b


def test_stream_reference_matches_the_engine():
    from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network_types import SNNParams, SNNState

    cfg = {"n_neurons": 256, "n_in": 32, "w_levels": [-3, 3], "w_in_levels": [0, 256],
           "w_in_step": 2.0 ** -11, "v_th": 4.0, "leak": 0.25, "r_ref": 1, "chunk_ticks": 8}
    dev = torch.device("cpu")
    w, w_in = snn_stream.weights(cfg, 99, dev)
    ext = snn_stream.drive(cfg, {"density": 0.3}, 99, dev, 3)
    n = cfg["n_neurons"]
    lif = LIFParams.make(n, v_th=4.0, leak=0.25, r_ref=1, device=dev)
    eng = TickEngine(EngineOptions(mode="fixed_leak", backend="jnp"))
    carry = TickCarry(state=SNNState.zeros((), n, device=dev))
    state = (torch.zeros(n), torch.zeros(n, dtype=torch.int32), torch.zeros(n))
    spikes = 0
    for i in range(3):
        carry, raster = eng.chunk(SNNParams(w=w, c=None, w_in=w_in, lif=lif), carry, ext[i], 8)
        want, state = ref.stream(w, w_in, 4.0, 0.25, 1, state, ext[i])
        assert torch.equal(raster, want)
        assert torch.equal(carry.state.lif.v, state[0])
        spikes += int(want.sum())
    assert spikes > 0


def test_stream_keeps_only_the_sampled_chunks():
    """The window keeps ``check_chunks`` chunks drawn from the seed, each with
    both of its states, and nothing of the others."""
    import json

    from port_bench import harness

    bench = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    _, cfg, mix = harness.resolve(bench, "snn-64k.stream", harness.HERE.parent)
    cfg = {**cfg, **SMALL["snn-64k.stream"]}
    drv = snn_stream.Driver(cfg, mix, 2**33 + 3, torch.device("cpu"))
    drv.setup()
    rec = drv.window(0.3)
    m = int(cfg["check_chunks"])
    assert rec["chunks"] > m
    assert len(drv.kept) == m
    assert all(len(k) == 4 and all(s is not None for s in (k[1], k[3])) for k in drv.kept)
    assert json.dumps(drv.check()) == json.dumps([["wrong_spikes_and_state", 0, 0]])
