"""A run whose timed path is broken underneath comes out not correct: one
case for each fault a cell can have (a tick that hands its state on
unchanged, half the batch left out, an answer altered where it is made;
every cell is one chip, so there is no exchange to leave out)."""
import pytest
import torch

from port_bench.tests.conftest import small_run


def unchanged_tick(monkeypatch):
    from repro_torch.core import engine

    def tick_body(self, carry, xs, **kw):
        return carry, torch.zeros_like(carry.state.lif.y)

    monkeypatch.setattr(engine.TickEngine, "tick_body", tick_body)


def half_the_slots(monkeypatch):
    """The odd slots are left out of every chunk: their drive is never assembled."""
    from repro_torch.launch import serve

    real = serve.SNNServer._run_chunk

    def run_chunk(self, res, engine, backend, chunk, slot_req, *a, **kw):
        kept = [r if i % 2 == 0 else None for i, r in enumerate(slot_req)]
        return real(self, res, engine, backend, chunk, kept, *a, **kw)

    monkeypatch.setattr(serve.SNNServer, "_run_chunk", run_chunk)


def altered_counts(monkeypatch):
    """Slot 0's running counts gain a spike a chunk, where the program keeps them."""
    from repro_torch.launch import serve

    real = serve.SNNServer._run_chunk

    def run_chunk(self, res, *a, **kw):
        real(self, res, *a, **kw)
        res.counts[0] += 1.0

    monkeypatch.setattr(serve.SNNServer, "_run_chunk", run_chunk)


def half_the_fan_in(monkeypatch):
    """Half the presynaptic rows of ``W`` are left out of the hoisted product."""
    from repro_torch.core import engine

    def masked(params):
        w = params.w.clone()
        w[: w.shape[0] // 2] = 0
        return w

    monkeypatch.setattr(engine, "masked_weights", masked)


def altered_spike(monkeypatch):
    """One spike of every chunk's raster is flipped where the engine returns it."""
    from repro_torch.core import engine

    real = engine.TickEngine.chunk

    def chunk(self, *a, **kw):
        carry, raster = real(self, *a, **kw)
        raster[0, 0] = 1.0 - raster[0, 0]
        return carry, raster

    monkeypatch.setattr(engine.TickEngine, "chunk", chunk)


SERVING = [unchanged_tick, half_the_slots, altered_counts]
STREAM = [unchanged_tick, half_the_fan_in, altered_spike]


@pytest.mark.parametrize("cell,fault", [("snn-fused.dense-sat", f) for f in SERVING]
                         + [("snn-64k.stream", f) for f in STREAM],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = small_run(cell, seconds=0.3)
    assert res["correct"] is False, res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())

