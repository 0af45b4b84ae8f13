"""On the card: served frozen chunks replayed as one CUDA graph each, held
bitwise to the same chunks run eager.

On each dense program (``pallas_fused``: kernel B2, the telemetry kernel
and the drive's cuBLAS product on every tick; ``pallas``, whose frozen tick
reads ``w`` and ``c``; ``jnp``), two servers of the same demo tenants serve
the same four calls; the second has the graph path switched off by patching
:func:`repro_torch.launch.serve.chunk_graph_engages`. After every chunk the
resident's state, counts and telemetry are compared, and at the end every
count, prediction, tenant report and learned weight. The calls: frozen
tenants in 2-tick chunks with tenants swapped into slots between replays,
the same at 4 ticks (a second capture), a group that learns on every chunk
(no capture, no replay), and frozen tenants at 2 ticks again: a new group
that replays the first group's graph from the reseeded resident, or, where
the learning group handed back new weights, captures anew.

The file imports no JAX, so it runs where the card is (without the
conftest and the warning filters, which import the JAX package):
``PYTHONPATH=src python -m pytest -q -p no:cacheprovider -p no:warnings
--noconftest tests/test_torch_chunk_graph.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.launch import serve as t_serve

KW = dict(n_max=64, slots=4, max_ticks=12)
BACKENDS = ("jnp", "pallas", "pallas_fused")


def _calls(server, names):
    """Frozen requests at chunk 2, again at chunk 4, then a learning group:
    the plastic tenant (the last) at the full budget beside three frozen
    requests, so every chunk of that group learns; then frozen requests at
    chunk 2 again."""
    frozen = names[:-1]
    learn = t_serve.make_demo_requests(server, [names[-1]] + frozen[:3], server.slots,
                                       seed=3)
    learn[0].n_ticks = server.max_ticks
    return [(t_serve.make_demo_requests(server, frozen, 24, seed=1), 2),
            (t_serve.make_demo_requests(server, frozen, 12, seed=2), 4),
            (learn, 4),
            (t_serve.make_demo_requests(server, frozen, 12, seed=5), 2)]


def _serve(dev, backend: str, graphs: bool, monkeypatch):
    server = t_serve.SNNServer(device=dev, backend=backend, **KW)
    names = t_serve.make_demo_tenants(server, 8, seed=0)
    log, fills, w_ptrs = [], [], []
    run, fill = server._run_chunk, t_serve._Resident.fill

    def watched(res, engine, backend, chunk, slot_req, offset, budget, until, *, learning):
        replays = server._c_graph_replays.value(backend=backend)
        run(res, engine, backend, chunk, slot_req, offset, budget, until, learning=learning)
        st = res.state
        log.append({"learning": learning,
                    "replayed": server._c_graph_replays.value(backend=backend) > replays,
                    "state": [x.clone() for x in (st.lif.v, st.lif.r, st.lif.y, st.tick)],
                    "counts": res.counts.clone(), "telem": res.telem.buf.clone()})

    def counted(res, i, t):
        fills.append(len(log))
        fill(res, i, t)

    server._run_chunk = watched
    monkeypatch.setattr(t_serve._Resident, "fill", counted)
    if not graphs:
        monkeypatch.setattr(t_serve, "chunk_graph_engages", lambda *a: False)
    out = []
    for reqs, chunk in _calls(server, names):
        stats = server.serve_continuous(reqs, chunk_ticks=chunk)
        out.append((reqs, stats))
        w_ptrs.append(server._residents[backend].w.data_ptr())
    torch.cuda.synchronize(dev)
    monkeypatch.undo()
    return server, names, out, log, fills, w_ptrs


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS)
def test_cuda_chunk_graph_replays_equal_the_eager_chunks(backend, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and kernel B2 run only on the card")
    dev = torch.device("cuda", torch.cuda.current_device())
    se, names, eager, log_e, _, _ = _serve(dev, backend, False, monkeypatch)
    sg, _, graph, log_g, fills, w_ptrs = _serve(dev, backend, True, monkeypatch)

    # The counters: one capture a chunk size; every frozen chunk but the
    # first of its size a replay (the captured chunk's work is its first);
    # none in the learning group. The last group replays the first one's
    # graph from its first chunk, unless the learning group handed back new
    # weights, which drops the graphs: then it captures anew.
    (_, s2), (_, s4), (_, s_learn), (_, s2b) = graph
    moved = w_ptrs[2] != w_ptrs[1]
    reg = sg.registry
    assert reg.get("snn_chunk_graph_captures_total").value(backend=backend) == 2 + moved
    assert reg.get("snn_chunk_graph_replays_total").value(backend=backend) == (
        s2["chunks"] - 1) + (s4["chunks"] - 1) + (s2b["chunks"] - moved)
    assert reg.get("snn_chunks_total").value(backend=backend) == (
        s2["chunks"] + s4["chunks"] + s_learn["chunks"] + s2b["chunks"])
    for name in t_serve.GRAPH_COUNTERS:
        assert se.registry.get(name).value(backend=backend) == 0
    first = s2["chunks"] + s4["chunks"]
    learning = log_g[first:first + s_learn["chunks"]]
    assert all(c["learning"] and not c["replayed"] for c in learning)
    assert sum(c["learning"] for c in log_g) == s_learn["chunks"]
    assert all(c["replayed"] for c in log_g[first + s_learn["chunks"] + moved:])

    # A tenant swapped into a slot between two replays of one group (a
    # fill counted before chunk ``f`` of the first call).
    replayed = [i for i, c in enumerate(log_g[:s2["chunks"]]) if c["replayed"]]
    assert any(replayed[0] < f <= replayed[-1] for f in fills), (fills, replayed)

    # Chunk by chunk, and every answer: bitwise.
    assert len(log_g) == len(log_e)
    for i, (g, e) in enumerate(zip(log_g, log_e)):
        for key in ("counts", "telem"):
            assert torch.equal(g[key], e[key]), (i, key)
        for a, b in zip(g["state"], e["state"]):
            assert torch.equal(a, b), i
    for (reqs_g, st_g), (reqs_e, st_e) in zip(graph, eager):
        assert st_g["preds"] == st_e["preds"]
        for a, b in zip(reqs_g, reqs_e):
            np.testing.assert_array_equal(a.counts, b.counts, err_msg=str(a.rid))
    assert sg.tenant_report() == se.tenant_report()
    assert len(sg._residents) == 1
    learner = names[-1]
    assert torch.equal(sg.tenants[learner].params.w, se.tenants[learner].params.w)


@pytest.mark.cuda
def test_cuda_async_worker_captures_in_its_own_thread(monkeypatch):
    """``AsyncSNNServer``'s worker thread captures and replays (thread-local
    capture mode) and its answers equal the eager chunks'."""
    import asyncio

    from repro_torch.launch.serve_async import AsyncSNNServer

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and kernel B2 run only on the card")
    dev = torch.device("cuda", torch.cuda.current_device())

    def server():
        s = t_serve.SNNServer(device=dev, backend="pallas_fused", chunk_ticks=2, **KW)
        return s, t_serve.make_demo_tenants(s, 8, seed=0)

    se, names = server()
    eager = t_serve.make_demo_requests(se, names[:-1], 16, seed=4)
    with monkeypatch.context() as m:
        m.setattr(t_serve, "chunk_graph_engages", lambda *a: False)
        se.serve_continuous(eager)
    sg, _ = server()
    reqs = t_serve.make_demo_requests(sg, names[:-1], 16, seed=4)

    async def go():
        front = AsyncSNNServer(sg, max_queue=32, tenant_cap=16)
        try:
            return await asyncio.gather(*(front.submit(r) for r in reqs))
        finally:
            await front.aclose()

    results = {r.rid: r for r in asyncio.run(go())}
    for r in eager:
        np.testing.assert_array_equal(results[r.rid].counts, r.counts, err_msg=str(r.rid))
        assert results[r.rid].pred == r.pred
    # Every request runs at least 4 ticks, so the server runs at least two
    # frozen chunks of 2: one capture, however many groups the worker's
    # bursts make, and a replay for every frozen chunk after the first.
    reg = sg.registry
    assert reg.get("snn_chunk_graph_captures_total").value(backend="pallas_fused") == 1
    assert reg.get("snn_chunk_graph_replays_total").value(backend="pallas_fused") == (
        reg.get("snn_chunks_total").value(backend="pallas_fused") - 1)
