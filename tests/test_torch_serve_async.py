"""The port's async serving front-end against the JAX package's.

The counterparts of ``tests/test_serve_async.py``: normal completion
resolves every future with real results, equal (counts and predictions
bitwise) to a direct ``serve_continuous`` of the same requests on the port
and on the reference's server; no new program goes into use across bursts;
every admission edge (queue overflow, per-tenant cap, shutdown, unknown
tenant) rejects before touching the device, counted by reason in
``snn_admission_rejections_total``. Servers as the reference's tests build
them: n_max 24, 4 slots, 12 ticks, ``event_density=0.2``, 6 demo tenants of
seed 0, on the CPU (``pallas_fused`` and ``jnp``, the kernels' plain twins).
"""
from __future__ import annotations

import asyncio
import threading

import numpy as np
import pytest
import torch

from repro.launch import serve as j_serve
from repro_torch.launch import serve as t_serve
from repro_torch.launch import serve_async
from repro_torch.launch.serve_async import AsyncSNNServer

KW = dict(n_max=24, slots=4, max_ticks=12, event_density=0.2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _server(backend="pallas_fused"):
    s = t_serve.SNNServer(backend=backend, device="cpu", **KW)
    return s, t_serve.make_demo_tenants(s, 6, seed=0)


def _req(mod, server, names, rid, *, n_ticks=4, tenant=None, seed=0):
    tenant = tenant or names[rid % len(names)]
    t = server.tenants[tenant]
    rng = np.random.default_rng(seed + rid)
    ext = ((rng.random((max(1, n_ticks), t.n_in)) < 0.3) * 200.0).astype(np.float32)
    return mod.ServeRequest(rid=rid, tenant=tenant, ext=ext, n_ticks=n_ticks)


def _rejections(server, reason):
    return server.registry.get("snn_admission_rejections_total").value(reason=reason)


def _burst(server, names, rids, **kw):
    async def go():
        front = AsyncSNNServer(server, max_queue=16, **kw)
        try:
            reqs = [_req(t_serve, server, names, i) for i in rids]
            return await asyncio.gather(*(front.submit(r) for r in reqs))
        finally:
            await front.aclose()

    return asyncio.run(go())


def test_requests_complete_with_results():
    server, names = _server()
    results = _burst(server, names, range(6))
    assert len(results) == 6
    for res in results:
        assert isinstance(res, t_serve.ServeResult)
        assert not res.rejected and res.counts is not None and res.ttft_s >= 0.0
    assert server.registry.get("snn_requests_total").value() == 6


@pytest.fixture(scope="module")
def reference_direct():
    j_server = j_serve.SNNServer(**KW)
    names = j_serve.make_demo_tenants(j_server, 6, seed=0)
    direct = [_req(j_serve, j_server, names, i) for i in range(4)]
    j_server.serve_continuous(direct)
    return names, direct


@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
def test_results_match_direct_continuous_serve(reference_direct, backend):
    names, j_direct = reference_direct
    twin, _ = _server(backend)
    direct = [_req(t_serve, twin, names, i) for i in range(4)]
    twin.serve_continuous(direct)
    server, _ = _server(backend)
    by_rid = {r.rid: r for r in _burst(server, names, range(4))}
    for d, jd in zip(direct, j_direct):
        np.testing.assert_array_equal(by_rid[d.rid].counts, d.counts)
        np.testing.assert_array_equal(by_rid[d.rid].counts, jd.counts)
        assert by_rid[d.rid].pred == d.pred == jd.pred


def test_zero_recompiles_across_bursts():
    server, names = _server()

    async def burst(front, base):
        reqs = [_req(t_serve, server, names, base + i) for i in range(4)]
        return await asyncio.gather(*(front.submit(r) for r in reqs))

    async def go():
        front = AsyncSNNServer(server, max_queue=16)
        try:
            await burst(front, 0)
            warm = (server.compiles, dict(server._compiles))
            await burst(front, 100)
            assert (server.compiles, dict(server._compiles)) == warm
        finally:
            await front.aclose()

    asyncio.run(go())
    assert server.compiles >= 2


def test_queue_overflow_rejected_and_counted():
    server, names = _server()

    async def go():
        front = AsyncSNNServer(server, max_queue=2)
        # Checked against a full queue directly: racing the worker is not.
        with front._lock:
            front._queue.extend(_req(t_serve, server, names, 90 + i) for i in range(2))
        res = await front.submit(_req(t_serve, server, names, 99))
        with front._lock:
            front._queue.clear()
        await front.aclose()
        return res

    res = asyncio.run(go())
    assert res.rejected and res.reason == "queue_full"
    assert _rejections(server, "queue_full") == 1


def test_tenant_cap_rejected_and_counted():
    server, names = _server()

    async def go():
        front = AsyncSNNServer(server, max_queue=16, tenant_cap=1)
        with front._lock:
            front._inflight[names[0]] = 1   # one already in flight
        res = await front.submit(_req(t_serve, server, names, 0, tenant=names[0]))
        with front._lock:
            front._inflight.clear()
        await front.aclose()
        return res

    res = asyncio.run(go())
    assert res.rejected and res.reason == "tenant_cap"
    assert _rejections(server, "tenant_cap") == 1


def test_unknown_tenant_rejected():
    server, _ = _server()

    async def go():
        front = AsyncSNNServer(server)
        try:
            r = t_serve.ServeRequest(rid=0, tenant="ghost", ext=np.zeros((2, 4), np.float32),
                                     n_ticks=2)
            return await front.submit(r)
        finally:
            await front.aclose()

    res = asyncio.run(go())
    assert res.rejected and res.reason == "unknown_tenant"
    assert _rejections(server, "unknown_tenant") == 1


def test_request_after_shutdown_rejected():
    server, names = _server()

    async def go():
        front = AsyncSNNServer(server)
        await front.aclose()
        return await front.submit(_req(t_serve, server, names, 0))

    res = asyncio.run(go())
    assert res.rejected and res.reason == "shutdown"
    assert _rejections(server, "shutdown") == 1
    assert server.registry.get("snn_requests_rejected_total").value() == 1


def test_constructor_validation():
    server, _ = _server()
    with pytest.raises(ValueError, match="max_queue"):
        AsyncSNNServer(server, max_queue=0)
    with pytest.raises(ValueError, match="tenant_cap"):
        AsyncSNNServer(server, tenant_cap=0)


def test_depth_returns_to_zero():
    server, names = _server()
    _burst(server, names, range(5))
    assert server.registry.get("snn_async_queue_depth").value() == 0
    assert server.registry.get("snn_async_submitted_total").value() == 5


def test_worker_runs_on_the_servers_device_and_close_joins():
    """The worker serves on the server's own device and ``close`` (sync)
    drains and joins it."""
    server, names = _server()
    seen = []
    run = server.serve_continuous

    def spy(*a, **k):
        seen.append((threading.current_thread().name, server.device))
        return run(*a, **k)

    server.serve_continuous = spy

    async def go(front):
        return await front.submit(_req(t_serve, server, names, 0))

    front = AsyncSNNServer(server)
    res = asyncio.run(go(front))
    front.close(timeout=60)
    assert not front._worker.is_alive()
    assert not res.rejected and seen and seen[0] == ("snn-serve-worker", torch.device("cpu"))


def test_smoke_cli_on_the_cpu(capsys):
    results = serve_async.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(results) == 12 and not any(r.rejected for r in results)
    assert "served 12/12 requests on cpu" in out and "snn_async_submitted_total 12" in out
