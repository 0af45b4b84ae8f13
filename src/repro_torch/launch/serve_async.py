"""Async front-end for the continuous-admission SNN server.

Counterpart of ``repro.launch.serve_async``. :class:`AsyncSNNServer` puts an
asyncio face on :meth:`repro_torch.launch.serve.SNNServer.serve_continuous`:
callers ``await submit(request)`` and get a :class:`ServeResult` back as soon
as *their* request retires from its slot, not when a whole batch drains. One
worker thread runs the chunked scheduler; the event loop never waits on the
device.

The seam between the two worlds is narrow:

* ``submit`` stamps the enqueue time (so TTFT measures queueing and
  compute), applies admission control, and parks an ``asyncio.Future``.
* The worker thread feeds the scheduler through its non-blocking ``feeder``
  hook (polled once per chunk, so late arrivals take free slots mid-flight)
  and resolves futures from the ``on_complete`` hook through
  ``loop.call_soon_threadsafe``. It works on the server's own device (an
  explicit card index), never on its thread's current device.

Admission control rejects before anything touches the device, each with a
reason counted in ``snn_admission_rejections_total``:

* ``queue_full`` -- the queue holds ``max_queue`` requests.
* ``tenant_cap`` -- that tenant already has ``tenant_cap`` requests in
  flight (queued or resident in a slot).
* ``unknown_tenant`` -- no such resident tenant.
* ``shutdown`` -- the server was closed.

A rejected ``submit`` returns a :class:`ServeResult` with ``rejected=True``
and the reason rather than raising: rejection is a normal serving outcome.

Smoke run (without ``--device`` it serves on the CUDA card)::

    PYTHONPATH=src python -m repro_torch.launch.serve_async --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.launch.serve import (
    ServeRequest,
    ServeResult,
    SNNServer,
    make_demo_requests,
    make_demo_tenants,
)
from repro_torch.obs import log_event


class AsyncSNNServer:
    """Asyncio wrapper around one :class:`SNNServer`.

    The server's resident programs carry over between scheduler runs, so the
    zero-recompile contract holds across bursts too: once the first burst
    has warmed a program, later bursts admit, refill and retire without
    putting a new one into use.

    Args:
      server: the (already tenant-populated) SNN server to drive.
      max_queue: reject with ``queue_full`` once this many requests wait in
        the queue (requests resident in a slot do not count).
      tenant_cap: per-tenant in-flight ceiling (queued + resident); keeps one
        chatty tenant from starving the rest.
      chunk_ticks: chunk size override passed to the scheduler.
    """

    def __init__(self, server: SNNServer, *, max_queue: int = 64, tenant_cap: int = 8,
                 chunk_ticks: Optional[int] = None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if tenant_cap < 1:
            raise ValueError(f"tenant_cap must be >= 1, got {tenant_cap}")
        self.server = server
        self.max_queue = int(max_queue)
        self.tenant_cap = int(tenant_cap)
        self.chunk_ticks = chunk_ticks
        self._lock = threading.Lock()
        self._queue: Deque[ServeRequest] = deque()
        self._inflight: Dict[str, int] = {}
        self._futures: Dict[int, Tuple[asyncio.AbstractEventLoop, asyncio.Future]] = {}
        self._wake = threading.Event()
        self._closed = False
        r = server.registry
        self._g_depth = r.gauge("snn_async_queue_depth", "requests waiting for a slot")
        self._c_submitted = r.counter(
            "snn_async_submitted_total", "requests accepted by submit()")
        self._worker = threading.Thread(target=self._run, name="snn-serve-worker",
                                         daemon=True)
        self._worker.start()

    # -- admission ---------------------------------------------------------

    def _reject(self, r: ServeRequest, reason: str) -> ServeResult:
        self.server.requests_rejected += 1
        self.server._c_rejected.inc()
        self.server._c_rej_reason.inc(reason=reason)
        log_event("snn_requests_rejected", n=1, tenants=[r.tenant], reason=reason)
        return ServeResult.rejection(r, reason)

    async def submit(self, r: ServeRequest) -> ServeResult:
        """Admit one request; resolves when it retires (or rejects now).

        TTFT for this request is measured from this call: the enqueue stamp
        rides ``r.t_submit`` through the scheduler into the
        ``snn_ttft_seconds`` histogram.
        """
        loop = asyncio.get_running_loop()
        if not r.t_submit:
            r.t_submit = time.time()
        with self._lock:
            if self._closed:
                return self._reject(r, "shutdown")
            if r.tenant not in self.server.tenants:
                return self._reject(r, "unknown_tenant")
            if len(self._queue) >= self.max_queue:
                return self._reject(r, "queue_full")
            if self._inflight.get(r.tenant, 0) >= self.tenant_cap:
                return self._reject(r, "tenant_cap")
            fut: asyncio.Future = loop.create_future()
            self._futures[id(r)] = (loop, fut)
            self._inflight[r.tenant] = self._inflight.get(r.tenant, 0) + 1
            self._queue.append(r)
            self._g_depth.set(len(self._queue))
            self._c_submitted.inc()
        self._wake.set()
        return await fut

    # -- worker-thread side ------------------------------------------------

    def _feed(self) -> Optional[ServeRequest]:
        """Non-blocking feeder polled by the scheduler once per chunk."""
        with self._lock:
            if not self._queue:
                return None
            r = self._queue.popleft()
            self._g_depth.set(len(self._queue))
            return r

    def _complete(self, r: ServeRequest) -> None:
        """``on_complete`` hook: runs in the worker thread at each retire."""
        with self._lock:
            entry = self._futures.pop(id(r), None)
            n = self._inflight.get(r.tenant, 0) - 1
            if n > 0:
                self._inflight[r.tenant] = n
            else:
                self._inflight.pop(r.tenant, None)
        if entry is None:
            return
        loop, fut = entry
        result = ServeResult.of(r)
        loop.call_soon_threadsafe(lambda: fut.done() or fut.set_result(result))

    def _run(self) -> None:
        dev = self.server.device
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            while True:
                self._wake.wait()
                with self._lock:
                    self._wake.clear()
                    empty, closed = not self._queue, self._closed
                if empty:
                    if closed:
                        return
                    continue
                # One scheduler burst: drains the queue, and whatever arrives
                # through the feeder while slots are busy.
                self.server.serve_continuous(feeder=self._feed, on_complete=self._complete,
                                             chunk_ticks=self.chunk_ticks)

    # -- lifecycle ---------------------------------------------------------

    def close(self, timeout: float = 60.0) -> None:
        """Stop accepting work, drain what is queued, join the worker.

        Safe from sync or async code: the worker never blocks on the event
        loop (futures resolve through ``call_soon_threadsafe``), so joining
        it from a coroutine cannot deadlock; the callbacks land after
        ``close`` returns.
        """
        with self._lock:
            self._closed = True
        self._wake.set()
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            raise TimeoutError("serve worker did not drain in time")

    async def aclose(self, timeout: float = 60.0) -> None:
        """``close`` for async callers; joins the worker off the loop."""
        with self._lock:
            self._closed = True
        self._wake.set()
        await asyncio.get_running_loop().run_in_executor(None, self._worker.join, timeout)
        if self._worker.is_alive():
            raise TimeoutError("serve worker did not drain in time")


# -- smoke ----------------------------------------------------------------


async def _smoke(n_requests: int, slots: int, device=None) -> List[ServeResult]:
    server = SNNServer(n_max=32, slots=slots, max_ticks=16, event_density=0.2, device=device)
    names = make_demo_tenants(server, max(6, slots), seed=0)
    reqs = make_demo_requests(server, names, n_requests, seed=1)
    front = AsyncSNNServer(server, max_queue=max(8, n_requests))
    try:
        results = await asyncio.gather(*(front.submit(r) for r in reqs))
    finally:
        await front.aclose()
    ok = [r for r in results if not r.rejected]
    ttfts = sorted(r.ttft_s for r in ok)
    print(f"served {len(ok)}/{len(results)} requests on {server.device} "
          f"({len(results) - len(ok)} rejected)")
    if ttfts:
        print(f"ttft: min {ttfts[0] * 1e3:.1f} ms, max {ttfts[-1] * 1e3:.1f} ms")
    print(f"programs in use: {dict(server._compiles)}")
    print(server.registry.to_prometheus())
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "kernels' plain twins)")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.error("only --smoke runs are wired for the CLI")
    return asyncio.run(_smoke(args.requests, args.slots, args.device))


if __name__ == "__main__":
    main()
