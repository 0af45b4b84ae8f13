"""The multi-tenant server: ``SNNServer.serve_continuous`` through its feeder.

Set-up registers the tenants from their register images (the program's
``RegisterBank`` loads the bytes), makes the request pool and serves the
mix's ``warmup`` requests. The window then feeds the server in one of two
ways: ``backlog`` keeps ``slots + backlog`` requests in flight, cycling the
pool in a seeded order, until the window closes; ``poisson`` offers the
pool at the mix's fixed rate whatever the server does (an open loop), each
request due at its arrival time, and calls the scheduler again whenever it
has drained, as the async front end does. Requests fed before the window
closes are served to the end after it. Every answer is then compared with
the plain reference's.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import tenants, traffic, work
from port_bench.reference import snn as ref


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), device

    # -- set-up ---------------------------------------------------------------

    def inputs(self) -> None:
        """The benchmark's side: register images, the pool and its order."""
        c, mix = self.cfg, self.mix
        self.images = tenants.make_images(self.seed, c["n_neurons"], c["tenants"])
        self.targets = [img for img in self.images
                        if img.kind in mix["kinds"] and not img.plastic]
        self.entries = traffic.make_pool(mix, [t.n_in for t in self.targets], self.seed)
        self.order = traffic.order(mix, self.seed, len(self.entries))
        self.fed: List = []            # (pool index, ServeRequest) of every request fed
        self.host: Dict = {}
        self._k = 0

    def setup(self) -> None:
        from repro_torch.core.registers import RegisterBank, WeightLayout
        from repro_torch.launch.serve import SNNServer

        c, mix = self.cfg, self.mix
        self.inputs()
        self.server = SNNServer(
            n_max=c["n_neurons"], slots=c["slots"], max_ticks=c["n_ticks"],
            mode=c["snn_mode"], backend=c["snn_backend"], event_density=c["event_density"],
            chunk_ticks=c["chunk_ticks"], telemetry=c["telemetry"], device=self.device)
        for img in self.images:
            bank = RegisterBank(img.n, weight_layout=WeightLayout.PER_SYNAPSE)
            bank.load_bytes(img.payload)
            bank.set_leak(img.leak)
            bank.set_refractory(img.refractory)
            self.server.add_tenant(img.name, bank, n_in=img.n_in, n_out=img.n_out,
                                   plastic=img.plastic)
        self._backlog(None, count=int(mix["warmup"]))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.fed.clear()

    def _request(self, due: float):
        from repro_torch.launch.serve import ServeRequest

        j = int(self.order[self._k % len(self.order)])
        self._k += 1
        e = self.entries[j]
        r = ServeRequest(rid=len(self.fed), tenant=self.targets[e.tenant].name, ext=e.ext,
                         n_ticks=e.ticks, t_submit=due)
        self.fed.append((j, r))
        return r

    # -- the window -------------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        reg = self.server.registry
        before = {k: reg.get(k).value() for k in ("snn_useful_slot_ticks_total",
                                                   "snn_slot_ticks_total")}
        self.host = {}
        t0 = time.time()
        if self.mix["arrival"] == "backlog":
            self._backlog(t0 + seconds)
        elif self.mix["arrival"] == "poisson":
            self._open_loop(t0, seconds)
        else:
            raise ValueError(f"unknown arrival {self.mix['arrival']!r}")
        t_end = t0 + seconds
        after = {k: reg.get(k).value() for k in before}
        done = [r for _, r in self.fed if r.t_done is not None and t0 <= r.t_done <= t_end]
        now = time.time()
        rec = {
            "window_s": float(seconds),
            "attempted": len(self.fed),
            "failed": sum(r.t_done is None for _, r in self.fed),
            "useful_slot_ticks": float(sum(min(r.n_ticks, self.cfg["n_ticks"]) for r in done)),
            "latencies_s": [(r.t_done if r.t_done is not None else now) - r.t_submit
                            for _, r in self.fed],
            "slot_ticks_useful": after["snn_useful_slot_ticks_total"]
            - before["snn_useful_slot_ticks_total"],
            "slot_ticks_run": after["snn_slot_ticks_total"] - before["snn_slot_ticks_total"],
            "chunks": self.host.get("dispatch", (0.0, 0))[1],
            "host_s": {k: v[0] for k, v in self.host.items()},
            "backends": sorted({self.server.tenants[t.name].backend for t in self.targets}),
        }
        rec["ticks"] = rec["chunks"] * self.cfg["chunk_ticks"]
        rec["tick_work"] = self._work(r for r in done)
        rec["product_work"] = self._work(r for _, r in self.fed if r.t_done is not None)
        return rec

    def _serve(self, feeder, on_complete) -> None:
        self.server.serve_continuous(feeder=feeder, on_complete=on_complete)
        for k, (sec, n) in self.server.host_time.items():
            s0, n0 = self.host.get(k, (0.0, 0))
            self.host[k] = (s0 + sec, n0 + n)

    def _backlog(self, t_end, count=None) -> None:
        """Keep ``slots + backlog`` requests in flight until ``t_end`` (or
        until ``count`` have been fed)."""
        target = self.cfg["slots"] + int(self.mix["backlog"])
        flight = {"n": 0, "closed": False}

        def feeder():
            if flight["closed"]:
                return None
            now = time.time()
            if (t_end is not None and now >= t_end) or (count is not None
                                                        and len(self.fed) >= count):
                flight["closed"] = True
                return None
            if flight["n"] >= target:
                return None
            flight["n"] += 1
            return self._request(now)

        def on_complete(r):
            flight["n"] -= 1

        self._serve(feeder, on_complete)

    def _open_loop(self, t0: float, seconds: float) -> None:
        """Offer requests at their Poisson due times over ``seconds``."""
        rate = float(self.mix["rate_per_s"])
        gaps = traffic.gaps(self.mix, self.seed, int(math.ceil(rate * seconds * 1.25)) + 16)
        due = t0 + np.cumsum(gaps)
        due = due[due < t0 + seconds]
        nxt = {"i": 0}

        def feeder():
            i = nxt["i"]
            if i < len(due) and due[i] <= time.time():
                nxt["i"] = i + 1
                return self._request(float(due[i]))
            return None

        while nxt["i"] < len(due):
            wait = due[nxt["i"]] - time.time()
            if wait > 0:
                time.sleep(wait)
            self._serve(feeder, None)

    def _work(self, reqs) -> work.Work:
        by_name = {t.name: t for t in self.targets}
        total = work.Work()
        for r in reqs:
            t = by_name[r.tenant]
            total.add(work.product(t.n, t.nnz, n_in=t.n_in), min(r.n_ticks, self.cfg["n_ticks"]))
        return total

    # -- after the window ---------------------------------------------------------

    def release(self) -> None:
        self.server = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[tuple]:
        """``(name, value, limit)`` of each number compared: answers whose
        counts or class differ from the reference's (float32, TF32 off, as
        the configuration states), and answers that never came."""
        used = sorted({j for j, _ in self.fed})
        nets = [ref.Tenant(t.payload, t.n, t.n_in, t.n_out, t.leak, t.refractory, self.device)
                for t in self.targets]
        want = ref.answers_of(nets, self.entries, used, "f32")
        wrong = missing = 0
        for j, r in self.fed:
            if r.counts is None:
                missing += 1
            elif not (np.array_equal(np.asarray(r.counts), want[j])
                      and r.pred == int(ref.pred(want[j]))):
                wrong += 1
        return [("wrong_answers", wrong, 0), ("missing_answers", missing, 0)]
