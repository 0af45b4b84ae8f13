"""One large fabric streamed: the chunk loop of ``serve_sharded_main``.

Set-up draws the network on the device from the seed (``inputs``), puts it
on a mesh of one rank as ``serve_sharded_main`` does, and runs the mix's
``warmup`` chunks. The window calls ``TickEngine.chunk`` on the carry, one
chunk after another with no host wait, until ``--seconds`` have passed,
then waits for the device. Of the window's chunks it keeps ``check_chunks``
drawn from the seed (a reservoir sample, decided before each chunk runs),
each with the state it started from, its raster and the state it handed
on; the other chunks keep nothing. The check replays the first chunk from
the zero state and the kept chunks from their start states, comparing
every spike and the state each chunk hands on.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import work
from port_bench.reference import snn as ref


def weights(cfg: dict, seed: int, device) -> tuple:
    """``(w (n, n), w_in (n_in, n))`` float32 on ``device`` from the seed: ``w``
    on the dyadic grid ``level * 2^round(log2(2 / sqrt(n)))`` with levels
    uniform in ``w_levels``, ``w_in`` on ``level * w_in_step`` with levels
    uniform in ``w_in_levels``. A few large calls on the device; the same
    seed, shape and device give the same tensors."""
    n, n_in = cfg["n_neurons"], cfg["n_in"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    lo, hi = cfg["w_levels"]
    w = torch.empty((n, n), dtype=torch.float32, device=device)
    w.random_(0, hi - lo + 1, generator=g).add_(lo).mul_(2.0 ** round(np.log2(2.0 / np.sqrt(n))))
    a, b = cfg["w_in_levels"]
    w_in = torch.empty((n_in, n), dtype=torch.float32, device=device)
    w_in.random_(a, b, generator=g).mul_(float(cfg["w_in_step"]))
    return w, w_in


def drive(cfg: dict, mix: dict, seed: int, device, chunks: int) -> torch.Tensor:
    """``(chunks, chunk_ticks, n_in)`` input spikes at the mix's ``density``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) + 1) % (1 << 63))
    shape = (chunks, cfg["chunk_ticks"], cfg["n_in"])
    return (torch.rand(shape, generator=g, device=device) < float(mix["density"])).float()


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), device

    def inputs(self) -> None:
        """The benchmark's side: the drive of every chunk."""
        self.ext = drive(self.cfg, self.mix, self.seed, self.device, int(self.mix["pool_chunks"]))
        self.n_chunks = 0
        self.kept: List[tuple] = []        # (drive index, start state, raster, end state)

    def setup(self) -> None:
        from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
        from repro_torch.core.lif import LIFParams
        from repro_torch.core.network_types import SNNParams, SNNState
        from repro_torch.obs.telemetry import TickTelemetry
        from repro_torch.parallel import snn_sharding
        from repro_torch.parallel.mesh import make_snn_mesh

        c = self.cfg
        n = c["n_neurons"]
        self.inputs()
        mesh = make_snn_mesh(None, device=self.device)
        self.engine = TickEngine(EngineOptions(mode=c["snn_mode"], backend=c["snn_backend"],
                                               telemetry=c["telemetry"], mesh=mesh))
        w, w_in = weights(c, self.seed, mesh.device)
        lif = LIFParams.make(n, v_th=c["v_th"], leak=c["leak"], r_ref=c["r_ref"],
                             device=mesh.device)
        specs = snn_sharding.params_specs(snn_sharding.snn_rules(mesh.axis),
                                          SNNParams(w=w, c=None, w_in=w_in, lif=lif))
        self.params = SNNParams(w=w, c=None, w_in=snn_sharding.place(w_in, specs.w_in, mesh),
                                lif=snn_sharding.place(lif, specs.lif, mesh))
        self.carry = TickCarry(state=SNNState.zeros((), n, device=mesh.device),
                               telem=TickTelemetry.zeros((), device=mesh.device)
                               if c["telemetry"] else None)
        self.start = self._chunk(keep=True)
        for _ in range(int(self.mix["warmup"]) - 1):
            self._chunk(keep=False)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _state(self) -> tuple:
        lif = self.carry.state.lif
        return (lif.v.clone(), lif.r.clone(), lif.y.clone())

    def _chunk(self, keep: bool) -> Optional[tuple]:
        """Run the next chunk; with ``keep`` return ``(drive index, start
        state, raster, end state)`` (the carry is handed over owned, so its
        state is copied on both sides)."""
        i = self.n_chunks % self.ext.shape[0]
        self.n_chunks += 1
        start = self._state() if keep else None
        self.carry, raster = self.engine.chunk(self.params, self.carry, self.ext[i],
                                               self.cfg["chunk_ticks"], owned=True)
        return (i, start, raster, self._state()) if keep else None

    def window(self, seconds: float) -> Dict:
        m = int(self.cfg["check_chunks"])
        pick = np.random.default_rng((self.seed, 4))
        self.n_chunks, self.kept = 0, []
        k = 0
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            slot = k if k < m else int(pick.integers(0, k + 1))
            got = self._chunk(keep=slot < m)
            if k < m:
                self.kept.append(got)
            elif got is not None:
                self.kept[slot] = got
            k += 1
            if ts - t0 >= seconds:
                break
        self._sync()
        wall = time.perf_counter() - t0
        n = self.cfg["n_neurons"]
        ticks = k * self.cfg["chunk_ticks"]
        per_tick = work.product(n, n * n, n_in=self.cfg["n_in"], dense_input=True)
        total = work.Work()
        total.add(per_tick, ticks)
        return {"window_s": wall, "attempted": ticks, "failed": 0, "ticks": ticks, "chunks": k,
                "backends": [self.engine.backend], "tick_work": total, "product_work": total}

    def release(self) -> None:
        self.params = self.carry = self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[tuple]:
        """Spikes and state entries that differ from the reference's (float32,
        TF32 off, as the configuration states), over the first chunk (from the
        zero state) and the window's kept chunks (each from the program's state
        at its start)."""
        c = self.cfg
        w, w_in = weights(c, self.seed, self.device)
        wrong = 0
        for i, start, raster, end in [self.start] + self.kept:
            want, state = ref.stream(w, w_in, c["v_th"], c["leak"], c["r_ref"], start,
                                     self.ext[i], "f32")
            wrong += int((want != raster.float()).sum())
            wrong += sum(int((a.float() != b.float()).sum()) for a, b in zip(end, state))
        return [("wrong_spikes_and_state", wrong, 0)]
