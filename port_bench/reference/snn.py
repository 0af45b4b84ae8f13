"""Plain reference of the SNN tick, the register decode and the decode of
an answer, in PyTorch and NumPy alone (it imports nothing of the program).

The tick is the paper's fixed-leak LIF (Eq. 5) on an all-to-all mux fabric:
the spikes of the previous tick arrive through ``W * C`` (``W[pre, post]``),
the drive ``ext @ w_in`` is added, then

    v~ = v + syn - sign(v) * min(leak * [v != 0], |v|)
    y  = [v~ >= v_th] and [r == 0]
    v' = 0 where y or r > 0, else v~
    r' = r_ref where y, else max(r - 1, 0)

``precision`` is how the tick's arithmetic runs: ``"f32"`` (float32, TF32
off: what the configurations state), ``"tf32"`` (float32 with the matrix
products in TF32, on the card), ``"bf16"`` (every tensor of the tick in
bfloat16) or ``"fp8"`` (the weights and the drive stored as float8 e4m3,
the arithmetic in float32). The last three are the controls: the
reference put in the program's place one, two and three precisions down.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

PRECISIONS = ("f32", "tf32", "bf16", "fp8")


def decode(payload: bytes, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A register image's ``(c bool (n, n), thresholds u8 (n,), weights u8
    (n, n))``. The wire order is the bit-packed connection-list rows (MSB
    first, ``ceil(n / 8)`` bytes a row), the thresholds, the per-synapse
    weights, the impulse register."""
    row = (n + 7) // 8
    a = np.frombuffer(payload, dtype=np.uint8)
    if a.size != n * row + n + n * n + row:
        raise ValueError(f"image of {a.size} bytes is not one of {n} neurons")
    cl = a[:n * row].reshape(n, row)
    c = np.unpackbits(cl, axis=1)[:, :n].astype(np.bool_)
    th = a[n * row:n * row + n]
    w = a[n * row + n:n * row + n + n * n].reshape(n, n)
    return c, th, w


@contextlib.contextmanager
def precision_of(precision: str):
    """Set the matrix products' float32 precision for the block, and restore it."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield torch.bfloat16 if precision == "bf16" else torch.float32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def stored(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as the precision stores a product's operand (float8 e4m3 for
    ``"fp8"``, read back as float32)."""
    return x.to(torch.float8_e4m3fn).float() if precision == "fp8" else x


def step(v, r, y, syn, v_th, leak, r_ref):
    """One fixed-leak LIF update; returns ``(v', r', y')``."""
    active = (v != 0).to(v.dtype)
    leak_step = torch.minimum(leak * active, v.abs())
    vt = v + syn - torch.sign(v) * leak_step
    fire = (vt >= v_th) & (r == 0)
    v2 = torch.where(fire | (r > 0), torch.zeros_like(vt), vt)
    r2 = torch.where(fire, r_ref, torch.clamp(r - 1, min=0))
    return v2, r2, fire.to(v.dtype)


class Tenant:
    """One tenant's network, decoded from its register image onto ``device``."""

    def __init__(self, payload: bytes, n: int, n_in: int, n_out: int, leak: int,
                 refractory: int, device):
        c, th, w = decode(payload, n)
        self.n, self.n_in, self.n_out = n, n_in, n_out
        self.wc = torch.from_numpy(w.astype(np.float32) * c).to(device)
        self.v_th = torch.from_numpy(th.astype(np.float32)).to(device)
        self.leak = torch.full((n,), float(leak), device=device)
        self.r_ref = torch.full((n,), int(refractory), dtype=torch.int32, device=device)

    def answer(self, exts: Sequence[np.ndarray], budgets: Sequence[int],
               precision: str = "f32", block: int = 512) -> np.ndarray:
        """Each request's output counts ``(B, n_out)``: the spikes of the last
        ``n_out`` neurons over the request's budget, from a fresh state, with
        its drive on the first ``n_in`` neurons (identity input weights)."""
        out = []
        for b0 in range(0, len(exts), block):
            out.append(self._answer(exts[b0:b0 + block], budgets[b0:b0 + block], precision))
        return np.concatenate(out) if out else np.zeros((0, self.n_out), np.float32)

    def _answer(self, exts, budgets, precision):
        dev, n, B = self.wc.device, self.n, len(exts)
        T = max(int(b) for b in budgets)
        drive = np.zeros((T, B, n), np.float32)
        for i, e in enumerate(exts):
            t = min(int(budgets[i]), e.shape[0])
            drive[:t, i, :e.shape[1]] = e[:t]
        with precision_of(precision) as dt:
            wc, v_th, leak = stored(self.wc, precision).to(dt), self.v_th.to(dt), self.leak.to(dt)
            drive_d = stored(torch.from_numpy(drive).to(dev), precision).to(dt)
            v = torch.zeros((B, n), dtype=dt, device=dev)
            y = torch.zeros((B, n), dtype=dt, device=dev)
            r = torch.zeros((B, n), dtype=torch.int32, device=dev)
            counts = torch.zeros((B, n), dtype=torch.float32, device=dev)
            live = torch.tensor([int(b) for b in budgets], device=dev)
            for t in range(T):
                syn = y @ wc + drive_d[t]
                v, r, y = step(v, r, y, syn, v_th, leak, self.r_ref)
                counts += y.float() * (t < live).float()[:, None]
        return counts[:, n - self.n_out:].cpu().numpy()


def pred(counts: np.ndarray) -> np.ndarray:
    """The class of each answer: the first output neuron with the most spikes."""
    return counts.argmax(axis=-1)


def stream(w: torch.Tensor, w_in: torch.Tensor, v_th: float, leak: float, r_ref: int,
           state: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ext: torch.Tensor,
           precision: str = "f32") -> Tuple[torch.Tensor, Tuple]:
    """``len(ext)`` ticks of one network from ``state = (v, r, y)``; returns
    ``(raster (T, n), (v, r, y))`` in float32 (``r`` int32)."""
    with precision_of(precision) as dt:
        v, r, y = (state[0].to(dt), state[1].to(torch.int32), state[2].to(dt))
        wd, wind = stored(w, precision).to(dt), stored(w_in, precision).to(dt)
        n = w.shape[-1]
        th = torch.full((n,), v_th, dtype=dt, device=w.device)
        lk = torch.full((n,), leak, dtype=dt, device=w.device)
        rr = torch.full((n,), r_ref, dtype=torch.int32, device=w.device)
        raster = torch.empty((ext.shape[0], n), dtype=torch.float32, device=w.device)
        for t in range(ext.shape[0]):
            syn = y @ wd + stored(ext[t], precision).to(dt) @ wind
            v, r, y = step(v, r, y, syn, th, lk, rr)
            raster[t] = y.float()
    return raster, (v.float(), r, y.float())


def answers_of(tenants: List[Tenant], entries, idx: Sequence[int], precision: str = "f32"
               ) -> dict:
    """The reference's counts for the pool entries ``idx``: ``{i: counts}``,
    batched tenant by tenant."""
    by_tenant: dict = {}
    for i in idx:
        by_tenant.setdefault(entries[i].tenant, []).append(i)
    out = {}
    for t, ids in sorted(by_tenant.items()):
        counts = tenants[t].answer([entries[i].ext for i in ids],
                                   [entries[i].ticks for i in ids], precision)
        out.update(zip(ids, counts))
    return out

