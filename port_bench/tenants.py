"""The tenants' register images, drawn from the seed.

A frozen copy of the register recipe of ``repro_torch.launch.serve.
make_demo_tenants``: tenant ``i`` is layered, ring, sparse-random or
all-to-all by ``i % 4``, with u8 weights in ``[40, 200)`` on its closed
synapses, u8 thresholds in ``[60, 160)``, a leak in ``[0, 8)`` and a
refractory length in ``[0, 3)``; the last tenant is plastic. Two changes:
the bytes are drawn through float32 uniforms (:func:`uniform_u8`), and the
tenant sizes are a fixed set, one size a tenant evenly spaced over
``[n_max // 3, n_max]`` for each kind, dealt to the kind's tenants in an
order drawn from the seed, so that every seed serves the same amount of
work in another arrangement.

An image is the register bank's wire format (paper §III.B): the bit-packed
connection-list rows, then thresholds, then the per-synapse weight matrix,
then the impulse register; leak and refractory are device-local registers
outside the stream. The program loads it through its own ``RegisterBank``;
the reference decodes the same bytes itself (``reference/snn.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

KINDS = ("layered", "ring", "sparse", "dense")


@dataclasses.dataclass(frozen=True)
class Image:
    name: str
    kind: str
    n: int
    n_in: int
    n_out: int
    plastic: bool
    nnz: int                # closed synapses
    payload: bytes          # CL rows, thresholds, weights (n x n), impulses
    leak: int
    refractory: int


def sizes(n_max: int, per_kind: int) -> List[int]:
    """The fixed tenant sizes of one kind: evenly spaced over [n_max // 3, n_max]."""
    lo = max(6, n_max // 3)
    return [int(round(lo + (n_max - lo) * (j + 0.5) / per_kind)) for j in range(per_kind)]


def uniform_u8(rng, lo: int, hi: int, shape) -> np.ndarray:
    """Bytes uniform in ``[lo, hi)``, from float32 draws (four times faster
    than ``rng.integers`` for a 4096 x 4096 matrix)."""
    return (lo + rng.random(shape, dtype=np.float32) * (hi - lo)).astype(np.uint8)


def _topology(kind: str, n: int, i: int, seed: int):
    """``(c, n_in, n_out)``: the make_demo_tenants topologies."""
    c = np.zeros((n, n), dtype=np.bool_)
    if kind == "layered":
        n_in, n_out = max(2, n // 3), max(2, n // 4)
        hidden = n - n_in - n_out
        layers = [n_in, hidden, n_out] if hidden > 0 else [n_in, n_out]
        off = 0
        for a, b in zip(layers[:-1], layers[1:]):
            c[off:off + a, off + a:off + a + b] = True
            off += a
        return c, n_in, n_out
    if kind == "ring":
        k = 1 + i % 2
        for j in range(1, k + 1):
            c[np.arange(n), (np.arange(n) + j) % n] = True
    elif kind == "sparse":
        c = np.random.default_rng((seed, i)).random((n, n), dtype=np.float32) < 0.1
        np.fill_diagonal(c, False)
    else:
        c = np.ones((n, n), dtype=np.bool_)
        np.fill_diagonal(c, False)
    return c, n, n


def make_images(seed: int, n_max: int, n_tenants: int) -> List[Image]:
    """``n_tenants`` register images (a multiple of 4), the last one plastic."""
    if n_tenants % len(KINDS):
        raise ValueError(f"n_tenants must be a multiple of {len(KINDS)}, got {n_tenants}")
    rng = np.random.default_rng(seed)
    per_kind = n_tenants // len(KINDS)
    dealt = {k: list(rng.permutation(sizes(n_max, per_kind))) for k in KINDS}
    out = []
    for i in range(n_tenants):
        kind = KINDS[i % len(KINDS)]
        n = int(dealt[kind].pop())
        c, n_in, n_out = _topology(kind, n, i, seed)
        w = uniform_u8(rng, 40, 200, (n, n)) * c.view(np.uint8)
        th = uniform_u8(rng, 60, 160, (n,))
        leak = int(rng.integers(0, 8))
        refractory = int(rng.integers(0, 3))
        row = (n + 7) // 8
        payload = b"".join([np.packbits(c, axis=1).tobytes(), th.tobytes(), w.tobytes(),
                            np.zeros((row,), np.uint8).tobytes()])
        out.append(Image(name=f"{kind}-{i}", kind=kind, n=n, n_in=n_in, n_out=n_out,
                         plastic=(i == n_tenants - 1), nnz=int(c.sum()), payload=payload, leak=leak,
                         refractory=refractory))
    return out

