"""Connection-list topologies -- the paper's "universal interconnections".

On the FPGA, ``connection_list[n][m] = 1`` closes a multiplexer that routes
the output spike of neuron *n* to an input of neuron *m*; a 0 routes a
constant zero. Here the connection list is a boolean matrix ``C`` (a runtime
*input*, never a compiled constant), and spike routing is the masked matmul
``s @ (W * C)``. Any topology -- feed-forward, recurrent, sparse, dense --
is therefore data, and switching topologies never rebuilds a kernel.

Convention: ``C[n, m]`` routes *presynaptic* neuron ``n`` -> *postsynaptic*
neuron ``m``, matching the paper's ``connection list[n][m]``.

The numpy builders of ``repro.core.connectivity``, copied so that the
port never imports the JAX package. The compressed layouts (CSR, padded
neighbour lists) and the shard statistics arrive with the event-backend
and sharding slices.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def all_to_all(n: int, *, self_connections: bool = False) -> np.ndarray:
    """Fully connected N x N topology (the hardware's maximal fabric)."""
    c = np.ones((n, n), dtype=np.bool_)
    if not self_connections:
        np.fill_diagonal(c, False)
    return c


def layered(layer_sizes: Sequence[int]) -> np.ndarray:
    """Feed-forward topology over a flat neuron array.

    ``layered([4, 3])`` reproduces the paper's Iris network: neurons 0-3 are
    the input layer, neurons 4-6 the output layer, with full bipartite
    connectivity between consecutive layers and nothing else. This is the
    exact construction of Fig. 4 / Fig. 6.
    """
    n = int(sum(layer_sizes))
    c = np.zeros((n, n), dtype=np.bool_)
    offset = 0
    for a, b in zip(layer_sizes[:-1], layer_sizes[1:]):
        c[offset : offset + a, offset + a : offset + a + b] = True
        offset += a
    return c


def sparse_random(
    n: int, density: float, *, seed: int = 0, self_connections: bool = False
) -> np.ndarray:
    """Random sparse topology at the given density (for scaling studies)."""
    rng = np.random.default_rng(seed)
    c = rng.random((n, n)) < density
    if not self_connections:
        np.fill_diagonal(c, False)
    return c


def ring(n: int, k: int = 1) -> np.ndarray:
    """Each neuron feeds its next ``k`` neighbours (synfire chain)."""
    c = np.zeros((n, n), dtype=np.bool_)
    for i in range(n):
        for j in range(1, k + 1):
            c[i, (i + j) % n] = True
    return c


def validate(c: np.ndarray) -> None:
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError(f"connection list must be square, got {c.shape}")
    if c.dtype != np.bool_:
        raise ValueError(f"connection list must be boolean, got {c.dtype}")


def pack_bits(c: np.ndarray) -> np.ndarray:
    """Bit-pack each row to bytes -- the register-bank wire format.

    Row ``n`` of the 74-neuron system packs to ``ceil(74/8) = 10`` bytes,
    reproducing the paper's "each CL requires 10 transactions".
    """
    validate(c)
    return np.packbits(c, axis=1)


def unpack_bits(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits` (drops pad bits)."""
    return np.unpackbits(packed, axis=1)[:, :n].astype(np.bool_)


def fan_in(c: np.ndarray) -> np.ndarray:
    """Per-neuron in-degree (drives per-neuron LUT cost, paper Table I)."""
    return np.asarray(c).sum(axis=0)


def fan_out(c: np.ndarray) -> np.ndarray:
    return np.asarray(c).sum(axis=1)
