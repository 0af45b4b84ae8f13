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
port never imports the JAX package: the topologies, the bit packing, and
the compressed layouts the event backend plans from (CSR, padded
neighbour lists, :func:`stats`) and the shard helpers of the sharded
fabric (:func:`shard_fan_in`, :func:`shard_stats`, :func:`shard_imbalance`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# Compressed connectivity: CSR + padded neighbor lists (the event backend's
# data layout -- only the *closed* muxes are named; silent rows cost nothing)
# ---------------------------------------------------------------------------


def to_csr(c: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dense boolean ``C`` -> CSR ``(indptr, indices)`` over presynaptic rows.

    ``indices[indptr[p]:indptr[p+1]]`` are the postsynaptic targets of
    neuron ``p``, ascending.  Exact: :func:`csr_to_dense` round-trips.
    """
    validate(c)
    n = c.shape[0]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(c.sum(axis=1), out=indptr[1:])
    indices = np.nonzero(c)[1].astype(np.int32)
    return indptr, indices


def csr_to_dense(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`to_csr`."""
    c = np.zeros((n, n), dtype=np.bool_)
    for p in range(n):
        c[p, indices[indptr[p] : indptr[p + 1]]] = True
    return c


@dataclasses.dataclass(frozen=True)
class PaddedNeighbors:
    """Fixed-width neighbor lists: row ``i`` of ``idx`` holds the (ascending)
    neighbors of neuron ``i``, padded to ``cap`` entries; ``mask`` is 1.0 on
    real entries and 0.0 on padding (padded ``idx`` entries are 0 and must be
    gated by the mask before use).

    ``axis`` records the direction: ``"out"`` (row i = fan-out targets of
    presynaptic i, from :func:`padded_neighbors`) or ``"in"`` (row i =
    fan-in sources of postsynaptic i, from :func:`padded_fan_in`).

    The cap/padding trade-off the stats expose: a tight cap minimizes the
    gather width (and the event backend's FLOPs/bytes), but the cap must
    hold the *maximum* degree -- one hub row sets the width for everyone,
    and ``padding_fraction`` says how much of the padded layout is air.
    """

    idx: np.ndarray          # (n, cap) int32
    mask: np.ndarray         # (n, cap) float32, 1.0 = real edge
    cap: int
    axis: str                # "out" | "in"
    n_edges: int
    max_degree: int

    @property
    def mean_degree(self) -> float:
        return self.n_edges / max(1, self.idx.shape[0])

    @property
    def padding_fraction(self) -> float:
        """Fraction of the (n, cap) layout that is padding."""
        slots = self.idx.shape[0] * self.cap
        return 1.0 - self.n_edges / max(1, slots)


def _padded_lists(c: np.ndarray, cap: Optional[int], axis: str) -> PaddedNeighbors:
    validate(c)
    rows = c if axis == "out" else c.T
    degrees = rows.sum(axis=1).astype(np.int64)
    max_deg = int(degrees.max()) if rows.size else 0
    if cap is None:
        cap = max(1, max_deg)
    if max_deg > cap:
        raise ValueError(
            f"fan-{axis} cap {cap} below max degree {max_deg}: a capped "
            "neighbor list would silently drop synapses (raise the cap or "
            "prune the topology)")
    n = rows.shape[0]
    idx = np.zeros((n, cap), dtype=np.int32)
    mask = np.zeros((n, cap), dtype=np.float32)
    for i in range(n):
        nz = np.nonzero(rows[i])[0]
        idx[i, : nz.size] = nz
        mask[i, : nz.size] = 1.0
    return PaddedNeighbors(idx=idx, mask=mask, cap=int(cap), axis=axis,
                           n_edges=int(degrees.sum()), max_degree=max_deg)


def padded_neighbors(c: np.ndarray, cap: Optional[int] = None) -> PaddedNeighbors:
    """Padded fan-OUT lists: row ``p`` = postsynaptic targets of ``p``.

    ``cap=None`` picks the tightest cap (the max fan-out).  Raises if an
    explicit cap is below the max degree -- the builders never truncate.
    """
    return _padded_lists(c, cap, "out")


def padded_fan_in(c: np.ndarray, cap: Optional[int] = None) -> PaddedNeighbors:
    """Padded fan-IN lists: row ``m`` = presynaptic sources of ``m``.

    This is the gather-friendly dual of :func:`padded_neighbors`: the
    event backend's vmap-safe path reads, for every postsynaptic neuron,
    exactly its ``cap`` (mostly real) in-edges -- no scatter, no
    data-dependent control flow, FLOPs ``B*n*cap`` instead of ``B*n*n``.
    """
    return _padded_lists(c, cap, "in")


def shard_fan_in(
    c: np.ndarray, n_shards: int, cap: Optional[int] = None
) -> Tuple[PaddedNeighbors, ...]:
    """Slice the padded fan-in lists by DESTINATION shard (DESIGN.md §15).

    Shard ``i`` gets the rows of :func:`padded_fan_in` for its own
    postsynaptic neurons ``[i*n/D, (i+1)*n/D)``:

    * ``idx`` entries stay **global** presynaptic ids -- under the
      fabric's column sharding each shard's ``wc`` slab keeps the full
      presynaptic row axis, so no index translation ever happens;
    * the cap is the **global** max fan-in for every shard -- uniform
      shapes, so every shard runs the same event-backend tick.

    Per-shard ``n_edges``/``max_degree`` are recomputed on the slice, so
    the returned stats expose the load balance the topology actually
    gives each shard (see :func:`shard_stats` for the full view).
    """
    full = padded_fan_in(c, cap)
    n = full.idx.shape[0]
    if n_shards < 1 or n % n_shards:
        raise ValueError(
            f"n={n} destinations do not split evenly over {n_shards} shards")
    n_local = n // n_shards
    out = []
    for i in range(n_shards):
        idx = full.idx[i * n_local:(i + 1) * n_local]
        mask = full.mask[i * n_local:(i + 1) * n_local]
        degrees = mask.sum(axis=1).astype(np.int64)
        out.append(PaddedNeighbors(
            idx=idx, mask=mask, cap=full.cap, axis="in",
            n_edges=int(degrees.sum()),
            max_degree=int(degrees.max()) if degrees.size else 0))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardStats:
    """Per-shard load view of a destination-sharded topology.

    ``n_edges_in`` is the shard's synaptic work per tick (its fan-in dot
    reduces exactly these edges); ``n_edges_out`` is how many of the
    fabric's synapses *originate* from the shard's own neurons (how much
    of the gathered spike vector the rest of the fabric consumes from
    it).  A balanced topology keeps ``n_edges_in`` near ``edges / D``.
    """

    shard: int
    n_post: int
    n_edges_in: int
    max_fan_in: int
    mean_fan_in: float
    n_edges_out: int
    max_fan_out: int
    mean_fan_out: float


def shard_stats(c: np.ndarray, n_shards: int) -> Tuple[ShardStats, ...]:
    """Host-side per-shard statistics (the sharded serve CLI prints them at
    load), from the dense list directly -- no padded layout needed."""
    cb = np.asarray(c) > 0
    validate(cb)
    n = cb.shape[0]
    if n_shards < 1 or n % n_shards:
        raise ValueError(
            f"n={n} destinations do not split evenly over {n_shards} shards")
    n_local = n // n_shards
    out = []
    for i in range(n_shards):
        lo, hi = i * n_local, (i + 1) * n_local
        fi = cb[:, lo:hi].sum(axis=0)          # fan-in of local posts
        fo = cb[lo:hi, :].sum(axis=1)          # fan-out of local pres
        out.append(ShardStats(
            shard=i, n_post=n_local,
            n_edges_in=int(fi.sum()),
            max_fan_in=int(fi.max()) if fi.size else 0,
            mean_fan_in=float(fi.mean()) if fi.size else 0.0,
            n_edges_out=int(fo.sum()),
            max_fan_out=int(fo.max()) if fo.size else 0,
            mean_fan_out=float(fo.mean()) if fo.size else 0.0))
    return tuple(out)


def shard_imbalance(stats: Sequence[ShardStats]) -> float:
    """Max/mean ratio of per-shard synaptic work (1.0 = perfectly even;
    the weak-scaling efficiency ceiling is roughly its reciprocal)."""
    edges = [s.n_edges_in for s in stats]
    mean = sum(edges) / max(1, len(edges))
    return max(edges) / mean if mean else 1.0


@dataclasses.dataclass(frozen=True)
class ConnectivityStats:
    """Topology statistics the dispatch policy decides from.

    ``padding_fraction_in``/``_out`` are the air fractions of the
    *tightest* padded layouts (cap == max degree): how much of the
    fan-in gather / fan-out scatter would multiply zeros.  A hub-heavy
    topology has a large max/mean gap and a padding fraction near 1 --
    exactly where the fixed-cap gather stops paying and the policy
    should pick the dense product or the spike-list path instead.
    """

    n: int
    n_edges: int
    density: float
    max_fan_in: int
    mean_fan_in: float
    max_fan_out: int
    mean_fan_out: float
    padding_fraction_in: float
    padding_fraction_out: float


def stats(c: np.ndarray) -> ConnectivityStats:
    """Host-side summary of a concrete connection list (the dispatch
    policy's trace-time input -- see :mod:`repro.core.dispatch_policy`)."""
    validate(np.asarray(c) > 0 if np.asarray(c).dtype != np.bool_ else c)
    cb = np.asarray(c) > 0
    n = cb.shape[0]
    fi = cb.sum(axis=0)
    fo = cb.sum(axis=1)
    edges = int(cb.sum())
    max_fi = int(fi.max()) if n else 0
    max_fo = int(fo.max()) if n else 0
    frac = lambda mx: 1.0 - edges / max(1, n * max(1, mx))
    return ConnectivityStats(
        n=n, n_edges=edges, density=edges / max(1, n * n),
        max_fan_in=max_fi, mean_fan_in=float(fi.mean()) if n else 0.0,
        max_fan_out=max_fo, mean_fan_out=float(fo.mean()) if n else 0.0,
        padding_fraction_in=frac(max_fi), padding_fraction_out=frac(max_fo))
