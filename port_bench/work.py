"""What a tick needs, counted from its shapes, and the chip's peaks.

The counts are of the work the inputs need, not of what a program happens
to do: each network's own connection matrix once (as a dense float32
matrix or as float32 values with int32 indices, whichever is smaller), its
state and drive once. A padded fabric, a resident identity input matrix or
a second read of the same bytes is the program's cost and is not counted.
So a roofline share from these counts cannot pass 100 % unless the time
leaves out part of the work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# Published dense peaks, SXM part, by the name torch.cuda.get_device_name()
# gives: float32 outside the tensor cores, and HBM bandwidth.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}

# The device kernels that compute a tick's matrix products, by the backend
# that ran the tick: name fragments of the kernels in a profiler trace.
PRODUCT_KERNELS: Dict[str, Tuple[str, ...]] = {
    # kernel B2, the whole tick (the drive's product runs outside it)
    "pallas_fused": ("tick_fused_kernel",),
    # kernel B1, the product and the LIF step
    "pallas": ("lif_step_kernel",),
    # cuBLAS: the recurrent product and the drive's, and a split-K reduce
    "jnp": ("gemvx", "gemv2", "gemm", "splitKreduce"),
    # the fan-in gather and its contraction (cuBLAS); B3 / B4 on the spike list
    "event": ("_scatter_gather_elementwise_kernel", "gemv2T_kernel", "event_dispatch"),
}


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def add(self, other: "Work", times: float = 1.0) -> None:
        self.flops += other.flops * times
        self.bytes += other.bytes * times

    def seconds(self, kind: str) -> Optional[float]:
        """The least time the chip could take for this work (None off the table)."""
        peak = PEAKS.get(kind)
        if peak is None:
            return None
        return max(self.flops / peak["f32_flops"], self.bytes / peak["hbm_bytes"])


def matrix_bytes(n_pre: int, n_post: int, nnz: int) -> int:
    """A connection matrix read once: dense float32, or float32 values with
    int32 indices, whichever is smaller."""
    return min(4 * n_pre * n_post, 8 * nnz)


def product(n: int, nnz: int, *, n_in: int = 0, dense_input: bool = False) -> Work:
    """One network's synaptic product and LIF update for one tick: the matrix
    once (``nnz`` closed synapses, two operations each), the previous spikes
    and the drive in, ``v`` and ``r`` read and written, the spikes written.
    ``dense_input``: the drive is ``ext @ w_in`` with a dense ``(n_in, n)``
    ``w_in`` (read once, two operations an entry); otherwise the drive is
    ``ext`` itself on the first ``n_in`` neurons."""
    flops = 2.0 * nnz + 6.0 * n
    nbytes = matrix_bytes(n, n, nnz) + 4.0 * (n + n_in + 2 * n + 2 * n + n)
    if dense_input:
        flops += 2.0 * n_in * n
        nbytes += 4.0 * n_in * n
    return Work(flops, nbytes)


def roofline_share(work: Work, seconds: float, kind: str) -> Optional[float]:
    """``work``'s least time over ``seconds``, in percent (None when it cannot
    be told: no peak for this card, or no time)."""
    least = work.seconds(kind)
    if least is None or not seconds or seconds <= 0:
        return None
    return 100.0 * least / seconds


def is_product_kernel(name: str, backend: str) -> bool:
    return any(f in name for f in PRODUCT_KERNELS.get(backend, ()))
