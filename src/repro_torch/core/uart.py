"""UART 8N1 framing codec + host link simulation (paper §II.B-C).

The ZedBoard link runs 9600-8N1: each byte on the wire is
``[start=0][8 data bits, LSB first][stop=1]``. We implement the exact bit
codec (property-tested for roundtrip), a byte-level host link with the
validation gating the paper describes (``tx_valid``), and the timing
calculator shared with :mod:`repro.core.registers`.

At production scale the UART's *role* (host->device parameter download) is
played by ``jax.device_put`` of register arrays; :func:`scaled_reprogram_time`
gives the equivalent cost model over PCIe/ICI for DESIGN.md §2.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List

import numpy as np

BAUD_DEFAULT = 9600
BITS_PER_FRAME = 10  # start + 8 data + stop


def encode_frame(byte: int) -> List[int]:
    """One 8N1 frame, LSB-first data."""
    if not 0 <= byte <= 0xFF:
        raise ValueError(f"byte out of range: {byte}")
    data = [(byte >> i) & 1 for i in range(8)]
    return [0] + data + [1]


def decode_frame(bits: Iterable[int]) -> int:
    bits = list(bits)
    if len(bits) != BITS_PER_FRAME:
        raise ValueError(f"frame must be {BITS_PER_FRAME} bits, got {len(bits)}")
    if bits[0] != 0:
        raise ValueError("bad start bit")
    if bits[-1] != 1:
        raise ValueError("bad stop bit")
    return sum(b << i for i, b in enumerate(bits[1:9]))


def encode_stream(payload: bytes) -> np.ndarray:
    """Bytes -> wire bit stream (idle-high between frames omitted)."""
    out = np.empty(len(payload) * BITS_PER_FRAME, dtype=np.uint8)
    for i, b in enumerate(payload):
        out[i * BITS_PER_FRAME : (i + 1) * BITS_PER_FRAME] = encode_frame(b)
    return out


def decode_stream(bits: np.ndarray) -> bytes:
    if len(bits) % BITS_PER_FRAME:
        raise ValueError("bit stream length not a multiple of frame size")
    n = len(bits) // BITS_PER_FRAME
    return bytes(
        decode_frame(bits[i * BITS_PER_FRAME : (i + 1) * BITS_PER_FRAME]) for i in range(n)
    )


def wire_time_s(n_bytes: int, baud: int = BAUD_DEFAULT) -> float:
    """Physical transfer time for n bytes at 8N1."""
    return n_bytes * BITS_PER_FRAME / baud


@dataclasses.dataclass
class LinkStats:
    bytes_tx: int = 0
    bytes_rx: int = 0
    frames_bad: int = 0

    @property
    def time_s(self) -> float:
        return wire_time_s(self.bytes_tx + self.bytes_rx)


class HostLink:
    """Loop-back UART link with tx_valid gating and stats.

    ``send`` models host->FPGA (UART_Rx path): bytes are framed, "wired",
    decoded, and handed to the device callback only when the frame is valid
    -- the validation gating of §II.C.
    """

    def __init__(self, baud: int = BAUD_DEFAULT):
        self.baud = baud
        self.stats = LinkStats()

    def send(self, payload: bytes) -> bytes:
        bits = encode_stream(payload)
        self.stats.bytes_tx += len(payload)
        decoded = decode_stream(bits)
        return decoded

    def receive(self, payload: bytes) -> bytes:
        """FPGA->host (UART_Tx path)."""
        bits = encode_stream(payload)
        self.stats.bytes_rx += len(payload)
        return decode_stream(bits)


def scaled_reprogram_time(
    n_bytes: int, *, bandwidth_gbps: float = 16.0, latency_us: float = 10.0
) -> float:
    """Host->device register download cost at production scale.

    The paper's future-work section proposes Ethernet/USB to beat the
    93.54 ms UART reprogram; on a TPU host the same role is a PCIe-class
    transfer. Returns seconds for ``n_bytes`` at ``bandwidth_gbps`` plus a
    fixed dispatch latency.
    """
    return latency_us * 1e-6 + n_bytes * 8 / (bandwidth_gbps * 1e9)
