"""Byte-exact register bank + UART transaction cost model (paper §II.C, §III.B).

The FPGA holds all SNN parameters in a UART-fed register bank; runtime
reconfiguration = rewriting these registers (never re-synthesis). We
reproduce the register layout byte-for-byte and the paper's transaction
arithmetic exactly:

  74-neuron system:
    CL registers   74 rows x ceil(74/8)=10 bytes  -> 740 transactions
    Thresholds     74 x 1 byte                    ->  74
    Weights        74 x 1 byte                    ->  74
    Impulses       ceil(74/8)=10 bytes            ->  10
    total                                             898 transactions
  1-neuron system: 1 + 1 + 1 + 1 = 4 transactions.

Timing: the paper charges 104.17 us per transaction (one 9600-baud bit
time), i.e. 898 txns -> 93.54 ms, and 4 txns -> 416.68 us. A byte on a
9600-8N1 wire actually occupies 10 bit times (1.0417 ms); we reproduce the
paper's figure as ``PAPER`` and also report the bit-accurate ``WIRE_8N1``
model (10x the paper's). EXPERIMENTS.md discusses the discrepancy.

Note the paper's count implies *one weight byte per neuron* (74, not
74x74): the hardware applies a per-neuron weight to the summed input. The
bank supports both that layout and the general per-synapse matrix layout
used by the scaled framework.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict

import numpy as np

from repro_torch.core import connectivity

BAUD = 9600
BIT_TIME_S = 1.0 / BAUD                 # 104.17 us -- the paper's "transaction"
BYTE_TIME_8N1_S = 10.0 / BAUD           # start + 8 data + stop


class TimingModel(str, enum.Enum):
    PAPER = "paper"        # 1 bit-time per transaction (paper's arithmetic)
    WIRE_8N1 = "wire_8n1"  # 10 bit-times per byte (physical 8N1 framing)


class WeightLayout(str, enum.Enum):
    PER_NEURON = "per_neuron"    # paper's register count: N weight bytes
    PER_SYNAPSE = "per_synapse"  # general N x N u8 matrix


@dataclasses.dataclass
class TransactionBreakdown:
    connection_list: int
    thresholds: int
    weights: int
    impulses: int

    @property
    def total(self) -> int:
        return self.connection_list + self.thresholds + self.weights + self.impulses

    def time_s(self, model: TimingModel = TimingModel.PAPER) -> float:
        per = BIT_TIME_S if model == TimingModel.PAPER else BYTE_TIME_8N1_S
        return self.total * per


def transaction_breakdown(
    n_neurons: int, layout: WeightLayout = WeightLayout.PER_NEURON
) -> TransactionBreakdown:
    """The paper's §III.B arithmetic, generalized to any N."""
    row_bytes = math.ceil(n_neurons / 8)
    cl = n_neurons * row_bytes
    th = n_neurons
    w = n_neurons if layout == WeightLayout.PER_NEURON else n_neurons * n_neurons
    imp = row_bytes
    return TransactionBreakdown(cl, th, w, imp)


class RegisterBank:
    """Host-visible parameter store; the single source of truth the SNN
    module reads, mirroring ``reg_input_clf`` / ``reg_threshclf`` /
    ``weight_reg`` / ``impulse_reg`` of the waveform (Fig. 5/7).

    All fields are u8 numpy arrays (byte-exact). ``serialize()`` produces
    the UART byte stream; ``load_bytes()`` applies one (the device side).
    Rewriting registers never changes shapes -> jitted programs that take
    these arrays as inputs are never re-traced: the "no re-synthesis"
    property.
    """

    def __init__(
        self,
        n_neurons: int,
        *,
        weight_layout: WeightLayout = WeightLayout.PER_NEURON,
    ):
        self.n = int(n_neurons)
        self.weight_layout = weight_layout
        row_bytes = math.ceil(self.n / 8)
        self.connection_list = np.zeros((self.n, row_bytes), dtype=np.uint8)
        self.thresholds = np.zeros((self.n,), dtype=np.uint8)
        if weight_layout == WeightLayout.PER_NEURON:
            self.weights = np.zeros((self.n,), dtype=np.uint8)
        else:
            self.weights = np.zeros((self.n, self.n), dtype=np.uint8)
        self.impulses = np.zeros((row_bytes,), dtype=np.uint8)
        self.refractory = np.zeros((self.n,), dtype=np.uint8)
        self.leak = np.zeros((self.n,), dtype=np.uint8)
        # tonic-input register (paper Eq. 1 I_bias); device-local like
        # refractory/leak, not part of the §III.B transaction stream
        self.bias = np.zeros((self.n,), dtype=np.uint8)

    # -- host-side setters ------------------------------------------------
    def set_connection_list(self, c: np.ndarray) -> None:
        connectivity.validate(c)
        if c.shape != (self.n, self.n):
            raise ValueError(f"expected ({self.n},{self.n}), got {c.shape}")
        self.connection_list = connectivity.pack_bits(c)

    def get_connection_list(self) -> np.ndarray:
        return connectivity.unpack_bits(self.connection_list, self.n)

    def set_thresholds(self, th: np.ndarray) -> None:
        self.thresholds = np.asarray(th, dtype=np.uint8).reshape(self.n)

    def set_weights(self, w: np.ndarray) -> None:
        w = np.asarray(w, dtype=np.uint8)
        expect = (self.n,) if self.weight_layout == WeightLayout.PER_NEURON else (self.n, self.n)
        if w.shape != expect:
            raise ValueError(f"expected {expect}, got {w.shape}")
        self.weights = w

    def set_impulses(self, spikes: np.ndarray) -> None:
        """Bit-pack the input spike vector (the impulse register)."""
        s = np.asarray(spikes).astype(np.bool_).reshape(1, self.n)
        self.impulses = np.packbits(s, axis=1)[0]

    def get_impulses(self) -> np.ndarray:
        return np.unpackbits(self.impulses.reshape(1, -1), axis=1)[0, : self.n]

    def set_refractory(self, r) -> None:
        self.refractory = np.asarray(np.broadcast_to(r, (self.n,)), dtype=np.uint8).copy()

    def set_leak(self, lam) -> None:
        self.leak = np.asarray(np.broadcast_to(lam, (self.n,)), dtype=np.uint8).copy()

    def set_bias(self, b) -> None:
        self.bias = np.asarray(np.broadcast_to(b, (self.n,)), dtype=np.uint8).copy()

    # -- wire format -------------------------------------------------------
    def serialize(self) -> bytes:
        """CL rows, thresholds, weights, impulses -- the §III.B order."""
        parts = [
            self.connection_list.tobytes(),
            self.thresholds.tobytes(),
            self.weights.tobytes(),
            self.impulses.tobytes(),
        ]
        return b"".join(parts)

    def load_bytes(self, payload: bytes) -> None:
        expect = self.breakdown().total
        if len(payload) != expect:
            raise ValueError(f"expected {expect} bytes, got {len(payload)}")
        a = np.frombuffer(payload, dtype=np.uint8)
        o = 0
        cl_n = self.connection_list.size
        self.connection_list = a[o : o + cl_n].reshape(self.connection_list.shape).copy(); o += cl_n
        self.thresholds = a[o : o + self.n].copy(); o += self.n
        w_n = self.weights.size
        self.weights = a[o : o + w_n].reshape(self.weights.shape).copy(); o += w_n
        self.impulses = a[o:].copy()

    def breakdown(self) -> TransactionBreakdown:
        return transaction_breakdown(self.n, self.weight_layout)

    def reprogram_time_s(self, model: TimingModel = TimingModel.PAPER) -> float:
        return self.breakdown().time_s(model)

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {
            "connection_list": self.get_connection_list(),
            "thresholds": self.thresholds,
            "weights": self.weights,
            "impulses": self.get_impulses(),
            "refractory": self.refractory,
            "leak": self.leak,
        }
