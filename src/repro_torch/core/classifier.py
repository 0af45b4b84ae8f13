"""The paper's classification workflow, end to end (§III + §IV).

Counterpart of ``repro.core.classifier``. Host side: encode features to
spikes, train the 2-layer SNN offline, quantize to the u8 hardware grid and
download through the register bank's UART byte protocol. Device side:
bit-faithful integer LIF inference, what the FPGA executes.

Every function that computes takes ``device=`` (None: the CUDA card, which
raises without one; ``"cpu"`` runs on the host). ``train`` runs on that
device with torch autograd and the port's AdamW,
:func:`repro_torch.optim.adamw.update` with ``weight_decay=0.0``, as the
reference's ``_train_step`` calls its own. Its initial parameters come
from a ``torch.Generator`` on the CPU, moved to the device afterwards, so
one seed names one model on either device (not the reference's:
``jax.random`` draws other numbers).

``predict_int`` computes the synaptic product on the device with kernel B6
(:func:`repro_torch.kernels.ops.spike_matmul`, one launch per call): the
downloaded bank's u8 weight block and its connection-list block go up as
f32, and B6 masks and sums them in f32. That is exact -- bitwise the
reference's int32 product -- while every partial sum is an integer below
2^24; the call checks ``max|x| * max_col sum(w) < 2^24`` on the host first
and raises otherwise. The LIF ticks then run on the integer datapath.

Weights are constrained non-negative (softplus) to match the hardware's
0-255 weight registers; argmax readout over output-neuron accumulated
potential is invariant to the common offset. Predictions are int32 numpy
arrays, as the reference's are; ties go to the lower index in both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import connectivity, quant, uart
from repro_torch.core.lif import LIFParams, LIFState, lif_step
from repro_torch.core.registers import RegisterBank, WeightLayout
from repro_torch.kernels import ops
from repro_torch.optim import adamw

EXACT_BOUND = 2 ** 24   # f32 holds every integer below this exactly


@dataclasses.dataclass
class TrainedSNN:
    w: np.ndarray            # float32 non-negative (n_in, n_out)
    bias: np.ndarray         # float32 non-negative (n_out,) tonic I_bias (Eq. 1)
    v_th: float
    n_ticks: int
    leak: float
    r_ref: int


def _forward_float(w: torch.Tensor, bias: torch.Tensor, x_drive: torch.Tensor, *,
                   v_th: float, n_ticks: int, leak: float, surrogate: bool) -> torch.Tensor:
    """Clamp input drive for ``n_ticks``; return output logits.

    Output neurons integrate ``x_drive @ w + I_bias`` each tick (paper Eq. 1);
    logits = spike count + ``v / v_th``. Under reset-by-subtraction
    ``count * v_th + v_final == n_ticks * drive``, so the readout is an exact
    monotone image of the drive."""
    b = x_drive.shape[0]
    n_out = w.shape[1]
    p = LIFParams.make(n_out, v_th=v_th, leak=leak, r_ref=0, device=w.device)
    syn = x_drive @ w + bias[None, :]
    state = LIFState.zeros((b,), n_out, device=w.device)
    counts = torch.zeros((b, n_out), dtype=torch.float32, device=w.device)
    for _ in range(n_ticks):
        state = lif_step(state, syn, p, mode="fixed_leak", surrogate=surrogate,
                         reset="subtract")
        counts = counts + state.y
    return counts + state.v / p.v_th


def _drives(raw: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The per-class drive ``x @ w + I_bias`` with softplus-constrained
    non-negative weights and bias."""
    w = F.softplus(raw["w"]) * 2.0
    bias = F.softplus(raw["b"]) * 2.0
    return x @ w + bias[None, :]


def init_raw(n_in: int, n_out: int, seed: int, device=None) -> Dict[str, torch.Tensor]:
    """The unconstrained initial parameters: ``N(0, 0.3^2)`` weights and
    ``N(0, 0.1^2)`` biases, drawn on the CPU from ``seed`` and then moved."""
    dev = _device.resolve(device)
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    w = torch.randn((n_in, n_out), generator=g, dtype=torch.float32) * 0.3
    b = torch.randn((n_out,), generator=g, dtype=torch.float32) * 0.1
    return {"w": w.to(dev), "b": b.to(dev)}


def _fit(raw: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor, epochs: int,
         lr: float) -> Dict[str, torch.Tensor]:
    """Full-batch AdamW on the drive's cross-entropy from ``raw`` (not
    written); returns the fitted unconstrained parameters."""
    def loss_fn(params):
        lp = torch.log_softmax(_drives(params, x), dim=-1)
        return -lp.gather(-1, y[:, None]).mean()

    params = {k: v.detach() for k, v in raw.items()}
    opt = adamw.init(params)
    for _ in range(int(epochs)):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss_fn(leaves), list(leaves.values()))))
        with torch.no_grad():
            params, opt = adamw.update(grads, opt, params, lr=lr, weight_decay=0.0)
    return params


def _upload(x: np.ndarray, y: Optional[np.ndarray], dev: torch.device):
    xd = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yd = None if y is None else torch.as_tensor(np.asarray(y), dtype=torch.int64, device=dev)
    return xd, yd


def trained_from_raw(raw: Dict[str, torch.Tensor], x: torch.Tensor, n_ticks: int, *,
                     v_th: Optional[float] = None, leak: float = 0.0) -> TrainedSNN:
    """The constrained host-side model from fitted ``raw``; ``v_th`` None sets
    it just below the winners' typical per-tick drive on ``x``: 0.9 x the
    median over samples of the largest drive, plus 1e-3 (the reference's
    rule, in its float32 arithmetic)."""
    with torch.no_grad():
        w = (F.softplus(raw["w"]) * 2.0).cpu().numpy()
        bias = (F.softplus(raw["b"]) * 2.0).cpu().numpy()
        if v_th is None:
            d = _drives(raw, x).cpu().numpy()
            v_th = float(np.median(d.max(axis=1)) * 0.9) + 1e-3
    return TrainedSNN(w=w, bias=bias, v_th=v_th, n_ticks=n_ticks, leak=leak, r_ref=0)


def train(x: np.ndarray, y: np.ndarray, cfg: ModelConfig, *, epochs: int = 1500,
          lr: float = 0.1, v_th: Optional[float] = None, leak: float = 0.0, seed: int = 0,
          device=None) -> TrainedSNN:
    """Full-batch training of the paper's 2-layer net on ``device``.

    Optimizes the per-class *drive* ``x @ w + I_bias`` directly: with a
    threshold shared across output neurons the hardware readout is the same
    strictly monotone function of each neuron's constant drive, so training
    the drive trains the spiking classifier. Then ``v_th`` is set so that
    only the winning output neuron spikes (:func:`trained_from_raw`).
    """
    dev = _device.resolve(device)
    n_in, n_out = cfg.layer_sizes
    xd, yd = _upload(x, y, dev)
    raw = _fit(init_raw(n_in, n_out, seed, dev), xd, yd, epochs, lr)
    return trained_from_raw(raw, xd, cfg.n_ticks, v_th=v_th, leak=leak)


def predict_float(model: TrainedSNN, x: np.ndarray, *, device=None) -> np.ndarray:
    """argmax of the float spiking readout, on ``device``."""
    return np.asarray(torch.argmax(logits_float(model, x, device=device), dim=-1)
                      .to(torch.int32).cpu())


def logits_float(model: TrainedSNN, x: np.ndarray, *, device=None) -> torch.Tensor:
    """The float model's readout logits (B, n_out) on ``device``."""
    dev = _device.resolve(device)
    w = torch.as_tensor(np.asarray(model.w, np.float32), device=dev)
    bias = torch.as_tensor(np.asarray(model.bias, np.float32), device=dev)
    xd, _ = _upload(x, None, dev)
    return _forward_float(w, bias, xd, v_th=model.v_th, n_ticks=model.n_ticks,
                          leak=model.leak, surrogate=False)


# ---------------------------------------------------------------------------
# hardware download path


@dataclasses.dataclass
class DeployedSNN:
    """What lives on the device after the UART download."""
    bank: RegisterBank
    w_int: np.ndarray       # i32 (n_in, n_out) reconstructed from registers
    th_int: np.ndarray      # i32 (n_out,)
    b_int: np.ndarray       # i32 (n_out,) tonic I_bias register
    scale: float
    n_ticks: int


def deploy(model: TrainedSNN, *, n_neurons: Optional[int] = None, device=None) -> DeployedSNN:
    """Quantize (on ``device``) -> pack into a RegisterBank -> serialize over
    the UART byte protocol -> reload on the 'device' -> reconstruct the
    integer network.

    The general per-synapse layout (paper §II.A); the flat neuron array is
    ``[inputs..., outputs...]`` as in Fig. 4/6, the connection list wiring
    the bipartite layers.
    """
    dev = _device.resolve(device)
    n_in, n_out = model.w.shape
    n = n_neurons or (n_in + n_out)
    # One grid for weights, biases and thresholds; it must cover v_th (8-bit
    # threshold registers) or th_int clips.
    w_max = float(max(model.w.max(), model.bias.max(), model.v_th, 1e-8))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    qw = quant.quantize_u8(f32(model.w), w_max)
    qb = quant.quantize_u8(f32(model.bias), w_max)
    th_q = quant.quantize_threshold(
        torch.full((n_out,), model.v_th, dtype=torch.float32, device=dev), qw.scale)

    bank = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
    w_full = np.zeros((n, n), np.uint8)
    w_full[:n_in, n_in : n_in + n_out] = qw.q.cpu().numpy()
    bank.set_weights(w_full)
    bank.set_connection_list(connectivity.layered([n_in, n_out]))
    th_full = np.zeros((n,), np.uint8)
    th_full[n_in : n_in + n_out] = th_q.cpu().numpy()
    bank.set_thresholds(th_full)
    b_full = np.zeros((n,), np.uint8)
    b_full[n_in : n_in + n_out] = qb.q.cpu().numpy()
    bank.set_bias(b_full)

    # wire transfer: serialize -> (UART) -> reload
    received = uart.HostLink().send(bank.serialize())
    bank_dev = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
    bank_dev.load_bytes(received)
    bank_dev.set_bias(bank.bias)  # device-local registers (not in the stream)

    c = bank_dev.get_connection_list().astype(np.int32)
    w_dev = bank_dev.weights.astype(np.int32) * c
    w_int = w_dev[:n_in, n_in : n_in + n_out]
    th_int = bank_dev.thresholds[n_in : n_in + n_out].astype(np.int32)
    b_int = bank_dev.bias[n_in : n_in + n_out].astype(np.int32)
    return DeployedSNN(bank=bank_dev, w_int=w_int, th_int=th_int, b_int=b_int,
                       scale=float(qw.scale), n_ticks=model.n_ticks)


def synaptic_input(dep: DeployedSNN, x_spikes: np.ndarray, *, device=None) -> torch.Tensor:
    """``x @ (W*C)`` on ``device`` as int32 (B, n_out): one launch of kernel
    B6 on the bank's weight and connection-list blocks.

    Raises ``ValueError`` unless ``max|x| * max_col sum(w) < 2^24``, the
    range in which B6's f32 sums are exact."""
    dev = _device.resolve(device)
    n_in, n_out = dep.w_int.shape
    x = np.asarray(x_spikes).astype(np.int32)
    if dep.bank.weights.ndim != 2:
        raise ValueError("predict_int reads a per-synapse weight bank")
    cols = slice(n_in, n_in + n_out)
    w = dep.bank.weights[:n_in, cols]
    c = dep.bank.get_connection_list()[:n_in, cols]
    reach = int(np.abs(x.astype(np.int64)).max(initial=0)) * int(
        w.astype(np.int64).sum(axis=0).max(initial=0))
    if reach >= EXACT_BOUND:
        raise ValueError(
            f"max|x| * max_col sum(w) = {reach} >= 2^24: the f32 synaptic product "
            "would not be exact")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return ops.spike_matmul(up(x), up(w), up(c)).to(torch.int32)


def predict_int(dep: DeployedSNN, x_spikes: np.ndarray, *, device=None) -> np.ndarray:
    """Bit-faithful integer inference (the FPGA datapath) on ``device``.

    ``x_spikes``: (B, n_in) integer drive (binary spikes or quantized
    levels). Returns argmax over ``count * v_th + v_final``, the exact
    rate-coding readout."""
    dev = _device.resolve(device)
    syn = synaptic_input(dep, x_spikes, device=dev)
    b, n_out = syn.shape
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    zeros = torch.zeros(n_out, dtype=torch.int32, device=dev)
    th = i32(dep.th_int)
    p = LIFParams(v_th=th, leak=zeros, r_ref=zeros, gain=torch.ones_like(zeros),
                  i_bias=i32(dep.b_int), v_reset=zeros)
    z = torch.zeros((b, n_out), dtype=torch.int32, device=dev)
    state = LIFState(v=z, r=z, y=z)
    counts = z
    for _ in range(dep.n_ticks):
        state = lif_step(state, syn, p, mode="int", reset="subtract")
        counts = counts + state.y
    score = counts * th + state.v
    return np.asarray(torch.argmax(score, dim=-1).to(torch.int32).cpu())


def accuracy(pred: np.ndarray, y: np.ndarray) -> float:
    return float((pred == y).mean())
