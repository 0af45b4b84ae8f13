"""On-device learning on the MNIST-8x8 fabric: STDP features + R-STDP readout.

Counterpart of ``examples/online_learning.py``. The paper's processor is
inference-only: weights are trained off-chip and streamed in over the UART.
This example runs the NeuroCoreX direction (arXiv:2506.14138) on the same
fabric: all learning happens inside the network tick loop, from a random
init, with weights inside the u8 register range at every tick:

  stage 1  64 inputs -> 64 feature neurons, pair STDP (unsupervised).
           Competition = fixed-leak thresholds + host-side homeostasis:
           every spike bumps the winner's *threshold register*.
  stage 2  64 features -> 10 outputs, R-STDP: eligibility accumulates
           during the presentation, a terminal +/- dopamine scalar (was
           the argmax right?) converts it into the weight update.
  readback the learned u8 weights serialize through the RegisterBank /
           UART byte protocol and must produce *identical spikes* after the
           round trip.

``--backend`` sets all three tick engines (inference, feature learning,
readout learning): ``pallas`` (the default) runs kernel B1 and the
plasticity kernel B5, ``pallas_fused`` kernel B2 and B5, ``jnp`` the plain
PyTorch tick. The random draws are the reference's, on numpy, so the initial
weights, thresholds and presentation order equal its own bit for bit. A
presentation never reads the device back: only the ``log_every`` line and
the accuracies do.

  PYTHONPATH=src python -m repro_torch.examples.online_learning [--fast] \
      [--backend {jnp,pallas,pallas_fused}] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import get_bundle
from repro_torch.configs.mnist_stdp import N_CLASSES, N_HIDDEN, N_INPUT, RUN
from repro_torch.core import connectivity
from repro_torch.core.engine import EngineOptions, TickEngine
from repro_torch.core.lif import LIFParams
from repro_torch.core.network import SNNParams, SNNState, params_from_registers
from repro_torch.core.registers import RegisterBank, WeightLayout
from repro_torch.data import mnist
from repro_torch.plasticity import PlasticityState, apply_reward

BACKENDS = ("jnp", "pallas", "pallas_fused")
DEFAULT_BACKEND = "pallas"
# A run's schedule: (MNIST samples per class, stage-1 epochs, stage-2 epochs).
SCHEDULES = {"fast": (16, 2, 3), "full": (40, 3, 8)}


@dataclasses.dataclass(frozen=True)
class Engines:
    """One tick datapath, three uses: frozen inference, STDP feature
    learning, R-STDP readout learning (one fabric, two learning-engine
    register settings)."""

    infer: TickEngine
    feature: TickEngine
    readout: TickEngine


ENGINES = {b: Engines(infer=TickEngine(EngineOptions(backend=b)),
                      feature=TickEngine(EngineOptions(backend=b, plasticity=RUN.feature)),
                      readout=TickEngine(EngineOptions(backend=b, plasticity=RUN.readout)))
           for b in BACKENDS}


# ---------------------------------------------------------------------------
# network construction


def routing_mask() -> np.ndarray:
    """Feed-forward block + lateral hidden->hidden WTA block (no self-loops)."""
    c = connectivity.layered([N_INPUT, N_HIDDEN])
    lat = connectivity.all_to_all(N_HIDDEN)
    c[N_INPUT:, N_INPUT:] = lat
    return c


@functools.lru_cache(maxsize=None)
def _fabric(dev: torch.device) -> Dict[str, object]:
    """What both nets hold fixed, made once per device so that a
    presentation copies nothing from the host: each net's parameters but
    ``w`` (the feature net's thresholds are replaced by theta's), the
    plastic mask, the WTA block, the latency weights and the class ids.
    Callers never write them."""
    n, m = N_INPUT + N_HIDDEN, N_HIDDEN + N_CLASSES
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    leak = np.zeros((n,))
    leak[N_INPUT:] = RUN.leak
    v_th_out = np.ones((m,))
    v_th_out[N_HIDDEN:] = RUN.readout_v_th
    return {
        "feature": SNNParams(
            w=None, c=f32(routing_mask()), w_in=torch.eye(n, device=dev) * 2.0,
            lif=dataclasses.replace(LIFParams.make(n, device=dev), leak=f32(leak))),
        "readout": SNNParams(
            w=None, c=f32(connectivity.layered([N_HIDDEN, N_CLASSES])),
            w_in=torch.eye(m, device=dev) * 2.0,
            lif=dataclasses.replace(LIFParams.make(m, device=dev), v_th=f32(v_th_out))),
        "plastic": f32(connectivity.layered([N_INPUT, N_HIDDEN])),
        "lateral": f32(-RUN.lateral_inhibition * connectivity.all_to_all(N_HIDDEN)),
        "ones_in": torch.ones((N_INPUT,), device=dev),
        "lat_w": torch.arange(RUN.ticks_per_sample, 0, -1, dtype=torch.float32, device=dev),
        "classes": torch.arange(m, device=dev),
    }


def plastic_mask(device=None) -> torch.Tensor:
    """Only the feed-forward input->hidden block learns."""
    return _fabric(_device.resolve(device))["plastic"]


def with_lateral_inhibition(w: torch.Tensor) -> torch.Tensor:
    """Install the fixed negative WTA block (the on-chip inhibitory bank)
    into a copy of ``w``."""
    out = w.clone()
    out[N_INPUT:, N_INPUT:] = _fabric(w.device)["lateral"]
    return out


def feature_net(w: torch.Tensor, theta: torch.Tensor) -> SNNParams:
    """64 -> 64 feature net with a frozen WTA block; hidden thresholds carry theta."""
    k = _fabric(w.device)
    net = k["feature"]
    v_th = torch.cat([k["ones_in"], RUN.v_th_base + theta])
    return dataclasses.replace(net, w=w, lif=dataclasses.replace(net.lif, v_th=v_th))


def readout_net(w: torch.Tensor) -> SNNParams:
    """64 -> 10 bipartite readout net driven by replayed feature spikes."""
    return dataclasses.replace(_fabric(w.device)["readout"], w=w)


def _clamp(ext_row: torch.Tensor, n: int, ticks: int) -> torch.Tensor:
    """Level-coded presentation: clamp a spike vector for ``ticks`` ticks."""
    ext = torch.zeros((ext_row.shape[0], n), dtype=torch.float32, device=ext_row.device)
    ext[:, : ext_row.shape[1]] = ext_row
    return ext.unsqueeze(0).expand((ticks,) + tuple(ext.shape))


# ---------------------------------------------------------------------------
# stage 1: unsupervised STDP features


def stdp_present(w, theta, x, *, backend=DEFAULT_BACKEND):
    """One presentation: learning rollout + host-side homeostasis.

    Two slow register-level loops close around the on-device STDP:
    threshold homeostasis (spikers get harder to fire) and synaptic scaling
    (each feature neuron's fan-in is renormalized to a fixed budget, so
    potentiation on the won pattern costs weight elsewhere). Returns
    ``(w2, theta2, counts)``; ``w`` and ``theta`` are never written.
    """
    n = N_INPUT + N_HIDDEN
    dev = w.device
    params = feature_net(w, theta)
    ext = _clamp(x.unsqueeze(0), n, RUN.ticks_per_sample)
    state = SNNState.zeros((1,), n, device=dev)
    pstate = PlasticityState.zeros((1,), n, device=dev)
    (_, _, w2), raster = ENGINES[backend].feature.learning_rollout(
        params, state, pstate, ext, RUN.ticks_per_sample, plastic_c=_fabric(dev)["plastic"])
    # w2 is the rollout's own buffer (the caller's w is never written), so
    # the scaled block goes straight into it.
    ff = w2[:N_INPUT, N_INPUT:]
    scale = RUN.w_total / torch.clamp_min(ff.sum(0), 1e-6)
    w2[:N_INPUT, N_INPUT:] = torch.clamp(ff * scale.unsqueeze(0), RUN.feature.w_min,
                                         RUN.feature.w_max)
    counts = raster[:, 0, N_INPUT:].sum(0)
    theta2 = torch.clamp(theta + RUN.theta_plus * counts - RUN.theta_drift,
                         RUN.theta_min, RUN.theta_max)
    return w2, theta2, counts


def feature_counts(w, theta, xs, *, backend=DEFAULT_BACKEND):
    """Inference-only feature responses for a batch (no plasticity).

    Returns latency-weighted scores (earlier spike => stronger match -- the
    competition variable the WTA actually races on) and the raster.
    """
    n = N_INPUT + N_HIDDEN
    params = feature_net(w, theta)
    ext = _clamp(xs, n, RUN.ticks_per_sample)
    state = SNNState.zeros((xs.shape[0],), n, device=w.device)
    _, raster = ENGINES[backend].infer.rollout(params, state, ext, RUN.ticks_per_sample)
    score = torch.einsum("t,tbn->bn", _fabric(w.device)["lat_w"], raster[..., N_INPUT:])
    return score, raster


def init_feature_state(rng, device=None):
    """Sparse dispersed receptive fields + jittered thresholds: enough
    across-neuron drive variance that threshold crossings spread over
    several ticks, which is what lets the (1-tick-delayed) WTA block pick
    distinct winners. The draws are the reference's, on numpy."""
    n = N_INPUT + N_HIDDEN
    w = (rng.uniform(RUN.w_init_lo, RUN.w_init_hi, (n, n))
         * (rng.random((n, n)) < RUN.w_init_density)).astype(np.float32)
    theta = rng.uniform(0.0, RUN.theta_init_jitter, N_HIDDEN).astype(np.float32)
    dev = _device.resolve(device)
    return (with_lateral_inhibition(torch.as_tensor(w, device=dev)),
            torch.as_tensor(theta, device=dev))


def train_features(xtr, seed=0, epochs=2, backend=DEFAULT_BACKEND, log_every=200,
                   device=None):
    """Stage 1 over ``epochs`` permutations of ``xtr`` (numpy spikes, copied
    to the device once)."""
    rng = np.random.default_rng(seed)
    w, theta = init_feature_state(rng, device)
    xs = torch.as_tensor(np.asarray(xtr, np.float32), device=w.device)
    seen = 0
    for _ in range(epochs):
        for i in rng.permutation(len(xtr)):
            w, theta, _ = stdp_present(w, theta, xs[int(i)], backend=backend)
            seen += 1
            if log_every and seen % log_every == 0:
                wm = w[:N_INPUT, N_INPUT:]
                print(f"  [stdp] {seen} presentations, "
                      f"w mean {float(wm.mean()):.2f} / max {float(wm.max()):.1f}, "
                      f"theta mean {float(theta.mean()):.1f}")
    return w, theta


def neuron_labels(counts: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Label each feature neuron by the class it responds to most (mean),
    normalizing away per-neuron excitability differences first."""
    resp = counts / np.maximum(counts.sum(1, keepdims=True), 1e-6)
    per_class = np.stack([resp[y == d].mean(0) for d in range(N_CLASSES)])
    return per_class.argmax(0)


def cluster_accuracy(counts_te, yte, labels) -> float:
    """Diehl&Cook-style readout: average response within each label group,
    predict the group with the highest mean activity."""
    counts_te = np.asarray(counts_te)
    group = np.zeros((len(counts_te), N_CLASSES))
    for d in range(N_CLASSES):
        members = labels == d
        if members.any():
            group[:, d] = counts_te[:, members].mean(1)
    return float((group.argmax(1) == yte).mean())


# ---------------------------------------------------------------------------
# stage 2: R-STDP readout


def rstdp_present(w_out, hid_raster, label, *, backend=DEFAULT_BACKEND):
    """One readout presentation: bank eligibility, then terminal reward.
    Returns ``(w2, pred)``, the prediction a 0-d device tensor."""
    n = N_HIDDEN + N_CLASSES
    dev = w_out.device
    ticks = hid_raster.shape[0]
    params = readout_net(w_out)
    ext = torch.zeros((ticks, 1, n), dtype=torch.float32, device=dev)
    ext[:, 0, :N_HIDDEN] = hid_raster
    state = SNNState.zeros((1,), n, device=dev)
    pstate = PlasticityState.zeros((1,), n, device=dev)
    (fin, pst, _), raster = ENGINES[backend].readout.learning_rollout(
        params, state, pstate, ext, ticks)
    counts = raster[:, 0, N_HIDDEN:].sum(0)
    # exact drive-image tiebreak (classifier idiom): count*th + residual v
    score = counts * RUN.readout_v_th + fin.lif.v[0, N_HIDDEN:]
    pred = torch.argmax(score)
    reward = torch.where(pred == label, RUN.reward_correct, RUN.reward_wrong)
    # Mozafari-style credit assignment: dopamine gates only the *winning*
    # neuron's synapses -- right winners reinforce their active inputs,
    # wrong winners unlearn them.
    winner_col = (_fabric(dev)["classes"] == N_HIDDEN + pred).to(torch.float32)
    w2 = apply_reward(w_out, pst.elig * winner_col.unsqueeze(0), reward, RUN.readout,
                      params.c)
    return w2, pred


def readout_predict(w_out, hid_raster_batch, *, backend=DEFAULT_BACKEND):
    n = N_HIDDEN + N_CLASSES
    ticks, b = hid_raster_batch.shape[0], hid_raster_batch.shape[1]
    params = readout_net(w_out)
    ext = torch.zeros((ticks, b, n), dtype=torch.float32, device=w_out.device)
    ext[..., :N_HIDDEN] = hid_raster_batch
    state = SNNState.zeros((b,), n, device=w_out.device)
    fin, raster = ENGINES[backend].infer.rollout(params, state, ext, ticks)
    score = (raster[..., N_HIDDEN:].sum(0) * RUN.readout_v_th + fin.lif.v[:, N_HIDDEN:])
    return torch.argmax(score, dim=-1)


def train_readout(hid, ytr, seed=0, epochs=3, backend=DEFAULT_BACKEND):
    """``hid``: (T, B, H) feature spike trains on the device (one rollout,
    reused -- the caller already ran feature_counts for the labeling step)."""
    rng = np.random.default_rng(seed + 1)
    n = N_HIDDEN + N_CLASSES
    # random (not constant) init: with identical columns every output spikes
    # identically, eligibility is column-symmetric, and the scalar reward
    # could never break the tie
    w_out = torch.as_tensor(rng.uniform(
        0.5 * RUN.readout_w_init, 1.5 * RUN.readout_w_init, (n, n)).astype(np.float32),
        device=hid.device)
    for _ in range(epochs):
        for i in rng.permutation(len(ytr)):
            w_out, _ = rstdp_present(w_out, hid[:, int(i)], int(ytr[i]), backend=backend)
    return w_out


# ---------------------------------------------------------------------------
# device readback: learned u8 weights through the UART byte protocol


def readback_probe(device=None) -> torch.Tensor:
    """The readback's probe drive: 40 seed-7 MNIST-8x8 spike vectors, each
    clamped for a presentation, ``(ticks, 40, n)``."""
    x, _ = mnist.load(n_per_class=4, seed=7)
    xs = torch.as_tensor(np.asarray(mnist.to_spikes(x), np.float32),
                         device=_device.resolve(device))
    return _clamp(xs, N_INPUT + N_HIDDEN, RUN.ticks_per_sample)


def readback_spikes(bank: RegisterBank, ext: torch.Tensor, *,
                    backend=DEFAULT_BACKEND) -> torch.Tensor:
    """The raster of the fabric that ``bank`` programs, with the WTA block
    reinstalled, on the drive ``ext``."""
    params = params_from_registers(bank, device=ext.device)
    params = dataclasses.replace(params, w=with_lateral_inhibition(params.w))
    state = SNNState.zeros((ext.shape[1],), ext.shape[2], device=ext.device)
    _, raster = ENGINES[backend].infer.rollout(params, state, ext, RUN.ticks_per_sample)
    return raster


def readback_roundtrip(w, theta, *, backend=DEFAULT_BACKEND):
    """Quantize learned weights to u8, push through serialize()/load_bytes(),
    and assert the reloaded device produces identical spikes.

    Only the learned excitatory block lives in the streamed u8 weight
    registers; the fixed WTA block is the device-local inhibitory bank
    (reinstalled after load, like ``bias``/``leak`` in classifier.deploy).
    Returns ``(bank_dev, hidden spikes probed)``.
    """
    from repro_torch.core import uart
    from repro_torch.plasticity import weights_to_bank

    n = N_INPUT + N_HIDDEN
    bank = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
    bank.set_connection_list(routing_mask())
    w_exc = w.clone()
    w_exc[N_INPUT:, N_INPUT:] = 0.0
    w_u8 = weights_to_bank(bank, w_exc)
    th = np.ones((n,))
    th[N_INPUT:] = np.rint(RUN.v_th_base + theta.cpu().numpy())
    bank.set_thresholds(th.astype(np.uint8))
    leak = np.zeros((n,))
    leak[N_INPUT:] = RUN.leak
    bank.set_leak(leak.astype(np.uint8))

    payload = bank.serialize()
    received = uart.HostLink().send(payload)
    bank_dev = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
    bank_dev.load_bytes(received)
    bank_dev.set_leak(bank.leak)            # device-local regs (not streamed)
    if bank_dev.serialize() != payload:
        raise AssertionError("register payload not byte-exact")
    if not np.array_equal(bank_dev.weights, w_u8):
        raise AssertionError("u8 weights changed in flight")

    ext = readback_probe(w.device)
    before = readback_spikes(bank, ext, backend=backend).cpu().numpy()
    after = readback_spikes(bank_dev, ext, backend=backend).cpu().numpy()
    if not np.array_equal(before, after):
        raise AssertionError("spikes differ after round trip")
    return bank_dev, int(before[..., N_INPUT:].sum())


# ---------------------------------------------------------------------------


def load_split(n_per_class: int):
    """The seed-0 MNIST-8x8 spikes, the first fifth held out for the test:
    ``(xtr, ytr, xte, yte)`` on numpy."""
    x, y = mnist.load(n_per_class=n_per_class, seed=0)
    spikes = mnist.to_spikes(x)
    n_test = len(y) // 5
    return spikes[n_test:], y[n_test:], spikes[:n_test], y[:n_test]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="fewer samples/epochs (CI smoke)")
    ap.add_argument("--backend", default=DEFAULT_BACKEND, choices=BACKENDS,
                    help="tick and plasticity backend of every stage (default: "
                         f"{DEFAULT_BACKEND}, kernels B1 and B5)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    backend = args.backend

    cfg = get_bundle("mnist-stdp").model
    n_per_class, epochs, readout_epochs = SCHEDULES["fast" if args.fast else "full"]
    xtr, ytr, xte, yte = load_split(n_per_class)
    xtr_d = torch.as_tensor(np.asarray(xtr, np.float32), device=dev)
    xte_d = torch.as_tensor(np.asarray(xte, np.float32), device=dev)
    print(f"{cfg.name}: {len(ytr)} train / {len(yte)} test, "
          f"{N_INPUT}->{N_HIDDEN}->{N_CLASSES} neurons, "
          f"{RUN.ticks_per_sample} ticks/presentation ({backend} on {dev})")

    # baseline: random init, no learning
    w0, theta0 = init_feature_state(np.random.default_rng(0), dev)
    c0_tr, _ = feature_counts(w0, theta0, xtr_d, backend=backend)
    c0_te, _ = feature_counts(w0, theta0, xte_d, backend=backend)
    acc0 = cluster_accuracy(
        c0_te.cpu().numpy(), yte, neuron_labels(c0_tr.cpu().numpy(), ytr))

    # stage 1: unsupervised STDP
    print("stage 1: unsupervised STDP feature learning")
    w, theta = train_features(xtr, epochs=epochs, backend=backend, device=dev)
    ctr, rtr = feature_counts(w, theta, xtr_d, backend=backend)
    cte, rte = feature_counts(w, theta, xte_d, backend=backend)
    labels = neuron_labels(ctr.cpu().numpy(), ytr)
    acc1 = cluster_accuracy(cte.cpu().numpy(), yte, labels)
    print(f"  feature-cluster accuracy: random init {acc0:.3f} -> "
          f"STDP {acc1:.3f} (chance {1 / N_CLASSES:.2f})")
    print(f"  distinct class labels among {N_HIDDEN} features: "
          f"{len(set(labels.tolist()))}")

    # stage 2: R-STDP readout
    print("stage 2: R-STDP readout (terminal dopamine reward)")
    w_out = train_readout(rtr[..., N_INPUT:], ytr, epochs=readout_epochs, backend=backend)
    pred = readout_predict(w_out, rte[..., N_INPUT:], backend=backend).cpu().numpy()
    acc2 = float((pred == yte).mean())
    print(f"  end-to-end test accuracy: {acc2:.3f} (chance {1 / N_CLASSES:.2f})")

    # device readback
    bank_dev, n_spikes = readback_roundtrip(w, theta, backend=backend)
    bd = bank_dev.breakdown()
    print("device readback: learned u8 weights -> serialize -> UART -> load")
    print(f"  {bd.total} transactions ({bd.connection_list} CL + "
          f"{bd.thresholds} th + {bd.weights} w + {bd.impulses} imp), "
          f"spikes identical before/after ({n_spikes} hidden spikes probed)")

    ok = acc1 > max(2 / N_CLASSES, acc0) and acc2 > 2 / N_CLASSES
    print("PASS" if ok else "FAIL", "- on-device learning separates classes")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
