"""MNIST-8x8 on the 74-neuron system (paper §III.B + Fig. 6/7).

Counterpart of ``examples/mnist_snn.py``. Full pipeline: 8x8 grayscale ->
binarize -> 64 input spikes -> 74-neuron SNN -> 10 output neurons -> "neuron
with the highest accumulated activation" readout. Reports the paper's
898-transaction register-update arithmetic for this exact system.

  PYTHONPATH=src python -m repro_torch.examples.mnist_snn [--device cpu]
"""
import argparse

from repro_torch.configs import get_bundle
from repro_torch.core import classifier
from repro_torch.core.registers import TimingModel, transaction_breakdown
from repro_torch.data import mnist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = get_bundle("mnist-snn").model
    x, y = mnist.load(n_per_class=40, seed=0)
    spikes = mnist.to_spikes(x)          # binarized: '1' spikes, '0' silent
    n_test = len(y) // 5
    xtr, ytr = spikes[n_test:], y[n_test:]
    xte, yte = spikes[:n_test], y[:n_test]
    print(f"{len(ytr)} train / {len(yte)} test images, "
          f"{spikes.shape[1]} input neurons, refractory={cfg.n_ticks} ticks")

    model = classifier.train(xtr, ytr, cfg, device=args.device)
    dep = classifier.deploy(model, n_neurons=cfg.n_neurons, device=args.device)

    bd = transaction_breakdown(74)   # the paper's per-neuron weight layout
    print(f"\npaper §III.B register update ({dep.bank.n} neurons):")
    print(f"  CL {bd.connection_list} + th {bd.thresholds} + w {bd.weights}"
          f" + imp {bd.impulses} = {bd.total} transactions")
    print(f"  paper timing: {bd.time_s(TimingModel.PAPER)*1e3:.2f} ms "
          "(per-bit-time arithmetic); 8N1 wire: "
          f"{bd.time_s(TimingModel.WIRE_8N1)*1e3:.1f} ms")

    pred = classifier.predict_int(dep, xte, device=args.device)
    acc = classifier.accuracy(pred, yte)
    per_class = {d: float((pred[yte == d] == d).mean()) for d in range(10)}
    print(f"\ninteger-datapath test accuracy: {acc:.3f}")
    print("per-class:", {k: round(v, 2) for k, v in per_class.items()})
    print("all classes recognized:", all(v > 0 for v in per_class.values()))
    return acc, per_class


if __name__ == "__main__":
    main()
