"""Quickstart: the paper's Iris pipeline (paper §III.A + §IV).

Counterpart of ``examples/quickstart.py``. Host PC side: load data, encode
features to integer impulse levels, train the 4->3 LIF network offline.
Device side: download through the UART register protocol, run bit-faithful
integer inference (the synaptic product through kernel B6 on the card).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_bundle
from repro_torch.core import classifier, encoding
from repro_torch.core.registers import TimingModel
from repro_torch.data import iris


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = get_bundle("iris-snn").model
    print(f"network: {cfg.layer_sizes[0]} input + {cfg.layer_sizes[1]} output "
          f"LIF neurons (Fig. 4), threshold=1, {cfg.n_ticks} ticks")

    # --- host preprocessing (paper §IV): normalize + quantize to levels ---
    x, y = iris.load(seed=0)
    levels = encoding.level_encode(torch.from_numpy(iris.normalize(x)), levels=4).numpy()
    (xtr, ytr), (xte, yte) = iris.train_test_split(levels, y)

    # --- offline training (surrogate gradient) ---
    model = classifier.train(xtr, ytr, cfg, device=args.device)
    acc_f = classifier.accuracy(classifier.predict_float(model, xte, device=args.device), yte)
    print(f"float model test accuracy: {acc_f:.3f}")

    # --- UART download: quantize -> register bank -> serialize -> reload ---
    dep = classifier.deploy(model, n_neurons=cfg.n_neurons, device=args.device)
    bd = dep.bank.breakdown()
    print(f"register download: {bd.total} bytes "
          f"({bd.time_s(TimingModel.PAPER)*1e3:.2f} ms paper model / "
          f"{bd.time_s(TimingModel.WIRE_8N1)*1e3:.2f} ms on a real 9600-8N1 wire)")

    # --- device-side integer inference (the FPGA datapath) ---
    pred = classifier.predict_int(dep, xte, device=args.device)
    acc_i = classifier.accuracy(pred, yte)
    print(f"integer (u8 registers, i32 accumulate) test accuracy: {acc_i:.3f}")
    print("sample predictions:", pred[:10], "labels:", yte[:10])
    return np.asarray(pred)


if __name__ == "__main__":
    main()
