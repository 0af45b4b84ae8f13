"""Iris-like dataset synthesized from Fisher's published class statistics.

The container is offline, so we generate 50 samples/class from per-class
Gaussian statistics (means/stds of the real Iris data, public record).
This preserves the classification structure the paper's 4->3 network
exploits (setosa linearly separable; versicolor/virginica close). The
paper's claim validated here is *functional correctness of the pipeline*
(host encode -> register download -> FPGA-semantics inference -> decode),
not a statistical benchmark -- see EXPERIMENTS.md.

Copy of ``repro.data.iris`` (numpy only), so the port needs no JAX.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

CLASS_NAMES = ("setosa", "versicolor", "virginica")

# (mean, std) per feature: sepal length, sepal width, petal length, petal width
_STATS = {
    0: (np.array([5.006, 3.428, 1.462, 0.246]), np.array([0.352, 0.379, 0.174, 0.105])),
    1: (np.array([5.936, 2.770, 4.260, 1.326]), np.array([0.516, 0.314, 0.470, 0.198])),
    2: (np.array([6.588, 2.974, 5.552, 2.026]), np.array([0.636, 0.322, 0.552, 0.275])),
}

FEATURE_MAX = np.array([8.0, 4.5, 7.0, 2.6])


def load(seed: int = 0, per_class: int = 50) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (150, 4) float32 in feature units, y (150,) int32)."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c, (mu, sd) in _STATS.items():
        x = rng.normal(mu, sd, size=(per_class, 4))
        xs.append(np.clip(x, 0.1, FEATURE_MAX))
        ys.append(np.full(per_class, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def normalize(x: np.ndarray) -> np.ndarray:
    """Scale features to [0, 1] by fixed per-feature maxima (host preprocessing)."""
    return (x / FEATURE_MAX).astype(np.float32)


def train_test_split(x, y, *, test_frac: float = 0.3, seed: int = 1):
    rng = np.random.default_rng(seed)
    n = len(y)
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    te, tr = perm[:n_test], perm[n_test:]
    return (x[tr], y[tr]), (x[te], y[te])
