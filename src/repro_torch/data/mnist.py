"""Procedural MNIST-8x8: template digits + jitter + pixel noise (offline).

The paper resizes MNIST to 8x8, grayscales, binarizes by threshold, and
maps the 64 pixels onto input neurons 0..63 (§III.B). We synthesize the
8x8 digit images from hand-drawn templates with random shifts and noise,
then run the exact host pipeline: binarize -> spike impulses.

Copy of ``repro.data.mnist`` (numpy only), so the port needs no JAX.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_T = [
    # each template is 8 rows of 8 chars; '#' = ink
    [
        "..####..",
        ".#....#.",
        ".#....#.",
        ".#....#.",
        ".#....#.",
        ".#....#.",
        ".#....#.",
        "..####..",
    ],
    [
        "...##...",
        "..###...",
        "...##...",
        "...##...",
        "...##...",
        "...##...",
        "...##...",
        "..####..",
    ],
    [
        "..####..",
        ".#....#.",
        "......#.",
        ".....#..",
        "....#...",
        "...#....",
        "..#.....",
        ".######.",
    ],
    [
        ".#####..",
        "......#.",
        "......#.",
        "..####..",
        "......#.",
        "......#.",
        "......#.",
        ".#####..",
    ],
    [
        "....##..",
        "...#.#..",
        "..#..#..",
        ".#...#..",
        ".######.",
        ".....#..",
        ".....#..",
        ".....#..",
    ],
    [
        ".######.",
        ".#......",
        ".#......",
        ".#####..",
        "......#.",
        "......#.",
        "......#.",
        ".#####..",
    ],
    [
        "...###..",
        "..#.....",
        ".#......",
        ".#.###..",
        ".##...#.",
        ".#....#.",
        ".#....#.",
        "..####..",
    ],
    [
        ".######.",
        "......#.",
        ".....#..",
        "....#...",
        "...#....",
        "...#....",
        "...#....",
        "...#....",
    ],
    [
        "..####..",
        ".#....#.",
        ".#....#.",
        "..####..",
        ".#....#.",
        ".#....#.",
        ".#....#.",
        "..####..",
    ],
    [
        "..####..",
        ".#....#.",
        ".#....#.",
        "..#####.",
        "......#.",
        ".....#..",
        "....#...",
        "...#....",
    ],
]

TEMPLATES = np.stack(
    [np.array([[c == "#" for c in row] for row in t], dtype=np.float32) for t in _T]
)


def load(n_per_class: int = 50, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (N, 8, 8) float32 grayscale in [0,1], y (N,) int32)."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for digit in range(10):
        base = TEMPLATES[digit]
        for _ in range(n_per_class):
            img = base.copy()
            # sub-pixel intensity variation + stroke jitter
            img = img * rng.uniform(0.7, 1.0)
            dx, dy = rng.integers(-1, 2, size=2)
            img = np.roll(np.roll(img, dx, axis=1), dy, axis=0)
            img = img + rng.normal(0.0, 0.08, size=(8, 8))
            xs.append(np.clip(img, 0.0, 1.0))
            ys.append(digit)
    x = np.stack(xs).astype(np.float32)
    y = np.asarray(ys, dtype=np.int32)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def binarize(x: np.ndarray, threshold: float = 0.35) -> np.ndarray:
    """Paper's host preprocessing: pixels above threshold spike ('1')."""
    return (x > threshold).astype(np.float32)


def to_spikes(x: np.ndarray, threshold: float = 0.35) -> np.ndarray:
    """(N, 8, 8) -> (N, 64) binary spike vectors for input neurons 0..63."""
    return binarize(x, threshold).reshape(x.shape[0], 64)
