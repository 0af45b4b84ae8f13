"""Deterministic, resumable synthetic token stream (a copy of ``repro.data.synthetic``).

Batches are a pure function of (seed, step) -- a counter-based generator,
so the pipeline state that must be checkpointed is exactly one integer and
restart-after-failure is trivially exact (runtime/fault_tolerance.py).
Token distribution is Zipf-like over the vocab with a per-sequence offset
pattern so the LM loss is learnable (structure exists) without external
data.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def token_batch(
    seed: int,
    step: int,
    *,
    global_batch: int,
    seq_len: int,
    vocab_size: int,
    n_codebooks: int = 0,
    zipf_a: float = 1.3,
) -> Dict[str, np.ndarray]:
    """Returns {"inputs", "targets"} of shape (B, S[, K]) int32.

    targets are inputs shifted by one within a (B, S+1) sample, so the
    next-token objective has real sequential structure (learnable bigrams:
    each token deterministically biases its successor).
    """
    rng = _rng(seed, step)
    shape = (global_batch, seq_len + 1)
    if n_codebooks:
        shape = shape + (n_codebooks,)
    raw = rng.zipf(zipf_a, size=shape).astype(np.int64)
    toks = (raw - 1) % vocab_size
    # Inject bigram structure: even positions seed their successor.
    succ = (toks * 31 + 7) % vocab_size
    mask = (np.arange(seq_len + 1) % 2 == 1)
    if n_codebooks:
        mask = mask[None, :, None]
    else:
        mask = mask[None, :]
    toks = np.where(mask, np.roll(succ, 1, axis=1), toks)
    toks = toks.astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def vision_batch(seed: int, step: int, *, global_batch: int, n_tokens: int,
                 d_vision: int, dtype=np.float32) -> np.ndarray:
    rng = _rng(seed, step + 1_000_003)
    return rng.standard_normal((global_batch, n_tokens, d_vision)).astype(dtype)
