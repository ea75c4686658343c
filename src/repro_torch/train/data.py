"""Deterministic, restart-safe data pipeline.

The port of the reference's `repro.train.data`. Two sources:

  * synthetic — tokens are a pure function of (seed, step), so a
    restarted job replays the identical stream with no stored state;
  * memmap corpus — a flat int32 token file; batch b of step s reads a
    deterministic strided window (the reference's windows exactly: the
    same numpy arithmetic).

Difference from the reference, on purpose: the synthetic stream draws
its base tokens from numpy's generator seeded with (seed, step), not
from `jax.random` (no torch or numpy generator reproduces it). The
mixing rule that makes the stream learnable is the reference's. The
same (seed, step) gives the same batch on every device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def synthetic_batch(step: int, batch: int, seq_len: int, vocab: int,
                    *, seed: int = 0, with_labels: bool = True,
                    device=None) -> dict:
    """{"tokens": (batch, seq_len) int32, "labels": the next tokens} on
    `device` (None: the package default)."""
    rng = np.random.default_rng((seed, step))
    base = rng.integers(0, vocab, (batch, seq_len + 1))
    # a low-order markov-ish stream: base tokens + a shifted mix, so
    # models can reduce the loss (uniform noise has no learnable signal)
    mixed = np.where(base % 3 == 0, (base + 7) % vocab, base).astype(
        np.int32)
    dev = resolve(device)
    out = {"tokens": torch.from_numpy(mixed[:, :-1].copy()).to(dev)}
    if with_labels:
        out["labels"] = torch.from_numpy(mixed[:, 1:].copy()).to(dev)
    return out


class MemmapCorpus:
    """Flat int32 token file; deterministic strided reads."""

    def __init__(self, path: str, seq_len: int):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.n_windows = max(1, (len(self.tokens) - 1) // seq_len)

    def batch(self, step: int, batch: int, *, device=None) -> dict:
        idx = (step * batch + np.arange(batch)) % self.n_windows
        starts = idx * self.seq_len
        tok = np.stack([self.tokens[s:s + self.seq_len] for s in starts])
        lab = np.stack([self.tokens[s + 1:s + 1 + self.seq_len]
                        for s in starts])
        dev = resolve(device)
        return {"tokens": torch.from_numpy(tok).to(dev),
                "labels": torch.from_numpy(lab).to(dev)}


def write_corpus(path: str, n_tokens: int, vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, vocab, size=n_tokens, dtype=np.int32)
    arr.tofile(path)
    return path
