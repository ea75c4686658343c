"""The one traffic generator: a mix is a data file of parameters.

A traffic mix is `flexbench/traffic/<name>.json`, read by `load`, and
this module turns it and `--seed` into requests. A new mix that the
parameters below can say needs no code: only its file.

Kind:

* ``block_read`` -- aggregated 4 KiB block reads, fio's
  ``rw=randread bs=4k`` with ``clients`` x ``iodepth`` LBAs a request:
  ``{"kind": "block_read", "loop": "closed", "clients": 128,
  "iodepth": 32, "lba": {"dist": "uniform"}}``, LBAs uniform over the
  store.

``loop`` is ``closed`` (one request outstanding: the next is issued
when the last completed). Requests depend only on the seed and their
index, so the reference draws the same requests again from the seed.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

KINDS = ("block_read",)
LOOPS = ("closed",)
POOL_LBAS = 1 << 22             # LBAs held ready before the window (32 MiB)


def load(path) -> dict:
    """The parameters of one mix, checked."""
    p = json.loads(Path(path).read_text())
    if p.get("kind") not in KINDS:
        raise ValueError(f"{path}: kind must be one of {KINDS}")
    if p.get("loop") not in LOOPS:
        raise ValueError(f"{path}: loop must be one of {LOOPS}")
    return p


def _stream(seed: int, tag: int) -> np.random.Generator:
    """An independent stream for one use of the seed (seeds may exceed
    32 bits: SeedSequence takes any non-negative integer)."""
    return np.random.default_rng([int(seed), tag])


class BlockReads:
    """Request i is ``lbas(i)``: `n` int64 LBAs in [0, n_blocks). A pool
    of POOL_LBAS // n requests (POOL_LBAS LBAs whatever the request's
    size) is drawn before the window and cycled, so the window times the
    store and not the generator."""

    def __init__(self, params: dict, n_blocks: int, seed: int):
        self.n = int(params["clients"]) * int(params["iodepth"])
        self.n_blocks = int(n_blocks)
        lba = params.get("lba", {"dist": "uniform"})
        if lba["dist"] != "uniform":
            raise ValueError(f"unknown LBA distribution {lba['dist']!r}")
        self.pool_size = max(1, POOL_LBAS // self.n)
        self.pool = _stream(seed, 1).integers(
            0, self.n_blocks, (self.pool_size, self.n), dtype=np.int64)

    def lbas(self, i: int) -> np.ndarray:
        return self.pool[i % self.pool_size]
