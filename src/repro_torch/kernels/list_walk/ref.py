"""Plain PyTorch version of the server-side list walk.

`ops.list_traverse` runs it for CPU tensors; the tests and
`chip_smoke.py` hold the CUDA kernel against it. It reads one key and
one `next` word per hop from the tensor (a host round trip per hop on
the card: the cost the kernel exists to remove).
"""
from __future__ import annotations

import math

import torch


def walk(records: torch.Tensor, key: float, head: int,
         max_hops: int) -> tuple[torch.Tensor, int, int]:
    """Walk (n, 2 + V) float32 records from `head` (in [-n, n)) to the
    record whose key equals the float32 `key`, stopping at a negative
    pointer or after `max_hops` hops. Returns (the value words of the
    record it rests on, hops, that record's index). A `next` that
    truncates to a value outside [-n, n), or is not finite, raises
    IndexError."""
    n = records.shape[0]
    ptr, hops = int(head), 0
    while ptr >= 0 and hops < max_hops:
        if records[ptr, 0].item() == key:
            break
        nxt = records[ptr, 1].item()
        t = math.trunc(nxt) if math.isfinite(nxt) else n
        if not -n <= t < n:
            raise IndexError(f"record {ptr}: next {nxt} outside "
                             f"[-{n}, {n})")
        ptr = t
        hops += 1
    if ptr < 0:
        ptr += n
    return records[ptr, 2:].clone(), hops, ptr
