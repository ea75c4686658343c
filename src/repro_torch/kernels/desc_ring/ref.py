"""Plain PyTorch versions of the device ring's produce/consume: the index
arithmetic of the reference's `kernels/desc_ring/desc_ring.py`.

The wrappers in `ops.py` run these for CPU tensors; the tests and
`chip_smoke.py` hold the CUDA kernel against them. `head`/`tail` arrive
reduced mod 2*capacity (slot and lap parity both survive).
"""
from __future__ import annotations

import torch


def produce(slots: torch.Tensor, flags: torch.Tensor, head: int,
            batch: torch.Tensor):
    """Write `batch` rows at ring positions head.. with lap-parity valid
    flags, in place."""
    cap = slots.shape[0]
    idx = head + torch.arange(batch.shape[0], device=slots.device)
    s = idx % cap
    slots[s] = batch
    flags[s] = (1 - (idx // cap) % 2).to(flags.dtype)


def consume(slots: torch.Tensor, flags: torch.Tensor, tail: int,
            limit: int) -> tuple[torch.Tensor, int]:
    """The first `limit` slots rotated to start at `tail`, and k, the
    length of their valid prefix. (The reference scans the whole ring
    and its caller clamps k to `limit`; scanning `limit` slots gives the
    same clamped k.)"""
    cap = flags.shape[0]
    idx = tail + torch.arange(limit, device=slots.device)
    s = idx % cap
    ok = flags[s] == (1 - (idx // cap) % 2).to(flags.dtype)
    k = limit if bool(ok.all()) else int(torch.argmin(ok.to(torch.uint8)))
    return slots[s], k
