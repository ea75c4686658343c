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


def schedule(slots: torch.Tensor, flags: torch.Tensor, plan, head: int,
             tail: int, batch: torch.Tensor | None,
             limit: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's schedule in plain torch, CTA by CTA, for a `plan`
    from `ops.plan`: CTA c owns the window slots (plan.base + j) % cap
    for j in [c * plan.per, min((c + 1) * plan.per, plan.span)); it
    writes the batch rows that land in them, then reads the positions
    from `tail` that fall in them and keeps the first invalid one (or
    `limit`) as its k word. Slots and flags are updated in place.
    Returns the (limit, width) rows by position and the (grid,) k
    words: the call's k is their minimum. CTAs own disjoint slots, so
    running them one after another computes what the grid does."""
    cap = slots.shape[0]
    n = 0 if batch is None else batch.shape[0]
    rows = torch.zeros((limit, slots.shape[1]), dtype=slots.dtype)
    kwords = torch.full((plan.grid,), limit, dtype=torch.int64)
    for c in range(plan.grid):
        j = torch.arange(c * plan.per, min((c + 1) * plan.per, plan.span))
        s = (plan.base + j) % cap
        if plan.produce:
            r = (s - head) % cap
            m = r < n
            slots[s[m]] = batch[r[m]]
            flags[s[m]] = (1 - ((head + r[m]) // cap) % 2).to(flags.dtype)
        if plan.consume:
            i = (s - tail) % cap
            m = i < limit
            s, i = s[m], i[m]
            bad = flags[s] != (1 - ((tail + i) // cap) % 2).to(flags.dtype)
            rows[i] = slots[s]
            if bool(bad.any()):
                kwords[c] = int(i[bad].min())
    return rows, kwords
