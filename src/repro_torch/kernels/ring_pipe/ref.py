"""Plain PyTorch version of the T3 pipe's payload gather.

`ops.ring_consume` runs it for CPU tensors; the tests and
`chip_smoke.py` hold the CUDA kernel against it. It takes int64 slot
indices, already range-checked, on the slots' device.
"""
from __future__ import annotations

import torch


def consume(slots: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The slot rows at `idx`, in order: (n, W)."""
    return slots.index_select(0, idx)
