"""Plain PyTorch versions of the fused scatter and gather.

The kernel wrappers in `ops.py` run these for CPU tensors; the tests and
`chip_smoke.py` hold the CUDA kernels against them. Both take int64
record offsets already on the region's device.
"""
from __future__ import annotations

import torch


def scatter(region: torch.Tensor, offs: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """region[offs[i]] = vals[i] rows, in place (vals already in the
    region's dtype and shaped (m, *region.shape[1:]))."""
    return region.index_copy_(0, offs, vals)


def gather(region: torch.Tensor, offs: torch.Tensor,
           length: int) -> torch.Tensor:
    """(n, length) block of the `length`-element records at record
    offsets `offs` of the flattened region, over an int64 index."""
    idx = offs[:, None] * length + torch.arange(length, device=offs.device)
    return region.reshape(-1)[idx]
