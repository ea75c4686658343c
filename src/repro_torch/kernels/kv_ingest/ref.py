"""Plain PyTorch versions of the T2 paged ingest and page gather.

The wrappers in `ops.py` run these for CPU tensors; the tests and
`chip_smoke.py` hold the CUDA kernels against them. Both take int64
page ids already on the pages' device; `ingest` takes unique ids (the
wrapper keeps the last occurrence of a repeated id first).
"""
from __future__ import annotations

import torch


def ingest(pages: torch.Tensor, ids: torch.Tensor,
           payload: torch.Tensor) -> torch.Tensor:
    """pages[ids[i]] = payload[i], in place (payload already in the
    pages' dtype and shaped (n, *pages.shape[1:]))."""
    return pages.index_copy_(0, ids, payload)


def gather(pages: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The pages at `ids`, in order: (n, *pages.shape[1:])."""
    return pages.index_select(0, ids)
