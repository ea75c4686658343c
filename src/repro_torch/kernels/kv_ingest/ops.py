"""T2 paged ingest and page gather: ONE kernel launch each.

`kv_ingest` scatters payload pages into the paged KV cache at physical
page ids, in place; `gather_pages` reads pages back in id order. On a
CUDA tensor each is one launch of the hand-written row-copy kernel
(`csrc/wr_rows.cu`: the `ingest_pages` entry point, and the
`gather_rows` entry point with a page as the row); on a CPU tensor it
is the plain version in `ref.py`; any other device raises.
Both launch through `kernels.wr_scatter.ops.launch_rows`.
`_build.LAUNCHES` counts the launches made on the card (an empty call
launches nothing). Neither counts on the registry: the reference's T2
path has no counter.

Differences from the reference's `kernels/kv_ingest`, on purpose:

  * In place — `pages` is written where it lies and returned (the
    reference aliases it in the Pallas call and donates it under jit;
    its callers rebind the result, and still do, to the same tensor).
  * A repeated page id keeps its LAST payload row, as the reference's
    in-order grid does; CUDA blocks run in no order, so the wrapper
    drops the earlier occurrences on the host before the launch.
  * int64 ids, range-checked: an id outside the pages raises IndexError
    before any launch (the reference drops such a row).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.offload_engine import dedupe_last_wins
from repro_torch.kernels.kv_ingest import ref
from repro_torch.kernels.wr_scatter.ops import _offsets, launch_rows


def _check_pages(pages):
    if not isinstance(pages, torch.Tensor):
        raise TypeError(f"pages must be a torch.Tensor, not {type(pages)}")
    if pages.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for {pages.device}")
    if pages.ndim < 1 or not pages.is_contiguous():
        raise ValueError("pages must be a contiguous (P, ...) tensor")


def kv_ingest(pages: torch.Tensor, payload: torch.Tensor,
              page_ids) -> torch.Tensor:
    """pages[page_ids[i]] = payload[i], in place; returns `pages`.
    pages: (P, T, F...); payload: (n, T, F...) on the same device, cast
    to the pages' dtype; page_ids: n ids in [0, P), host or device."""
    _check_pages(pages)
    if not isinstance(payload, torch.Tensor) \
            or payload.device != pages.device:
        raise ValueError(f"payload must be a tensor on {pages.device}")
    if tuple(payload.shape[1:]) != tuple(pages.shape[1:]):
        raise ValueError(f"payload pages {tuple(payload.shape[1:])} differ "
                         f"from the pool's {tuple(pages.shape[1:])}")
    ids = _offsets(page_ids, pages.shape[0])
    if ids.size != payload.shape[0]:
        raise ValueError(f"{ids.size} page ids for {payload.shape[0]} "
                         "payload pages")
    ids, payload = dedupe_last_wins(ids, payload)
    payload = payload.to(pages.dtype).contiguous()
    ids_t = torch.from_numpy(ids).to(pages.device)
    if pages.device.type == "cpu":
        return ref.ingest(pages, ids_t, payload)
    n, page_bytes = ids.size, math.prod(pages.shape[1:]) * pages.element_size()
    if n == 0 or page_bytes == 0:
        return pages
    launch_rows("ingest_pages", pages, payload, ids_t, n, page_bytes)
    return pages


def gather_pages(pages: torch.Tensor, page_ids) -> torch.Tensor:
    """The pages at `page_ids`, in order: a new (n, T, F...) tensor."""
    _check_pages(pages)
    ids = _offsets(page_ids, pages.shape[0])
    ids_t = torch.from_numpy(ids).to(pages.device)
    if pages.device.type == "cpu":
        return ref.gather(pages, ids_t)
    out = torch.empty((ids.size,) + tuple(pages.shape[1:]),
                      dtype=pages.dtype, device=pages.device)
    page_bytes = math.prod(pages.shape[1:]) * pages.element_size()
    if ids.size == 0 or page_bytes == 0:
        return out
    launch_rows("gather_rows", out, pages, ids_t, ids.size, page_bytes)
    return out
