"""T2 — unlimited-working-set in-cache processing RX path.

`ingest` scatters incoming KV payload tiles into the paged cache through
the logical->physical shadow table; `gather_pages` reads a sequence's
pages back in logical order. On a CUDA tensor each is one launch of a
hand-written kernel (`kernels/kv_ingest`: the ingest streams every page
through registers once, nothing staged — the port's form of the TPU
kernel's two-resident-tiles invariant); on a CPU tensor each is the
plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import to_host
from repro_torch.core.shadow import ShadowTable
from repro_torch.kernels.kv_ingest import ops as kv_ops


def _physical(logical_ids, shadow: ShadowTable | None) -> np.ndarray:
    ids = to_host(logical_ids)
    if shadow is not None:
        ids = shadow.translate(ids)
    return ids.astype(np.int64, copy=False)


def ingest(pages: torch.Tensor, payload: torch.Tensor, logical_ids,
           shadow: ShadowTable | None = None, *,
           use_kernel: bool = False) -> torch.Tensor:
    """pages: (n_pages, page_tokens, KVH, hd); payload: (n, page_tokens,
    KVH, hd); logical_ids: (n,) page ids (logical if shadow given).
    Writes the pages in place and returns them.

    The device decides the route, not `use_kernel`: CUDA pages always
    take the kernel and CPU pages the plain version, so the plain
    version never runs on the card. `use_kernel` stays in the signature
    for call-site parity with the reference (where it picks Pallas over
    a jnp scatter)."""
    del use_kernel
    return kv_ops.kv_ingest(pages, payload, _physical(logical_ids, shadow))


def gather_pages(pages: torch.Tensor, logical_ids,
                 shadow: ShadowTable | None = None) -> torch.Tensor:
    """Read back a sequence's pages in logical order -> contiguous KV."""
    return kv_ops.gather_pages(pages, _physical(logical_ids, shadow))
