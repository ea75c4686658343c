"""Paged KV cache pool + cache padding utilities.

The pool holds fixed-size pages; sequences own logical page ranges through
the core.shadow table (the paper's shadow memory region). Transferred
prefill caches are *ingested* page-by-page (core.rx_engine / the kv_ingest
kernel) and *gathered* back to the contiguous layout the decode step
consumes. Pages live on the pool's device (the card by default) and are
written in place; callers still rebind ``self.pages`` as the reference's
do.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import rx_engine
from repro_torch.core.shadow import ShadowTable
from repro_torch.device import resolve
from repro_torch.models.module import torch_dtype


SEQ_AXES = ("kv_seq", "seq")            # a cache leaf's sequence axis
PAD_AXES = SEQ_AXES + ("window",)       # the axes a prefill's leaf grows on


def _axis(spec, names) -> int | None:
    """The index of the first of `names` among `spec`'s axes, or None."""
    return next((i for i, a in enumerate(spec.axes) if a in names), None)


def pad_caches(caches, s_prefill: int, s_max: int, specs):
    """Pad layer-stacked decode caches from prefill length to max length.

    `specs` is the cache spec tree at length `s_max` (the model's
    `cache_specs(batch, s_max)`): each leaf is padded with zeros, at the
    end, along the axis its spec names, to that spec's length there. A
    ``kv_seq`` / ``seq`` leaf grows to `s_max`; a ``window`` leaf to
    min(window, s_max), so token p stays in slot p mod W, the rolling
    layout window decode reads; every other leaf (recurrent state, conv
    history) passes through, whatever its length.

    The reference pads every leaf whose dim 2 equals the prefill length,
    so a window, conv or state leaf that happens to have that length is
    padded too (and its engine then fails); the spec decides here."""
    if s_prefill == s_max:
        return caches

    def pad(a, spec):
        ax = _axis(spec, PAD_AXES)
        if ax is None:
            return a
        want, have = spec.shape[ax], a.shape[ax]
        if a.ndim != len(spec.shape) or have > want:
            raise ValueError(f"a cache leaf of shape {tuple(a.shape)} "
                             f"does not fit its spec {spec.shape}")
        if have == want:
            return a
        shape = list(a.shape)
        shape[ax] = want - have
        return torch.cat([a, a.new_zeros(shape)], dim=ax)

    return tree.map(pad, caches, specs)


@dataclass
class SeqAllocation:
    seq_id: int
    region: str
    logical_pages: np.ndarray


class PagedKVPool:
    """One pool per (layer-stack leaf); pages: (n_pages, page_tokens, ...)
    on `device` (None: the package default, the card)."""

    def __init__(self, n_pages: int, page_tokens: int, feature_shape: tuple,
                 dtype="bfloat16", *, device=None):
        self.page_tokens = page_tokens
        dt = dtype if isinstance(dtype, torch.dtype) else torch_dtype(dtype)
        self.pages = torch.zeros((n_pages, page_tokens)
                                 + tuple(feature_shape), dtype=dt,
                                 device=resolve(device))
        self.shadow = ShadowTable(n_pages)
        self._next_id = 0

    def allocate(self, n_tokens: int) -> SeqAllocation:
        n_pages = -(-n_tokens // self.page_tokens)
        name = f"seq{self._next_id}"
        region = self.shadow.register_region(name, n_pages, self.page_tokens)
        self._next_id += 1
        logical = np.arange(region.base_logical,
                            region.base_logical + n_pages)
        return SeqAllocation(self._next_id - 1, name, logical)

    def free(self, alloc: SeqAllocation):
        self.shadow.release_region(alloc.region)

    def ingest(self, alloc: SeqAllocation, kv: torch.Tensor,
               use_kernel: bool = False):
        """kv: (S, ...) contiguous prefill output -> paged pool (T2 path).
        `use_kernel` is kept for call-site parity: the device picks the
        route (`rx_engine.ingest`)."""
        S = kv.shape[0]
        n_pages = len(alloc.logical_pages)
        pad = n_pages * self.page_tokens - S
        if pad:
            kv = torch.cat([kv, kv.new_zeros((pad,) + tuple(kv.shape[1:]))])
        tiles = kv.reshape((n_pages, self.page_tokens) + tuple(kv.shape[1:]))
        self.pages = rx_engine.ingest(self.pages, tiles, alloc.logical_pages,
                                      self.shadow, use_kernel=use_kernel)

    def gather(self, alloc: SeqAllocation, n_tokens: int) -> torch.Tensor:
        tiles = rx_engine.gather_pages(self.pages, alloc.logical_pages,
                                       self.shadow)
        flat = tiles.reshape((-1,) + tuple(tiles.shape[2:]))
        return flat[:n_tokens]


def page_roundtrip(caches, max_seq: int, page_tokens: int, specs):
    """Every sequence-indexed cache leaf (its spec names ``kv_seq`` or
    ``seq``; `specs` as for `pad_caches`, at `max_seq`) through the
    paged ingest and gather, row by row: one `PagedKVPool` per (layer,
    batch) row, on the leaf's device. The body of the reference's
    `PDServer._page_roundtrip` (`serve/pd_disagg.py`), which the port's
    `PDServer.ingest_and_decode` calls; the result equals `caches`
    exactly. Window and state leaves pass through (the reference moves a
    window leaf too when `pad_caches` has grown it to `max_seq`)."""
    def one(a, spec):
        if _axis(spec, SEQ_AXES) is None:
            return a                    # state/window caches pass through
        if a.ndim < 3 or a.shape[2] != max_seq:
            raise ValueError(f"a sequence leaf of shape {tuple(a.shape)} "
                             f"is not padded to {max_seq}")
        lead = tuple(a.shape[:2])       # (L, B)
        flat = a.reshape((-1, max_seq) + tuple(a.shape[3:]))
        outs = []
        for row in range(flat.shape[0]):
            kv = flat[row]
            pool = PagedKVPool(-(-max_seq // page_tokens), page_tokens,
                               tuple(kv.shape[1:]), kv.dtype,
                               device=kv.device)
            alloc = pool.allocate(max_seq)
            pool.ingest(alloc, kv)
            outs.append(pool.gather(alloc, max_seq))
        return torch.stack(outs).reshape(lead + (max_seq,)
                                         + tuple(a.shape[3:]))
    return tree.map(one, caches, specs)
