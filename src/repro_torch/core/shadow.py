"""Shadow memory regions (paper §3.2), adapted: a logical->physical page
table over the paged KV cache.

The paper's shadow region lets the NIC resolve a host VA from an Arm VA
without any physical backing on the Arm. Our analogue: descriptors carry
*logical* page ids; the block table resolves them to physical pages of the
cache at payload-DMA time; the control plane never touches payload bytes.

A copy of the reference's `repro.core.shadow`, except that `translate`
returns int64 page ids (the reference's are int32), as the port
addresses everything in 64 bits.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ShadowRegion:
    name: str
    n_pages: int
    page_tokens: int
    base_logical: int           # start of the logical id range ("Arm VA")


class ShadowTable:
    """Allocates logical id ranges and maintains logical->physical maps."""

    def __init__(self, total_physical_pages: int):
        self.total = total_physical_pages
        self.free = list(range(total_physical_pages - 1, -1, -1))
        self.regions: dict[str, ShadowRegion] = {}
        self.page_map: dict[int, int] = {}       # logical -> physical
        self._next_logical = 0

    def register_region(self, name: str, n_pages: int,
                        page_tokens: int) -> ShadowRegion:
        """The paper's register path: kernel module informs (VA, size);
        Arm picks an unused VA range and installs the mapping."""
        if len(self.free) < n_pages:
            raise MemoryError(f"{name}: need {n_pages} pages, "
                              f"{len(self.free)} free")
        base = self._next_logical
        self._next_logical += n_pages
        region = ShadowRegion(name, n_pages, page_tokens, base)
        for i in range(n_pages):
            self.page_map[base + i] = self.free.pop()
        self.regions[name] = region
        return region

    def release_region(self, name: str):
        region = self.regions.pop(name)
        for i in range(region.n_pages):
            self.free.append(self.page_map.pop(region.base_logical + i))

    def translate(self, logical_ids: np.ndarray) -> np.ndarray:
        """Resolve logical page ids -> physical page ids (vectorized)."""
        flat = np.asarray(logical_ids).ravel()
        out = np.fromiter((self.page_map[int(i)] for i in flat),
                          dtype=np.int64, count=flat.size)
        return out.reshape(np.shape(logical_ids))

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.total
