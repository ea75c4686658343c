"""Protection domain + memory regions over the T4 offload engine.

A `ProtectionDomain` owns one `OffloadEngine`; `reg_mr` registers an array
as an engine DMA region and mints an (lkey, rkey) pair. One-sided verbs
address an MR in *records* — rows of the registered array — exactly the
unit `QPContext._flush` coalesces gathers over, so N outstanding
RDMA_READs against one MR collapse into a single fused gather (paper
Fig. 16b) without the verbs layer doing anything special.

The region is a tensor on the engine's device, written in place by
every WRITE that lands in it: `mr_array` returns that live tensor, so a
caller must not cache it across a flush.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.offload_engine import OffloadEngine


@dataclass(frozen=True)
class MemoryRegion:
    name: str                 # engine DMA-region name
    lkey: int
    rkey: int
    n_records: int
    record: int               # elements per record (coalescing unit)
    shape: tuple
    dtype: torch.dtype


class ProtectionDomain:
    """IBV pd: MRs registered here are only reachable through QPs that
    were created on the same pd (key lookup is per-domain)."""

    _next_key = 0x1000        # process-wide so keys never collide across PDs

    def __init__(self, engine: OffloadEngine | None = None, device=None):
        self.engine = engine or OffloadEngine(device)
        self._by_key: dict[int, MemoryRegion] = {}

    def reg_mr(self, name: str, array) -> MemoryRegion:
        """Register a copy of `array` (float64/int64 demoted to 32 bits,
        as the reference does) on the pd's device."""
        self.engine.register_dma_region(name, array)
        arr = self.engine.regions[name]
        record = math.prod(arr.shape[1:]) if arr.ndim > 1 else 1
        lkey = ProtectionDomain._next_key
        rkey = ProtectionDomain._next_key + 1
        ProtectionDomain._next_key += 2
        mr = MemoryRegion(name=name, lkey=lkey, rkey=rkey,
                          n_records=int(arr.shape[0]), record=record,
                          shape=tuple(arr.shape), dtype=arr.dtype)
        self._by_key[lkey] = mr
        self._by_key[rkey] = mr
        return mr

    def dereg_mr(self, mr: MemoryRegion):
        self._by_key.pop(mr.lkey, None)
        self._by_key.pop(mr.rkey, None)
        self.engine.regions.pop(mr.name, None)

    def dealloc(self):
        """ibv_dealloc_pd: deregister every MR still keyed here (stale
        keys then complete with IBV_WC_ACCESS_ERR, not a lookup hit)."""
        for mr in {id(m): m for m in self._by_key.values()}.values():
            self.engine.regions.pop(mr.name, None)
        self._by_key.clear()
        return self

    def lookup(self, key: int) -> MemoryRegion | None:
        return self._by_key.get(key)

    def mr_array(self, mr: MemoryRegion) -> torch.Tensor:
        """Current contents of the MR's backing region (the live tensor)."""
        return self.engine.regions[mr.name]
