"""Paged KV cache as DMA-registered memory.

The port of the reference's `repro.serve.paged`. The dense serve cache
becomes a `PagePool`: fixed-size KV *pages* (``page_tokens`` rows of
every layer of one cache leaf) held in per-leaf page tensors registered
as verbs MRs on the owning pod's protection domain, so one-sided
RDMA_WRITEs address pages as MR records. The decode step reads pages
through a slot -> page-table indirection (`make_paged_step`): gather
pages into the dense layout, run `model.decode_step`, write the
updated pages back.

Page 0 is the *null page*: table entries of inactive slots (and the
unallocated tail of short sequences) point at it. Its contents are
garbage by design — every row it backs sits at a position the decode
attention masks (``kvp <= pos``), so the masked lanes contribute exact
zeros and paged decode matches the dense one.

Differences from the reference, on purpose:

  * Pages are written in place into the registered tensors
    (`index_copy_` on ``pd.mr_array(mr)``) where the reference builds a
    new region and rebinds it; `rebind` only checks that it is handed
    the registered tensors back.
  * The step writes back only the rows whose table entry is not 0. The
    null page repeats in every table, and a repeated index in
    `index_copy_` races on the card; the reference writes it too, and
    its contents are garbage either way, so comparisons leave page 0
    out.

Eligibility is probed, not assumed: paging (and prompt-length
bucketing) require every cache leaf to be sequence-indexed; `pageable`
and `bucketable` decide, and ineligible models keep the dense path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models.module import is_spec, torch_dtype
from repro_torch.obs import metrics


def bucket_len(n: int, max_len: int) -> int:
    """Power-of-two bucket for a prompt length (capped at max_len): the
    engine meets O(log max_len) distinct prefill lengths instead of one
    per prompt length."""
    if n < 1:
        raise ValueError(f"prompt length must be >= 1, got {n}")
    p = 1
    while p < n:
        p <<= 1
    return min(p, max_len)


def _spec_shapes(model, batch: int, seq: int) -> list[tuple]:
    leaves = tree.leaves(model.cache_specs(batch, seq), is_leaf=is_spec)
    return [tuple(s.shape) for s in leaves]


def seq_indexed_only(model, probes: tuple[int, int] = (16, 24)) -> bool:
    """True iff EVERY cache leaf is sequence-indexed under the stacked
    ``(layers, batch, seq, ...)`` layout. Probed at two distinct seq
    values so a coincidental dimension (a window W == probe, a state
    width) cannot masquerade as the seq axis."""
    a, b = (_spec_shapes(model, 2, s) for s in probes)
    if not a or len(a) != len(b):
        return False
    for sa, sb in zip(a, b):
        if len(sa) < 3 or len(sa) != len(sb):
            return False
        if sa[2] != probes[0] or sb[2] != probes[1]:
            return False
        if any(x != y for i, (x, y) in enumerate(zip(sa, sb)) if i != 2):
            return False
    return True


def pageable(model) -> bool:
    """Paged KV is exact only when the whole cache is seq-indexed (and
    the arch has no windowed/rotating layers — hybrids carry both)."""
    return getattr(model.cfg, "hybrid", None) is None \
        and seq_indexed_only(model)


def bucketable(model) -> bool:
    """Bucketed (right-padded) prefill is exact under `pageable`'s
    conditions PLUS no MoE: expert capacity depends on the total token
    count, so padding could change which tokens drop."""
    return pageable(model) and getattr(model.cfg, "moe", None) is None


def _unflatten(specs, leaves: list):
    it = iter(leaves)
    return tree.map(lambda _: next(it), specs, is_leaf=is_spec)


class PagePool:
    """Fixed-size KV pages for one serving pod, registered as MRs.

    One page tensor per cache leaf, shaped ``(n_pages, layers,
    page_tokens, *feat)`` — an MR *record* is one page, so page ids are
    record offsets and one-sided verbs address pages directly. Page ids
    are shared across leaves: an allocation is one id list, valid in
    every leaf's region. The slot -> page table (``(max_batch,
    pages_per_slot)`` int32 on the host, 0 = null page) is the
    indirection the paged decode step consumes."""

    pages_allocated = metrics.counter_attr()
    pages_freed = metrics.counter_attr()

    def __init__(self, model, pd, *, max_batch: int, max_seq: int,
                 page_tokens: int = 16, n_pages: int | None = None):
        metrics.instance_scope(self, "pagepool", indexed=True)
        if max_seq % page_tokens:
            raise ValueError(
                f"max_seq={max_seq} must be a multiple of "
                f"page_tokens={page_tokens}")
        self.model = model
        self.pd = pd
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.page_tokens = page_tokens
        self.pages_per_slot = max_seq // page_tokens
        # +1 for the null page: a full pool can still back every slot
        self.n_pages = n_pages if n_pages is not None else \
            max_batch * self.pages_per_slot + 1
        self.pages_allocated = 0
        self.pages_freed = 0
        self.specs = model.cache_specs(max_batch, max_seq)
        self.mrs = []
        idx = metrics.scope_of(self).name     # pagepool{i}: unique MR names
        for i, spec in enumerate(tree.leaves(self.specs, is_leaf=is_spec)):
            shp = tuple(spec.shape)           # (L, B, S, *feat)
            page_shape = (self.n_pages, shp[0], page_tokens) + shp[3:]
            arr = torch.zeros(page_shape,
                              dtype=torch_dtype(spec.dtype or model.cfg.dtype),
                              device=pd.engine.device)
            self.mrs.append(self.pd.reg_mr(f"{idx}/leaf{i}", arr))
            del arr                           # reg_mr registered a copy
        self._free = list(range(self.n_pages - 1, 0, -1))   # page 0 = null
        self.table = np.zeros((max_batch, self.pages_per_slot), np.int32)

    # -- allocation ---------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_tokens)

    def alloc(self, n: int) -> np.ndarray:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        self.pages_allocated += n
        return np.asarray([self._free.pop() for _ in range(n)], np.int64)

    def free(self, ids) -> None:
        ids = np.asarray(ids, np.int64).ravel()
        self.pages_freed += int(ids.size)
        self._free.extend(int(i) for i in ids)

    def bind_slot(self, slot: int, ids) -> None:
        """Point a slot's table row at its pages (tail stays null)."""
        ids = np.asarray(ids, np.int64).ravel()
        self.table[slot, :] = 0
        self.table[slot, :ids.size] = ids

    def clear_slot(self, slot: int) -> np.ndarray:
        """Unbind and return the slot's pages (caller frees them)."""
        row = self.table[slot]
        ids = row[row != 0].astype(np.int64)
        self.table[slot, :] = 0
        return ids

    # -- host-local page writes (the prefill pod filling its own pool) ------
    def fill(self, ids, caches) -> None:
        """Write one sequence's prefill caches (batch 1, any seq length)
        into pages `ids`, in place: leaf rows are re-tiled to ``(k, L,
        page_tokens, *feat)`` pages — host-local writes don't ride the
        wire."""
        ids = np.asarray(ids, np.int64).ravel()
        k = int(ids.size)
        for mr, rows in zip(self.mrs, self.page_rows(caches, k)):
            region = self.pd.mr_array(mr)
            region.index_copy_(0, torch.from_numpy(ids).to(region.device),
                               rows.to(region.dtype))

    def page_rows(self, caches, k: int) -> list:
        """Each leaf of a batch-1 cache tree as ``(k, L, page_tokens,
        *feat)`` page records (padded / truncated to k pages) — the
        shape an MR record write expects."""
        need = k * self.page_tokens
        out = []
        for leaf in tree.leaves(caches):
            x = leaf[:, 0]                    # (L, S, *feat)
            S = x.shape[1]
            if S < need:
                pad = x.new_zeros((x.shape[0], need - S) + tuple(x.shape[2:]))
                x = torch.cat([x, pad], dim=1)
            else:
                x = x[:, :need]
            x = x.reshape((x.shape[0], k, self.page_tokens)
                          + tuple(x.shape[2:]))
            out.append(x.movedim(1, 0))
        return out

    # -- migration lease ----------------------------------------------------
    def lease(self, ids) -> list[tuple]:
        """The remote half of a migration: ``(rkey, page_ids)`` per leaf
        region, in leaf order — what a prefill pod needs to RDMA_WRITE
        pages into THIS pool."""
        ids = np.asarray(ids, np.int64).ravel()
        return [(mr.rkey, ids) for mr in self.mrs]

    # -- device views --------------------------------------------------------
    def regions(self) -> list:
        """The per-leaf page tensors (fetched once per decode step; RDMA
        migrations land in them in place between steps)."""
        return [self.pd.mr_array(mr) for mr in self.mrs]

    def rebind(self, new_regions) -> None:
        """Pages are written in place, so there is nothing to rebind:
        the regions handed back must be the registered tensors."""
        for mr, r in zip(self.mrs, new_regions, strict=True):
            if r is not self.pd.mr_array(mr):
                raise ValueError(f"{mr.name}: a page region must be the "
                                 "registered tensor, written in place")

    def close(self) -> None:
        for mr in self.mrs:
            self.pd.dereg_mr(mr)
        self.mrs = []
        self._free = []


def make_paged_step(model, pool: PagePool):
    """The paged decode step: page-table gather -> dense layout ->
    ``model.decode_step`` -> the updated pages written back in place.
    The table is the pool's host table; regions ride as arguments, so
    RDMA-landed pages are visible on the next call. Returns (logits,
    regions)."""
    specs = pool.specs
    ppslot = pool.pages_per_slot
    page_tokens = pool.page_tokens

    def step(params, tokens, table, pos, regions):
        table = np.asarray(table)
        B = table.shape[0]
        dev = regions[0].device
        flat_np = table.reshape(-1).astype(np.int64)
        flat = torch.from_numpy(flat_np).to(dev)
        live_np = np.flatnonzero(flat_np)     # rows that are not page 0
        live = torch.from_numpy(live_np).to(dev)
        ids = torch.from_numpy(flat_np[live_np]).to(dev)
        dense = []
        for pg in regions:
            rows = pg.index_select(0, flat)   # (B*ppslot, L, pt, *feat)
            L = pg.shape[1]
            r = rows.reshape((B, ppslot) + tuple(rows.shape[1:]))
            r = r.movedim(2, 0)               # (L, B, ppslot, pt, *feat)
            dense.append(r.reshape((L, B, ppslot * page_tokens)
                                   + tuple(pg.shape[3:])))
        caches = _unflatten(specs, dense)
        logits, new = model.decode_step(params, tokens, caches, pos)
        for pg, leaf in zip(regions, tree.leaves(new)):
            L = pg.shape[1]
            r = leaf.reshape((L, B, ppslot, page_tokens) + tuple(pg.shape[3:]))
            r = r.movedim(0, 2)               # (B, ppslot, L, pt, *feat)
            r = r.reshape((B * ppslot,) + tuple(pg.shape[1:]))
            pg.index_copy_(0, ids, r.index_select(0, live))
        return logits, list(regions)

    return step
