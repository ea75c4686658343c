"""T4 — programmable offloading engine (paper §3.5, Table 2, Listing 1).

Cloud-provider code registers an unused opcode with a handler; when a
packet bearing that opcode arrives, the engine invokes the handler with
the Table-2 API surface:

    register_opcode(opcode, qp, func)
    register_dma_region(host_addr, size)      -> here: a named tensor
    alloc_resp(context, size)
    submit_dma(context, op, host_addr, arm_addr, size) -> dma_id
    wait_dma_finish(context, dma_id)
    submit_resp(context, addr, size)

"DMA" ops against a registered region are *queued* and executed as one
fused gather/scatter at wait time — the coalescing that makes the
batched-READ opcode beat N independent reads (paper Fig. 16b) is
structural, not emulated. Regions are torch tensors on the engine's
device (`repro_torch.device`: the card unless the caller asks for the
CPU), and a WRITE lands in the region tensor in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.convert import to_host, to_tensor
from repro_torch.core.descriptors import OP_BATCH_READ
from repro_torch.device import resolve
from repro_torch.kernels.wr_scatter import ops as wr_scatter_ops


def dedupe_last_wins(offs: np.ndarray, vals):
    """Sequential-retirement semantics for a fused scatter: when target
    offsets repeat, keep only the LAST update per offset (the order in
    which a scatter retires duplicate indices is unspecified). Shared by
    every layer that stacks WRITEs — `QPContext._flush` and the
    transport's run fusion must agree bit-for-bit. `vals` is a numpy
    array or a tensor, row-aligned with `offs`."""
    if np.unique(offs).size == offs.size:
        return offs, vals
    _, first_rev = np.unique(offs[::-1], return_index=True)
    keep = np.sort(offs.size - 1 - first_rev)
    if isinstance(vals, torch.Tensor):
        return offs[keep], vals[torch.from_numpy(keep).to(vals.device)]
    return offs[keep], vals[keep]


@dataclass
class DmaOp:
    op: str                     # READ | WRITE
    region: str
    offsets: np.ndarray         # int64 record offsets into the region
    length: int                 # elements per offset
    buf: object = None          # WRITE source rows (numpy or tensor)


@dataclass
class QPContext:
    qp_id: int
    engine: "OffloadEngine"
    resp: torch.Tensor | None = None
    _dma_queue: list = field(default_factory=list)
    _dma_done: dict = field(default_factory=dict)
    dma_launches: int = 0       # fused launches (for Fig. 16 accounting)
    # fuse consecutive WRITEs to one region into a single scatter launch;
    # False = one indexing op per WRITE (the scalar bit-exactness oracle)
    coalesce_writes: bool = True
    # every op below this index has retired (a _flush retires ALL pending
    # ops), so a long-lived QP's flush scans only the ops queued since —
    # not its whole DMA history
    _scan_from: int = 0

    # ---- Table 2 API ----
    def alloc_resp(self, size: int, dtype=torch.float32):
        self.resp = torch.zeros((size,), dtype=dtype,
                                device=self.engine.device)
        return self.resp

    def submit_dma(self, op: str, region: str, offsets, length: int,
                   buf=None) -> int:
        """Queue one DMA. WRITEs carry their source data in `buf`
        (record rows matching `offsets`); READs leave it None. The buffer
        is SNAPSHOTTED at submission — a numpy buffer copied, a tensor
        cloned on its device — so a caller that reuses or mutates it
        before the flush (Table-2 handlers loop over scratch) cannot
        change what lands. Host data stays on the host here: the one
        device conversion happens at the fused scatter.

        An offset outside the region raises IndexError HERE, and nothing
        is queued: a queued bad op would fail every later flush of this
        context (and index out of bounds on the card). The reference
        queues it and drops or fills the record instead."""
        offs = np.asarray(to_host(offsets), np.int64)
        arr = self.engine.regions.get(region)
        if arr is not None:
            n = arr.shape[0] if op == "WRITE" else \
                arr.numel() // max(int(length), 1)
            if not wr_scatter_ops.records_in(offs, n):
                raise IndexError(f"{op} offsets outside region {region!r} "
                                 f"of {n} records")
        dma_id = len(self._dma_queue)
        if isinstance(buf, torch.Tensor):
            buf = buf.clone()
        elif buf is not None:
            buf = np.array(buf)
        self._dma_queue.append(DmaOp(op, region, offs, length, buf))
        return dma_id

    def wait_dma_finish(self, dma_id: int):
        if dma_id not in self._dma_done:
            self._flush()
        return self._dma_done[dma_id]

    def _flush(self):
        """Coalesce queued DMAs against the same region into fused
        launches (the batched-DMA win). Offsets are record indices;
        `length` is the record size in elements. Ops against one region
        retire in submission order — only a READ->WRITE or WRITE->READ
        boundary fences, so read-after-write sees the write (RC
        ordering) while a write-free batch of N reads costs ONE gather
        and a read-free batch of N writes ONE scatter.

        The coalescing path launches the fused kernels
        (`kernels/wr_scatter/ops`, counted as `fused/launches`; the
        scatter writes the region tensor in place). The oracle
        (`coalesce_writes=False`) keeps plain per-op indexing — an
        in-place `index_put_` per WRITE, an indexed read per READ run —
        and never launches a kernel of this package, by contract: it
        cannot share their bugs. Both index only offsets that
        `submit_dma` checked against the region."""
        pending = [(i, d) for i, d in enumerate(
            self._dma_queue[self._scan_from:], start=self._scan_from)
            if i not in self._dma_done]
        by_region: dict[str, list[tuple[int, DmaOp]]] = {}
        for i, d in pending:
            by_region.setdefault(d.region, []).append((i, d))
        for region, items in by_region.items():
            reads: list[tuple[int, DmaOp]] = []
            writes: list[tuple[int, DmaOp]] = []

            def gather_run():
                if not reads:
                    return
                arr = self.engine.regions[region]
                L = reads[0][1].length
                assert all(d.length == L for _, d in reads), \
                    "mixed record sizes in one flush group"
                offs = np.concatenate([d.offsets.ravel() for _, d in reads])
                if self.coalesce_writes:
                    flat = wr_scatter_ops.gather_records(arr, offs, L)
                else:
                    idx = offs[:, None] * L + np.arange(L)
                    flat = arr.reshape(-1)[
                        torch.from_numpy(idx).to(arr.device)]
                self.dma_launches += 1
                c = 0
                for i, d in reads:
                    n = d.offsets.size
                    self._dma_done[i] = flat[c:c + n]
                    c += n
                reads.clear()

            def scatter_one(i: int, d: DmaOp):
                arr = self.engine.regions[region]
                if self.coalesce_writes:
                    wr_scatter_ops.scatter_one(arr, d.offsets, d.buf)
                else:
                    arr[torch.from_numpy(d.offsets).to(arr.device)] = \
                        to_tensor(d.buf, arr.device, arr.dtype)
                self._dma_done[i] = True
                self.dma_launches += 1

            def scatter_run():
                if not writes:
                    return
                if len(writes) == 1:
                    scatter_one(*writes[0])
                    writes.clear()
                    return
                arr = self.engine.regions[region]
                rec_shape = tuple(arr.shape[1:])
                rec = math.prod(rec_shape)
                if any(_numel(d.buf) != d.offsets.size * rec
                       for _, d in writes):
                    # a broadcasting WRITE (buf rows != offsets) keeps
                    # its own scatter, in submission order
                    for i, d in writes:
                        scatter_one(i, d)
                    writes.clear()
                    return
                offs = np.concatenate([d.offsets.ravel() for _, d in writes])
                vals = _stack_rows([d.buf for _, d in writes], arr,
                                   rec_shape)
                offs, vals = dedupe_last_wins(offs, vals)
                # scatter_run only exists on the coalescing path (the
                # oracle scatters per-op above): always a fused launch
                wr_scatter_ops.scatter_records(arr, offs, vals)
                self.dma_launches += 1
                for i, _ in writes:
                    self._dma_done[i] = True
                writes.clear()

            for i, d in items:
                if d.op == "READ":
                    scatter_run()       # WRITE -> READ boundary fences
                    reads.append((i, d))
                elif self.coalesce_writes:
                    gather_run()        # READ -> WRITE boundary fences
                    writes.append((i, d))
                else:                   # oracle: one op per WRITE
                    gather_run()
                    scatter_one(i, d)
            gather_run()
            scatter_run()
        # advance only once everything retired: a mid-flush error leaves
        # the survivors rescannable by the next flush instead of orphaned
        self._scan_from = len(self._dma_queue)

    def submit_resp(self, buf):
        self.resp = buf
        return buf

    def reset(self):
        """Drop queued/retired DMA state (QP teardown): anything not yet
        waited on is abandoned, matching a hardware queue-pair reset."""
        self._dma_queue.clear()
        self._dma_done.clear()
        self._scan_from = 0
        self.resp = None
        return self


def _numel(buf) -> int:
    return buf.numel() if isinstance(buf, torch.Tensor) else np.size(buf)


def _stack_rows(bufs: list, arr: torch.Tensor, rec_shape: tuple):
    """Row-stack a fused run's WRITE sources. All-host sources stack on
    the host — numpy-first: ONE host->device copy happens at the
    scatter, not one per source. Device sources (READ results landing
    in a local MR) stack on the device with one concatenate, so no
    device data makes a round trip through the host."""
    if not any(isinstance(b, torch.Tensor) for b in bufs):
        rows = [np.asarray(b).reshape((-1,) + rec_shape) for b in bufs]
        return np.concatenate(rows) if len(rows) > 1 else rows[0]
    return torch.cat([to_tensor(b, arr.device).reshape((-1,) + rec_shape)
                      for b in bufs])


class OffloadEngine:
    def __init__(self, device=None):
        self.device = resolve(device)
        self.handlers: dict[int, Callable] = {}
        self.regions: dict[str, torch.Tensor] = {}
        self._qps: dict[int, QPContext] = {}

    # ---- Table 2 API ----
    def register_opcode(self, opcode: int, qp_id: int, func: Callable):
        self.handlers[opcode] = func
        self._qps.setdefault(qp_id, QPContext(qp_id, self))

    def register_dma_region(self, name: str, array) -> str:
        """Register a COPY of `array` (demoted like the reference's
        `jnp.asarray`) on the engine's device: later DMAs write the
        region, never the caller's memory."""
        t = to_tensor(array, self.device)
        if isinstance(array, torch.Tensor) or t.device.type == "cpu":
            t = t.clone()       # to_tensor may alias the caller's memory
        self.regions[name] = t
        return name

    def bind_context(self, qp_id: int, ctx: QPContext):
        """Adopt an externally-owned QPContext (the verbs layer creates
        one per QueuePair) so `handle_packet` dispatches into it."""
        self._qps[qp_id] = ctx
        return ctx

    def unbind_context(self, qp_id: int):
        """Release a QP's context (ibv_destroy_qp): queued DMAs are
        abandoned, handler dispatch for this qp_id gets a fresh context."""
        ctx = self._qps.pop(qp_id, None)
        if ctx is not None:
            ctx.reset()
        return ctx

    def handle_packet(self, opcode: int, packet, qp_id: int = 0):
        """Network-stack dispatch: a packet with a registered opcode is
        treated as a SEND, delivered, then handed to the engine."""
        if opcode not in self.handlers:
            raise KeyError(f"opcode {opcode:#x} not registered")
        ctx = self._qps.setdefault(qp_id, QPContext(qp_id, self))
        self.handlers[opcode](packet, ctx)
        return ctx.resp


# --------------------------------------------------------------------------
# Shipped opcodes (paper §5.6 / Listing 1)
# --------------------------------------------------------------------------
def install_batched_read(engine: OffloadEngine, region: str, value_size: int,
                         qp_id: int = 0) -> int:
    """Paper Listing 1: aggregate N scattered reads into one request; the
    server fetches all values with coalesced DMA and answers once."""
    def handle_batch_read(packet, ctx: QPContext):
        offsets = np.asarray(packet, np.int64)           # target offsets
        ctx.alloc_resp(offsets.size * value_size)
        # ONE submit_dma carrying every offset (Listing 1's aggregation):
        # submitting N single-offset DMAs would defeat the coalescing the
        # opcode exists to demonstrate
        dma_id = ctx.submit_dma("READ", region, offsets, value_size)
        ctx.submit_resp(ctx.wait_dma_finish(dma_id).reshape(-1))

    engine.register_opcode(OP_BATCH_READ, qp_id, handle_batch_read)
    return OP_BATCH_READ
