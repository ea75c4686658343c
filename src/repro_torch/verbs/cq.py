"""Completion queue on the T3 DMA-only notification ring.

CQEs are 64B descriptors (`wqe.encode_cqe`). The transport pushes every
completion of one processing pass into `_pending` and publishes them with
ONE `Ring.produce` — so `ring.dma_writes` grows per *flush*, not per CQE
(the paper's batched-ring argument, Fig. 15). `poll` is the consumer side:
it drains the ring and decodes descriptors back into `WorkCompletion`s.

Payload data that cannot ride a 64B cacheline (non-inline SEND deliveries,
RDMA_READ results, custom-opcode responses) travels out-of-band in a
seq-keyed sideband — the software analogue of the NIC DMA-ing payload
into the posted buffer while the CQE only carries metadata.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.core.descriptors import DESCRIPTOR_WIDTH, W_SEQ
from repro_torch.core.notification import Ring, RingFullError
from repro_torch.obs import metrics, trace
from repro_torch.verbs import wqe


class CQOverrunError(RuntimeError):
    pass


@dataclass(slots=True)
class WorkCompletion:
    """One decoded completion. A plain slots dataclass: poll_cq mints
    one per CQE on the hot path, and a frozen dataclass costs ~2.5x
    more to construct (object.__setattr__ per field)."""
    wr_id: int
    opcode: int
    status: int = wqe.IBV_WC_SUCCESS
    length: int = 0
    data: Any = None          # delivered payload / RDMA_READ result / resp

    @property
    def ok(self) -> bool:
        return self.status == wqe.IBV_WC_SUCCESS


class CompletionQueue:
    # registry-backed credit level: `cq{i}/fc_reserved` in snapshots
    fc_reserved = metrics.gauge_attr()

    def __init__(self, depth: int = 256, publish_every: int = 8,
                 vectorized: bool = True, *,
                 device_ring: bool | None = None, torch_device=None):
        metrics.instance_scope(self, "cq", indexed=True)
        self.vectorized = vectorized
        # device_ring=True publishes CQEs into a ring resident on
        # `torch_device` (None: the package default): each flush's staged
        # block lands in ONE produce kernel launch (kernels/desc_ring)
        # instead of a host memcpy. Vectorized-only — the oracle never
        # launches a kernel. device_ring=None (the default) defers to the
        # measured depth policy (`core.notification.
        # DEVICE_RING_AUTO_DEPTH`): device-resident above the device
        # type's crossover depth, host below it or where no crossover was
        # measured; an explicit kwarg always wins.
        if device_ring and not vectorized:
            raise ValueError("device_ring requires vectorized=True")
        self.ring = Ring(depth, publish_every=publish_every,
                         vectorized=vectorized,
                         metrics_parent=self._metrics, device=device_ring,
                         torch_device=torch_device)
        # fused publish+poll (enable_fused_poll): flush() defers staged
        # CQEs that fit the ring and poll() lands publish AND drain in
        # ONE produce_consume launch. Opt-in, device-ring only.
        self.fused_poll = False
        # staged CQEs live as ONE (n, width) block: staging a batch is an
        # array concat and publishing a chunk is a slice, never a python
        # loop over rows
        self._pending = np.zeros((0, DESCRIPTOR_WIDTH), np.int64)
        self._sideband: dict[int, Any] = {}
        self._seq = 0
        self.destroyed = False
        # flow control: slots reserved by not-yet-retired WRs. One pool
        # per CQ, shared by every sender QP charging against it.
        self.fc_reserved = 0

    @property
    def capacity(self) -> int:
        return self.ring.capacity

    def free_slots(self) -> int:
        """CQ credit: slots not yet claimed by a published CQE, a staged
        CQE, or an outstanding WR's reservation. This is the quantity
        senders charge new WRs against (QueuePair flow control); poll()
        grows it back."""
        return self.ring.capacity - len(self) - self.fc_reserved

    def fc_reserve(self, what: str = "CQ"):
        """Claim one slot for an outstanding WR; ENOMEM when the CQ is
        out of credit (the sender backs off and polls)."""
        from repro_torch.verbs.qp import ENOMEMError
        if self.destroyed:
            raise ENOMEMError(f"{what} CQ destroyed")
        if self.free_slots() < 1:
            raise ENOMEMError(
                f"{what} CQ credit exhausted: {self.fc_reserved} reserved"
                f" + {len(self)} occupied of {self.ring.capacity} "
                "(poll_cq to replenish)")
        self.fc_reserved += 1

    def fc_release(self):
        self.fc_reserved = max(0, self.fc_reserved - 1)

    def enable_fused_poll(self):
        """Fuse publish+poll: after this, `flush()` DEFERS staged CQEs
        that fit the ring and the next `poll()` publishes AND drains
        them in ONE `produce_consume` launch (kernels/desc_ring)
        — the serve engine's one-launch step. Requires a device ring
        (there is nothing to fuse on the host memcpy path). Completion
        visibility is unchanged: every staged CQE was only ever
        observable through poll(), which still delivers it."""
        if not self.ring.device:
            raise ValueError("fused poll requires a device ring "
                             "(device_ring=True)")
        self.fused_poll = True
        return self

    # -- teardown -----------------------------------------------------------
    def reset(self):
        """Reclaim everything a mid-flight QP reset/destroy can orphan:
        staged-but-unpublished CQEs, published-but-unpolled ring entries,
        and their sideband payloads. Flow-control reservations SURVIVE a
        reset — they are held by live senders' outstanding WRs, not by
        CQ content, and zeroing them here would let their eventual
        release steal credit from other tenants' reservations."""
        self._pending = self._pending[:0]
        self._sideband.clear()
        self.ring.consume(None)         # drop published entries
        self.ring.force_publish()       # hand the slots back as credit
        return self

    def destroy(self):
        """ibv_destroy_cq: reset + refuse further use (including new
        reservations, so a released stale claim can no longer interact
        with live credit)."""
        self.reset()
        self.fc_reserved = 0
        self.destroyed = True
        return self

    # -- producer (transport) side ----------------------------------------
    def push(self, cqe: np.ndarray, data=None):
        """Stage one CQE; nothing hits the ring until `flush`."""
        self.push_batch(np.asarray(cqe, np.int64)[None],
                        None if data is None else [data])

    def push_batch(self, cqes: np.ndarray, datas=None):
        """Stage a whole (n, width) CQE block in one array op; `datas`
        is an optional n-list of sideband payloads (None entries carry
        nothing). Sequence numbers are stamped vectorized. Repeated
        single-CQE pushes re-concat the staged block, which is fine
        because staging is bounded by CQ depth + max_wr (the hot paths
        stage whole passes in one call)."""
        if self.destroyed:
            raise CQOverrunError("CQ destroyed")
        cqes = np.atleast_2d(np.asarray(cqes, np.int64))
        n = cqes.shape[0]
        if n == 0:
            return
        cqes = cqes.copy()
        cqes[:, W_SEQ] = np.arange(self._seq, self._seq + n)
        if datas is not None:
            for j, data in enumerate(datas):
                if data is not None:
                    self._sideband[self._seq + j] = data
        self._seq += n
        self._pending = cqes if self._pending.shape[0] == 0 else \
            np.concatenate([self._pending, cqes])

    def flush(self):
        """Publish staged CQEs: one batched ring DMA when they fit (the
        common case), chunked by ring credit when the batch outsizes the
        free slots. Unpublishable CQEs stay staged (a poll frees slots
        and retries); raises CQOverrunError only when the ring is full
        and nothing could be published."""
        if self.fused_poll and \
                0 < self._pending.shape[0] <= self.ring.free_slots():
            # fused mode: staged CQEs that fit the ring ride the next
            # poll's single produce_consume launch instead of paying a
            # produce launch here. Oversized backlogs fall through to
            # the chunked publish (ring credit still bounds staging).
            return 0
        published = 0
        while self._pending.shape[0]:
            n = min(self._pending.shape[0], self.ring.free_slots())
            if n <= 0:
                break
            try:
                self.ring.produce(self._pending[:n])
            except RingFullError:
                break
            self._pending = self._pending[n:]
            published += n
        if self._pending.shape[0] and published == 0:
            raise CQOverrunError(
                f"CQ depth {self.ring.capacity} full with "
                f"{len(self._pending)} CQEs staged — poll_cq to drain")
        return published

    # -- consumer (application) side --------------------------------------
    def poll(self, max_n: int | None = None) -> list[WorkCompletion]:
        """ibv_poll_cq: drain up to max_n completions (0..n, never blocks).
        Drains the ring *before* flushing so a batch that previously
        overran the ring gets its slots back and publishes now. One
        consumer-counter publish per poll (the CQ consumer-index
        doorbell): this is what hands the freed slots back as credit —
        both to the ring producer and to flow-controlled senders."""
        tr = trace.TRACER
        t0 = tr.now() if tr is not None else 0
        out = self._drain(max_n)
        if out or len(self._pending):
            self.ring.force_publish()
        if len(self._pending) and (max_n is None or len(out) < max_n):
            want = None if max_n is None else max_n - len(out)
            if self.fused_poll and \
                    self._pending.shape[0] <= self.ring.free_slots():
                # ONE launch publishes the staged block AND
                # drains the valid prefix (ring empty in steady state,
                # so the drain above cost zero launches): the serve
                # engine's one-launch step
                pending, self._pending = self._pending, self._pending[:0]
                out += self._decode(self.ring.produce_consume(
                    pending, want))
            else:
                self.flush()        # backlog publishes into freed slots
                out += self._drain(want)
        if tr is not None and out:
            tr.complete("poll_cq", t0, cq=self._metrics.name,
                        cqes=len(out))
        return out

    def _drain(self, max_n: int | None) -> list[WorkCompletion]:
        return self._decode(self.ring.consume(max_n))

    def _decode(self, descs: np.ndarray) -> list[WorkCompletion]:
        if descs.shape[0] == 0:
            return []
        if self.vectorized:
            if descs.shape[0] == 1:
                # single-CQE drain (RPC round trips): the scalar field
                # decode beats the batch decode's fixed numpy overhead
                f = wqe.cqe_fields(descs[0])
                return [WorkCompletion(f["wr_id"], f["opcode"],
                                       f["status"], f["length"],
                                       self._sideband.pop(f["seq"], None))]
            # one array decode for the whole drained block, then plain
            # python scalars out of `.tolist()` (no per-row np indexing)
            f = wqe.decode_cqe_batch(descs)
            pop = self._sideband.pop
            return [WorkCompletion(w, o, s, ln, pop(q, None))
                    for w, o, s, ln, q in zip(
                        f["wr_id"].tolist(), f["opcode"].tolist(),
                        f["status"].tolist(), f["length"].tolist(),
                        f["seq"].tolist())]
        out = []
        for desc in descs:
            f = wqe.cqe_fields(desc)
            out.append(WorkCompletion(
                wr_id=f["wr_id"], opcode=f["opcode"], status=f["status"],
                length=f["length"], data=self._sideband.pop(f["seq"], None)))
        return out

    def __len__(self):
        return len(self.ring) + len(self._pending)
