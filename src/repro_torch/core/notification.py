"""T3 — DMA-only notification pipe (paper §3.4), faithfully reproduced as
the queue between the serving control plane and the device step functions.

Protocol (verbatim from the paper):
  * single producer, single consumer, lock-free;
  * each element is one cacheline-sized descriptor with a 1-bit validity
    flag; the flag's *expected* value toggles on every ring wraparound, so
    stale entries from the previous lap are never mistaken for fresh ones;
  * the producer batches multiple elements per "DMA" (one memcpy here);
  * the consumer publishes a consumer-counter; the producer re-reads it
    ("one DMA read") only when it runs out of credit — every n elements,
    not per element.

`dma_reads`/`dma_writes` counters let the benchmarks reproduce the paper's
Fig. 15 ordering (batched ring >> per-op doorbell >> emulated MMIO).

The hot paths are vectorized: an n-element produce is at most TWO slice
assignments (around the wraparound point) and a consume is one validity
scan + one gather, so the python cost of a batch is O(1), not O(n). The
element-at-a-time implementation is retained behind ``vectorized=False``
as the bit-exactness oracle (tests/test_line_rate.py).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.descriptors import DESCRIPTOR_WIDTH
from repro_torch.device import device_type, resolve
from repro_torch.obs import metrics


class RingFullError(RuntimeError):
    pass


# Auto device-residency policy (measured, per torch device type):
# `Ring(device=None)` — and `CompletionQueue(device_ring=None)` —
# resolve to a device-resident ring when vectorized AND capacity >= the
# entry for the ring's torch device type. An entry is set only from a
# measured depth x publish_every crossover sweep on that device: the
# reference's (depths 64, 512, 4096 x publish_every 8, 64; a full
# batch produced, then consume(None)), run by `chip_smoke.py` phase 7.
# On an H100 the device ring led the host ring in every round at depth
# 4096 at both publish_every values, in four runs (beyond the spread in
# three; PERF.md), and lost at 512 and 64, where the launch and the
# synchronisation cost more than the numpy copy they replace. A `cpu`
# device has no entry: there the plain version never
# beats the numpy copy. An explicit device=True/False kwarg always
# wins over this policy, and vectorized=False (the oracle) never
# launches a kernel regardless.
DEVICE_RING_AUTO_DEPTH: dict[str, int] = {"cuda": 4096}


def _auto_device(capacity: int, vectorized: bool, torch_device) -> bool:
    if not vectorized:
        return False
    depth = DEVICE_RING_AUTO_DEPTH.get(device_type(torch_device))
    return depth is not None and capacity >= depth


class Ring:
    # registry-backed (repro_torch.obs): each Ring instance still owns
    # independent values (the vectorized-vs-scalar bit-exactness tests
    # compare them across instances), but they are addressable as
    # `ring{i}/dma_writes` — or `cq{j}/ring{i}/...` when the owning CQ
    # passes itself as metrics_parent
    dma_writes = metrics.counter_attr()
    dma_reads = metrics.counter_attr()
    max_occupancy = metrics.gauge_attr()

    def __init__(self, capacity: int, width: int = DESCRIPTOR_WIDTH,
                 publish_every: int = 8, vectorized: bool = True,
                 metrics_parent=None, device: bool | None = None,
                 torch_device=None):
        assert capacity > 0
        metrics.instance_scope(self, "ring", indexed=True,
                               parent=metrics_parent)
        self.capacity = capacity
        self.width = width
        self.vectorized = vectorized
        # device=True keeps slot memory + valid flags resident on
        # `torch_device` (None: the package default, `repro_torch.device`)
        # and lands each produce/consume in ONE kernel launch that updates
        # them in place (kernels/desc_ring). Head/tail/credit/publish
        # bookkeeping stays host-side and identical — the protocol does
        # not change, only where the slot memcpy runs. device=None defers
        # to the measured depth policy (`DEVICE_RING_AUTO_DEPTH`).
        if device is None:
            device = _auto_device(capacity, vectorized, torch_device)
        self.device = device
        if device:
            if not vectorized:
                raise ValueError("device ring requires vectorized=True "
                                 "(the oracle never launches a kernel)")
            from repro_torch.kernels.desc_ring import ops as _ring_ops
            self._ring_ops = _ring_ops
            # int64 slot rows, natively: 64B cachelines as they are
            self.slots, self.flags = _ring_ops.alloc(
                capacity, width, resolve(torch_device))
            # on the card, the ring's own pinned read-back and staging
            # buffers and resolved entry points
            self._via = _ring_ops.Boundary(
                capacity, self.slots.device, self.slots, self.flags) \
                if self.slots.device.type == "cuda" else None
        else:
            self.slots = np.zeros((capacity, width), np.int64)
            self.flags = np.zeros((capacity,), np.uint8)  # starts invalid
        self.head = 0          # producer monotonic index
        self.tail = 0          # consumer monotonic index
        self.publish_every = publish_every
        self._published_tail = 0      # consumer counter (visible to producer)
        self._producer_view = 0       # producer's cached copy of it
        self._since_publish = 0
        # instrumentation
        self.dma_writes = 0           # producer descriptor-batch DMAs
        self.dma_reads = 0            # producer consumer-counter reads
        self.max_occupancy = 0

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _valid_flag(idx, capacity: int):
        # lap 0 writes 1, lap 1 writes 0, ... (toggles per wraparound).
        # Works elementwise on an index vector (the vectorized flag write).
        return 1 - ((idx // capacity) % 2)

    def _credit(self) -> int:
        return self.capacity - (self.head - self._producer_view)

    # -- producer ----------------------------------------------------------
    def produce(self, batch: np.ndarray) -> int:
        """batch: (n, width) descriptors; one batched DMA. All-or-nothing:
        accepts the whole batch and returns n, or raises RingFullError if
        there is no room even after a counter refresh (the paper's
        producer would spin). An empty batch is a no-op (no DMA)."""
        batch = np.atleast_2d(np.asarray(batch, np.int64))
        if batch.size == 0:
            return 0
        n = batch.shape[0]
        if self._credit() < n:
            # out of credit: pay one DMA read to refresh the counter
            self._producer_view = self._published_tail
            self.dma_reads += 1
            if self._credit() < n:
                raise RingFullError(
                    f"need {n} slots, have {self._credit()}")
        if self.device:
            # ONE launch writes slots and flags in place
            self._ring_ops.produce(self.slots, self.flags, self.head, batch,
                                   via=self._via)
        elif self.vectorized:
            # credit <= capacity, so the batch wraps at most once: the
            # whole memcpy is at most two slice assignments
            s0 = self.head % self.capacity
            first = min(n, self.capacity - s0)
            if n == 1:
                # single-descriptor fast path (RPCs, 1-WR chains): scalar
                # flag math, no arange/astype round trip
                self.slots[s0] = batch[0]
                self.flags[s0] = 1 - ((self.head // self.capacity) % 2)
            else:
                fl = self._valid_flag(self.head + np.arange(n),
                                      self.capacity).astype(np.uint8)
                self.slots[s0:s0 + first] = batch[:first]
                self.flags[s0:s0 + first] = fl[:first]
                if first < n:
                    self.slots[:n - first] = batch[first:]
                    self.flags[:n - first] = fl[first:]
        else:
            for i in range(n):
                idx = self.head + i
                s = idx % self.capacity
                self.slots[s, :] = batch[i]
                self.flags[s] = self._valid_flag(idx, self.capacity)
        self.head += n
        self.dma_writes += 1          # the whole batch rode one DMA
        self.max_occupancy = max(self.max_occupancy, self.head - self._published_tail)
        return n

    # -- consumer ----------------------------------------------------------
    def consume(self, max_n: int | None = None) -> np.ndarray:
        """Poll: drain every valid element (up to max_n). Returns (k, width)."""
        if not self.vectorized:
            return self._consume_scalar(max_n)
        limit = self.capacity if max_n is None else min(max_n, self.capacity)
        # occupancy cap: slots at/past the head cannot be valid (their
        # flags still carry the previous lap), so never scan them — same
        # k, smaller scan (the 1-WR poll checks 1 flag, not capacity)
        limit = min(limit, self.head - self.tail)
        if limit <= 0:
            return np.zeros((0, self.width), np.int64)
        if self.device:
            out = self._ring_ops.consume(self.slots, self.flags,
                                         self.tail, limit, via=self._via)
            k = out.shape[0]
            if k == 0:
                return out
            self.tail += k
            total = self._since_publish + k
            if total >= self.publish_every:
                self._since_publish = total % self.publish_every
                self._published_tail = self.tail - self._since_publish
            else:
                self._since_publish = total
            return out
        if limit == 1:
            # single-descriptor poll (RPC round trips): one scalar flag
            # check, no arange/argmin scan
            tail = self.tail
            s = tail % self.capacity
            if self.flags[s] != 1 - ((tail // self.capacity) % 2):
                return np.zeros((0, self.width), np.int64)
            out = self.slots[s:s + 1].copy()
            self.tail = tail + 1
            total = self._since_publish + 1
            if total >= self.publish_every:
                self._since_publish = total % self.publish_every
                self._published_tail = self.tail - self._since_publish
            else:
                self._since_publish = total
            return out
        # one vectorized validity scan from the tail (entries outstanding
        # never exceed capacity), then one gather for the valid prefix
        idx = self.tail + np.arange(limit)
        s = idx % self.capacity
        ok = self.flags[s] == self._valid_flag(idx, self.capacity)
        k = limit if ok.all() else int(np.argmin(ok))
        if k == 0:
            return np.zeros((0, self.width), np.int64)
        out = self.slots[s[:k]].copy()
        self.tail += k
        total = self._since_publish + k
        if total >= self.publish_every:
            # the consumer-counter publishes land exactly where the
            # element-at-a-time loop would have left them
            self._since_publish = total % self.publish_every
            self._published_tail = self.tail - self._since_publish
        else:
            self._since_publish = total
        return out

    def _consume_scalar(self, max_n: int | None) -> np.ndarray:
        out = []
        while max_n is None or len(out) < max_n:
            idx = self.tail
            s = idx % self.capacity
            if self.flags[s] != self._valid_flag(idx, self.capacity):
                break
            out.append(self.slots[s].copy())
            self.tail += 1
            self._since_publish += 1
            if self._since_publish >= self.publish_every:
                self._published_tail = self.tail
                self._since_publish = 0
        return np.stack(out) if out else np.zeros((0, self.width), np.int64)

    def produce_consume(self, batch: np.ndarray,
                        max_n: int | None = None) -> np.ndarray:
        """Fused publish+poll for a DEVICE ring: produce `batch` and
        drain the valid prefix in ONE launch (kernels/desc_ring
        `produce_consume`) — the serve engine's one-launch step rides
        this through `CompletionQueue.enable_fused_poll`. Head/tail/
        credit/publish bookkeeping is identical to `produce(batch)`
        followed by `consume(max_n)`; only the launch count differs
        (1, not 2). Returns the drained (k, width) descriptor block."""
        if not self.device:
            raise ValueError("produce_consume requires a device ring")
        batch = np.atleast_2d(np.asarray(batch, np.int64))
        if batch.size == 0:
            batch = np.zeros((0, self.width), np.int64)
        n = batch.shape[0]
        if n and self._credit() < n:
            self._producer_view = self._published_tail
            self.dma_reads += 1
            if self._credit() < n:
                raise RingFullError(
                    f"need {n} slots, have {self._credit()}")
        limit = self.capacity if max_n is None \
            else min(max_n, self.capacity)
        limit = min(limit, self.head + n - self.tail)
        if n == 0 and limit <= 0:
            return np.zeros((0, self.width), np.int64)
        out = self._ring_ops.produce_consume(
            self.slots, self.flags, self.head, self.tail,
            batch[:n], max(0, limit), via=self._via)
        if n:
            self.head += n
            self.dma_writes += 1      # the whole batch rode one DMA
            self.max_occupancy = max(self.max_occupancy,
                                     self.head - self._published_tail)
        k = out.shape[0]
        if k:
            self.tail += k
            total = self._since_publish + k
            if total >= self.publish_every:
                self._since_publish = total % self.publish_every
                self._published_tail = self.tail - self._since_publish
            else:
                self._since_publish = total
        return out

    def force_publish(self):
        self._published_tail = self.tail
        self._since_publish = 0

    def slots_view(self) -> np.ndarray:
        """Host int64 view of the slot memory (tests/introspection): a
        device ring copies its slots back — bit-exact with the host
        ring's slots."""
        if self.device:
            return self.slots.cpu().numpy()
        return self.slots

    def flags_view(self) -> np.ndarray:
        return self.flags.cpu().numpy() if self.device else self.flags

    def free_slots(self) -> int:
        """Slots the producer could fill right now given the TRUE consumer
        position (not its cached credit view): the quantity verbs-level
        flow control budgets against. Costs no DMA — in hardware this is
        the producer's local occupancy bound, refreshed by consumption."""
        return self.capacity - len(self)

    def __len__(self):
        return self.head - self.tail


class DoorbellQueue:
    """Baseline for Fig. 15: per-element submission, each costing one
    doorbell write plus one fetch DMA round-trip (two 'PCIe' ops/elem)."""

    def __init__(self, capacity: int, width: int = DESCRIPTOR_WIDTH):
        self.ring = Ring(capacity, width, publish_every=1)
        self.doorbell_writes = 0
        self.fetch_dmas = 0

    def produce(self, batch: np.ndarray) -> int:
        batch = np.atleast_2d(np.asarray(batch, np.int64))
        if batch.size == 0:
            # np.atleast_2d turns an empty batch into a (1, 0) row that
            # would be produced at the wrong width — no-op like Ring
            return 0
        for row in batch:
            self.ring.produce(row[None])
            self.doorbell_writes += 1
            self.fetch_dmas += 1
        return batch.shape[0]

    def consume(self, max_n=None):
        return self.ring.consume(max_n)
