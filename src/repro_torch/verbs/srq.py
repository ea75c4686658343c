"""Shared receive queue: one recv-WR pool feeding many QPs.

FlexiNS's RX path keeps an unbounded working set per tenant only because
every connection owns a private recv ring; multi-tenant serving wants the
ibv SRQ model instead — all QPs of a tenant draw landing buffers from ONE
pool, so a bursty connection cannot strand credits that an idle one is
hoarding. Semantics follow ibverbs:

  * ``post_recv`` refills the pool (any thread/owner; WRs are anonymous
    until a SEND claims one);
  * a QP created with ``srq=`` MUST NOT ``post_recv`` on itself — its
    recv side is the pool (``ibv_post_recv`` on such a QP returns EINVAL);
  * delivery order is pool-FIFO across all attached QPs, which is what
    makes the pool fair under overload: each arriving SEND takes the
    oldest posted buffer, whichever QP it lands on;
  * ``srq_limit``: arming a low watermark fires ONE limit event when the
    pool drops below it (the IBV_EVENT_SRQ_LIMIT_REACHED analogue) and
    disarms — re-arm with ``arm()`` after refilling. The serve engine
    uses it as its refill doorbell instead of polling pool depth.
"""
from __future__ import annotations

from collections import deque
from typing import Callable

from repro_torch.obs import metrics
from repro_torch.verbs.qp import QPStateError, RecvWR, check_recv


class SharedReceiveQueue:
    # watermark events fired, as `srq{i}/limit_events` in the registry
    limit_events = metrics.counter_attr()

    def __init__(self, max_wr: int = 512, *, srq_limit: int = 0,
                 on_limit: Callable[["SharedReceiveQueue"], None] | None = None):
        metrics.instance_scope(self, "srq", indexed=True)
        # pool depth is owned by the deque — sample it, don't mirror it
        # (weakly: the registry must not keep a dead pool's WRs alive)
        metrics.weak_probe(self._metrics, "pool_depth", self,
                           lambda s: len(s._wrs))
        self.max_wr = max_wr
        self.srq_limit = srq_limit
        # limit-event listeners: a fabric-scope pool serves several
        # tenants (serve engine, kvtransfer, ...), each with its own
        # refill doorbell — ONE watermark event fans out to all of them
        self._limit_cbs: list[Callable[["SharedReceiveQueue"], None]] = \
            [on_limit] if on_limit is not None else []
        self._wrs: deque[RecvWR] = deque()
        self._armed = srq_limit > 0
        self.limit_events = 0
        self.qps: list = []           # attached QueuePairs (for introspection)
        # accounting: recv WRs consumed per attached qp_num (fairness probes)
        self.taken_by_qp: dict[int, int] = {}

    # -- refill -------------------------------------------------------------
    def post_recv(self, wr: RecvWR | list[RecvWR]):
        wrs = wr if isinstance(wr, list) else [wr]
        if len(self._wrs) + len(wrs) > self.max_wr:
            raise QPStateError(
                f"SRQ full: {len(self._wrs)}+{len(wrs)} > max_wr="
                f"{self.max_wr}")
        for w in wrs:
            check_recv(w)
        self._wrs.extend(wrs)
        return self

    def arm(self, srq_limit: int):
        """ibv_modify_srq(IBV_SRQ_LIMIT): set the low watermark and re-arm
        the one-shot limit event."""
        self.srq_limit = srq_limit
        self._armed = srq_limit > 0
        return self

    # -- limit-event listeners ----------------------------------------------
    @property
    def on_limit(self):
        return self._limit_cbs[0] if self._limit_cbs else None

    @on_limit.setter
    def on_limit(self, cb):
        if len(self._limit_cbs) > 1:
            # a fabric-scope pool with several tenants' doorbells: one
            # client assigning on_limit must not silently wipe the
            # others' refill callbacks
            raise QPStateError(
                f"SRQ has {len(self._limit_cbs)} limit listeners "
                "(add_on_limit); assigning on_limit would drop them")
        self._limit_cbs = [cb] if cb is not None else []

    def add_on_limit(self, cb: Callable[["SharedReceiveQueue"], None]):
        """Register an ADDITIONAL limit listener (fabric-scope pools: one
        watermark, many tenants' refill doorbells)."""
        self._limit_cbs.append(cb)
        return self

    def remove_on_limit(self, cb: Callable[["SharedReceiveQueue"], None]):
        """Unregister a limit listener (a tenant leaving the pool must
        not keep firing — or keep the tenant alive via the closure)."""
        if cb in self._limit_cbs:
            self._limit_cbs.remove(cb)
        return self

    # -- transport side -----------------------------------------------------
    def attach(self, qp) -> "SharedReceiveQueue":
        if qp not in self.qps:
            self.qps.append(qp)
            self.taken_by_qp.setdefault(qp.qp_num, 0)
        return self

    def take(self, qp_num: int) -> RecvWR | None:
        """Claim the oldest posted WR for a SEND landing on `qp_num`;
        None means RNR (the SEND stalls, exactly like an empty per-QP rq).
        Crossing the armed watermark fires the one-shot limit event."""
        if not self._wrs:
            return None
        wr = self._wrs.popleft()
        self.taken_by_qp[qp_num] = self.taken_by_qp.get(qp_num, 0) + 1
        if self._armed and len(self._wrs) < self.srq_limit:
            self._armed = False
            self.limit_events += 1
            for cb in list(self._limit_cbs):
                cb(self)
        return wr

    def take_many(self, qp_num: int, n: int) -> list[RecvWR]:
        """Claim up to n oldest WRs in one batched pop (the vectorized
        dispatch path: one call per SEND run instead of one per SEND).
        Returns fewer than n when the pool runs dry — the caller treats
        the shortfall as RNR, exactly like a None from `take`."""
        if n <= 0 or not self._wrs:
            return []
        if self._armed and len(self._wrs) - min(n, len(self._wrs)) \
                < self.srq_limit:
            # the watermark may fire (and its refill callback may top the
            # pool back up) MID-batch: fall back to sequential takes so
            # batched and per-WR delivery stay bit-identical
            out = []
            while len(out) < n:
                wr = self.take(qp_num)
                if wr is None:
                    break
                out.append(wr)
            return out
        k = min(n, len(self._wrs))
        out = [self._wrs.popleft() for _ in range(k)]
        self.taken_by_qp[qp_num] = self.taken_by_qp.get(qp_num, 0) + k
        return out

    def untake(self, qp_num: int, wrs: list[RecvWR]):
        """Return claimed-but-unused WRs to the FRONT of the pool (a
        batched delivery failed mid-run): pool-FIFO order and the
        per-QP accounting both end up as if they were never taken."""
        self._wrs.extendleft(reversed(wrs))
        self.taken_by_qp[qp_num] = \
            self.taken_by_qp.get(qp_num, 0) - len(wrs)

    def __len__(self):
        return len(self._wrs)
