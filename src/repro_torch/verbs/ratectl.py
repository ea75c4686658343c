"""DCQCN-flavored per-route rate control on top of the CQ-credit pool.

DCQCN (RoCEv2's congestion control) pairs ECN marking at the congested
switch with a reaction point at the sender: multiplicative rate decrease
scaled by a moving congestion estimate ``alpha`` on a mark, additive
recovery when marks stop. Our in-process analogue of switch-queue depth
is the *destination recv CQ backlog* — exactly the quantity the existing
CQ-credit flow control reserves against — so the controller layers on
the same pool instead of inventing a parallel one:

- **congestion point**: a route is marked when its destination recv CQ
  occupancy (staged + published CQEs) exceeds ``ecn_watermark``.
- **reaction point**: on a mark, ``rate *= 1 - alpha/2`` and ``alpha``
  rises toward 1; without marks ``alpha`` decays by ``g`` and the rate
  recovers by ``ai_increment`` per tick up to ``line_rate``.
- **enforcement**: `Fabric.process_many` paces each flush in rounds —
  `throttle()` stashes the tail of every routed send queue beyond the
  route's current allowance, the round dispatches + polices, `restore()`
  puts the tail back, `tick()` observes and adapts. Rounds repeat until
  the stash drains, so one `flush()` still delivers everything the
  caller posted; the rate only shapes *how* it drains.

All state is registry-backed under the owning fabric's scope:
``fabric0/route:<src>-><dst>/{ecn_marks,rate_decreases,rate_increases,
throttled_wrs,current_rate}`` per route (gid-keyed, so snapshot paths are
stable across runs) plus controller totals under ``fabric0/ratectl0/``.
"""
from __future__ import annotations

from repro_torch.obs import metrics


class RouteState:
    """Reaction-point state for one directed route (src gid -> dst gid)."""

    ecn_marks = metrics.counter_attr()
    rate_decreases = metrics.counter_attr()
    rate_increases = metrics.counter_attr()
    throttled_wrs = metrics.counter_attr()
    current_rate = metrics.gauge_attr()
    alpha = metrics.gauge_attr()         # DCQCN congestion estimate

    def __init__(self, ctl: "RateController", src_gid: str, dst_gid: str):
        metrics.instance_scope(self, f"route:{src_gid}->{dst_gid}",
                               parent=ctl._fabric_scope)
        self.src_gid = src_gid
        self.dst_gid = dst_gid
        self.rate = float(ctl.line_rate)     # WRs per pacing round
        self.alpha = 1.0                     # congestion estimate
        self.ecn_marks = 0
        self.rate_decreases = 0
        self.rate_increases = 0
        self.throttled_wrs = 0
        self.current_rate = self.rate

    def react(self, ctl: "RateController", marked: bool):
        """One DCQCN reaction-point update: multiplicative decrease
        scaled by the moving congestion estimate on an ECN mark, alpha
        decay + additive recovery otherwise. Invariants (property-tested
        in the reference's serve-cluster tests): ``min_rate <= rate <=
        line_rate`` under ANY mark schedule, ``0 <= alpha <= 1``, and a
        drained (mark-free) route recovers to line rate additively."""
        if marked:
            self.ecn_marks += 1
            self.alpha = (1.0 - ctl.g) * self.alpha + ctl.g
            new_rate = max(ctl.min_rate,
                           self.rate * (1.0 - self.alpha / 2.0))
            if new_rate < self.rate:
                self.rate_decreases += 1
            self.rate = new_rate
        else:
            self.alpha *= (1.0 - ctl.g)
            if self.rate < ctl.line_rate:
                self.rate = min(float(ctl.line_rate),
                                self.rate + ctl.ai_increment)
                self.rate_increases += 1
        self.current_rate = self.rate


class RateController:
    """Per-route DCQCN reaction points for one `Fabric`.

    Driven entirely from `Fabric.process_many`; tenants never call it.
    Enable with ``Fabric(..., rate_control=True)`` (or a dict of the
    constructor knobs below)."""

    pacing_rounds = metrics.counter_attr()
    wrs_stashed = metrics.counter_attr()

    def __init__(self, fabric, *, line_rate: int = 64, min_rate: float = 1.0,
                 ecn_watermark: int = 32, ai_increment: float = 4.0,
                 g: float = 0.0625):
        self._fabric_scope = metrics.scope_of(fabric)
        metrics.instance_scope(self, "ratectl", indexed=True,
                               parent=self._fabric_scope)
        if line_rate < 1:
            raise ValueError(f"line_rate must be >= 1, got {line_rate}")
        self.fabric = fabric
        self.line_rate = int(line_rate)
        self.min_rate = float(min_rate)
        self.ecn_watermark = int(ecn_watermark)
        self.ai_increment = float(ai_increment)
        self.g = float(g)
        self.routes: dict[tuple[str, str], RouteState] = {}
        self._stash: list[tuple[object, list]] = []
        self.pacing_rounds = 0
        self.wrs_stashed = 0

    # -- route lookup ----------------------------------------------------
    def _route_state(self, qp):
        """The RouteState a QP sends on, or None for unrouted / loopback
        QPs (those are never paced — there is no wire to congest)."""
        fabric = self.fabric
        route = fabric.routes.get(qp.qp_num)
        src = fabric.gid_of.get(qp.qp_num)
        if route is None or src is None or route.gid == src:
            return None
        key = (src, route.gid)
        st = self.routes.get(key)
        if st is None:
            st = self.routes[key] = RouteState(self, src, route.gid)
        return st

    # -- enforcement (called by Fabric.process_many) ---------------------
    def throttle(self, qps) -> int:
        """Trim every routed QP's send queue to its route's current
        allowance for this pacing round; the tail is stashed and MUST be
        handed back via `restore()` before the flush returns."""
        stashed = 0
        for qp in qps:
            st = self._route_state(qp)
            if st is None:
                continue
            allowance = max(1, int(st.rate))
            excess = len(qp.sq) - allowance
            if excess <= 0:
                continue
            tail = [qp.sq.pop() for _ in range(excess)]
            tail.reverse()
            self._stash.append((qp, tail))
            st.throttled_wrs += excess
            stashed += excess
        if stashed:
            self.wrs_stashed += stashed
        return stashed

    def restore(self):
        """Put stashed tails back (post order preserved). Idempotent —
        `Fabric.process_many` also calls it from a finally block so a
        mid-dispatch raise can't leak posted WRs."""
        for qp, tail in self._stash:
            qp.sq.extend(tail)
        self._stash.clear()

    def tick(self, qps):
        """One pacing interval: observe each active route's congestion
        point (destination recv CQ backlog) and adapt its rate."""
        self.pacing_rounds += 1
        seen: set[tuple[str, str]] = set()
        fabric = self.fabric
        for qp in qps:
            st = self._route_state(qp)
            if st is None or (st.src_gid, st.dst_gid) in seen:
                continue
            seen.add((st.src_gid, st.dst_gid))
            route = fabric.routes.get(qp.qp_num)
            peer = fabric.qps.get(route.qpn) if route is not None else None
            if peer is None:
                continue
            depth = len(peer.recv_cq)
            st.react(self, depth > self.ecn_watermark)
