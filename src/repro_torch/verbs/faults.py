"""Fault-injecting fabric links: seeded drop / delay / duplicate schedules.

A `FaultModel` sits at the `Fabric` / transport boundary and decides, per
wire attempt of a SEND, whether the packet arrives. The decision is a
pure hash of ``(seed, flow, psn, attempt)`` — NOT a consumed RNG stream —
so the schedule is a property of the *traffic*, not of the order the
transport happens to consult it. That is the determinism contract that
keeps ``vectorized=False`` a bit-exactness oracle under faults: both
dispatch modes see identical flows (assigned at `Fabric.attach` in
construction order), identical per-WR packet sequence numbers (stamped in
`post_send`), and identical attempt counters (stored on the posted WR),
so they draw identical verdicts no matter how the passes batch.

What each verdict means on our in-process wire:

- **drop** — the packet is lost. The WR stalls in place; `Fabric._police`
  spends one unit of the QP's transport retry budget (``retry_cnt``,
  ibverbs' 0..7 — always finite) and retransmits. Budget exhausted →
  the WR retires ``IBV_WC_RETRY_EXC_ERR``, never a phantom SUCCESS.
- **delay** — the packet arrives a retransmission later: the WR stalls
  for one policing tick *without* touching the retry budget.
- **duplicate** — the packet arrives twice; RC PSN tracking absorbs the
  copy (``duplicates_absorbed``). Payloads stay exactly-once by
  construction, which is precisely the RC guarantee being modeled.
- **RNR-NAK drop** — the receiver's not-ready NAK is lost: the sender's
  retry timer still fires (retry accounting is unchanged) but the
  ``on_rnr_backoff`` refill hook never hears about it.

`kill_after(gid, n)` arms a count-based (hash-free) trigger: the n-th
wire packet toward ``gid`` kills that node mid-flush — the fabric tears
it down *after* the dispatch pass (`Fabric._run_pending_kills`), survivor
QPs drain as ``IBV_WC_WR_FLUSH_ERR`` and disconnect events fan out.

All injection bookkeeping lives in `repro_torch.obs` registry counters under
the owning fabric's scope (``fabric0/faults0/...``), so loss-schedule
tests assert on registry snapshots, not ad-hoc attributes.
"""
from __future__ import annotations

from repro_torch.obs import metrics

_M64 = (1 << 64) - 1
_RNR_SALT = 0xA5A5_5A5A_A5A5_5A5A


def _hash01(seed: int, flow: int, psn: int, attempt: int) -> float:
    """Uniform [0, 1) from a splitmix64-style finalizer over the packet
    identity. Stateless: the same packet attempt always draws the same
    verdict, in any consultation order."""
    x = (seed * 0x9E3779B97F4A7C15 + flow * 0xBF58476D1CE4E5B9
         + psn * 0x94D049BB133111EB + attempt * 0xD6E8FEB86659FD93) & _M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return x / 18446744073709551616.0      # / 2**64


def _check_rates(drop: float, delay: float, dup: float):
    for name, v in (("drop", drop), ("delay", delay), ("dup", dup)):
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"{name} rate {v} outside [0, 1]")
    if drop + delay + dup > 1.0:
        raise ValueError(
            f"drop+delay+dup = {drop + delay + dup} exceeds 1.0")


class FaultModel:
    """Seeded per-link fault schedule for one `Fabric`.

    Install at fabric construction (``Fabric(..., faults=FaultModel(...))``)
    so every posted WR carries a packet sequence number; base rates apply
    to every route, `link()` overrides a specific ordered gid pair."""

    # injected-event counters (registry-backed: `fabric0/faults0/...`)
    drops_injected = metrics.counter_attr()
    delays_injected = metrics.counter_attr()
    duplicates_absorbed = metrics.counter_attr()
    rnr_naks_dropped = metrics.counter_attr()
    retry_exhausted = metrics.counter_attr()
    wire_packets = metrics.counter_attr()        # admitted attempts
    kills_triggered = metrics.counter_attr()

    def __init__(self, seed: int = 0, *, drop: float = 0.0,
                 delay: float = 0.0, dup: float = 0.0,
                 rnr_nak_drop: float = 0.0):
        metrics.instance_scope(self, "faults", indexed=True)
        _check_rates(drop, delay, dup)
        if not 0.0 <= rnr_nak_drop <= 1.0:
            raise ValueError(f"rnr_nak_drop {rnr_nak_drop} outside [0, 1]")
        self.seed = int(seed)
        self._base = (float(drop), float(delay), float(dup))
        self.rnr_nak_drop = float(rnr_nak_drop)
        # ordered (src_gid, dst_gid) -> (drop, delay, dup) overrides
        self._links: dict[tuple[str | None, str | None],
                          tuple[float, float, float]] = {}
        self._kill_at: dict[str, int] = {}       # dst gid -> packet count
        self._kill_seen: dict[str, int] = {}
        # qp_num -> stable flow id, assigned in Fabric.attach order so the
        # schedule survives qp_num differences between runs
        self._flows: dict[int, int] = {}
        self.drops_injected = 0
        self.delays_injected = 0
        self.duplicates_absorbed = 0
        self.rnr_naks_dropped = 0
        self.retry_exhausted = 0
        self.wire_packets = 0
        self.kills_triggered = 0

    # -- schedule configuration ------------------------------------------
    def link(self, src_gid: str, dst_gid: str, *, drop: float | None = None,
             delay: float | None = None, dup: float | None = None):
        """Override the base rates for one directed link (src -> dst);
        omitted rates keep the base value. Returns self for chaining."""
        b = self._base
        rates = (b[0] if drop is None else float(drop),
                 b[1] if delay is None else float(delay),
                 b[2] if dup is None else float(dup))
        _check_rates(*rates)
        self._links[(src_gid, dst_gid)] = rates
        return self

    def kill_after(self, dst_gid: str, n: int):
        """Arm a deterministic kill: the n-th wire packet toward
        ``dst_gid`` (counting every admission consult, 1-based) takes the
        node down mid-flush. Count-based, so it consumes no hash
        decisions and lands identically under both dispatch modes."""
        if n < 1:
            raise ValueError(f"kill_after needs n >= 1, got {n}")
        self._kill_at[dst_gid] = int(n)
        return self

    def register(self, qp_num: int) -> int:
        """Assign (or look up) the stable flow id for a QP. Called by
        `Fabric.attach` in QP-construction order — the ordering that
        makes schedules reproducible across runs."""
        return self._flows.setdefault(qp_num, len(self._flows))

    # -- the link decision -----------------------------------------------
    def admit(self, fabric, qp, ps) -> bool:
        """One wire attempt for the head SEND `ps` on `qp`'s route, made
        AFTER the receive claim succeeded (claim order is what both
        dispatch modes share). True: the packet arrives (duplicates
        absorbed). False: it does not — the caller hands the claim back
        and the WR stalls with ``ps.fault_stall`` naming the cause for
        `Fabric._police` to act on."""
        route = fabric.routes.get(qp.qp_num)
        dst = route.gid if route is not None else None
        if dst is not None:
            if dst in fabric.dead_gids or dst in fabric._pending_kills:
                ps.fault_stall = "kill"
                return False
            kill_at = self._kill_at.get(dst)
            if kill_at is not None:
                seen = self._kill_seen.get(dst, 0) + 1
                self._kill_seen[dst] = seen
                if seen >= kill_at:
                    self.kills_triggered += 1
                    fabric._pending_kills.append(dst)
                    ps.fault_stall = "kill"
                    return False
        src = fabric.gid_of.get(qp.qp_num)
        drop, delay, dup = self._links.get((src, dst), self._base)
        flow = self.register(qp.qp_num)
        attempt = ps.wire_attempts
        ps.wire_attempts = attempt + 1
        if drop or delay or dup:
            h = _hash01(self.seed, flow, ps.psn, attempt)
            if h < drop:
                ps.fault_stall = "drop"
                self.drops_injected += 1
                return False
            if h < drop + delay:
                ps.fault_stall = "delay"
                self.delays_injected += 1
                return False
            if h < drop + delay + dup:
                self.duplicates_absorbed += 1    # RC PSN dedup eats the copy
        ps.fault_stall = None
        self.wire_packets += 1
        return True

    def drop_rnr_nak(self, qp, ps) -> bool:
        """Whether the RNR NAK for this retry of `ps` is lost on the
        wire. Salted separately from the data-packet hash so NAK fate is
        independent of the packet's own drop verdict."""
        if not self.rnr_nak_drop:
            return False
        flow = self.register(qp.qp_num)
        h = _hash01(self.seed ^ _RNR_SALT, flow, ps.psn, ps.rnr_tries)
        if h < self.rnr_nak_drop:
            self.rnr_naks_dropped += 1
            return True
        return False
