"""Opt-in datapath tracer: spans in a fixed ring, Chrome trace_event out.

FlexTOE's argument (NSDI'22) is that a programmable datapath is only
tunable with per-stage tracing; this module is that layer for the verbs
stack. When a `Tracer` is installed the datapath records the span chain

    post_send -> doorbell -> dispatch_run -> cqe_publish -> poll_cq

with fusion annotations on each dispatch run (run length, WRs handled,
stacked-DMA count, scatter size), buffered in a FIXED ring — tracing
never allocates unboundedly, old events fall off the back — and
exportable as Chrome ``trace_event`` JSON that loads directly in
perfetto (ui.perfetto.dev) or chrome://tracing.

The disabled case is the default and costs nothing on the hot loop:
``TRACER`` is a module global that instrumentation sites read once per
*batch operation* (a chain post, a dispatch run, a CQ publish — never
per WR) and test against None. No null-object method dispatch, no
wrapper frames: `bench_line_rate` with the registry installed and
tracing off must stay inside the committed perf gates, and does.

Usage:

    from repro_torch.obs import trace
    with trace.tracing() as t:
        ... run verbs traffic ...
    t.save("datapath.trace.json")       # load in perfetto
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager

#: THE tracer hook. None (the default) is the zero-cost fast path —
#: instrumentation sites guard with ``if trace.TRACER is not None``.
TRACER = None


class Tracer:
    """Fixed-ring span/event recorder. `clock` is injectable (tests pin
    a deterministic clock for the golden export)."""

    def __init__(self, capacity: int = 65536, clock=time.perf_counter_ns):
        assert capacity > 0
        self.capacity = capacity
        self._clock = clock
        self._events: list = [None] * capacity
        self._n = 0                 # monotonic event count

    # -- recording (the hot side) -------------------------------------------
    def now(self) -> int:
        """Span-open timestamp (ns) — pair with `complete`."""
        return self._clock()

    def complete(self, name: str, t0: int, tid: str = "datapath", **args):
        """One complete span [t0, now): Chrome phase 'X'."""
        t1 = self._clock()
        self._events[self._n % self.capacity] = \
            ("X", name, t0, t1 - t0, tid, args)
        self._n += 1

    def instant(self, name: str, tid: str = "datapath", **args):
        """Zero-duration marker: Chrome phase 'i' (doorbell rings)."""
        self._events[self._n % self.capacity] = \
            ("i", name, self._clock(), 0, tid, args)
        self._n += 1

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wrap (recording never blocks)."""
        return max(0, self._n - self.capacity)

    def events(self) -> list:
        """Retained events, oldest first."""
        if self._n <= self.capacity:
            return [e for e in self._events[:self._n]]
        i = self._n % self.capacity
        return self._events[i:] + self._events[:i]

    # -- export -------------------------------------------------------------
    def export(self) -> dict:
        """Chrome trace_event JSON (dict form): perfetto/chrome://tracing
        load it as-is. Timestamps are microseconds relative to the first
        retained event; each logical tid gets a thread_name metadata
        record so the track labels read as stages, not numbers."""
        evs = self.events()
        epoch = min((e[2] for e in evs), default=0)
        tids: dict[str, int] = {}
        out: list = []
        for ph, name, t0, dur, tid, args in evs:
            k = tids.get(tid)
            if k is None:
                k = tids[tid] = len(tids) + 1
                out.append({"ph": "M", "pid": 1, "tid": k,
                            "name": "thread_name",
                            "args": {"name": tid}})
            ev = {"ph": ph, "name": name, "cat": "verbs", "pid": 1,
                  "tid": k, "ts": round((t0 - epoch) / 1e3, 3),
                  "args": args}
            if ph == "X":
                ev["dur"] = round(dur / 1e3, 3)
            else:
                ev["s"] = "t"       # instant scope: thread
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ns"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.export(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path


def install(tracer: Tracer | None = None) -> Tracer:
    """Enable tracing (idempotent: an explicit tracer replaces the
    current one). Returns the installed tracer."""
    global TRACER
    TRACER = tracer if tracer is not None else Tracer()
    return TRACER


def uninstall() -> Tracer | None:
    """Disable tracing; returns the tracer that was active (so its
    buffer can still be exported)."""
    global TRACER
    t, TRACER = TRACER, None
    return t


@contextmanager
def tracing(capacity: int = 65536, clock=time.perf_counter_ns):
    """Scoped enable: ``with trace.tracing() as t: ...; t.save(path)``.
    Always uninstalls, so an exception can't leave the datapath paying
    for tracing nobody reads."""
    t = install(Tracer(capacity, clock))
    try:
        yield t
    finally:
        uninstall()
