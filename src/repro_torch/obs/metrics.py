"""Hierarchical metric registry for the verbs stack.

FlexiNS's line-rate claims are *counted hardware events* — desc-fetch
DMAs, doorbell writes, notification-ring batches — and FlexTOE's lesson
is that a programmable datapath is only debuggable with first-class
per-stage statistics. Before this module those counts lived as ad-hoc
``self.x += 1`` attributes scattered across qp/cq/fabric, visible only
to the one benchmark that knew each attribute name.

Here every counter is a named entry in ONE registry, addressed by a
hierarchical path such as ``fabric0/qp3/desc_fetch_dmas`` or
``cq0/fc_reserved``:

  * `Counter` — monotonic event count (doorbells, DMAs, RNR retries);
  * `Gauge`   — instantaneous level (CQ credit reservations, pool depth);
  * `Histogram` — sample distribution with a {count, p50, p95, max}
    summary (bench tail latency);
  * `Probe`   — a sampled view of a value owned elsewhere (SRQ depth,
    `QPContext.dma_launches`), held through a weakref so the registry
    never keeps a torn-down object alive.

`Registry.snapshot()` is a flat ``{path: value}`` dict, `Registry.diff`
subtracts two snapshots (counter deltas around a timed region), and
`Registry.aggregate()` groups instances (``qp3`` + ``qp7`` -> ``qp``)
into the ``{"counters": .., "gauges": .., "histograms": ..}`` block the
benchmarks embed under the ``"metrics"`` key of every BENCH_*.json.

Migration is zero-cost for call sites: `counter_attr` / `gauge_attr`
are data descriptors, so existing ``self.doorbell_writes += 1``
statements and every benchmark that reads ``qp.doorbell_writes`` keep
working verbatim — the value simply lives in the registry now. The
descriptor caches its Metric object per instance, so the steady-state
cost of an increment is one dict lookup on either side of an int add
(and the hot paths touch counters per *chain/flush*, never per WR).
"""
from __future__ import annotations

import re
import weakref
from typing import Any, Callable


class Counter:
    """Monotonic event count. `value` is plain int arithmetic so the
    attribute views can read/add/assign without conversion."""
    kind = "counter"
    __slots__ = ("scope", "leaf", "value")

    def __init__(self, scope: "Scope", leaf: str):
        self.scope = scope
        self.leaf = leaf
        self.value = 0

    @property
    def name(self) -> str:
        return f"{self.scope.path}/{self.leaf}"

    def inc(self, n: int = 1):
        self.value += n
        return self

    def set(self, v):
        self.value = v
        return self

    def read(self):
        return self.value

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}={self.read()!r}>"


class Gauge(Counter):
    """Instantaneous level — same storage as Counter, different
    aggregation/diff semantics (levels are reported, not subtracted)."""
    kind = "gauge"
    __slots__ = ()


class Probe:
    """A sampled metric: reads a value owned by some live object (pool
    depth, a dataclass counter) at snapshot time — zero hot-path cost.
    The sampler should return None once its subject is gone; the probe
    then reports the last value it saw while alive — or None when it
    was NEVER sampled alive (snapshots skip it rather than reporting a
    made-up zero for a counter that may well have advanced)."""
    __slots__ = ("scope", "leaf", "kind", "_fn", "_last")

    def __init__(self, scope: "Scope", leaf: str,
                 fn: Callable[[], Any], kind: str = "gauge"):
        self.scope = scope
        self.leaf = leaf
        self.kind = kind
        self._fn = fn
        self._last = None

    @property
    def name(self) -> str:
        return f"{self.scope.path}/{self.leaf}"

    def read(self):
        v = self._fn()
        if v is not None:
            self._last = v
        return self._last

    def __repr__(self):
        return f"<Probe[{self.kind}] {self.name}={self._last!r}>"


class Histogram:
    """Bounded-reservoir sample distribution. `read()` summarizes as
    {count, p50, p95, max} — the shape the bench JSONs commit so tail
    latency is part of the perf trajectory, not just the median."""
    kind = "histogram"
    __slots__ = ("scope", "leaf", "max_samples", "count", "_samples")

    def __init__(self, scope: "Scope", leaf: str, max_samples: int = 4096):
        self.scope = scope
        self.leaf = leaf
        self.max_samples = max_samples
        self.count = 0
        self._samples: list = []

    @property
    def name(self) -> str:
        return f"{self.scope.path}/{self.leaf}"

    def observe(self, v):
        self.count += 1
        if len(self._samples) >= self.max_samples:
            # drop-oldest: tail stats track the recent window
            self._samples.pop(0)
        self._samples.append(float(v))
        return self

    def observe_many(self, vs):
        for v in vs:
            self.observe(v)
        return self

    @staticmethod
    def _pct(s: list, q: float) -> float:
        return s[min(len(s) - 1, round(q * (len(s) - 1)))]

    def read(self) -> dict:
        if not self._samples:
            return {"count": 0, "p50": 0.0, "p95": 0.0, "max": 0.0}
        s = sorted(self._samples)
        return {"count": self.count, "p50": self._pct(s, 0.50),
                "p95": self._pct(s, 0.95), "max": s[-1]}

    def __repr__(self):
        return f"<Histogram {self.name} {self.read()!r}>"


class Scope:
    """One node in the name hierarchy (a QP, a CQ, a fabric, a bench).
    Metrics are created on first use; `reparent` re-homes the whole
    subtree (a QP attaching to a fabric becomes ``fabric0/qp3/...``)
    without touching the Metric objects call sites already cached."""
    __slots__ = ("registry", "name", "parent", "metrics", "__weakref__")

    def __init__(self, registry: "Registry", name: str,
                 parent: "Scope | None" = None):
        self.registry = registry
        self.name = name
        self.parent = parent
        self.metrics: dict[str, Any] = {}

    @property
    def path(self) -> str:
        parts = []
        sc: Scope | None = self
        while sc is not None:
            parts.append(sc.name)
            sc = sc.parent
        return "/".join(reversed(parts))

    def reparent(self, parent: "Scope | None") -> "Scope":
        self.parent = parent
        return self

    def _get(self, leaf: str, cls, *args, **kw):
        m = self.metrics.get(leaf)
        if m is None:
            m = self.metrics[leaf] = cls(self, leaf, *args, **kw)
        return m

    def counter(self, leaf: str) -> Counter:
        return self._get(leaf, Counter)

    def gauge(self, leaf: str) -> Gauge:
        return self._get(leaf, Gauge)

    def histogram(self, leaf: str, max_samples: int = 4096) -> Histogram:
        return self._get(leaf, Histogram, max_samples)

    def probe(self, leaf: str, fn: Callable[[], Any],
              kind: str = "gauge") -> Probe:
        return self._get(leaf, Probe, fn, kind)

    def __repr__(self):
        return f"<Scope {self.path} ({len(self.metrics)} metrics)>"


class Registry:
    def __init__(self):
        self.scopes: list[Scope] = []
        self._by_name: dict[tuple[int, str], Scope] = {}
        self._indices: dict[str, int] = {}

    def scope(self, name: str, parent: Scope | None = None, *,
              indexed: bool = False) -> Scope:
        """Create (or, for non-indexed names, reuse) a scope. With
        ``indexed=True`` the name gets a per-registry instance suffix
        (``cq`` -> ``cq0``, ``cq1``, ...) so snapshot keys never
        collide for anonymous objects; naturally-unique names (``qp{n}``)
        pass indexed=False and act as singletons."""
        if indexed:
            i = self._indices.get(name, 0)
            self._indices[name] = i + 1
            name = f"{name}{i}"
        else:
            sc = self._by_name.get((id(parent), name))
            if sc is not None:
                return sc
        sc = Scope(self, name, parent)
        self.scopes.append(sc)
        self._by_name[(id(parent), name)] = sc
        return sc

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat {full_path: value}: numbers for counters/gauges/probes,
        a {count, p50, p95, max} dict for histograms. Cheap — one pass,
        no copies beyond the dict itself."""
        out: dict = {}
        for sc in self.scopes:
            if not sc.metrics:
                continue
            base = sc.path
            for leaf, m in sc.metrics.items():
                v = m.read()
                if v is not None:       # never-sampled dead probes
                    out[f"{base}/{leaf}"] = v
        return out

    @staticmethod
    def diff(before: dict, after: dict) -> dict:
        """Counter-style delta of two snapshots: numeric keys present in
        both subtract (after - before), keys only in `after` report
        as-is, histogram summaries keep the `after` value (distribution
        summaries don't subtract meaningfully)."""
        out: dict = {}
        for k, av in after.items():
            bv = before.get(k)
            if isinstance(av, dict) or not isinstance(bv, (int, float)):
                out[k] = av
            else:
                out[k] = av - bv
        return out

    @staticmethod
    def group_key(path: str) -> str:
        """Strip instance ids from every path component: qp3 -> qp,
        fabric0/qp12 -> fabric/qp. The aggregation key for BENCH JSONs."""
        return "/".join(re.sub(r"\d+$", "", c) or c
                        for c in path.split("/"))

    def aggregate(self) -> dict:
        """Instance-collapsed view for the bench trajectory: counters and
        gauges SUM across instances of one kind (total desc-fetch DMAs
        over every QP of a run), histograms merge conservatively (count
        sums; p50/p95/max take the worst across instances). Probes —
        even counter-kind ones — land in the GAUGES bucket: a sampled
        view depends on when its subject was last alive, so the perf
        gate (which hard-fails on the counters bucket) must not treat
        it as a deterministic event count."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for sc in self.scopes:
            if not sc.metrics:
                continue
            gbase = self.group_key(sc.path)
            for leaf, m in sc.metrics.items():
                key = f"{gbase}/{leaf}"
                v = m.read()
                if m.kind == "histogram":
                    h = out["histograms"].setdefault(
                        key, {"count": 0, "p50": 0.0, "p95": 0.0,
                              "max": 0.0})
                    h["count"] += v["count"]
                    for q in ("p50", "p95", "max"):
                        h[q] = max(h[q], v[q])
                elif isinstance(v, (int, float)):
                    hard = m.kind == "counter" and \
                        not isinstance(m, Probe)
                    bucket = out["counters" if hard else "gauges"]
                    bucket[key] = bucket.get(key, 0) + v
        return out


# -- process-default registry ------------------------------------------------
_REGISTRY = Registry()


def get_registry() -> Registry:
    return _REGISTRY


def set_registry(reg: Registry) -> Registry:
    global _REGISTRY
    _REGISTRY = reg
    return reg


def fresh_registry() -> Registry:
    """Swap in an empty default registry (the bench harness does this per
    module so each BENCH_*.json snapshot covers exactly one run)."""
    return set_registry(Registry())


def instance_scope(obj, name: str, *, indexed: bool = False,
                   parent: Scope | None = None) -> Scope:
    """Give `obj` its registry scope (stored as ``obj._metrics``); the
    attribute views below resolve through it. Call FIRST in __init__,
    before any metric-backed attribute is touched."""
    sc = get_registry().scope(name, parent, indexed=indexed)
    obj.__dict__["_metrics"] = sc
    return sc


def scope_of(obj) -> Scope:
    """The object's scope, minting an anonymous one on demand so the
    attribute views never fail on an uninstrumented class."""
    sc = obj.__dict__.get("_metrics")
    if sc is None:
        sc = instance_scope(obj, type(obj).__name__.lower(), indexed=True)
    return sc


def weak_probe(scope: Scope, leaf: str, obj, fn, kind: str = "gauge"):
    """Register a sampled metric reading `fn(obj)` while holding `obj`
    only weakly: a registry outliving torn-down QPs/SRQs must not pin
    them (or their device buffers) in memory."""
    ref = weakref.ref(obj)

    def sample():
        o = ref()
        return None if o is None else fn(o)

    return scope.probe(leaf, sample, kind=kind)


class counter_attr:
    """Class-level view of a registry Counter. Declared as

        class QueuePair:
            doorbell_writes = counter_attr()

    existing ``self.doorbell_writes += 1`` call sites and every
    benchmark reading ``qp.doorbell_writes`` keep working unchanged —
    the descriptor routes both through the registry counter under the
    instance's scope."""
    _cls = Counter

    def __set_name__(self, owner, name):
        self._name = name
        self._slot = "_metric_" + name

    def _metric(self, obj):
        m = obj.__dict__.get(self._slot)
        if m is None:
            m = scope_of(obj)._get(self._name, self._cls)
            obj.__dict__[self._slot] = m
        return m

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return self._metric(obj).value

    def __set__(self, obj, value):
        self._metric(obj).value = value


class gauge_attr(counter_attr):
    """Like `counter_attr` but registers as a Gauge (level, not event
    count) — CQ credit reservations, occupancy high-watermarks."""
    _cls = Gauge
