"""Front-end router for a disaggregated serving cluster.

A `ServeCluster` is prefill pods + decode pods (paged `ServeEngine`s
listening under a service name) on ONE fabric. The `Router` is the
front-end: `submit()` enqueues a request; the scheduler places it on the
least-loaded decode pod with page capacity (continuous batching at
cluster scope — admission is gated on pages, not on a global barrier)
and hands it to a prefill pod round-robin. Placement is *discovered*,
not wired: decode pods are whatever `fabric.discover(prefix)` returns,
so a pod killed mid-run simply stops being offered and its unfinished
requests are re-queued through the survivors. Greedy decode is
deterministic, so a replayed request regenerates exactly the tokens the
dead pod would have produced — cluster output is bit-exact against a
single-pod oracle even across failover.

The router never touches cache bytes: pages move prefill pod -> decode
pod as one-sided RDMA_WRITEs (`KVTransferEngine.migrate_pages`), and
requests go live via OP_KV_ACTIVATE descriptors on the decode engine's
notification ring.

The port of the reference's `repro.serve.router`: the router is
host-side control flow and touches no tensor.
"""
from __future__ import annotations

from collections import deque

from repro_torch.obs import metrics


class Router:
    """Cluster front-end: service discovery + load balancing + failover
    re-routing. Holds the decode `ServeEngine`s (control plane) but
    places requests using only fabric-visible state: `discover()` for
    liveness, engine load/pages for capacity."""

    requests_routed = metrics.counter_attr()
    failovers = metrics.counter_attr()

    def __init__(self, fabric, *, prefix: str = "serve/"):
        metrics.instance_scope(self, "router", indexed=True)
        self.requests_routed = 0
        self.failovers = 0
        self.fabric = fabric
        self.prefix = prefix
        self.prefill_pods: list = []
        self.engines: dict[str, object] = {}    # decode gid -> ServeEngine
        self._rr = 0
        self._next_id = 0
        self._queue: deque = deque()            # (rid, prompt, max_new)
        self._placement: dict[int, tuple] = {}  # rid -> (prompt, max_new)
        self._owner: dict[int, str] = {}        # rid -> decode gid
        self._results: dict[int, list] = {}

    def add_decode(self, engine) -> "Router":
        if not engine.paged:
            raise ValueError("cluster decode pods must be paged")
        self.engines[engine.gid] = engine
        return self

    def add_prefill(self, pod) -> "Router":
        self.prefill_pods.append(pod)
        return self

    # -- placement ------------------------------------------------------
    def backends(self) -> list[str]:
        """LIVE decode gids, via service discovery (sorted by service
        name — deterministic iteration order)."""
        return [a.gid for a in self.fabric.discover(self.prefix).values()
                if a.gid in self.engines]

    def _capacity_ok(self, eng, plen: int, max_new: int) -> bool:
        n = min(eng.pool.pages_for(plen + max_new + 1),
                eng.pool.pages_per_slot)
        busy = sum(1 for s in eng.slots if s is not None) \
            + len(eng._reserved)
        return busy < eng.max_batch and len(eng.pool._free) >= n

    def _pick_decode(self, plen: int, max_new: int) -> str | None:
        """Least-loaded live decode pod with page capacity for this
        request; gid-ordered tie-break keeps placement deterministic."""
        cands = [g for g in self.backends()
                 if self._capacity_ok(self.engines[g], plen, max_new)]
        if not cands:
            return None
        def load(g):
            e = self.engines[g]
            return (sum(1 for s in e.slots if s is not None)
                    + len(e._reserved), g)
        return min(cands, key=load)

    # -- client API -----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        rid = self._next_id
        self._next_id += 1
        self.requests_routed += 1
        self._placement[rid] = (list(prompt), max_new_tokens)
        self._queue.append(rid)
        return rid

    def _dispatch(self):
        """Admit queued requests while some decode pod has capacity:
        prefill round-robin, decode least-loaded."""
        while self._queue:
            rid = self._queue[0]
            prompt, max_new = self._placement[rid]
            gid = self._pick_decode(len(prompt), max_new)
            if gid is None:
                return                      # full — retry next iteration
            self._queue.popleft()
            pod = self.prefill_pods[self._rr % len(self.prefill_pods)]
            self._rr += 1
            self._owner[rid] = pod.process(rid, prompt, max_new,
                                           self.engines, decode_gid=gid)

    def _reroute_dead(self):
        """Requests owned by a dead decode pod go back on the queue —
        head of line, so survivors pick them up first. Deterministic
        greedy decode makes the replayed output identical."""
        for rid, gid in list(self._owner.items()):
            if self.fabric.alive(gid):
                continue
            del self._owner[rid]
            self.failovers += 1
            self._queue.appendleft(rid)

    def _collect(self):
        for gid, eng in self.engines.items():
            if not self.fabric.alive(gid):
                continue
            for rid in [r for r in list(eng._finished)
                        if r in self._placement and r not in self._queue]:
                self._results[rid] = eng._finished.pop(rid)
                del self._placement[rid]
                self._owner.pop(rid, None)

    # -- the serving loop ----------------------------------------------
    def step(self) -> int:
        """One cluster iteration: reroute orphans, dispatch, step every
        live decode engine, harvest finished requests. Returns the
        number of active slots across the cluster."""
        self._reroute_dead()
        self._dispatch()
        busy = 0
        for gid, eng in self.engines.items():
            if not self.fabric.alive(gid):
                continue
            busy += eng.step()
        self._collect()
        return busy

    def run_until_done(self, max_iters: int = 5000) -> dict[int, list]:
        for _ in range(max_iters):
            self.step()
            if not self._queue and not self._placement:
                break
        return dict(self._results)

    def close(self):
        for pod in self.prefill_pods:
            pod.close()
        for gid, eng in self.engines.items():
            if self.fabric.alive(gid):
                eng.close()
        return self
