"""Routed multi-pod fabric: connection manager + addressed QPs.

FlexiNS keeps transport policy (QPs, steering, notification) on the NIC
so many connections/tenants share one engine without per-connection
control-plane cost. This module is that control plane for the repro:

  * `FabricAddress` — a QP (or listener) named by ``(gid, qpn)``, where
    the GID is a ``"pod{p}/dev{d}"`` coordinate on the fabric's
    `pod` x `device` grid (``repro_torch.launch.mesh.make_fabric_mesh``:
    CUDA devices when the machine has exactly that many cards, else the
    logical grid);
  * `ConnectionManager` — the RDMA-CM analogue, one per fabric node:
    ``listen`` registers a service, ``resolve`` maps a service name to
    an address, ``connect`` mints BOTH sides' QPs and drives them
    RESET -> INIT -> RTR -> RTS itself. Clients never touch the RC
    state machine;
  * `Fabric` — a routing `LoopbackTransport`: the routing table maps a
    source qp_num to its destination ``(gid, qpn)`` and one
    ``fabric.flush(*endpoints)`` pass dispatches every endpoint's WR
    chain batch-wise: same-opcode runs still fuse —
    grouped per (dst_ctx, opcode) run — CQEs of the whole pass publish
    once per CQ, and a chain spanning destination QPs costs one
    descriptor-fetch DMA per chain, not per WR. Cross-POD payload-tree
    SENDs lower onto `tx_engine.transmit` (the T1 striped wire; the
    identity in one process), intra-pod ones move by reference —
    `MeshTransport` semantics, routed.

Every node's protection domain lives on the fabric's device
(``Fabric(device=None)``: the package default, the card), so a fabric
built without a card raises at construction instead of at first use.

Fabric-scope SRQ: ``fabric.shared_srq()`` is ONE recv pool (and one
``srq_limit`` watermark, fanned out to every registered refill doorbell
via ``SharedReceiveQueue.add_on_limit``) serving every listener that
asked for ``srq="fabric"`` — serve-engine, kvtransfer and pd_disagg
tenants draw landing buffers from the same pool.

RNR semantics: ibverbs' rnr_retry. ``rnr_retry=7`` (the default) means
retry forever — a stalled SEND stays queued, exactly the pre-fabric
behavior. With a finite budget, ONE ``flush()`` runs the whole retry
schedule for a stalled head WR: each retry models one RNR timeout
firing (exponential backoff accumulates in ``rnr_backoff_units``, and
``on_rnr_backoff`` is the timeout hook — refill the peer there to model
a receiver catching up) and re-dispatches; a WR still stalled past the
budget retires with an ``IBV_WC_RNR_ERR`` completion — surfaced through
``poll_cq`` like any other status. RNR accounting is single-source: the
QP owns its ``rnr_retries`` / ``rnr_exhausted`` / ``rnr_backoff_units``
registry counters (``fabric{k}/qp{n}/...`` once attached), and the
fabric's same-named attributes are read-only sums over every QP it ever
attached — two views of ONE counter, never double-booked.

Unreliable-fabric semantics (see verbs/README.md "Fault model &
failover" for the full contract):

  * a `FaultModel` (``Fabric(..., faults=...)``, verbs/faults.py) makes
    the wire lossy — seeded drop/delay/duplicate schedules on SENDs and
    RNR NAKs. `_police` generalizes the RNR schedule to link faults:
    drops spend the ``retry_cnt`` transport budget (exhaustion retires
    ``IBV_WC_RETRY_EXC_ERR``), delays retransmit for free, duplicates
    are absorbed by RC PSN tracking. Faulted WRs retire with an error
    status or deliver exactly once — never a phantom SUCCESS;
  * ``rate_control=True`` layers a DCQCN-flavored per-route rate
    controller (verbs/ratectl.py) on the CQ-credit pool: each flush
    drains in paced rounds, marks routes whose destination recv CQ
    backlog crosses the ECN watermark, and adapts per-route rates
    (``fabric0/route:<src>-><dst>/...`` in registry snapshots);
  * peer death is an *event*, not a timeout: ``kill_node(gid)`` (or a
    `FaultModel.kill_after` trigger mid-flush) destroys the node's QPs
    and listeners, drains surviving senders' in-flight WRs as
    ``IBV_WC_WR_FLUSH_ERR``, and fans ``on_disconnect`` callbacks out to
    the endpoint (``connect(on_disconnect=...)``), the server's listener
    (``listen(on_disconnect=...)``) and the node's ConnectionManager
    (``cm.add_on_disconnect``) — tenants re-resolve and replay instead
    of stalling on RNR backoff.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.descriptors import TransferPlan
from repro_torch.device import resolve
from repro_torch.launch.mesh import make_fabric_mesh
from repro_torch.obs import metrics
from repro_torch.verbs import wqe
from repro_torch.verbs.cq import CompletionQueue, CQOverrunError
from repro_torch.verbs.pd import ProtectionDomain
from repro_torch.verbs.qp import QPState, QPStateError, QueuePair, SendWR
from repro_torch.verbs.ratectl import RateController
from repro_torch.verbs.srq import SharedReceiveQueue
from repro_torch.verbs.transport import MeshTransport, two_sided_send

# first qpn handed to listeners: a separate "service port" space so a
# listener address can never collide with a real QP number
_SERVICE_QPN_BASE = 1 << 20


@dataclass(frozen=True)
class FabricAddress:
    """Where a QP (or a listener) lives on the fabric: mesh coordinate
    (gid, e.g. ``"pod1/dev0"``) + queue-pair / service number."""
    gid: str
    qpn: int

    @property
    def pod(self) -> str:
        return self.gid.split("/", 1)[0]


def as_address(addr) -> FabricAddress:
    if isinstance(addr, FabricAddress):
        return addr
    if isinstance(addr, tuple) and len(addr) == 2:
        return FabricAddress(str(addr[0]), int(addr[1]))
    raise TypeError(f"not a fabric address: {addr!r}")


@dataclass
class _Listener:
    """One ``cm.listen()`` registration: accepted QPs share this recv CQ
    (and the fabric pool when srq is the shared one)."""
    cm: "ConnectionManager"
    service: str | None
    addr: FabricAddress
    recv_cq: CompletionQueue
    depth: int
    publish_every: int
    max_wr: int
    srq: SharedReceiveQueue | None
    flow_control: bool
    on_connect: Callable | None
    on_disconnect: Callable | None = None
    # None defers per-CQ device residency to the measured auto policy
    # (core.notification.DEVICE_RING_AUTO_DEPTH); accepted QPs' send CQs
    # inherit this so both directions of a connection resolve alike
    device_ring: bool | None = None
    accepted: list = field(default_factory=list)


class FabricEndpoint:
    """One side of a CM-established connection: the QP plus its CQs and
    the VerbsPair-style convenience surface (rpc/send/send_many). On the
    loopback rig ``.peer`` is the other side's endpoint — what a client
    polls to observe server-side recv completions in-process."""

    def __init__(self, fabric: "Fabric", qp: QueuePair, gid: str,
                 remote: FabricAddress | None = None,
                 peer: "FabricEndpoint | None" = None,
                 listener: _Listener | None = None):
        self.fabric = fabric
        self.qp = qp
        self.gid = gid
        self.remote = remote
        self.peer = peer
        self.listener = listener        # set on accepted (server) sides
        self.send_cq = qp.send_cq
        self.recv_cq = qp.recv_cq
        # disconnect event (rdma-cm DISCONNECTED): fired by the fabric
        # when the connected peer dies or hangs up — see _fire_disconnect
        self.on_disconnect: Callable | None = None

    @property
    def address(self) -> FabricAddress:
        return FabricAddress(self.gid, self.qp.qp_num)

    # -- verbs passthrough ---------------------------------------------------
    def post_send(self, wr):
        self.qp.post_send(wr)
        return self

    def post_recv(self, wr):
        self.qp.post_recv(wr)
        return self

    def flush(self) -> int:
        return self.fabric.process(self.qp)

    def poll(self, max_n: int | None = None):
        return self.send_cq.poll(max_n)

    def poll_recv(self, max_n: int | None = None):
        return self.recv_cq.poll(max_n)

    # -- the two-lines-of-setup conveniences (VerbsPair surface) -------------
    def rpc(self, opcode: int, payload, wr_id: int = 0):
        """post_send + flush + poll: one request/response round trip."""
        self.qp.post_send(SendWR(wr_id=wr_id, opcode=opcode,
                                 payload=payload))
        self.flush()
        wcs = self.send_cq.poll()
        assert wcs, "rpc produced no completion"
        return wcs[-1]

    def _exclusive_recv_cq(self):
        """send/send_many attribute EVERY completion they drain from the
        peer's recv CQ to this connection — refuse loudly when the peer's
        listener shares that CQ with other accepted connections (their
        completions would be cross-consumed silently). Multi-connection
        listeners poll the shared CQ themselves (the serve engine)."""
        lst = self.peer.listener
        if lst is not None and len(lst.accepted) > 1:
            raise QPStateError(
                f"listener at {lst.addr} has {len(lst.accepted)} accepted "
                "connections sharing one recv CQ; send()/send_many() "
                "cannot attribute its completions — poll the listener CQ "
                "directly instead")

    def send(self, payload, *, wr_id: int = 0, spec_tree=None,
             inline: bool | None = None):
        """Two-sided SEND to the connected peer; the peer-side recv
        completion is returned (recv side topped up automatically)."""
        self._exclusive_recv_cq()
        wcs = two_sided_send(self.qp, self.flush, self.peer.qp,
                             self.peer.recv_cq, [payload], wr_id=wr_id,
                             spec_tree=spec_tree, inline=inline)
        assert wcs, "send was not delivered (RNR?)"
        return wcs[-1]

    def send_many(self, payloads: list, *, wr_id: int = 0, spec_tree=None,
                  inline: bool | None = None):
        """Doorbell-batched two-sided SENDs: ONE WQE chain (one doorbell
        write, one descriptor-fetch DMA); recv completions in order."""
        if not payloads:
            return []
        self._exclusive_recv_cq()
        wcs = two_sided_send(self.qp, self.flush, self.peer.qp,
                             self.peer.recv_cq, payloads, wr_id=wr_id,
                             spec_tree=spec_tree, inline=inline)
        assert len(wcs) == len(payloads), \
            f"{len(wcs)}/{len(payloads)} delivered (RNR?)"
        return wcs


class ConnectionManager:
    """RDMA-CM for one fabric node: every QP it mints lives at this
    node's gid, on this node's protection domain."""

    def __init__(self, fabric: "Fabric", gid: str,
                 pd: ProtectionDomain | None = None):
        if gid not in fabric.gids:
            raise QPStateError(f"gid {gid!r} is not on this fabric "
                               f"(grid: {fabric.gids})")
        self.fabric = fabric
        self.gid = gid
        self.pd = pd or ProtectionDomain(device=fabric.device)
        # CM-level disconnect fan-out: fired for every connection of this
        # node that loses its peer (on top of per-endpoint/listener hooks)
        self._disconnect_cbs: list[Callable] = []

    def add_on_disconnect(self, cb: Callable) -> "ConnectionManager":
        self._disconnect_cbs.append(cb)
        return self

    def listen(self, service: str | None = None, *, depth: int = 512,
               publish_every: int = 8, max_wr: int = 256,
               srq: Any = "fabric", flow_control: bool = False,
               on_connect: Callable | None = None,
               on_disconnect: Callable | None = None,
               device_ring: bool | None = None) -> FabricAddress:
        """Register a listener and return its address. Accepted QPs share
        one recv CQ, and — with ``srq="fabric"`` (the default) — draw
        their landing buffers from the fabric-scope pool. Pass an SRQ
        instance for a private pool, or ``None`` for per-QP rq's.
        ``on_disconnect`` fires (with the accepted server endpoint) when
        a client of this listener dies or hangs up."""
        fabric = self.fabric
        if self.gid in fabric.dead_gids:
            raise QPStateError(f"node {self.gid} is dead")
        if service is not None and service in fabric._services:
            raise QPStateError(f"service {service!r} already listening")
        addr = FabricAddress(self.gid, fabric._next_service_qpn)
        fabric._next_service_qpn += 1
        pool = fabric.shared_srq() if srq == "fabric" else srq
        fabric._listeners[addr.qpn] = _Listener(
            self, service, addr,
            CompletionQueue(depth, publish_every, fabric.vectorized,
                            device_ring=device_ring,
                            torch_device=fabric.device),
            depth, publish_every, max_wr, pool, flow_control, on_connect,
            on_disconnect, device_ring=device_ring)
        if service is not None:
            fabric._services[service] = addr
        return addr

    def resolve(self, service: str) -> FabricAddress:
        """rdma_resolve_addr: service name -> fabric address."""
        addr = self.fabric._services.get(service)
        if addr is None:
            raise QPStateError(f"no listener for service {service!r}")
        return addr

    def connect(self, addr, *, depth: int = 512, publish_every: int = 8,
                max_wr: int = 256, flow_control: bool = False,
                on_disconnect: Callable | None = None,
                device_ring: bool | None = None) -> FabricEndpoint:
        """rdma_connect: mint a client QP here, accept a server QP at
        `addr` (a listener address, a service name, or a bare addressed
        QP still in RESET) and drive BOTH through the RC ladder. The
        returned endpoint is ready to post — no state-machine calls left
        to the client. ``on_disconnect`` fires (with this endpoint) when
        the connected peer dies."""
        fabric = self.fabric
        if self.gid in fabric.dead_gids:
            raise QPStateError(f"node {self.gid} is dead")
        if isinstance(addr, str):
            addr = self.resolve(addr)
        addr = as_address(addr)
        if addr.gid in fabric.dead_gids:
            raise QPStateError(f"cannot connect to {addr}: node "
                               f"{addr.gid} is dead")
        vec = fabric.vectorized
        # accept FIRST: a bad address must fail before the client QP is
        # minted (QueuePair.__init__ binds a T4 context on pd.engine —
        # a retry loop against a not-yet-listening service must not grow
        # the context table)
        server, listener = fabric._accept(addr)
        qp = QueuePair(self.pd,
                       CompletionQueue(depth, publish_every, vec,
                                       device_ring=device_ring,
                                       torch_device=fabric.device),
                       CompletionQueue(depth, publish_every, vec,
                                       device_ring=device_ring,
                                       torch_device=fabric.device),
                       max_send_wr=max_wr, max_recv_wr=max_wr,
                       flow_control=flow_control, vectorized=vec)
        fabric._register(qp, self.gid)
        for side, dest in ((server.qp, qp.qp_num),
                           (qp, server.qp.qp_num)):
            side.modify(QPState.INIT)
            side.modify(QPState.RTR, dest_qp_num=dest)
            side.modify(QPState.RTS)
        fabric.routes[qp.qp_num] = server.address
        fabric.routes[server.qp.qp_num] = FabricAddress(self.gid,
                                                        qp.qp_num)
        ep = FabricEndpoint(fabric, qp, self.gid, remote=server.address,
                            peer=server)
        ep.on_disconnect = on_disconnect
        server.remote = ep.address
        server.peer = ep
        fabric.endpoints[qp.qp_num] = ep
        fabric.endpoints[server.qp.qp_num] = server
        if listener is not None:
            listener.accepted.append(server)
            if listener.on_connect is not None:
                listener.on_connect(server)
        return ep


class Fabric(MeshTransport):
    """A routed transport over a `pod` x `device` grid. See the module
    docstring for the full contract; in one line: addressed QPs, CM
    bring-up, batch-wise multi-destination dispatch, a fabric-scope SRQ
    and ibverbs RNR retry/backoff. Subclasses `MeshTransport`: the wire
    lowering (plan/staged/wire_sends) is ONE implementation, gated here
    by the route's pod crossing."""

    #: ibverbs sentinel: rnr_retry == 7 retries forever (RNR = stall)
    RNR_RETRY_INFINITE = 7
    #: safety valve: max fault-injected retransmission ticks one flush
    #: spends per QP (a delay-rate-1.0 schedule must not wedge a flush)
    MAX_FAULT_TICKS = 256

    # failure-domain telemetry (registry-backed, `fabric{k}/...`):
    # disconnect events fired, nodes killed, and intra-pod device hops
    # (the devices_per_pod > 1 routing path)
    disconnects = metrics.counter_attr()
    nodes_killed = metrics.counter_attr()
    intra_pod_hops = metrics.counter_attr()

    def __init__(self, pods: int = 1, devices_per_pod: int = 1, *,
                 plan: TransferPlan | None = None, staged: bool = False,
                 vectorized: bool = True, rnr_retry: int = 7,
                 rnr_timeout: int = 1,
                 on_rnr_backoff: Callable[[QueuePair, int], None] | None
                 = None,
                 srq_max_wr: int = 512, srq_limit: int = 0,
                 faults=None, retry_cnt: int = 7,
                 rate_control: bool | dict = False, device=None):
        # the cross-pod payload wire (plan/staged/wire_sends) comes from
        # MeshTransport; _lower_payload below gates it on the route
        super().__init__(plan, staged=staged, vectorized=vectorized)
        # every node's pd and CQs live here (None: the package default);
        # resolving now makes a fabric without a card fail at construction
        self.device = resolve(device)
        self.pods = pods
        self.devices_per_pod = devices_per_pod
        self.gids = [f"pod{p}/dev{d}" for p in range(pods)
                     for d in range(devices_per_pod)]
        self._mesh = None
        self._mesh_built = False
        # control plane
        self.nodes: dict[str, ConnectionManager] = {}
        self.routes: dict[int, FabricAddress] = {}   # src qpn -> dst addr
        self.gid_of: dict[int, str] = {}
        self._listeners: dict[int, _Listener] = {}
        self._services: dict[str, FabricAddress] = {}
        self._next_service_qpn = _SERVICE_QPN_BASE
        # live CM-established connections by qp_num (both sides): the
        # disconnect fan-out path from a dying peer to its tenants
        self.endpoints: dict[int, FabricEndpoint] = {}
        # failure domain: gids taken down by kill_node, and kills a
        # FaultModel trigger armed mid-dispatch (executed post-pass)
        self.dead_gids: set[str] = set()
        self._pending_kills: list[str] = []
        self.disconnects = 0
        self.nodes_killed = 0
        self.intra_pod_hops = 0
        # fabric-scope shared recv pool (lazy)
        self._srq: SharedReceiveQueue | None = None
        self.srq_max_wr = srq_max_wr
        self.srq_limit = srq_limit
        # RNR policy. The counters live on the QPs (single-source):
        # `_rnr_sources` captures each attached QP's registry Counter
        # objects by qp_num, so the fabric's summed views below survive
        # a qp.destroy() — a torn-down connection's retries stay counted.
        self.rnr_retry = rnr_retry
        self.rnr_timeout = rnr_timeout
        self.on_rnr_backoff = on_rnr_backoff
        self._rnr_sources: dict[int, tuple] = {}
        # lossy-link policy: transport retry budget for dropped packets
        # (ibverbs retry_cnt, 0..7 — always finite) and the FaultModel
        # supplying the schedule (None = the lossless wire)
        self.retry_cnt = retry_cnt
        if faults is not None:
            self.install_faults(faults)
        # DCQCN-flavored per-route rate control (opt-in)
        self.ratectl: RateController | None = None
        if rate_control:
            self.enable_rate_control(
                **(rate_control if isinstance(rate_control, dict) else {}))

    # -- fault / congestion policy -------------------------------------------
    def install_faults(self, fm) -> "Fabric":
        """Install a `FaultModel` as this fabric's link layer: its scope
        re-homes under the fabric (``fabric{k}/faults{i}/...``) and every
        attached QP gets a stable flow id (attach order — NOT qp_num, so
        schedules reproduce across runs). Install at construction: WRs
        posted before the model was installed carry no packet sequence
        numbers."""
        self.faults = fm
        metrics.scope_of(fm).reparent(metrics.scope_of(self))
        for qpn in self.qps:
            fm.register(qpn)
        return self

    def enable_rate_control(self, **knobs) -> RateController:
        """Attach the DCQCN-flavored `RateController` (verbs/ratectl.py);
        knobs are its constructor's (line_rate, ecn_watermark, ...)."""
        self.ratectl = RateController(self, **knobs)
        return self.ratectl

    # -- telemetry -----------------------------------------------------------
    def attach(self, qp: QueuePair) -> QueuePair:
        """MeshTransport.attach + telemetry adoption: the QP's metric
        scope re-homes under this fabric (``fabric{k}/qp{n}/...``) and
        its RNR counters are captured for the fabric's summed views."""
        super().attach(qp)
        sc = metrics.scope_of(qp)
        sc.reparent(metrics.scope_of(self))
        self._rnr_sources[qp.qp_num] = tuple(
            sc.counter(leaf) for leaf in
            ("rnr_retries", "rnr_exhausted", "rnr_backoff_units"))
        if self.faults is not None:
            self.faults.register(qp.qp_num)
        return qp

    # One registry counter, two views (the RNR dedup): these sums read
    # the SAME Counter objects `qp.rnr_retries += 1` writes.
    @property
    def rnr_retries(self) -> int:
        return sum(t[0].value for t in self._rnr_sources.values())

    @property
    def rnr_exhausted(self) -> int:
        return sum(t[1].value for t in self._rnr_sources.values())

    @property
    def rnr_backoff_units(self) -> int:
        return sum(t[2].value for t in self._rnr_sources.values())

    @property
    def mesh(self):
        """The `pod` x `device` grid of CUDA devices — built LAZILY on
        first access (pure routing never touches device state): None on
        rigs without pods*devices cards, where addressing stays
        identical and routing is logical-only."""
        if not self._mesh_built:
            self._mesh = make_fabric_mesh(self.pods, self.devices_per_pod)
            self._mesh_built = True
        return self._mesh

    # -- control plane -------------------------------------------------------
    def node(self, gid: str,
             pd: ProtectionDomain | None = None) -> ConnectionManager:
        """The node's connection manager (created on first use)."""
        cm = self.nodes.get(gid)
        if cm is None:
            cm = self.nodes[gid] = ConnectionManager(self, gid, pd)
        return cm

    def connect(self, addr, *, src_gid: str | None = None,
                **opts) -> FabricEndpoint:
        """``fabric.connect(addr)``: connect from `src_gid` (default the
        grid's first node) — the one-call client bring-up."""
        return self.node(src_gid or self.gids[0]).connect(addr, **opts)

    def register_qp(self, qp: QueuePair, gid: str) -> FabricAddress:
        """Give an existing RESET QP a fabric address so a CM can
        ``connect`` to it directly (addressed-QP connect)."""
        if qp.transport is not None and qp.transport is not self:
            raise QPStateError(
                f"QP {qp.qp_num} is already attached to a different "
                "transport")
        if gid not in self.gids:
            raise QPStateError(f"gid {gid!r} is not on this fabric")
        self._register(qp, gid)
        return FabricAddress(gid, qp.qp_num)

    def _register(self, qp: QueuePair, gid: str):
        self.attach(qp)
        self.gid_of[qp.qp_num] = gid

    def _accept(self, addr: FabricAddress):
        """Server side of a connect: mint a QP under the listener at
        `addr`, or adopt a bare addressed QP still in RESET."""
        lst = self._listeners.get(addr.qpn)
        if lst is not None:
            vec = self.vectorized
            sqp = QueuePair(
                lst.cm.pd,
                CompletionQueue(lst.depth, lst.publish_every, vec,
                                device_ring=lst.device_ring,
                                torch_device=self.device),
                lst.recv_cq, max_send_wr=lst.max_wr,
                max_recv_wr=lst.max_wr, srq=lst.srq,
                flow_control=lst.flow_control, vectorized=vec)
            self._register(sqp, addr.gid)
            return FabricEndpoint(self, sqp, addr.gid, listener=lst), lst
        qp = self.qps.get(addr.qpn)
        if qp is None or self.gid_of.get(addr.qpn) != addr.gid:
            raise QPStateError(f"nothing listening at {addr}")
        if qp.state != QPState.RESET:
            raise QPStateError(
                f"QP {addr.qpn} at {addr.gid} is {qp.state.name}, "
                "not RESET — already connected?")
        return FabricEndpoint(self, qp, addr.gid), None

    def disconnect(self, ep: FabricEndpoint):
        """rdma_disconnect: tear down BOTH sides of a connection and drop
        every fabric registration it holds (routes, gids, transport
        attachment, SRQ membership, listener accept list, T4 contexts) —
        a long-lived fabric must not accumulate state from short-lived
        connections (one KVTransferEngine per transfer, say). The PASSIVE
        side observes a DISCONNECTED event (rdma-cm semantics): its
        disconnect callbacks fire; the initiator asked, so its don't."""
        for side in (ep, ep.peer):
            if side is None:
                continue
            self.routes.pop(side.qp.qp_num, None)
            self.gid_of.pop(side.qp.qp_num, None)
            self.endpoints.pop(side.qp.qp_num, None)
            if side.listener is not None and \
                    side in side.listener.accepted:
                side.listener.accepted.remove(side)
            side.qp.destroy()       # ERR-flush + transport/SRQ/ctx release
        if ep.peer is not None:
            self._fire_disconnect(ep.peer)
        return self

    # -- failure domain ------------------------------------------------------
    def alive(self, gid: str) -> bool:
        return gid in self.gids and gid not in self.dead_gids

    def _fire_disconnect(self, ep: FabricEndpoint | None):
        """Fan one connection's disconnect event out to every registered
        observer: the endpoint's own hook, its listener's, and the
        CM-level callbacks of the surviving node."""
        self.disconnects += 1
        if ep is None:
            return
        cbs: list[Callable] = []
        if ep.on_disconnect is not None:
            cbs.append(ep.on_disconnect)
        if ep.listener is not None and \
                ep.listener.on_disconnect is not None:
            cbs.append(ep.listener.on_disconnect)
        cm = self.nodes.get(ep.gid)
        if cm is not None:
            cbs.extend(cm._disconnect_cbs)
        for cb in cbs:
            cb(ep)

    def kill_node(self, gid: str) -> "Fabric":
        """Simulate the death of one fabric node (a pod device): its
        listeners close, its QPs are destroyed, and every SURVIVOR
        routed at it transitions to ERR — in-flight WRs drain as
        ``IBV_WC_WR_FLUSH_ERR`` completions — with disconnect events
        fanned out so tenants re-resolve instead of timing out. Safe to
        call mid-flush only via the FaultModel kill trigger (which defers
        to `_run_pending_kills` after the dispatch pass)."""
        if gid not in self.gids:
            raise QPStateError(f"gid {gid!r} is not on this fabric")
        if gid in self.dead_gids:
            return self
        self.dead_gids.add(gid)
        self.nodes_killed += 1
        # listeners at the dead gid close: resolve()/connect() now find
        # only survivors
        for qpn, lst in list(self._listeners.items()):
            if lst.addr.gid == gid:
                self.unlisten(lst.addr)
        # the node's own QPs die with it (no CQEs escape a dead node)
        for qpn, g in list(self.gid_of.items()):
            if g != gid:
                continue
            qp = self.qps.get(qpn)
            self.routes.pop(qpn, None)
            self.endpoints.pop(qpn, None)
            self.gid_of.pop(qpn, None)
            if qp is not None:
                qp.destroy()
        # survivors routed INTO the dead node observe peer death: the
        # route drops, in-flight WRs flush with WR_FLUSH_ERR, and the
        # disconnect event reaches the tenant
        for qpn, route in list(self.routes.items()):
            if route.gid != gid:
                continue
            self.routes.pop(qpn, None)
            sqp = self.qps.get(qpn)
            if sqp is not None and sqp.state == QPState.RTS:
                sqp.modify(QPState.ERR)     # WRs drain as WR_FLUSH_ERR
            self._fire_disconnect(self.endpoints.pop(qpn, None))
        return self

    def kill_pod(self, pod: str) -> "Fabric":
        """Kill every device of one pod (``kill_pod("pod1")``)."""
        for gid in [g for g in self.gids
                    if g.split("/", 1)[0] == pod and g not in
                    self.dead_gids]:
            self.kill_node(gid)
        return self

    def _run_pending_kills(self):
        """Execute kills a FaultModel trigger armed during the dispatch
        pass: the trigger only marks the packet's WR as kill-stalled
        (dispatch must not tear down QPs it is iterating), the node
        actually dies here, between passes."""
        while self._pending_kills:
            self.kill_node(self._pending_kills.pop(0))

    def unlisten(self, addr) -> "Fabric":
        """Close a listener: new connects to its address are refused
        (existing connections live until `disconnect`)."""
        addr = as_address(addr)
        lst = self._listeners.pop(addr.qpn, None)
        if lst is not None and lst.service is not None:
            self._services.pop(lst.service, None)
        return self

    def discover(self, prefix: str = "") -> dict[str, FabricAddress]:
        """Service discovery for front-end routers: every LIVE named
        listener whose service name starts with `prefix`, as
        ``{service: address}``. A listener at a dead gid (or already
        unlistened) is not offered — re-running discover after a
        `kill_node` is how a router re-resolves its backend set."""
        out: dict[str, FabricAddress] = {}
        for service, addr in sorted(self._services.items()):
            if not service.startswith(prefix):
                continue
            if addr.qpn in self._listeners and self.alive(addr.gid):
                out[service] = addr
        return out

    # -- fabric-scope SRQ ----------------------------------------------------
    def shared_srq(self, max_wr: int | None = None,
                   srq_limit: int | None = None) -> SharedReceiveQueue:
        """THE fabric recv pool (one per fabric, created on first use):
        every ``srq="fabric"`` listener's QPs draw from it and one
        watermark serves every tenant."""
        if self._srq is None:
            self._srq = SharedReceiveQueue(
                max_wr or self.srq_max_wr,
                srq_limit=self.srq_limit if srq_limit is None
                else srq_limit)
        else:
            if max_wr is not None and max_wr > self._srq.max_wr:
                self._srq.max_wr = max_wr      # grow for a new tenant
            if srq_limit:
                self._srq.arm(srq_limit)
        return self._srq

    @property
    def srq(self) -> SharedReceiveQueue | None:
        return self._srq

    def on_srq_limit(self, cb: Callable[[SharedReceiveQueue], None]):
        """Register a tenant refill doorbell on the fabric pool's single
        watermark event."""
        self.shared_srq().add_on_limit(cb)
        return self

    # -- data plane ----------------------------------------------------------
    def _peer(self, qp: QueuePair) -> QueuePair:
        route = self.routes.get(qp.qp_num)
        if route is not None:
            peer = self.qps.get(route.qpn)
            if peer is None or self.gid_of.get(route.qpn) != route.gid:
                raise QPStateError(
                    f"QP {qp.qp_num}'s route to {route} is stale "
                    "(peer destroyed?)")
            return peer
        return super()._peer(qp)

    def device_of(self, gid: str):
        """The CUDA device at a gid when the grid is physically backed
        (pods*devices_per_pod == torch.cuda.device_count()); None on the
        logical-routing rig."""
        mesh = self.mesh
        if mesh is None:
            return None
        pod, dev = gid.split("/", 1)
        return mesh[int(pod[3:])][int(dev[3:])]

    def _device_hop(self, dst_gid: str, payload):
        """Intra-pod cross-DEVICE hop (devices_per_pod > 1): the payload
        is materialized at the destination device instead of moving by
        python reference. On a physically-backed grid that is a copy
        onto the gid's card (the NVLink hop); on the logical rig a copy
        on the tensor's own device stands in (the reference goes through
        host memory there; the port keeps the copy on the device) —
        either way the delivered tree no longer aliases the sender's
        buffers, which is what makes per-device routing testable."""
        dev = self.device_of(dst_gid)

        def hop(x):
            if isinstance(x, np.ndarray):
                return x.copy()
            if isinstance(x, torch.Tensor):
                if dev is not None:
                    return x.to(dev, copy=True)
                return x.clone()
            return x
        return tree.map(hop, payload)

    def _lower_payload(self, qp: QueuePair, wr: SendWR, payload):
        """The wire follows the route: cross-POD payload trees ride the
        T1 striped wire (packet spraying, MeshTransport's lowering),
        intra-pod cross-device hops materialize on the destination
        device (`_device_hop`), and same-gid loopback moves by
        reference. Lowering is per-WR even when the extraction was the
        fused MR-run gather (`_fused_mr_rows`)."""
        route = self.routes.get(qp.qp_num)
        src_gid = self.gid_of.get(qp.qp_num)
        if route is None or src_gid is None or route.gid == src_gid:
            return payload
        if route.pod == src_gid.split("/", 1)[0]:
            self.intra_pod_hops += 1
            return self._device_hop(route.gid, payload)
        return super()._lower_payload(qp, wr, payload)

    def flush(self, *endpoints) -> int:
        """ONE dispatch pass over many endpoints (the multi-destination
        chain case): per-(dst_ctx, opcode) run fusion and one CQE
        publish per CQ, across every endpoint's chain."""
        return self.process_many([ep.qp if isinstance(ep, FabricEndpoint)
                                  else ep for ep in endpoints])

    def process_many(self, qps: list[QueuePair]) -> int:
        rc = self.ratectl
        if rc is None:
            processed = super().process_many(qps)
            for qp in qps:
                processed += self._police(qp)
            self._run_pending_kills()
            return processed
        # rate-controlled: drain in paced rounds. Each round throttles
        # every routed send queue to its route's current allowance,
        # dispatches + polices, hands the stashed tail back, and ticks
        # the controller (ECN observation + rate adaptation). Rounds
        # repeat until the stash drains — one flush still delivers
        # everything posted, the rate shapes how it drains.
        total = 0
        try:
            while True:
                stashed = rc.throttle(qps)
                n = super().process_many(qps)
                for qp in qps:
                    n += self._police(qp)
                self._run_pending_kills()
                rc.restore()
                rc.tick(qps)
                total += n
                if stashed == 0 or n == 0:
                    break           # drained, or wedged (RNR/fault stall)
        finally:
            rc.restore()            # a mid-dispatch raise must not leak WRs
        return total

    def _police(self, qp: QueuePair) -> int:
        """The transport's retry schedules, run to completion inside this
        flush. Two stall families share the loop:

        * **RNR** (receiver not ready, ``fault_stall is None``): ibverbs
          rnr_retry — each iteration models one RNR timeout firing
          (backoff counted, `on_rnr_backoff` invoked unless the
          FaultModel dropped the NAK, queue re-dispatched); a head still
          stalled past the budget retires IBV_WC_RNR_ERR. rnr_retry == 7
          (the ibverbs sentinel) retries forever — the stall-in-place
          behavior every non-fabric transport keeps.
        * **link faults** (a FaultModel refused the packet): a *dropped*
          packet spends one unit of the ``retry_cnt`` transport budget
          and retransmits; budget exhausted retires the WR with
          IBV_WC_RETRY_EXC_ERR. A *delayed* packet retransmits without
          touching any budget (capped by MAX_FAULT_TICKS per flush). A
          *kill*-stalled head stays queued — `_run_pending_kills` is
          about to flush the whole QP as WR_FLUSH_ERR.

        Error CQEs batch per status run (one encode + one ring produce)
        and always publish BEFORE a re-dispatch so completion order
        matches the oracle's."""
        if self.faults is None and \
                self.rnr_retry >= self.RNR_RETRY_INFINITE:
            return 0
        extra = 0
        fault_ticks = 0
        err_ops: list[int] = []
        err_ids: list[int] = []
        err_sts: list[int] = []

        def publish_errs():
            if not err_ops:
                return
            if not qp.send_cq.destroyed:
                qp.send_cq.push_batch(wqe.encode_cqe_batch(
                    err_ops, err_ids, list(err_sts), 0))
                try:
                    qp.send_cq.flush()
                except CQOverrunError:
                    pass            # staged; republishes on next poll
            err_ops.clear()
            err_ids.clear()
            err_sts.clear()

        def retire(head, status):
            qp.sq.popleft()
            qp._fc_retire(head)
            err_ops.append(head.wr.opcode)
            err_ids.append(head.wr.wr_id)
            err_sts.append(status)

        while qp.sq:
            head = qp.sq[0]
            if head.wr.opcode != wqe.IBV_WR_SEND:
                break               # only SENDs stall
            stall = head.fault_stall
            if stall == "kill":
                break               # the pending node kill flushes the QP
            if stall in ("drop", "delay"):
                if stall == "drop" and head.wire_tries >= self.retry_cnt:
                    # transport retries exhausted on a lossy link
                    retire(head, wqe.IBV_WC_RETRY_EXC_ERR)
                    self.faults.retry_exhausted += 1
                    extra += 1
                    if qp.sq:
                        # the WRs behind the dead head were never
                        # attempted: give them a fresh dispatch so their
                        # stall cause (if any) is recorded, not inherited
                        publish_errs()
                        extra += super().process_many([qp])
                    continue
                if fault_ticks >= self.MAX_FAULT_TICKS:
                    break           # pathological schedule: next flush
                fault_ticks += 1
                head.fault_stall = None
                if stall == "drop":
                    head.wire_tries += 1    # retransmission spends budget
                publish_errs()      # keep CQE order ahead of a re-dispatch
                extra += super().process_many([qp])
                continue
            # RNR stall (receiver not ready)
            if self.rnr_retry >= self.RNR_RETRY_INFINITE:
                break
            if head.rnr_tries < self.rnr_retry:
                publish_errs()      # keep CQE order ahead of a re-dispatch
                head.rnr_tries += 1
                qp.rnr_retries += 1     # fabric.rnr_retries sums this
                # exponential timeout backoff, in rnr_timeout units
                qp.rnr_backoff_units += \
                    self.rnr_timeout << (head.rnr_tries - 1)
                heard = True
                if self.faults is not None and \
                        self.faults.drop_rnr_nak(qp, head):
                    # the NAK was lost: the sender's timeout still fires
                    # (retry accounting above is unchanged) but the
                    # receiver-side hook never hears about it
                    heard = False
                if heard and self.on_rnr_backoff is not None:
                    # the timeout hook: tests/benches refill the peer
                    # pool here to model a receiver catching up
                    self.on_rnr_backoff(qp, head.rnr_tries)
                extra += super().process_many([qp])
                continue
            # retry budget exhausted: complete the WR with RNR_ERR
            retire(head, wqe.IBV_WC_RNR_ERR)
            qp.rnr_exhausted += 1   # fabric.rnr_exhausted sums this
            extra += 1
            if qp.sq and qp.sq[0].wr.opcode != wqe.IBV_WR_SEND:
                # a dispatchable (non-SEND) chain was blocked behind the
                # exhausted head: run it in THIS flush, not the next one
                # (stalled-SEND heads instead fall through to the retry
                # branch above, which re-dispatches anyway)
                publish_errs()
                extra += super().process_many([qp])
        publish_errs()
        return extra
