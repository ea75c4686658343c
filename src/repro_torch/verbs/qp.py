"""Queue pairs: the RC state machine and the send/recv work queues.

A `QueuePair` is created on a `ProtectionDomain` and walks the standard
RC ladder RESET -> INIT -> RTR -> RTS (`modify`); posting rules follow
ibverbs: `post_recv` needs INIT or later, `post_send` needs RTS, and the
transport refuses to deliver into a QP that has not reached RTR.

Each QP owns a T4 `QPContext` on its pd's offload engine — one-sided
verbs are lowered onto `submit_dma`, so everything a processing pass
queues against one QP coalesces through `QPContext._flush` (the batched
DMA win; Fig. 16b).
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.convert import to_host
from repro_torch.core.offload_engine import QPContext
from repro_torch.kernels.wr_scatter.ops import records_in
from repro_torch.obs import metrics, trace
from repro_torch.verbs import wqe
from repro_torch.verbs.cq import CQOverrunError
from repro_torch.verbs.pd import MemoryRegion, ProtectionDomain


class QPState(enum.IntEnum):
    RESET = 0
    INIT = 1
    RTR = 2       # ready to receive
    RTS = 3       # ready to send
    ERR = 4


_LEGAL = {
    QPState.RESET: {QPState.INIT},
    QPState.INIT: {QPState.RTR, QPState.RESET},
    QPState.RTR: {QPState.RTS, QPState.RESET},
    QPState.RTS: {QPState.RESET, QPState.ERR},
    QPState.ERR: {QPState.RESET},
}


class QPStateError(RuntimeError):
    pass


class ENOMEMError(RuntimeError):
    """ibv_post_send's ENOMEM: posting would overrun the peer's CQ
    credit. Backpressure, not corruption — poll the CQs and retry."""


def _flat_inlinable(payload) -> bool:
    """True when the payload survives the inline flat-bytes roundtrip
    unchanged: a plain <=1-D array of a real scalar dtype. Lists are
    rejected even when rectangular (the roundtrip returns an ndarray,
    not a list), as are object/structured dtypes (a ragged list becomes
    an object-dtype 1-D array that passes the ndim check but cannot be
    reconstructed from flat bytes). A tensor moves by reference: packing
    it inline would need a device->host copy per WR."""
    if payload is None or isinstance(payload,
                                      (dict, tuple, list, torch.Tensor)):
        return False
    try:
        arr = np.asarray(payload)
    except Exception:
        return False
    return arr.ndim <= 1 and arr.dtype.kind not in "OV"


@dataclass
class SendWR:
    """One send work request.

    opcode      IBV_WR_SEND / IBV_WR_RDMA_WRITE / IBV_WR_RDMA_READ, or any
                custom opcode registered with the remote offload engine.
    payload     by-value payload (SEND / RDMA_WRITE / custom); any object
                moves as-is by reference on the loopback transport. May be
                a tree of tensors for mesh-transport SENDs (spec_tree then
                lowers it onto the TX engine's wire).
    mr/offsets  local MR + record offsets: SEND/WRITE source when payload
                is None, RDMA_READ landing zone when given.
    remote_key  rkey of the remote MR (one-sided ops only).
    remote_offsets  record offsets into the remote MR.
    inline      force/deny inlining; None = auto (inline iff <= 64B).
    """
    wr_id: int = 0
    opcode: int = wqe.IBV_WR_SEND
    payload: Any = None
    mr: MemoryRegion | None = None
    offsets: Any = None
    remote_key: int = 0
    remote_offsets: Any = None
    inline: bool | None = None
    signaled: bool = True
    spec_tree: Any = None


@dataclass
class RecvWR:
    """A receive buffer posting: SENDs land in mr[offsets] when an MR is
    given, otherwise the payload is delivered in the CQE sideband."""
    wr_id: int = 0
    mr: MemoryRegion | None = None
    offsets: Any = None


def check_recv(wr: RecvWR):
    """Refuse, at post_recv, a recv WR whose integer offsets name a
    record outside its MR: a SEND landing there could only fail at
    flush time, and the claim handed back to the pool would then fail
    every later SEND too. The reference accepts it and drops the
    landing row."""
    if wr.mr is None or wr.offsets is None:
        return
    offs = np.asarray(to_host(wr.offsets))
    if offs.dtype.kind in "iu" and not records_in(offs, wr.mr.n_records):
        raise IndexError(f"recv WR {wr.wr_id}: offsets outside MR "
                         f"{wr.mr.name!r} of {wr.mr.n_records} records")


@dataclass(slots=True)
class _PostedSend:
    desc: np.ndarray
    wr: SendWR
    inline_row: np.ndarray | None = None
    inline_nbytes: int = 0
    inline_dtype: int = 0
    # chain-pack provenance: (block, j) when the inline row is row j of a
    # pack_inline_batch block — a whole run whose rows are consecutive in
    # ONE block is delivered with one batched unpack (zero-copy slices).
    # Chain-built WRs carry ONLY this (inline_row stays None; the row is
    # block[j], sliced lazily if a scalar delivery ever needs it).
    inline_src: tuple | None = None
    # CQs holding a flow-control slot reservation for this WR (claimed at
    # post time, released when the WR retires and its CQE occupies the
    # slot for real)
    fc_peer_cq: Any = None
    fc_self_cq: Any = None
    # RNR-stall retries consumed so far (fabric transports with a finite
    # rnr_retry budget retire the WR with IBV_WC_RNR_ERR when exhausted)
    rnr_tries: int = 0
    # lossy-link state (fabrics with a FaultModel installed; see
    # verbs/faults.py). `psn` is the per-QP packet sequence number stamped
    # at post time, `wire_attempts` counts admission consults — together
    # they make every fault verdict a pure function of the packet
    # identity. `fault_stall` records why the head WR last stalled
    # ("drop" / "delay" / "kill", None = receiver-not-ready) and
    # `wire_tries` is the transport retry budget already spent on drops.
    psn: int = 0
    wire_attempts: int = 0
    wire_tries: int = 0
    fault_stall: str | None = None


class QueuePair:
    _next_qp_num = 1

    # registry-backed telemetry (repro_torch.obs): `self.x += 1` call
    # sites and benchmark reads are unchanged, but the values live under
    # this QP's scope (`qp{n}/...`, re-homed to `fabric{k}/qp{n}/...` on
    # attach to a fabric)
    doorbell_writes = metrics.counter_attr()
    desc_fetch_dmas = metrics.counter_attr()
    rnr_retries = metrics.counter_attr()
    rnr_exhausted = metrics.counter_attr()
    rnr_backoff_units = metrics.counter_attr()

    def __init__(self, pd: ProtectionDomain, send_cq, recv_cq=None, *,
                 max_send_wr: int = 256, max_recv_wr: int = 256,
                 srq=None, flow_control: bool = False,
                 vectorized: bool = True):
        self.pd = pd
        # batch-wise WQE building + write-coalescing T4 flushes; False is
        # the element-at-a-time oracle
        self.vectorized = vectorized
        self.send_cq = send_cq
        self.recv_cq = recv_cq if recv_cq is not None else send_cq
        self.max_send_wr = max_send_wr
        self.max_recv_wr = max_recv_wr
        self.qp_num = QueuePair._next_qp_num
        QueuePair._next_qp_num += 1
        # registry scope FIRST: every metric-backed attribute below
        # resolves through it (qp_num is naturally unique -> no index)
        metrics.instance_scope(self, f"qp{self.qp_num}")
        self.state = QPState.RESET
        self.dest_qp_num: int | None = None
        self.sq: deque[_PostedSend] = deque()
        self.rq: deque[RecvWR] = deque()
        self.transport = None
        # shared recv pool: when set, this QP's recv side IS the SRQ
        self.srq = srq
        if srq is not None:
            srq.attach(self)
        # credit-based flow control: outstanding WRs are charged against
        # the peer recv CQ's / own send CQ's free slots (see post_send)
        self.flow_control = flow_control
        # doorbell accounting (paper Fig. 15): one doorbell write + one
        # WQE-chain fetch DMA per post_send CALL, however many WRs ride it
        self.doorbell_writes = 0
        self.desc_fetch_dmas = 0
        # RNR accounting (fabric transports): timeout-backoff retries
        # consumed, backoff units slept, and WRs retired IBV_WC_RNR_ERR
        # after retry exhaustion. These are THE counters — the Fabric's
        # same-named attributes are read-only sums over its QPs.
        self.rnr_retries = 0
        self.rnr_exhausted = 0
        self.rnr_backoff_units = 0
        # per-QP packet sequence, stamped onto posted WRs when the
        # transport carries a FaultModel (verbs/faults.py): the psn is
        # half of the packet identity fault verdicts hash over
        self._psn = 0
        # the T4 context every one-sided op against this QP coalesces in
        # (bound into the engine so handle_packet dispatches into it too)
        self.ctx = pd.engine.bind_context(
            self.qp_num, QPContext(self.qp_num, pd.engine,
                                   coalesce_writes=vectorized))
        # QPContext is a plain dataclass: surface its DMA-launch count as
        # a sampled probe (weak — the registry must not pin a torn-down
        # context's buffers)
        metrics.weak_probe(self._metrics, "dma_launches", self.ctx,
                           lambda c: c.dma_launches, kind="counter")

    # -- state machine ------------------------------------------------------
    def modify(self, state: QPState, *, dest_qp_num: int | None = None):
        """ibv_modify_qp: enforce the RC ladder; RTR pins the peer."""
        state = QPState(state)
        if state not in _LEGAL[self.state]:
            raise QPStateError(f"illegal transition {self.state.name} -> "
                               f"{state.name}")
        if state == QPState.RTR:
            if dest_qp_num is None:
                raise QPStateError("RTR requires dest_qp_num")
            self.dest_qp_num = dest_qp_num
        if state == QPState.ERR:
            self._flush_err()           # ibverbs: ERR flushes posted WRs
        if state == QPState.RESET:
            for ps in self.sq:          # hand reserved CQ credit back
                self._fc_retire(ps)
            self.sq.clear()
            self.rq.clear()
            self.dest_qp_num = None
        self.state = state
        return self

    def _flush_err(self):
        """Retire every posted WR with an IBV_WC_WR_FLUSH_ERR completion
        (send WRs to the send CQ, un-matched recv WRs to the recv CQ) so
        a mid-flight reset/destroy leaks neither WRs nor CQ sideband.

        Teardown is batch-wise like the datapath: the FLUSH_ERR CQEs for
        one CQ are encoded in ONE `encode_cqe_batch` and published with
        ONE ring produce, not one per orphaned WR."""
        groups: dict[int, tuple] = {}   # id(cq) -> (cq, opcodes, wr_ids)

        def stage(cq, opcode, wr_id):
            if cq.destroyed:             # nobody left to notify
                return
            g = groups.get(id(cq))
            if g is None:
                g = groups[id(cq)] = (cq, [], [])
            g[1].append(opcode)
            g[2].append(wr_id)

        for ps in self.sq:
            self._fc_retire(ps)
            stage(self.send_cq, ps.wr.opcode, ps.wr.wr_id)
        for rwr in self.rq:
            stage(self.recv_cq, wqe.IBV_WC_RECV, rwr.wr_id)
        self.sq.clear()
        self.rq.clear()
        for cq, ops, ids in groups.values():
            cq.push_batch(wqe.encode_cqe_batch(
                ops, ids, wqe.IBV_WC_WR_FLUSH_ERR, 0))
            try:
                cq.flush()
            except CQOverrunError:
                # the consumer is behind (ring full): the FLUSH_ERR CQEs
                # are safely staged and republish on its next poll_cq —
                # teardown itself must not fail
                pass

    def destroy(self):
        """ibv_destroy_qp: ERR-flush outstanding WRs, detach from the
        transport/SRQ, release the T4 context. The CQs stay alive (they
        may serve other QPs) — reclaiming a CQ wholesale is
        `CompletionQueue.destroy`."""
        if self.state != QPState.RESET:
            self._flush_err()
        if self.srq is not None and self in self.srq.qps:
            self.srq.qps.remove(self)
        if self.transport is not None:
            self.transport.qps.pop(self.qp_num, None)
            self.transport = None
        probe = self._metrics.metrics.get("dma_launches")
        if probe is not None:
            probe.read()        # freeze the final count before teardown
        self.pd.engine.unbind_context(self.qp_num)
        self.state = QPState.ERR
        return self

    # -- posting ------------------------------------------------------------
    def post_recv(self, wr: RecvWR):
        if self.srq is not None:
            raise QPStateError(
                f"QP {self.qp_num} uses an SRQ; post_recv on the SRQ")
        if self.state < QPState.INIT or self.state == QPState.ERR:
            raise QPStateError(f"post_recv in {self.state.name}")
        if len(self.rq) >= self.max_recv_wr:
            raise QPStateError("recv queue full")
        check_recv(wr)
        self.rq.append(wr)
        return self

    def post_send(self, wr: SendWR | list[SendWR]):
        """Post one WR, or a LIST of WRs staged as a single WQE chain and
        rung with one doorbell: the transport fetches the whole chain in
        one descriptor DMA, so N-WR lists cost 1/N the doorbell traffic
        of N single posts (the batched-doorbell win, Fig. 15)."""
        chain = wr if isinstance(wr, list) else [wr]
        if not chain:
            return self
        tr = trace.TRACER
        t0 = tr.now() if tr is not None else 0
        if self.state != QPState.RTS:
            raise QPStateError(f"post_send in {self.state.name} "
                               "(need RTS)")
        if len(self.sq) + len(chain) > self.max_send_wr:
            raise QPStateError("send queue full")
        if self.vectorized and len(chain) > 1:
            posted = self._build_wqe_chain(chain)
        else:
            posted = [self._build_wqe(w) for w in chain]
        if self.flow_control:
            self._fc_admit(posted)
        tp = self.transport
        if tp is not None and tp.faults is not None:
            # lossy link: stamp packet sequence numbers so fault verdicts
            # are a pure function of packet identity (see verbs/faults.py)
            psn = self._psn
            for k, ps in enumerate(posted):
                ps.psn = psn + k
            self._psn = psn + len(posted)
        self.sq.extend(posted)
        self.doorbell_writes += 1
        self.desc_fetch_dmas += 1       # whole chain rides one fetch DMA
        if tr is not None:
            tr.complete("post_send", t0, qp=self.qp_num, wrs=len(chain))
            tr.instant("doorbell", qp=self.qp_num, wrs=len(chain))
        return self

    # -- flow control --------------------------------------------------------
    def _fc_admit(self, posted: list[_PostedSend]):
        """Charge the chain against CQ credit before it is queued: each
        SEND reserves a slot on the peer's recv CQ, each signaled WR one
        on our send CQ. Reservations live on the CQ itself
        (`CompletionQueue.fc_reserved`) so MANY sender QPs feeding one CQ
        share one credit pool — per-sender counters would let two tenants
        jointly over-claim it. The receiver's poll_cq frees slots and
        thereby replenishes every sender (ENOMEM now instead of a
        CQOverrunError later)."""
        peer = None
        if self.transport is not None and self.dest_qp_num is not None:
            peer = self.transport.qps.get(self.dest_qp_num)
        claims: list = []               # CQs charged so far (for rollback)
        try:
            for ps in posted:
                if ps.wr.opcode == wqe.IBV_WR_SEND and peer is not None:
                    peer.recv_cq.fc_reserve("peer recv")
                    ps.fc_peer_cq = peer.recv_cq
                    claims.append(peer.recv_cq)
                if ps.wr.signaled:
                    self.send_cq.fc_reserve("send")
                    ps.fc_self_cq = self.send_cq
                    claims.append(self.send_cq)
        except ENOMEMError:
            for cq in claims:           # all-or-nothing chain admission
                cq.fc_release()
            for ps in posted:
                ps.fc_peer_cq = ps.fc_self_cq = None
            raise

    @staticmethod
    def _fc_retire(ps: _PostedSend):
        """A WR left the send queue: its CQE now occupies the CQ for real
        (counted by occupancy), so the reservation is released."""
        if ps.fc_peer_cq is not None:
            ps.fc_peer_cq.fc_release()
            ps.fc_peer_cq = None
        if ps.fc_self_cq is not None:
            ps.fc_self_cq.fc_release()
            ps.fc_self_cq = None

    def _wqe_fields(self, wr: SendWR):
        """Per-WR descriptor fields + inline packing (everything that is
        inherently payload-dependent python). The descriptor encode
        itself happens in `encode_wqe` (scalar) or `encode_wqe_batch`
        (one call per chain)."""
        if wr.opcode == wqe.IBV_WR_RDMA_WRITE and wr.payload is None \
                and wr.mr is None:
            # reject at post time: a source-less WRITE failing mid-
            # dispatch would wedge the head of the send queue
            raise ValueError("RDMA_WRITE needs a payload or a source MR")
        flags = wqe.WQE_F_SIGNALED if wr.signaled else 0
        if wqe.is_custom(wr.opcode):
            flags |= wqe.WQE_F_CUSTOM
        inline_row, nbytes, dcode, length, roff = None, 0, 0, 0, 0
        if wr.opcode == wqe.IBV_WR_SEND and wr.mr is None:
            # inline delivery is a flat byte copy (shape is not wire
            # metadata), so auto-inline only payloads whose 1-D roundtrip
            # is exact; inline=True forces it and documents the flatten
            want = wr.inline is True or (
                wr.inline is None and _flat_inlinable(wr.payload))
            if want:
                try:
                    inline_row, nbytes, dcode = wqe.pack_inline(wr.payload)
                    flags |= wqe.WQE_F_INLINE
                    length = nbytes
                except (ValueError, TypeError):
                    if wr.inline is True:
                        raise
        if wr.remote_offsets is not None:
            offs = np.asarray(wr.remote_offsets)
            length = int(offs.size)
            roff = int(offs.ravel()[0])
        return (wr.mr.lkey if wr.mr else 0, roff, length, flags, dcode,
                inline_row, nbytes)

    def _build_wqe(self, wr: SendWR) -> _PostedSend:
        lkey, roff, length, flags, dcode, inline_row, nbytes = \
            self._wqe_fields(wr)
        desc = wqe.encode_wqe(
            wr.opcode, wr_id=wr.wr_id, rkey=wr.remote_key, lkey=lkey,
            remote_offset=roff, length=length, flags=flags,
            dtype_code=dcode)
        return _PostedSend(desc, wr, inline_row, nbytes, dcode)

    def _build_wqe_chain(self, chain: list[SendWR]) -> list[_PostedSend]:
        """Stage an N-WR chain with ONE descriptor-block encode and ONE
        batched inline pack: the per-WR python is plain attribute
        traversal; byte packing and the descriptor encode are each a
        single array pass (`pack_inline_batch` / `encode_wqe_batch`).
        Field-for-field this mirrors the scalar `_wqe_fields` — the
        bit-exactness property tests hold the two together."""
        n = len(chain)
        lkeys = [0] * n
        roffs = [0] * n
        lengths = [0] * n
        flagv = [0] * n
        dcodes = [0] * n
        inline_meta: list = [None] * n      # i -> (block, j, nbytes, dcode)
        pack_idx: list[int] = []            # chain indices headed to pack
        pack_payloads: list = []
        ro_fix: list[tuple[int, int, int]] = []   # (i, size, first offset)
        # module-lookup hoists: this loop runs per WR on the hot path
        SEND, WRITE = wqe.IBV_WR_SEND, wqe.IBV_WR_RDMA_WRITE
        SIG, CUSTOM = wqe.WQE_F_SIGNALED, wqe.WQE_F_CUSTOM
        VERBS, CODES = wqe._VERB_OPCODES, wqe._DTYPE_CODES
        INL_MAX, ndarray = wqe.INLINE_MAX_BYTES, np.ndarray
        pk_append, pl_append = pack_idx.append, pack_payloads.append
        # payload-object memo: chains routinely post ONE payload object
        # many times (RPC fan-out, the send benches); its inlinability
        # verdict — a pure function of (payload, inline) — is computed
        # once and replayed by identity
        memo_p = memo_inline = memo = None
        for i, w in enumerate(chain):
            op = w.opcode
            if op == WRITE and w.payload is None and w.mr is None:
                raise ValueError("RDMA_WRITE needs a payload or a source MR")
            f = SIG if w.signaled else 0
            if op not in VERBS:
                f |= CUSTOM
            flagv[i] = f
            if op == SEND and w.mr is None and w.inline is not False:
                p = w.payload
                if p is memo_p and w.inline is memo_inline \
                        and memo_p is not None:
                    ok, a = memo
                else:
                    if isinstance(p, ndarray):
                        a = p
                    elif w.inline is None and (
                            p is None or isinstance(
                                p, (dict, tuple, list, torch.Tensor))):
                        a = None            # _flat_inlinable rejects these
                    else:
                        try:
                            a = np.asarray(p)
                        except Exception:
                            a = None
                    ok = a is not None \
                        and (w.inline is True or a.ndim <= 1) \
                        and a.dtype in CODES \
                        and a.nbytes <= INL_MAX
                    memo_p, memo_inline, memo = p, w.inline, (ok, a)
                if ok:
                    pk_append(i)
                    pl_append(a)
                elif w.inline is True:
                    wqe.pack_inline(p)      # raises the scalar-path error
            if w.remote_offsets is not None:
                offs = np.asarray(w.remote_offsets)
                ro_fix.append((i, int(offs.size), int(offs.ravel()[0])))
            if w.mr is not None:
                lkeys[i] = w.mr.lkey
        if pack_idx:
            rows, nbs, dcs = wqe.pack_inline_batch(pack_payloads)
            INLINE = wqe.WQE_F_INLINE
            for j, (i, nb, dc) in enumerate(
                    zip(pack_idx, nbs.tolist(), dcs.tolist())):
                flagv[i] |= INLINE
                lengths[i] = nb
                dcodes[i] = dc
                inline_meta[i] = (rows, j, nb, dc)
        for i, size, first in ro_fix:       # remote_offsets wins on length
            lengths[i] = size
            roffs[i] = first
        descs = wqe.encode_wqe_batch(
            [w.opcode for w in chain],
            wr_ids=[w.wr_id for w in chain],
            rkeys=[w.remote_key for w in chain],
            lkeys=lkeys, remote_offsets=roffs, lengths=lengths,
            flags=flagv, dtype_codes=dcodes)
        # inline_row stays None: the (block, j) provenance IS the row —
        # materializing n row views here costs more than the whole
        # batched unpack that usually consumes them
        return [
            _PostedSend(d, w) if m is None else
            _PostedSend(d, w, None, m[2], m[3], inline_src=(m[0], m[1]))
            for d, w, m in zip(descs, chain, inline_meta)]

    # -- progress -----------------------------------------------------------
    def flush(self):
        """Ring the doorbell: hand the posted send queue to the transport
        (one processing pass; every queued DMA coalesces, every CQE rides
        one batched ring write per CQ)."""
        if self.transport is None:
            raise QPStateError("QP not attached to a transport")
        return self.transport.process(self)
