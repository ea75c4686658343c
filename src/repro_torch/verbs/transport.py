"""Transports: what actually moves bytes when a send queue is flushed.

`LoopbackTransport` connects QPs in-process (intra-host RPC, the
datapath on one card): payloads change hands by reference, one-sided ops
run against the peer's registered MRs, which are tensors on the pd's
device. `MeshTransport` is the mesh wire: a non-inline SEND whose WR
carries a `spec_tree` lowers onto `tx_engine.transmit` (the T1 striped
path) while the WQE/CQE headers stay on the T3 ring. Same verbs, two
substrates.

One `process()` pass is the unit of batching. Dispatch is BATCH-WISE
(FlexTOE's discipline): consecutive same-opcode WRs form a *run*, and a
run costs O(1) python/launch overhead —

  * a run of RDMA_WRITEs into one remote MR submits ONE stacked DMA;
  * a run of SENDs into an SRQ claims its recv WRs with ONE
    `take_many`;
  * MR-sourced payloads (SEND or WRITE sources with payload=None and
    mr+offsets) extract with ONE fused `gather_records` launch per
    same-local-MR segment (`_fused_mr_rows`), not a per-WR
    `pd.mr_array` + device index;
  * every RDMA_READ posted in the pass coalesces into one fused gather
    per remote region (`QPContext._flush`);
  * every completion of the pass is encoded per-CQ in ONE
    `encode_cqe_batch` and published with ONE ring DMA per CQ.

`vectorized=False` keeps the element-at-a-time dispatch as the
bit-exactness oracle; it never launches a kernel of this package.

Host/device boundary: payloads by value are numpy and stay on the host
until the fused scatter's one host->device copy. MR-sourced payloads
(the fused MR-row gather `_fused_mr_rows`, or a per-WR `_wr_source`)
are tensors on the MR's device and stay there: a stack that holds one
concatenates on the device (`offload_engine.stack_rows`), so device
data never makes a round trip through the host — which numpy could not
hold for a bf16 MR anyway.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import islice
from typing import Any

import math

import numpy as np
import torch

from repro_torch.convert import demote, to_host
from repro_torch.core import tx_engine
from repro_torch.core.descriptors import TransferPlan
from repro_torch.core.offload_engine import dedupe_last_wins, stack_rows
from repro_torch.kernels.wr_scatter import ops as wr_scatter_ops
from repro_torch.obs import metrics, trace
from repro_torch.verbs import wqe
from repro_torch.verbs.cq import CompletionQueue
from repro_torch.verbs.pd import MemoryRegion, ProtectionDomain
from repro_torch.verbs.qp import (QPState, QPStateError, QueuePair, RecvWR,
                                  SendWR)


# opcode labels for trace spans (perfetto track names read as verbs)
_OP_NAMES = {wqe.IBV_WR_SEND: "SEND", wqe.IBV_WR_RDMA_WRITE: "RDMA_WRITE",
             wqe.IBV_WR_RDMA_READ: "RDMA_READ"}

# Small-chain fast path: at or below this send-queue depth, run-grouping
# and batch staging cost more than they save, so vectorized dispatch
# takes the element-at-a-time path (same observable behavior — the two
# paths are held together by the bit-exactness property tests). Exactly
# 1: multi-WR chains get the batched path's all-or-nothing claim-release
# semantics (test_send_run_failure_mid_run_releases_claims,
# test_malformed_recv_offsets_fail_without_phantom_success), which a
# single-WR dispatch trivially satisfies either way.
SCALAR_DISPATCH_MAX = 1


def _op_name(op: int) -> str:
    return _OP_NAMES.get(op, f"CUSTOM_{op:#x}")


@dataclass(slots=True)
class _Cqe:
    """One staged completion, field-level (the scalar oracle's staging
    unit): its descriptor is encoded at publication time."""
    cq: CompletionQueue
    opcode: int
    wr_id: int
    status: int
    length: int
    data: Any = None


def _submit_stacked(ctx, mr, offs: list, bufs: list, touch):
    """Submit one accumulated stack of record WRITEs as ONE DMA:
    duplicate offsets across the stacked entries retire last-writer-wins,
    exactly like the sequential submissions they replace. Host rows
    stack on the host; a stack holding device rows stacks on the device.
    Clears the accumulators. Shared by the WRITE-run and SEND-landing
    paths."""
    if not offs:
        return
    if len(offs) > 1:
        o, b = dedupe_last_wins(np.concatenate(offs), stack_rows(
            bufs, ctx.engine.regions[mr.name], tuple(mr.shape[1:])))
    else:
        o, b = offs[0], bufs[0]
    ctx.submit_dma("WRITE", mr.name, o, mr.record, buf=b)
    touch(ctx)
    offs.clear()
    bufs.clear()


def _rows(src, rec_shape: tuple):
    """A WRITE source as record rows: a tensor stays on its device, host
    data becomes numpy."""
    if not isinstance(src, torch.Tensor):
        src = to_host(src)
    return src.reshape((-1,) + rec_shape)


class _CqStage:
    """Struct-of-arrays CQE staging for ONE CQ: the vectorized pass
    appends plain scalars (no per-CQE object) and publication is a
    single `encode_cqe_batch` + `push_batch` of the columns."""
    __slots__ = ("cq", "ops", "ids", "sts", "lens", "datas")

    def __init__(self, cq: CompletionQueue):
        self.cq = cq
        self.ops: list = []
        self.ids: list = []
        self.sts: list = []
        self.lens: list = []
        self.datas: list = []

    def add(self, opcode, wr_id, status, length, data=None) -> int:
        self.ops.append(opcode)
        self.ids.append(wr_id)
        self.sts.append(status)
        self.lens.append(length)
        self.datas.append(data)
        return len(self.datas) - 1


class LoopbackTransport:
    # fault-injecting link layer (verbs/faults.py); only Fabric installs
    # one, but the hook lives here so both dispatch paths consult the
    # SAME admission points — that's the vectorized/oracle parity
    faults = None

    def __init__(self, vectorized: bool = True):
        self.qps: dict[int, QueuePair] = {}
        self.vectorized = vectorized

    def attach(self, qp: QueuePair) -> QueuePair:
        self.qps[qp.qp_num] = qp
        qp.transport = self
        return qp

    def _peer(self, qp: QueuePair) -> QueuePair:
        peer = self.qps.get(qp.dest_qp_num or -1)
        if peer is None:
            raise QPStateError(f"QP {qp.qp_num} has no attached peer "
                               f"(dest={qp.dest_qp_num})")
        return peer

    @staticmethod
    def _wr_source(qp: QueuePair, wr: SendWR):
        """By-value payload, or — per the SendWR contract — the local MR
        records wr.mr[wr.offsets] when payload is None (gathered at send
        time, like a NIC DMA-reading the source buffer)."""
        if wr.payload is not None or wr.mr is None:
            return wr.payload
        arr = qp.pd.mr_array(wr.mr)
        offs = np.asarray(to_host(wr.offsets), np.int64).ravel()
        if not wr_scatter_ops.records_in(offs, arr.shape[0]):
            raise IndexError(f"WR {wr.wr_id}: source offsets outside MR "
                             f"{wr.mr.name!r} of {arr.shape[0]} records")
        return arr[torch.from_numpy(offs).to(arr.device)]

    def _lower_payload(self, qp: QueuePair, wr: SendWR, payload):
        """Hook: how an ALREADY-EXTRACTED payload crosses the wire
        (identity on loopback). Split from `_wr_source` so the fused
        MR-run gather can extract a whole run's payloads in ONE launch
        and still give the transport its per-WR wire lowering."""
        return payload

    def _move_payload(self, qp: QueuePair, wr: SendWR):
        """Hook: how a non-inline payload crosses the wire — extraction
        (`_wr_source`) then wire lowering (`_lower_payload`)."""
        return self._lower_payload(qp, wr, self._wr_source(qp, wr))

    @staticmethod
    def _remote_mr(peer: QueuePair, rkey: int) -> MemoryRegion | None:
        mr = peer.pd.lookup(rkey)
        if mr is None or mr.rkey != rkey:       # lkey grants no remote access
            return None
        return mr

    @staticmethod
    def _in_mr(mr: MemoryRegion, offsets) -> bool:
        """Whether record `offsets` all lie inside `mr`. A one-sided WR
        that names a record outside an MR completes with
        IBV_WC_ACCESS_ERR and moves nothing, like a bad rkey (the
        reference drops such a WRITE row and fills such a READ row)."""
        return wr_scatter_ops.records_in(to_host(offsets), mr.n_records)

    @classmethod
    def _read_ok(cls, mr: MemoryRegion, wr: SendWR) -> bool:
        """A READ's records lie inside the remote MR and, when it lands
        in a local MR, inside that one too: checked before the READ is
        queued, so the landing in `settle` cannot fail."""
        return cls._in_mr(mr, wr.remote_offsets) and (
            wr.mr is None or wr.offsets is None
            or cls._in_mr(wr.mr, wr.offsets))

    @staticmethod
    def _as_records(mr: MemoryRegion, buf):
        """`buf` as rows of `mr`'s record shape, demoted like the
        reference's `jnp.asarray` (a tensor stays on its device, host
        data stays numpy). A size that is no whole number of records
        raises TypeError, as the reference's reshape does."""
        rec_shape = tuple(mr.shape[1:])
        b = demote(buf)
        n = b.numel() if isinstance(b, torch.Tensor) else b.size
        rec = math.prod(rec_shape)
        if rec == 0 or n % rec:
            raise TypeError(f"payload of {n} elements is not a whole "
                            f"number of {rec_shape} records")
        return b.reshape((-1,) + rec_shape)

    def process(self, qp: QueuePair) -> int:
        """Drain qp's send queue: execute, coalesce, publish. Returns the
        number of WQEs consumed (SENDs stall in place on RNR)."""
        return self.process_many([qp])

    def process_many(self, qps: list[QueuePair]) -> int:
        """ONE processing pass over several QPs' send queues (a fabric
        flush): CQE staging, read coalescing and destination-context
        flushes are shared across the whole pass, so completions from
        many QPs into one CQ publish with ONE ring DMA and DMA runs
        against one destination context fuse together, grouped per
        (dst_ctx, opcode) run. For a single QP this is exactly the old
        per-QP pass."""
        for qp in qps:
            if qp.state != QPState.RTS:
                raise QPStateError(f"flush in {qp.state.name} (need RTS)")
        vec = self.vectorized
        cqes: list[_Cqe] = []               # scalar-oracle staging
        stages: dict[int, _CqStage] = {}    # vectorized: columns per CQ
        reads: list[tuple[QueuePair, Any, int, Any, SendWR]] = []
        # id()-keyed so membership checks stay O(1) however many DMAs a
        # pass queues; insertion order IS the flush order
        touched: dict[int, Any] = {}

        def touch(ctx):
            touched.setdefault(id(ctx), ctx)

        if vec:
            def stage(cq, opcode, wr_id, status, length, data=None):
                st = stages.get(id(cq))
                if st is None:
                    st = stages[id(cq)] = _CqStage(cq)
                return st, st.add(opcode, wr_id, status, length, data)
        else:
            def stage(cq, opcode, wr_id, status, length, data=None):
                c = _Cqe(cq, opcode, wr_id, status, length, data)
                cqes.append(c)
                return c

        def settle():
            # resolve reads: the FIRST wait triggers one coalesced gather
            # per remote region for everything queued this pass (Fig. 16b)
            for src_qp, ctx, dma_id, slot, wr in reads:
                data = ctx.wait_dma_finish(dma_id)
                if wr.mr is not None and wr.offsets is not None:
                    src_qp.ctx.submit_dma("WRITE", wr.mr.name, wr.offsets,
                                          wr.mr.record,
                                          buf=self._as_records(wr.mr, data))
                    touch(src_qp.ctx)
                if slot is not None:
                    if vec:
                        slot[0].datas[slot[1]] = data
                    else:
                        slot.data = data
            for ctx in touched.values():
                ctx._flush()
            # publish: one batched ring DMA per CQ, not per CQE — and in
            # vectorized mode one descriptor-block encode per CQ too
            tr = trace.TRACER
            if vec:
                for st in stages.values():
                    t0 = tr.now() if tr is not None else 0
                    if len(st.ops) == 1:        # RPC-sized publish: the
                        block = wqe.encode_cqe(  # scalar encode is cheaper
                            st.ops[0], st.ids[0], st.sts[0],
                            st.lens[0])[None]
                    else:
                        block = wqe.encode_cqe_batch(
                            st.ops, st.ids, st.sts, st.lens)
                    st.cq.push_batch(block, st.datas)
                    st.cq.flush()
                    if tr is not None:
                        tr.complete("cqe_publish", t0,
                                    cq=st.cq._metrics.name,
                                    cqes=len(st.ids))
                return
            groups: dict[int, list[_Cqe]] = {}
            for c in cqes:
                groups.setdefault(id(c.cq), []).append(c)
            for items in groups.values():
                cq = items[0].cq
                # oracle: per-element descriptor encode (the old per-CQE
                # cost), staged once like the old stacked produce — NOT
                # a per-CQE ring write
                t0 = tr.now() if tr is not None else 0
                cq.push_batch(np.stack([
                    wqe.encode_cqe(c.opcode, c.wr_id, c.status, c.length)
                    for c in items]), [c.data for c in items])
                cq.flush()
                if tr is not None:
                    tr.complete("cqe_publish", t0, cq=cq._metrics.name,
                                cqes=len(items))

        processed = 0
        try:
            for qp in qps:
                processed += self._dispatch(qp, stage, reads, touch)
        finally:
            settle()        # a mid-pass error must not drop staged work
        return processed

    # -- batch-wise dispatch ------------------------------------------------
    def _dispatch(self, qp, stage, reads, touch) -> int:
        if not self.vectorized:
            return self._dispatch_scalar(qp, stage, reads, touch)
        if len(qp.sq) <= SCALAR_DISPATCH_MAX:
            # tiny chains (RPCs, single sends) skip run-grouping; CQE
            # staging and the T4 flush stay batch-wise either way. The
            # dispatch span survives the shortcut — the trace chain is
            # part of the datapath contract (test_obs).
            tr = trace.TRACER
            if tr is None or not qp.sq:
                return self._dispatch_scalar(qp, stage, reads, touch)
            op = qp.sq[0].wr.opcode
            t0 = tr.now()
            handled = self._dispatch_scalar(qp, stage, reads, touch)
            tr.complete(f"dispatch_run:{_op_name(op)}", t0, qp=qp.qp_num,
                        run=1, handled=handled)
            return handled
        processed = 0
        sq = qp.sq
        while sq:
            # every verb targets the peer: a peer below RTR (or torn down
            # to ERR) refuses delivery — one-sided ops included, so a
            # late RDMA_WRITE cannot mutate a being-destroyed QP's memory
            peer = self._peer(qp)
            if peer.state not in (QPState.RTR, QPState.RTS):
                raise QPStateError(
                    f"peer QP {peer.qp_num} in {peer.state.name}, "
                    "not ready to receive")
            op = sq[0].wr.opcode
            run = [sq[0]]
            if not wqe.is_custom(op):       # handlers may mutate QP state:
                for ps in islice(sq, 1, len(sq)):   # customs never fuse
                    if ps.wr.opcode != op:
                        break
                    run.append(ps)
            # fusion-annotated span per run (one TRACER check per RUN,
            # never per WR): run length, WRs handled, and how many DMAs
            # the run stacked onto the peer's T4 context
            tr = trace.TRACER
            t0 = tr.now() if tr is not None else 0
            dmas0 = len(peer.ctx._dma_queue) if tr is not None else 0
            if wqe.is_custom(op):
                handled = self._run_custom(qp, peer, run[0], stage)
            elif op == wqe.IBV_WR_SEND:
                handled = self._run_sends(qp, peer, run, stage, touch)
            elif op == wqe.IBV_WR_RDMA_WRITE:
                handled = self._run_writes(qp, peer, run, stage, touch)
            elif op == wqe.IBV_WR_RDMA_READ:
                handled = self._run_reads(qp, peer, run, stage, reads)
            else:
                raise ValueError(f"unknown opcode {op:#x}")
            if tr is not None:
                tr.complete(f"dispatch_run:{_op_name(op)}", t0,
                            qp=qp.qp_num, run=len(run), handled=handled,
                            stacked_dmas=len(peer.ctx._dma_queue) - dmas0)
            for _ in range(handled):
                ps = sq.popleft()            # reservation -> CQ occupancy
                if ps.fc_peer_cq is not None or ps.fc_self_cq is not None:
                    qp._fc_retire(ps)
            processed += handled
            if handled < len(run):
                break                       # RNR: SENDs stall in place
        return processed

    def _wr_payload(self, qp, ps):
        """The payload one posted SEND delivers — THE shared helper for
        the scalar and vectorized paths (they must not drift): inline
        rows unpack from the companion descriptor, everything else moves
        by reference through `_move_payload`. Returns (payload, nbytes)
        where nbytes is the inline byte count (0 for by-reference moves:
        the wire bytes are the payload's own)."""
        if ps.inline_row is not None:
            return wqe.unpack_inline(ps.inline_row, ps.inline_nbytes,
                                     ps.inline_dtype), ps.inline_nbytes
        if ps.inline_src is not None:       # chain-built: row = block[j]
            block, j = ps.inline_src
            return wqe.unpack_inline(block[j], ps.inline_nbytes,
                                     ps.inline_dtype), ps.inline_nbytes
        return self._move_payload(qp, ps.wr), 0

    @staticmethod
    def _stage_recv_run(stage, cq, ids, lens, datas):
        """Bulk-stage a run of SUCCESS recv CQEs: one `stage` call for
        the head (get-or-create the CQ's column stage), then ONE column
        extend for the rest — same columns in the same order as n
        individual stage calls, without n closure dispatches. Only valid
        on the vectorized path (stage returns the _CqStage)."""
        st, _ = stage(cq, wqe.IBV_WC_RECV, ids[0], wqe.IBV_WC_SUCCESS,
                      lens[0], datas[0])
        k = len(ids) - 1
        if k:
            st.ops.extend([wqe.IBV_WC_RECV] * k)
            st.ids.extend(ids[1:])
            st.sts.extend([wqe.IBV_WC_SUCCESS] * k)
            st.lens.extend(lens[1:])
            st.datas.extend(datas[1:])

    @staticmethod
    def _batch_inline(run):
        """One batched unpack for a homogeneous inline SEND run: when
        every claimed WR's inline row sits at consecutive positions of
        ONE chain-pack block (how `_build_wqe_chain` stages them), the
        run's payloads are a single slice+byte-view of that block —
        zero per-WR byte roundtrips, delivered rows are views. Returns
        the (k, m) payload block, or None for mixed / non-inline runs
        (those take the per-WR `_wr_payload` path)."""
        first = run[0]
        src = first.inline_src
        if src is None:
            return None
        block, j0 = src
        nb, dc = first.inline_nbytes, first.inline_dtype
        for pos in range(1, len(run)):
            ps = run[pos]
            s = ps.inline_src
            if s is None or s[0] is not block or s[1] != j0 + pos \
                    or ps.inline_nbytes != nb or ps.inline_dtype != dc:
                return None
        return wqe.unpack_inline_batch(block[j0:j0 + len(run)], nb, dc)

    @staticmethod
    def _fused_mr_rows(qp, run):
        """Fused extraction for the MR-sourced WRs of one claimed run:
        maximal segments of consecutive WRs sourcing from the SAME local
        MR (payload=None, mr+offsets — the NIC-DMA-reads-the-source
        contract) gather through ONE `gather_records` launch per segment
        instead of a per-WR `pd.mr_array` + device index each. Returns a
        run-aligned list whose fused positions hold the (k, *rec) row
        blocks, views of the gathered block on the MR's device
        (bit-exact with the oracle's per-WR gather — same region, same
        offsets, no region mutation can interleave because every DMA of
        the pass queues until settle) and None elsewhere; or None when
        nothing fuses. A WR whose offsets don't normalize or fall outside
        its MR stays un-fused so it fails on the per-WR path at exactly
        the oracle's position."""
        n = len(run)
        mrs: list = [None] * n
        offs: list = [None] * n
        fusable = 0
        for i, ps in enumerate(run):
            wr = ps.wr
            if ps.inline_row is not None or ps.inline_src is not None \
                    or wr.payload is not None or wr.mr is None:
                continue
            try:
                off = np.asarray(wr.offsets, np.int64).ravel()
            except Exception:
                continue
            if off.size and wr_scatter_ops.records_in(off, wr.mr.n_records):
                mrs[i] = wr.mr
                offs[i] = off
                fusable += 1
        if fusable < 2:
            return None
        rows = None
        i = 0
        while i < n:
            mr = mrs[i]
            j = i + 1
            while mr is not None and j < n and mrs[j] is mr:
                j += 1
            if mr is not None and j - i >= 2:
                if rows is None:
                    rows = [None] * n
                seg = offs[i:j]
                cat = np.concatenate(seg)
                # ONE region fetch + ONE fused gather launch for the
                # whole segment; the rows stay on the device, cut into
                # per-WR views by ONE split (a python slice per WR costs
                # several times more on a long run)
                block = wr_scatter_ops.gather_records(
                    qp.pd.mr_array(mr), cat, int(mr.record))
                parts = block.reshape((-1,) + tuple(mr.shape[1:])).split(
                    [off.size for off in seg])
                rows[i:j] = parts
            i = j
        return rows

    def _run_custom(self, qp, peer, ps, stage) -> int:
        # escape hatch: dispatch into the peer's offload engine
        wr = ps.wr
        resp = peer.pd.engine.handle_packet(
            wr.opcode, wr.payload, qp_id=peer.qp_num)
        if wr.signaled:
            stage(qp.send_cq, wr.opcode, wr.wr_id, wqe.IBV_WC_SUCCESS, 0,
                  resp)
        return 1

    def _run_sends(self, qp, peer, run, stage, touch) -> int:
        """A run of SENDs claims its recv WRs in ONE batched pool pop
        (`SRQ.take_many` / a single rq drain); a short claim is an RNR
        stall for the remainder of the run.

        Landings are batch-wise like the WRITE path: the fallible phase
        gathers every payload first, then `_land_sends` stacks contiguous
        landings into the SAME posted MR into ONE `submit_dma`. A payload
        failing mid-gather still delivers the WRs before it (exactly what
        the element-at-a-time oracle would have done) before re-raising.
        A SUBMIT-time failure (malformed recv posting) is where the
        batched path deliberately diverges from the oracle: the whole
        un-submitted tail — including sideband landings queued behind the
        failed stack for CQE ordering — rolls back for redelivery rather
        than completing piecemeal; conservative (a retried sideband WR
        re-runs `_move_payload`), but never a SUCCESS CQE for data that
        did not land."""
        n = len(run)
        if self.faults is not None:
            # lossy link: claim + admit WR-by-WR in exactly the oracle's
            # order. A refused packet hands its claim straight back and
            # stalls the rest of the run — decision parity with
            # `_dispatch_scalar` is what keeps vectorized=False a
            # bit-exactness oracle under the same fault schedule.
            rwrs = []
            for ps in run:
                if peer.srq is not None:
                    rwr = peer.srq.take(peer.qp_num)
                else:
                    rwr = peer.rq.popleft() if peer.rq else None
                if rwr is None:
                    ps.fault_stall = None       # RNR, not a link fault
                    break
                if not self.faults.admit(self, qp, ps):
                    if peer.srq is not None:
                        peer.srq.untake(peer.qp_num, [rwr])
                    else:
                        peer.rq.appendleft(rwr)
                    break
                rwrs.append(rwr)
            run = run[:len(rwrs)]
            if not run:
                return 0
        elif peer.srq is not None:
            rwrs = peer.srq.take_many(peer.qp_num, n)
        else:
            k = min(n, len(peer.rq))
            rwrs = [peer.rq.popleft() for _ in range(k)]
        landed: list[tuple] = []    # (ps, rwr, payload, off, buf, nbytes)
        staged = [0]                # landings whose CQEs _land_sends staged

        def release_claims():
            # retire exactly the WRs whose CQEs are staged (a redelivery
            # on the next flush would duplicate them) and hand every
            # other pre-claimed recv WR back to the FRONT of the pool —
            # the element-at-a-time oracle can't over-claim, so neither
            # may the batched path
            unused = rwrs[staged[0]:]
            if peer.srq is not None:
                peer.srq.untake(peer.qp_num, unused)
            else:
                peer.rq.extendleft(reversed(unused))
            for _ in range(staged[0]):
                qp._fc_retire(qp.sq.popleft())

        claimed = run[:len(rwrs)] if len(rwrs) < n else run
        rows = self._batch_inline(claimed) if len(rwrs) > 1 else None
        # MR-sourced payloads of the claimed run gather fused (ONE
        # launch per same-MR segment); the same block feeds the same-CQ
        # per-WR ordering fallback below, so that fallback costs CQE
        # ordering only — never a second host extraction pass
        mr_rows = None if rows is not None or len(rwrs) <= 1 else \
            self._fused_mr_rows(qp, claimed)
        if rows is not None and all(rwr.mr is None for rwr in rwrs):
            # pure sideband inline run (the serve/submit hot path):
            # payloads are already unpacked and nothing between here and
            # the CQE stage can fail, so stage straight off the block —
            # no landed-tuple staging, no per-WR closure calls
            sig = [ps for ps in claimed if ps.wr.signaled]
            if not sig or qp.send_cq is not peer.recv_cq:
                nb = claimed[0].inline_nbytes
                k = len(rwrs)
                self._stage_recv_run(stage, peer.recv_cq,
                                     [rwr.wr_id for rwr in rwrs],
                                     [nb] * k, rows)
                for ps in sig:
                    stage(qp.send_cq, wqe.IBV_WR_SEND, ps.wr.wr_id,
                          wqe.IBV_WC_SUCCESS, ps.inline_nbytes)
                staged[0] = k
                return k
        has_mr = False
        try:
            for pos, (ps, rwr) in enumerate(zip(run, rwrs)):
                if rows is not None:
                    payload = rows[pos]
                    nbytes = ps.inline_nbytes
                elif mr_rows is not None and mr_rows[pos] is not None:
                    # pre-gathered block row: by-reference move, the wire
                    # lowering (spec_tree / fabric routing) still per-WR
                    payload = self._lower_payload(qp, ps.wr, mr_rows[pos])
                    nbytes = 0
                else:
                    payload, nbytes = self._wr_payload(qp, ps)
                off = buf = None
                if rwr.mr is not None:
                    has_mr = True
                    # ALL landing validation happens here in the fallible
                    # phase — offsets normalized, payload reshaped
                    # (`_as_records` so a bad payload fails exactly like
                    # the oracle's); host payloads stay numpy for the
                    # stack (the ONE device conversion happens at the
                    # fused scatter), MR-sourced ones stay on the device
                    off = np.asarray(to_host(rwr.offsets)).ravel()
                    buf = self._as_records(rwr.mr, payload)
                landed.append((ps, rwr, payload, off, buf, nbytes))
        except BaseException:
            # payload/landing prep failed mid-run: deliver the gathered
            # prefix (exactly what the oracle would have delivered),
            # then release the claims — even if that delivery itself
            # fails
            try:
                self._land_sends(qp, peer, landed, stage, touch, staged,
                                 has_mr)
            finally:
                release_claims()
            raise
        try:
            self._land_sends(qp, peer, landed, stage, touch, staged,
                             has_mr)
        except BaseException:
            release_claims()
            raise
        return len(rwrs)

    def _land_sends(self, qp, peer, landed, stage, touch, staged,
                    has_mr=None):
        """Deliver a prepared SEND run: stack contiguous landings into
        one posted MR into ONE `submit_dma` (duplicate offsets retire
        last-writer-wins, like sequential landings). A broadcasting
        landing (payload rows != posted offsets) keeps its own DMA.

        A landing's SUCCESS CQEs stage only AFTER the DMA carrying it
        was submitted: stage calls queue in `pending` (delivery order
        preserved — sideband landings ride the queue too) and drain at
        each stack flush, so a submit-time failure leaves the affected
        WRs un-staged and un-retired (`staged[0]` counts delivered
        landings for the caller's claim accounting) — queued for retry,
        never completed-but-not-landed."""
        if has_mr is None:
            has_mr = any(rwr.mr is not None for _, rwr, *_ in landed)
        if not has_mr:
            # no MR landings (the serve/submit hot path: sideband-only
            # deliveries): nothing can fail at submit time, stage
            # directly without the stacking/pending machinery
            sig = [(t[0], t[5]) for t in landed if t[0].wr.signaled]
            if len(landed) > 1 and (not sig
                                    or qp.send_cq is not peer.recv_cq):
                # bulk-stage the run's recv CQEs: ONE column extend per
                # run instead of a closure call per WR. Send-CQ CQEs for
                # signaled WRs follow the run; when both would land in
                # the SAME CQ the per-WR loop below keeps the oracle's
                # recv/send interleaving instead.
                self._stage_recv_run(stage, peer.recv_cq,
                                     [t[1].wr_id for t in landed],
                                     [t[5] for t in landed],
                                     [t[2] for t in landed])
                for ps, nbytes in sig:
                    stage(qp.send_cq, wqe.IBV_WR_SEND, ps.wr.wr_id,
                          wqe.IBV_WC_SUCCESS, nbytes)
                staged[0] += len(landed)
                return
            for ps, rwr, payload, off, buf, nbytes in landed:
                stage(peer.recv_cq, wqe.IBV_WC_RECV, rwr.wr_id,
                      wqe.IBV_WC_SUCCESS, nbytes, payload)
                if ps.wr.signaled:
                    stage(qp.send_cq, wqe.IBV_WR_SEND, ps.wr.wr_id,
                          wqe.IBV_WC_SUCCESS, nbytes)
                staged[0] += 1
            return
        offs: list[np.ndarray] = []
        bufs: list = []
        cur_mr = None
        pending: list[list[tuple]] = []    # per-landing stage calls

        def drain_pending():
            for calls in pending:
                for args in calls:
                    stage(*args)
                staged[0] += 1
            pending.clear()

        def flush_stack():
            nonlocal cur_mr
            if cur_mr is not None:
                _submit_stacked(peer.ctx, cur_mr, offs, bufs, touch)
                cur_mr = None
            drain_pending()

        for ps, rwr, payload, off, buf, nbytes in landed:
            calls = []
            delivered = payload
            broadcast = False
            if rwr.mr is not None:
                delivered = None         # landed in memory, not the CQE
                if buf.shape[0] == off.size:
                    if cur_mr is not None and cur_mr is not rwr.mr:
                        flush_stack()
                    cur_mr = rwr.mr
                    offs.append(off)
                    bufs.append(buf)
                else:                    # broadcasting: submit alone
                    flush_stack()
                    peer.ctx.submit_dma("WRITE", rwr.mr.name, rwr.offsets,
                                        rwr.mr.record, buf=buf)
                    touch(peer.ctx)
                    broadcast = True
            calls.append((peer.recv_cq, wqe.IBV_WC_RECV, rwr.wr_id,
                          wqe.IBV_WC_SUCCESS, nbytes, delivered))
            if ps.wr.signaled:
                calls.append((qp.send_cq, wqe.IBV_WR_SEND, ps.wr.wr_id,
                              wqe.IBV_WC_SUCCESS, nbytes))
            pending.append(calls)
            if broadcast:
                # its DMA is already submitted: stage NOW, so a later
                # stack failure cannot leave it landed-but-unretired
                # (a redelivery would run the DMA twice)
                drain_pending()
        flush_stack()

    def _run_writes(self, qp, peer, run, stage, touch) -> int:
        """Consecutive WRITEs to one remote MR fuse into ONE stacked
        `submit_dma` (offsets concatenated, record rows stacked) — one
        DmaOp, one scatter launch, N completions. A WR naming a record
        outside the remote MR completes with IBV_WC_ACCESS_ERR in its
        place in the run and moves nothing (one range check per sub-run;
        per WR only when it fails).

        Each sub-run is all-or-nothing: every source is gathered and
        reshaped BEFORE anything is submitted or any SUCCESS CQE is
        staged, so a bad payload mid-run cannot publish a completion
        for a write that never landed. On failure the sub-runs that DID
        retire are popped (their CQEs are staged) and the rest stay
        queued untouched."""
        done = 0
        try:
            i = 0
            while i < len(run):
                rkey = run[i].wr.remote_key
                j = i
                while j < len(run) and run[j].wr.remote_key == rkey:
                    j += 1
                sub = run[i:j]
                i = j
                mr = self._remote_mr(peer, rkey)
                if mr is None:
                    for ps in sub:
                        stage(qp.send_cq, ps.wr.opcode, ps.wr.wr_id,
                              wqe.IBV_WC_ACCESS_ERR, 0)
                    done += len(sub)
                    continue
                # fallible phase: gather every source up front.
                # numpy-first for payloads by value: a variadic device
                # concatenate over thousands of tiny operands costs more
                # than the scatter it feeds — their ONE device conversion
                # is the scatter's. MR-sourced rows are already on the
                # device and stay there.
                # MR-sourced WRITEs fuse their source extraction the
                # same way as SENDs: one gather launch per same-local-MR
                # segment instead of a per-WR `pd.mr_array` + index.
                rec_shape = tuple(mr.shape[1:])
                roffs = [to_host(ps.wr.remote_offsets).ravel() for ps in sub]
                inside = [True] * len(sub) if wr_scatter_ops.records_in(
                    np.concatenate(roffs), mr.n_records) else \
                    [wr_scatter_ops.records_in(o, mr.n_records)
                     for o in roffs]
                mr_rows = self._fused_mr_rows(qp, sub) \
                    if len(sub) > 1 else None
                srcs = [(ps, off, _rows(
                             mr_rows[pos] if mr_rows is not None
                             and mr_rows[pos] is not None
                             else self._wr_source(qp, ps.wr), rec_shape)
                         if ok else None)
                        for pos, (ps, off, ok)
                        in enumerate(zip(sub, roffs, inside))]
                # infallible phase: stack, submit, stage. A WR whose
                # source rows don't match its offset count (a
                # broadcasting WRITE) keeps its own DMA.
                offs: list[np.ndarray] = []
                bufs: list = []

                def flush_stack():
                    _submit_stacked(peer.ctx, mr, offs, bufs, touch)

                for ps, off, buf in srcs:
                    wr = ps.wr
                    if buf is None:         # a record outside the MR
                        stage(qp.send_cq, wr.opcode, wr.wr_id,
                              wqe.IBV_WC_ACCESS_ERR, 0)
                        continue
                    if buf.shape[0] == off.size:
                        offs.append(off)
                        bufs.append(buf)
                    else:                   # broadcasting: submit alone
                        flush_stack()
                        peer.ctx.submit_dma("WRITE", mr.name,
                                            wr.remote_offsets, mr.record,
                                            buf=buf)
                        touch(peer.ctx)
                    if wr.signaled:
                        stage(qp.send_cq, wr.opcode, wr.wr_id,
                              wqe.IBV_WC_SUCCESS, int(off.size))
                flush_stack()
                done += len(sub)
        except BaseException:
            for _ in range(done):
                qp._fc_retire(qp.sq.popleft())
            raise
        return len(run)

    def _run_reads(self, qp, peer, run, stage, reads) -> int:
        done = 0
        try:
            for ps in run:
                wr = ps.wr
                mr = self._remote_mr(peer, wr.remote_key)
                if mr is None or not self._read_ok(mr, wr):
                    stage(qp.send_cq, wr.opcode, wr.wr_id,
                          wqe.IBV_WC_ACCESS_ERR, 0)
                    done += 1
                    continue
                dma_id = peer.ctx.submit_dma(
                    "READ", mr.name, wr.remote_offsets, mr.record)
                slot = None
                if wr.signaled:
                    slot = stage(qp.send_cq, wr.opcode, wr.wr_id,
                                 wqe.IBV_WC_SUCCESS,
                                 int(np.asarray(wr.remote_offsets).size))
                reads.append((qp, peer.ctx, dma_id, slot, wr))
                done += 1
        except BaseException:
            # a bad WR mid-run: retire the WRs whose CQEs are staged so
            # the next flush cannot redeliver them
            for _ in range(done):
                qp._fc_retire(qp.sq.popleft())
            raise
        return len(run)

    # -- element-at-a-time dispatch (the oracle) ----------------------------
    def _dispatch_scalar(self, qp, stage, reads, touch) -> int:
        processed = 0
        while qp.sq:
            ps = qp.sq[0]
            wr = ps.wr
            peer = self._peer(qp)
            if peer.state not in (QPState.RTR, QPState.RTS):
                raise QPStateError(
                    f"peer QP {peer.qp_num} in {peer.state.name}, "
                    "not ready to receive")
            if wqe.is_custom(wr.opcode):
                resp = peer.pd.engine.handle_packet(
                    wr.opcode, wr.payload, qp_id=peer.qp_num)
                if wr.signaled:
                    stage(qp.send_cq, wr.opcode, wr.wr_id,
                          wqe.IBV_WC_SUCCESS, 0, resp)
            elif wr.opcode == wqe.IBV_WR_SEND:
                # recv side: the shared pool when the peer attached an
                # SRQ (pool-FIFO across every attached QP), else its rq
                if peer.srq is not None:
                    rwr = peer.srq.take(peer.qp_num)
                else:
                    rwr = peer.rq.popleft() if peer.rq else None
                if rwr is None:
                    if self.faults is not None:
                        ps.fault_stall = None   # RNR, not a link fault
                    break       # RNR: leave this and later SENDs queued
                if self.faults is not None and \
                        not self.faults.admit(self, qp, ps):
                    # refused at the link: hand the claim back and stall
                    # (`Fabric._police` reads ps.fault_stall for the why)
                    if peer.srq is not None:
                        peer.srq.untake(peer.qp_num, [rwr])
                    else:
                        peer.rq.appendleft(rwr)
                    break
                payload, nbytes = self._wr_payload(qp, ps)
                delivered = payload
                if rwr.mr is not None:
                    peer.ctx.submit_dma(
                        "WRITE", rwr.mr.name, rwr.offsets, rwr.mr.record,
                        buf=self._as_records(rwr.mr, payload))
                    touch(peer.ctx)
                    delivered = None     # landed in memory, not the CQE
                stage(peer.recv_cq, wqe.IBV_WC_RECV, rwr.wr_id,
                      wqe.IBV_WC_SUCCESS, nbytes, delivered)
                if wr.signaled:
                    stage(qp.send_cq, wqe.IBV_WR_SEND, wr.wr_id,
                          wqe.IBV_WC_SUCCESS, nbytes)
            elif wr.opcode == wqe.IBV_WR_RDMA_WRITE:
                mr = self._remote_mr(peer, wr.remote_key)
                if mr is None or not self._in_mr(mr, wr.remote_offsets):
                    stage(qp.send_cq, wr.opcode, wr.wr_id,
                          wqe.IBV_WC_ACCESS_ERR, 0)
                else:
                    peer.ctx.submit_dma(
                        "WRITE", mr.name, wr.remote_offsets, mr.record,
                        buf=self._as_records(mr, self._wr_source(qp, wr)))
                    touch(peer.ctx)
                    if wr.signaled:
                        stage(qp.send_cq, wr.opcode, wr.wr_id,
                              wqe.IBV_WC_SUCCESS,
                              int(np.asarray(wr.remote_offsets).size))
            elif wr.opcode == wqe.IBV_WR_RDMA_READ:
                mr = self._remote_mr(peer, wr.remote_key)
                if mr is None or not self._read_ok(mr, wr):
                    stage(qp.send_cq, wr.opcode, wr.wr_id,
                          wqe.IBV_WC_ACCESS_ERR, 0)
                else:
                    dma_id = peer.ctx.submit_dma(
                        "READ", mr.name, wr.remote_offsets, mr.record)
                    slot = None
                    if wr.signaled:
                        slot = stage(qp.send_cq, wr.opcode, wr.wr_id,
                                     wqe.IBV_WC_SUCCESS,
                                     int(np.asarray(wr.remote_offsets).size))
                    reads.append((qp, peer.ctx, dma_id, slot, wr))
            else:
                raise ValueError(f"unknown opcode {wr.opcode:#x}")
            qp.sq.popleft()
            qp._fc_retire(ps)   # reservation becomes real CQ occupancy
            processed += 1
        return processed


class MeshTransport(LoopbackTransport):
    """Lower payload-bearing SENDs onto the T1 TX engine: headers on the
    ring, payload once over the fattest direct path (striped wire)."""

    # registry-backed: `meshtransport{i}/wire_sends` (or `fabric{i}/...`
    # for Fabric subclasses — the scope is minted lazily from the class
    # name on first touch)
    wire_sends = metrics.counter_attr()

    def __init__(self, plan: TransferPlan | None = None, *,
                 staged: bool = False, vectorized: bool = True):
        super().__init__(vectorized=vectorized)
        self.plan = plan or TransferPlan()
        self.staged = staged
        self.wire_sends = 0

    def _lower_payload(self, qp: QueuePair, wr: SendWR, payload):
        if wr.spec_tree is None:
            return payload
        self.wire_sends += 1
        fn = tx_engine.transmit_staged if self.staged else tx_engine.transmit
        return fn(payload, wr.spec_tree, self.plan)


def two_sided_send(send_qp: QueuePair, flush, server_qp: QueuePair,
                   recv_cq: CompletionQueue, payloads: list, *,
                   wr_id: int = 0, spec_tree=None,
                   inline: bool | None = None):
    """Shared body of the send/send_many conveniences (VerbsPair and
    FabricEndpoint): top the recv side
    up to the batch size (the server's SRQ pool, else its rq), post the
    whole list as ONE WQE chain (one doorbell write, one
    descriptor-fetch DMA), flush, and drain the recv CQ until every
    completion arrived — a batch can outsize the CQ ring, and each poll
    republishes one ring's worth of staged backlog. Returns the recv
    completions in posting order."""
    if not payloads:
        return []
    need = len(payloads)
    pool = server_qp.srq
    if pool is not None:
        if len(pool) < need:
            pool.post_recv([RecvWR(wr_id=wr_id + i)
                            for i in range(len(pool), need)])
    else:
        while len(server_qp.rq) < need:
            server_qp.post_recv(RecvWR(wr_id=wr_id + len(server_qp.rq)))
    send_qp.post_send([SendWR(wr_id=wr_id + i, payload=p,
                              spec_tree=spec_tree, inline=inline)
                       for i, p in enumerate(payloads)])
    flush()
    wcs = recv_cq.poll()
    while len(wcs) < need:
        more = recv_cq.poll()
        if not more:
            break
        wcs += more
    return wcs


def connect(a: QueuePair, b: QueuePair, transport: LoopbackTransport):
    """Run the RC handshake for a local pair: both sides RESET -> INIT ->
    RTR(dest) -> RTS on the given transport.

    Both QPs must live on THIS transport: silently re-homing a QP that
    is already attached elsewhere would leave a stale registration behind
    and the mismatch would surface only at the first post_send — validate
    up front, before any state transitions."""
    for qp in (a, b):
        if qp.transport is not None and qp.transport is not transport:
            raise QPStateError(
                f"QP {qp.qp_num} is already attached to a different "
                "transport; detach (destroy) it before reconnecting")
    transport.attach(a)
    transport.attach(b)
    a.modify(QPState.INIT)
    b.modify(QPState.INIT)
    a.modify(QPState.RTR, dest_qp_num=b.qp_num)
    b.modify(QPState.RTR, dest_qp_num=a.qp_num)
    a.modify(QPState.RTS)
    b.modify(QPState.RTS)
    return a, b


class VerbsPair:
    """A connected client/server RC pair — the two-lines-of-setup path
    the call sites (kvtransfer, solar, serve) build on."""

    def __init__(self, pd: ProtectionDomain | None = None,
                 transport: LoopbackTransport | None = None, *,
                 depth: int = 512, publish_every: int = 8,
                 max_wr: int = 256, srq=None, flow_control: bool = False,
                 vectorized: bool = True):
        self.pd = pd or ProtectionDomain()     # the default device
        self.transport = transport if transport is not None else \
            LoopbackTransport(vectorized=vectorized)
        self.srq = srq                  # shared recv pool for the server QP
        self.client_cq = CompletionQueue(depth, publish_every, vectorized)
        self.client_recv_cq = CompletionQueue(depth, publish_every, vectorized)
        self.server_cq = CompletionQueue(depth, publish_every, vectorized)
        self.server_recv_cq = CompletionQueue(depth, publish_every, vectorized)
        self.client = QueuePair(self.pd, self.client_cq, self.client_recv_cq,
                                max_send_wr=max_wr, max_recv_wr=max_wr,
                                flow_control=flow_control,
                                vectorized=vectorized)
        self.server = QueuePair(self.pd, self.server_cq, self.server_recv_cq,
                                max_send_wr=max_wr, max_recv_wr=max_wr,
                                srq=srq, flow_control=flow_control,
                                vectorized=vectorized)
        connect(self.client, self.server, self.transport)

    def rpc(self, opcode: int, payload, wr_id: int = 0):
        """post_send + flush + poll: one request/response round trip on
        the client QP. Returns the completion (resp in `.data`)."""
        self.client.post_send(SendWR(wr_id=wr_id, opcode=opcode,
                                     payload=payload))
        self.client.flush()
        wcs = self.client_cq.poll()
        assert wcs, "rpc produced no completion"
        return wcs[-1]

    def send(self, payload, *, wr_id: int = 0, spec_tree=None,
             inline: bool | None = None):
        """Two-sided SEND client -> server; server-side recv completion is
        returned (the recv side — SRQ pool or per-QP rq — is topped up
        automatically)."""
        wcs = two_sided_send(self.client, self.client.flush, self.server,
                             self.server_recv_cq, [payload], wr_id=wr_id,
                             spec_tree=spec_tree, inline=inline)
        assert wcs, "send was not delivered (RNR?)"
        return wcs[-1]

    def send_many(self, payloads: list, *, wr_id: int = 0, spec_tree=None,
                  inline: bool | None = None):
        """Doorbell-batched two-sided SENDs: the whole list is staged as
        ONE WQE chain (one doorbell write, one descriptor-fetch DMA) and
        the recv side is topped up to match. WRs are numbered wr_id,
        wr_id+1, ... . Returns the recv completions in posting order."""
        wcs = two_sided_send(self.client, self.client.flush, self.server,
                             self.server_recv_cq, payloads, wr_id=wr_id,
                             spec_tree=spec_tree, inline=inline)
        if payloads:
            assert len(wcs) == len(payloads), \
                f"{len(wcs)}/{len(payloads)} delivered (RNR?)"
        return wcs
