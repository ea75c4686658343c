"""KVCache transfer engine (Mooncake analogue, paper §5.7 Fig. 18).

Prefill pods produce KV caches in the *streaming layout* (sequence sharded
over `model`, batch over `data`) — the same layout decode consumes. The
transfer is issued as ONE verbs SEND on a fabric-routed RC queue pair
(prefill pod CM -> decode pod listener): the WQE/CQE headers ride the T3
ring (the CQ), the payload moves once, pod->pod, already striped over
every per-pod path (packet spraying, via `tx_engine.transmit` under the
fabric's cross-pod `_lower_payload`). The staged baseline re-replicates
first (the QP hash-collision analogue: all bytes ride one path per
data-row, stripe-factor more wire traffic).

With no mesh `tx_engine.transmit` is the identity, so a cross-pod SEND
delivers the sender's own tensors, by reference, as the reference does
without a pod axis. Torch tensors are mutable: a sender must not write a
tree in place after posting it (ROADMAP Queue 3). `make_transfer_step`
is the payload path of the SEND without the control plane: under a mesh
with a pod axis, the permute of `tx_engine.transmit` (or the staged
baseline's).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import tree, verbs
from repro_torch.core import tx_engine
from repro_torch.core.descriptors import TransferPlan
from repro_torch.obs import metrics


@dataclass
class TransferStats:
    n_leaves: int = 0
    payload_bytes: int = 0
    header_bytes: int = 0


def account(caches, plan: TransferPlan) -> TransferStats:
    """Header/payload byte accounting: one 64B descriptor per cache leaf
    on the control path, payload bytes on the wire."""
    stats = TransferStats()
    leaves = tree.leaves(caches)
    stats.n_leaves = len(leaves)
    # from the shapes alone: no host copy of a device leaf
    stats.payload_bytes = int(sum(
        l.numel() * l.element_size() if isinstance(l, torch.Tensor)
        else np.asarray(l).nbytes for l in leaves))
    descs = plan.descriptors(len(leaves), stats.payload_bytes)
    stats.header_bytes = int(descs.nbytes)
    return stats


class KVTransferEngine:
    """Moves a model's decode cache across the `pod` axis through the
    verbs fabric: the prefill pod's CM connects to the decode pod's
    listener (`fabric.connect` — no manual QP bring-up) and each
    transfer is one SEND on the routed RC connection.

    Failover: the engine listens on EVERY decode-capable gid (each pod
    except the prefill pod's) and `transfer()` is replayed end to end
    when the connected decode node dies mid-transfer — peer death
    arrives as a CM disconnect *event* (`connect(on_disconnect=...)`),
    the route re-resolves to a surviving listener, and the SEND is
    re-posted on the fresh connection. The delivered payload is the
    replayed one, bit-exact; `route_reresolutions`/`transfers_replayed`
    registry counters (``kvtransfer{i}/...``) prove what happened."""

    transfers_replayed = metrics.counter_attr()
    route_reresolutions = metrics.counter_attr()
    pages_migrated = metrics.counter_attr()

    def __init__(self, model, batch: int, seq_len: int,
                 plan: TransferPlan | None = None, *,
                 vectorized: bool = True, fabric=None,
                 replay_limit: int = 3, src_gid: str | None = None,
                 decode_gids: list[str] | None = None):
        metrics.instance_scope(self, "kvtransfer", indexed=True)
        self.model = model
        self.plan = plan or TransferPlan()
        self.spec_tree = model.cache_specs(batch, seq_len)
        self.replay_limit = replay_limit
        self.transfers_replayed = 0
        self.route_reresolutions = 0
        self.pages_migrated = 0
        # decode-side landing buffers come from the FABRIC-scope shared
        # pool (one SRQ + one watermark for every tenant on the fabric)
        # and the prefill sender runs under CQ-credit flow control: a
        # slow decode pod ENOMEMs the sender instead of overrunning its
        # CQ. A caller-supplied fabric shares its pool (and routing)
        # with other engines; by default the engine spans its own
        # 2-pod grid (on the package default device) so the payload tree
        # rides the striped cross-pod wire (tx_engine.transmit under the
        # routed `_lower_payload`).
        self.fabric = fabric if fabric is not None else verbs.Fabric(
            pods=2, plan=self.plan, vectorized=vectorized)
        self.srq = self.fabric.shared_srq(max_wr=256)
        if fabric is not None and self.fabric.pods < 2:
            # the wire bypass is decided by POD equality (the fabric
            # lowers spec_tree SENDs onto tx_engine only across pods):
            # on a single-pod fabric — however many devices — transfers
            # move by reference and transfer_staged has no striped-vs-
            # staged wire to compare
            warnings.warn(
                "KVTransferEngine on a single-pod fabric: transfers "
                "are intra-pod (by reference); the tx_engine wire "
                "(and transfer_staged's baseline) is bypassed",
                stacklevel=2)
        # decode listeners: the primary on the LAST gid (the historical
        # decode pod) plus a standby on every other decode-capable gid
        # (pods other than the prefill pod's) — the failover targets.
        # `src_gid` / `decode_gids` pin the roles explicitly (a serving
        # cluster with several prefill pods passes its own topology).
        self._prefill_gid = src_gid or self.fabric.gids[0]
        prefill_pod = self._prefill_gid.split("/", 1)[0]
        if decode_gids is None:
            decode_gids = [g for g in self.fabric.gids
                           if g.split("/", 1)[0] != prefill_pod]
        if not decode_gids:                 # single-pod fabric (warned)
            decode_gids = [self.fabric.gids[-1]]
        self._listen_addrs = [
            self.fabric.node(g).listen(depth=256, srq="fabric",
                                       flow_control=True)
            for g in decode_gids]
        self._peer_lost = False
        self._connect_to(len(self._listen_addrs) - 1)
        self.stats = TransferStats()
        self._wr_id = 0

    def _connect_to(self, idx: int):
        """Establish (or re-establish) the transfer connection against
        the decode listener at `idx`; peer death on it raises the
        `_peer_lost` flag via the CM disconnect event."""
        addr = self._listen_addrs[idx]

        def lost(_ep):
            self._peer_lost = True
        self.ep = self.fabric.connect(addr, src_gid=self._prefill_gid,
                                      depth=256, flow_control=True,
                                      on_disconnect=lost)
        self._peer_lost = False
        self._active = idx
        self.ring = self.ep.peer.recv_cq.ring   # the header path (T3)

    def _failover(self):
        """Re-resolve the route to a surviving decode listener and
        reconnect. The dead connection's surviving (prefill) QP is torn
        down here; the dead node's side is already gone."""
        old = self.ep
        survivors = [i for i, a in enumerate(self._listen_addrs)
                     if self.fabric.alive(a.gid)
                     and a.qpn in self.fabric._listeners]
        if not survivors:
            raise verbs.QPStateError(
                "KV transfer failover: no surviving decode listener")
        self.fabric.routes.pop(old.qp.qp_num, None)
        self.fabric.gid_of.pop(old.qp.qp_num, None)
        self.fabric.endpoints.pop(old.qp.qp_num, None)
        old.qp.destroy()
        self.route_reresolutions += 1
        self._connect_to(survivors[-1])

    @property
    def decode_gid(self) -> str:
        """The gid of the decode listener currently connected (changes
        on failover — `migrate_pages` retarget callbacks read it)."""
        return self._listen_addrs[self._active].gid

    def retarget(self, gid: str):
        """Point the transfer connection at a specific decode listener
        (a router placing a request on the least-loaded decode pod).
        No-op when already connected there and healthy."""
        if self.decode_gid == gid and not self._peer_lost:
            return self
        for i, a in enumerate(self._listen_addrs):
            if a.gid == gid and self.fabric.alive(gid) \
                    and a.qpn in self.fabric._listeners:
                if self.ep.qp.qp_num in self.fabric.qps:
                    self.fabric.disconnect(self.ep)
                self._connect_to(i)
                return self
        raise verbs.QPStateError(f"no live decode listener at {gid!r}")

    def _migrate_once(self, runs) -> bool:
        """One attempt at a page migration: the whole run list posts as
        ONE RDMA_WRITE chain (one doorbell, one descriptor-fetch DMA),
        one WR *per page* so a run of pages from the same local MR is a
        maximal same-MR segment for `_fused_mr_rows` — ONE
        `gather_records` launch per leaf run on the source, and one
        stacked scatter per leaf region at the peer context flush.

        A run list of more WRs than the send queue holds posts as
        consecutive chains of at most `max_send_wr` WRs, each flushed
        and polled before the next (ROADMAP Queue 3): the reference posts
        it whole, gets "send queue full", reads that as a dead peer and
        fails over until its replays run out."""
        if self._peer_lost:
            return False
        wrs = []
        for mr, src_ids, rkey, dst_ids in runs:
            src_ids = np.asarray(src_ids, np.int64).ravel()
            dst_ids = np.asarray(dst_ids, np.int64).ravel()
            for s, t in zip(src_ids, dst_ids):
                self._wr_id += 1
                wrs.append(verbs.SendWR(
                    wr_id=self._wr_id, opcode=verbs.IBV_WR_RDMA_WRITE,
                    mr=mr, offsets=np.asarray([s], np.int64),
                    remote_key=int(rkey),
                    remote_offsets=np.asarray([t], np.int64),
                    signaled=True))
        step = self.ep.qp.max_send_wr
        # an empty run list still posts one (empty) chain, as before
        for i in range(0, max(len(wrs), 1), step):
            try:
                self.ep.post_send(wrs[i:i + step])
                self.ep.flush()
            except verbs.QPStateError:
                return False                # peer (or connection) gone
            if self._peer_lost:
                self.ep.poll()              # drain WR_FLUSH_ERR
                return False
            wcs = self.ep.poll()
            if not wcs or not all(wc.ok for wc in wcs):
                return False
        return True

    def migrate_pages(self, runs, *, retarget=None):
        """Move KV pages pod->pod as one-sided RDMA_WRITEs.

        `runs` is a list of ``(mr, src_page_ids, remote_key,
        dst_page_ids)`` — local page-pool MR records written straight
        into the decode pod's pool regions (no recv WRs, no payload
        tree: cache state is DMA memory on both ends). On peer death the
        route re-resolves exactly like `transfer()`; since the surviving
        pod's pool has different rkeys/page ids, `retarget(decode_gid)`
        must return the replacement run list (re-reserved on the
        survivor) for the replay. Returns the gid the pages landed on."""
        ok = self._migrate_once(runs)
        replays = 0
        while not ok:
            if replays >= self.replay_limit:
                raise verbs.QPStateError(
                    f"page migration failed after {replays} replays")
            self._failover()
            self.transfers_replayed += 1
            replays += 1
            if retarget is not None:
                runs = retarget(self.decode_gid)
            ok = self._migrate_once(runs)
        self.pages_migrated += sum(
            int(np.asarray(r[1]).size) for r in runs)
        return self.decode_gid

    def close(self):
        """Release every fabric registration this engine holds
        (listeners, both QPs, routes, SRQ membership): a long-lived
        shared fabric must not grow state per short-lived engine."""
        for addr in self._listen_addrs:
            if addr.qpn in self.fabric._listeners:
                self.fabric.unlisten(addr)
        if self.ep.qp.qp_num in self.fabric.qps:
            self.fabric.disconnect(self.ep)
        return self

    def _send_once(self, caches, staged: bool):
        """One transfer attempt on the current connection. Returns
        ``(delivered, ok)``; not-ok means the decode peer died (before,
        or — via the kill-mid-flush fault trigger — during the SEND) and
        the caller should fail over and replay."""
        if self._peer_lost:
            return None, False
        pool = self.ep.peer.qp.srq
        self._wr_id += 1
        try:
            if pool is not None and len(pool) < 1:
                pool.post_recv([verbs.RecvWR(wr_id=self._wr_id)])
            self.ep.post_send(verbs.SendWR(
                wr_id=self._wr_id, payload=caches,
                spec_tree=self.spec_tree, inline=False))
            self.ep.flush()
        except verbs.QPStateError:
            return None, False              # peer (or connection) gone
        if self._peer_lost:
            # the kill landed mid-flush: our in-flight WR drained as
            # WR_FLUSH_ERR (visible on the send CQ) — nothing delivered
            self.ep.poll()
            return None, False
        for wc in self.ep.poll():           # retire the send completion
            if not wc.ok:
                return None, False
        wcs = self.ep.peer.recv_cq.poll()
        if not wcs:
            return None, False
        assert wcs[-1].ok, \
            f"transfer completion status {wcs[-1].status}"
        return wcs[-1].data, True

    def _send(self, caches, staged: bool):
        self.stats = account(caches, self.plan)
        self.fabric.plan = self.plan
        self.fabric.staged = staged
        data, ok = self._send_once(caches, staged)
        replays = 0
        while not ok:
            if replays >= self.replay_limit:
                raise verbs.QPStateError(
                    f"KV transfer failed after {replays} replays")
            self._failover()
            self.transfers_replayed += 1
            replays += 1
            data, ok = self._send_once(caches, staged)
        return data

    def transfer(self, caches):
        """FlexiNS path: headers on the CQ ring, payload via striped
        ppermute."""
        return self._send(caches, staged=False)

    def transfer_many(self, cache_list):
        """Several cache trees in ONE doorbell: the SENDs are staged as a
        single WQE chain (one descriptor-fetch DMA for the whole batch)
        and the decode pool absorbs them from the SRQ. Returns received
        trees in order."""
        self.fabric.plan = self.plan
        self.fabric.staged = False
        per = [account(c, self.plan) for c in cache_list]
        self.stats = TransferStats(
            n_leaves=sum(s.n_leaves for s in per),
            payload_bytes=sum(s.payload_bytes for s in per),
            header_bytes=sum(s.header_bytes for s in per))
        base = self._wr_id + 1              # same sequence transfer() uses
        self._wr_id += len(cache_list)
        wcs = self.ep.send_many(cache_list, wr_id=base,
                                spec_tree=self.spec_tree, inline=False)
        for wc in wcs:
            assert wc.ok, f"transfer completion status {wc.status}"
        self.ep.poll()                      # retire the send completions
        return [wc.data for wc in wcs]

    def transfer_staged(self, caches):
        """Naive baseline (replicate-then-move)."""
        return self._send(caches, staged=True)

    def make_transfer_step(self, staged: bool = False):
        """A cache -> cache function (dry-run / benchmarks): the payload
        path of the SEND, without the control plane."""
        send = tx_engine.transmit_staged if staged else tx_engine.transmit

        def step(caches):
            return send(caches, self.spec_tree, self.plan)
        return step
