"""Batched serving engine.

The port of the reference's `repro.serve.engine`. Request flow (the
FlexiNS verbs path, through `repro_torch.verbs`):
  submit()  — the app is a verbs *client*: it posts an inline SEND whose
              64B payload is the request descriptor (req id, prompt
              length); the WQE rides the header path, the prompt payload
              lands in a pinned token table, never on the wire
              (header/payload split);
  step()    — the engine is the *server* QP: it polls its recv CQ — the
              T3 notification ring, drained batched — prefills new
              requests, and runs one batched decode step across all
              active slots with per-slot positions (continuous batching).

When the model is `pageable`, the dense per-slot cache is a `PagePool`
of MR-backed KV pages and the decode step reads them through a slot ->
page-table indirection (`make_paged_step`): the engine is a decode
*pod* whose pages a prefill pod can `reserve()` and RDMA_WRITE into,
going live with an OP_KV_ACTIVATE descriptor on the same ring. Prompt
lengths are bucketed to powers of two (`bucketable` models), and
`prefill_compiles` counts the distinct padded prefill lengths, as the
reference counts its prefill compilations; the port runs eagerly, so
nothing is compiled.

Finished requests leave the engine: their slot pages are freed and the
`requests` / `pinned_prompts` entries deleted at retire time (and in
`close()`); the output tokens move to `_finished`, which the caller
owns via `run_until_done()`'s return value.

Tensors (tokens, positions, caches) live on the fabric's device, which
must be the parameters' device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import tree, verbs
from repro_torch.core.descriptors import (OP_KV_ACTIVATE, OP_KV_WRITE,
                                          make_descriptor)
from repro_torch.obs import metrics
from repro_torch.serve.kvcache import pad_caches
from repro_torch.serve.paged import (PagePool, bucket_len, bucketable,
                                     make_paged_step, pageable)


@dataclass
class Request:
    req_id: int
    prompt: list
    max_new_tokens: int
    out_tokens: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    # per-tenant telemetry (`serve{i}/...` in the registry): requests
    # posted through the verbs client side, pool refills the SRQ
    # watermark doorbell triggered, connected clients the fabric
    # reported dead (the listener's CM DISCONNECTED event), and distinct
    # padded prefill lengths seen (the reference's compilations)
    requests_submitted = metrics.counter_attr()
    srq_refills = metrics.counter_attr()
    client_disconnects = metrics.counter_attr()
    prefill_compiles = metrics.counter_attr()

    def __init__(self, model, params, *, max_batch: int = 4,
                 max_seq: int = 256, ring_capacity: int = 64,
                 vectorized: bool = True, fabric=None,
                 device_ring: bool | None = None, gid: str | None = None,
                 service: str | None = None, paged: bool | None = None,
                 page_tokens: int = 16):
        metrics.instance_scope(self, "serve", indexed=True)
        self.requests_submitted = 0
        self.srq_refills = 0
        self.client_disconnects = 0
        self.prefill_compiles = 0
        # levels are owned by engine state — sample, don't mirror
        metrics.weak_probe(self._metrics, "slots_active", self,
                           lambda e: sum(1 for s in e.slots
                                         if s is not None))
        metrics.weak_probe(self._metrics, "requests_pending", self,
                           lambda e: sum(1 for r in e.requests.values()
                                         if not r.done))
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        # the engine is a fabric tenant: its listener's QPs draw landing
        # buffers from the FABRIC-scope recv pool, armed with a low
        # watermark whose limit event (not a depth poll) is the refill
        # doorbell; the CM drives all QP bring-up
        self.fabric = fabric if fabric is not None else \
            verbs.Fabric(vectorized=vectorized)
        self.device = self.fabric.device
        self.srq = self.fabric.shared_srq(max_wr=max(256, 4 * max_batch))
        self.fabric.on_srq_limit(self._refill_srq)
        # device_ring=True pins the submit ring device-resident AND arms
        # the fused publish+poll: an admitting step is ONE produce_consume
        # launch (submits are unsignaled inline SENDs, launch-free)
        self.gid = gid or self.fabric.gids[0]
        cm = self.fabric.node(self.gid)
        self._listen_addr = cm.listen(service=service,
                                      depth=ring_capacity,
                                      max_wr=max(256, 2 * max_batch),
                                      srq="fabric",
                                      on_disconnect=self._client_lost,
                                      device_ring=device_ring)
        self.ep = self.fabric.connect(self._listen_addr,
                                      src_gid=self.gid,
                                      depth=ring_capacity,
                                      max_wr=max(256, 2 * max_batch),
                                      device_ring=device_ring)
        self._refill_srq(self.srq)
        self.ring = self.ep.peer.recv_cq.ring       # the T3 header pipe
        if self.ring.device:
            self.ep.peer.recv_cq.enable_fused_poll()
        self.pinned_prompts: dict[int, np.ndarray] = {}   # payload table
        self.requests: dict[int, Request] = {}
        self._finished: dict[int, list] = {}
        self._reserved: dict[int, tuple] = {}       # rid -> pre-admitted
        self.slots: list[int | None] = [None] * max_batch
        self.positions = np.zeros((max_batch,), np.int32)
        self._next_id = 0
        self._seen_prefill_lens: set[int] = set()
        self.paged = pageable(model) if paged is None else paged
        self.bucketed = bucketable(model)
        if self.paged:
            # cache state on this pod's protection domain: one MR per
            # cache leaf, record = one page — remotely addressable
            self.pool = PagePool(model, cm.pd, max_batch=max_batch,
                                 max_seq=max_seq, page_tokens=page_tokens)
            self._paged_step = make_paged_step(model, self.pool)
            self.caches = None
        else:
            self.pool = None
            self.caches = model.init_cache(max_batch, max_seq,
                                           device=self.device)
            # what a prefill's caches are padded to, leaf by leaf
            self._slot_specs = model.cache_specs(1, max_seq)
        self._decode = model.decode_step
        self._prefill = model.prefill

    def close(self):
        """Release every registration this engine holds on the fabric
        (listener, both QPs, routes, SRQ membership, the page-pool MRs,
        and the refill doorbell): a short-lived engine on a long-lived
        shared fabric must leak nothing."""
        self.srq.remove_on_limit(self._refill_srq)
        if self._listen_addr.qpn in self.fabric._listeners:
            self.fabric.unlisten(self._listen_addr)
        if self.ep.qp.qp_num in self.fabric.qps:
            self.fabric.disconnect(self.ep)
        if self.paged:
            self.pool.close()
        self.pinned_prompts.clear()
        self.requests.clear()
        self._finished.clear()
        self._reserved.clear()
        return self

    # -- client side --------------------------------------------------------
    def submit(self, prompt: list, max_new_tokens: int = 16) -> int:
        rid = self._next_id
        self._next_id += 1
        self.requests_submitted += 1
        self.pinned_prompts[rid] = np.asarray(prompt, np.int32)
        self.requests[rid] = Request(rid, list(prompt), max_new_tokens)
        self._post_descriptor(make_descriptor(OP_KV_WRITE, src=rid,
                                              length=len(prompt)))
        return rid

    def _client_lost(self, _ep):
        """Listener-level CM DISCONNECTED event: a connected client's
        node died (or hung up). In-flight requests from that client have
        already drained as WR_FLUSH_ERR; here we only account."""
        self.client_disconnects += 1

    def _refill_srq(self, srq):
        """SRQ limit event: top the shared pool back up to 2x batch and
        re-arm the watermark."""
        want = self.max_batch * 2
        if len(srq) < want:
            srq.post_recv([verbs.RecvWR() for _ in range(want - len(srq))])
            self.srq_refills += 1
        srq.arm(self.max_batch)

    def _post_descriptor(self, descs):
        """Inline verbs SEND(s): each 64B request descriptor IS the
        payload (unsignaled — the recv completion is the notification).
        A list is staged as one WQE chain and rings ONE doorbell."""
        if not isinstance(descs, list):
            descs = [descs]
        self.ep.post_send([
            verbs.SendWR(wr_id=int(d[1]), payload=np.asarray(d, np.int64),
                         inline=True, signaled=False) for d in descs])

    # -- disaggregated admission (decode-pod side) ----------------------
    def reserve(self, rid: int, prompt_len: int, max_new_tokens: int,
                first_token: int) -> list[tuple]:
        """Decode-side half of a disaggregated admit: allocate the
        request's pages up front and hand back the migration lease —
        per-leaf ``(rkey, page_ids)`` — that the prefill pod's
        RDMA_WRITEs target. The request goes live (binds a slot) only
        when its OP_KV_ACTIVATE descriptor arrives, i.e. after the
        pages have landed."""
        if not self.paged:
            raise ValueError("reserve() requires the paged KV pool")
        n = min(self.pool.pages_for(prompt_len + max_new_tokens + 1),
                self.pool.pages_per_slot)
        ids = self.pool.alloc(n)
        self._reserved[rid] = (ids, prompt_len, max_new_tokens,
                               int(first_token))
        return self.pool.lease(ids[:self.pool.pages_for(prompt_len)])

    def _activate(self, slot: int, rid: int):
        """OP_KV_ACTIVATE arrived: the reserved pages now hold the
        migrated prefill — bind them to a slot and start decoding. A
        stale rid (re-reserved on another pod after a failover replay)
        is dropped: the replacement activation carries the request."""
        res = self._reserved.pop(rid, None)
        if res is None:
            return
        ids, plen, max_new, first_tok = res
        req = Request(rid, [], max_new)
        req.out_tokens.append(first_tok)
        self.requests[rid] = req
        self.pool.bind_slot(slot, ids)
        self.positions[slot] = plen - 1
        self.slots[slot] = rid

    # -- engine side ----------------------------------------------------
    def _free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def _run_prefill(self, prompt: np.ndarray):
        """Prefill one prompt, padded to its power-of-two bucket when
        the model allows (`bucketable`): the engine meets O(log max_seq)
        distinct prefill lengths instead of one per prompt length, and
        `last_pos` keeps the first sampled token what an unpadded
        prefill gives. Returns (logits, caches, padded_len)."""
        plen = int(prompt.size)
        pad = bucket_len(plen, self.max_seq) if self.bucketed else plen
        if pad not in self._seen_prefill_lens:
            self._seen_prefill_lens.add(pad)
            self.prefill_compiles += 1
        if self.bucketed:
            padded = np.zeros((1, pad), np.int32)
            padded[0, :plen] = prompt
            logits, caches = self._prefill(
                self.params, self._tokens(padded),
                last_pos=self._tokens(np.asarray([plen - 1])))
        else:
            logits, caches = self._prefill(self.params,
                                           self._tokens(prompt[None, :]))
        return logits, caches, pad

    def _admit(self):
        # top up shared recv credits (the SRQ limit event normally does
        # this; the direct call covers the cold start), then ring the
        # doorbell: pending WQEs (incl. RNR-stalled re-posts) deliver,
        # CQEs land batched on the ring
        if len(self.srq) < self.max_batch:
            self._refill_srq(self.srq)
        self.ep.flush()
        pending = [wc.data for wc in self.ep.peer.recv_cq.poll()]
        for i, d in enumerate(pending):
            slot = self._free_slot()
            if slot is None:
                # re-post EVERY remaining drained descriptor as ONE
                # doorbell-batched chain: the verbs queues absorb the
                # burst (paper's burst argument), nothing drops
                self._post_descriptor([np.asarray(d2)
                                       for d2 in pending[i:]])
                break
            if int(d[0]) == OP_KV_ACTIVATE:
                self._activate(slot, int(d[1]))
            else:
                self._admit_local(slot, int(d[1]))

    def _admit_local(self, slot: int, rid: int):
        """Same-pod admission: prefill here, land the caches in this
        pod's own pool (paged) or dense slot."""
        req = self.requests[rid]
        prompt = self.pinned_prompts[rid]
        plen = int(prompt.size)
        logits, caches, padded = self._run_prefill(prompt)
        req.out_tokens.append(int(torch.argmax(logits[0, -1])))
        if self.paged:
            n = min(self.pool.pages_for(plen + req.max_new_tokens + 1),
                    self.pool.pages_per_slot)
            ids = self.pool.alloc(n)
            self.pool.fill(ids[:self.pool.pages_for(plen)], caches)
            self.pool.bind_slot(slot, ids)
            self.positions[slot] = plen - 1
        else:
            caches = pad_caches(caches, padded, self.max_seq,
                                self._slot_specs)
            self._install(slot, caches, plen)
        self.slots[slot] = rid

    def _install(self, slot: int, caches, prompt_len: int):
        """Copy a padded prefill's caches (batch 1) into `slot` of every
        leaf: sequence, window and recurrent-state leaves alike."""
        def put(dst, src):
            if dst.ndim >= 2:
                dst[:, slot:slot + 1] = src
            return dst
        self.caches = tree.map(put, self.caches, caches)
        self.positions[slot] = prompt_len - 1

    def step(self) -> int:
        """One engine iteration: admit from ring, one batched decode step.
        Returns number of active slots."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        tokens = np.zeros((self.max_batch, 1), np.int32)
        for i in active:
            tokens[i, 0] = self.requests[self.slots[i]].out_tokens[-1]
        pos = self._tokens(self.positions + 1)               # write index
        if self.paged:
            # table-indirected decode: gather pages, step, write the
            # updated pages back in place; RDMA-migrated pages are
            # picked up through the region arguments
            logits, regions = self._paged_step(
                self.params, self._tokens(tokens), self.pool.table, pos,
                self.pool.regions())
            self.pool.rebind(regions)
        else:
            logits, self.caches = self._decode(
                self.params, self._tokens(tokens), self.caches, pos)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for i in active:
            rid = self.slots[i]
            req = self.requests[rid]
            req.out_tokens.append(int(nxt[i]))
            self.positions[i] += 1
            if len(req.out_tokens) >= req.max_new_tokens or \
                    self.positions[i] >= self.max_seq - 2:
                req.done = True
                self.slots[i] = None
                if self.paged:
                    self.pool.free(self.pool.clear_slot(i))
                # retention fix: done requests leave the live dicts —
                # results move to _finished, owned by the caller
                self._finished[rid] = req.out_tokens
                del self.requests[rid]
                self.pinned_prompts.pop(rid, None)
        return len(active)

    def run_until_done(self, max_iters: int = 1000):
        for _ in range(max_iters):
            # the CQ length counts ring occupancy PLUS staged CQEs —
            # under fused poll a flush defers staging to the next poll,
            # so len(self.ring) alone would miss pending work
            if not self.step() and not len(self.ep.peer.recv_cq):
                if not self.requests:
                    break
        out = dict(self._finished)
        out.update({rid: r.out_tokens for rid, r in self.requests.items()})
        return out
