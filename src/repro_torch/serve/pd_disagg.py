"""Prefill/decode disaggregation (paper §5.7 KVCache-transfer workload).

A prefill engine produces KV caches; a verbs SEND on a mesh-transport QP
ships them over the `pod` axis; the decode engine ingests them into its
paged pool and serves decode steps. In one process the pod axis is the
identity transfer (`core.tx_engine`), but every API, layout and
descriptor path is the production one.

`PrefillPod` is one prefill pod of the serving cluster: it prefills a
prompt, stages the caches in pages on its own protection domain and
moves them into a decode pod's reserved pages as one-sided RDMA_WRITEs
(`KVTransferEngine.migrate_pages`), then sends the go-live descriptor.

The port of the reference's `repro.serve.pd_disagg`. Tensors live on
the parameters' device: `device=None` takes the fabric's device, or the
package default when there is no fabric. `PDServer` takes the
reference's options with its defaults: `vectorized` (the transfer leg's
batch-wise dispatch, its scalar oracle when False), `staged` (the
replicate-then-move baseline, `KVTransferEngine.transfer_staged`) and
`use_kernel`, which is accepted and ignored: the device picks the
kernel route, as in `rx_engine.ingest` and `PagedKVPool.ingest`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import verbs
from repro_torch.core.descriptors import (OP_KV_ACTIVATE, TransferPlan,
                                          make_descriptor)
from repro_torch.core.kvtransfer import KVTransferEngine
from repro_torch.device import resolve
from repro_torch.obs import metrics
from repro_torch.serve.kvcache import pad_caches, page_roundtrip
from repro_torch.serve.paged import PagePool, bucket_len, bucketable, pageable


def _tokens(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


class PDServer:
    def __init__(self, model, params, *, max_seq: int = 128,
                 page_tokens: int = 16, quantize_bits: int = 0,
                 vectorized: bool = True, fabric=None, device=None):
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.max_seq = max_seq
        self.page_tokens = page_tokens
        self.plan = TransferPlan(quantize_bits=quantize_bits)
        # batch-wise verbs dispatch on the transfer leg (scalar oracle
        # when False); threaded into the KVTransferEngine per transfer
        self.vectorized = vectorized
        # optional shared verbs fabric: when given, every transfer's
        # KVTransferEngine rides it (and its fabric-scope recv pool)
        # instead of spanning a private 2-pod grid per transfer
        self.fabric = fabric
        self.device = fabric.device if fabric is not None and device is None \
            else resolve(device)

    # -- prefill pod ----------------------------------------------------
    def prefill(self, prompts: np.ndarray):
        """prompts: (B, P). Returns (first_tokens, caches, prefill_len)."""
        logits, caches = self.model.prefill(self.params,
                                            _tokens(prompts, self.device))
        first = torch.argmax(logits[:, -1], dim=-1)
        return first, caches, prompts.shape[1]

    # -- the wire ---------------------------------------------------------
    def transfer(self, caches, batch: int, seq_len: int, staged=False):
        """One verbs SEND per transfer: prefill is the client QP, decode
        the server; headers ride the CQ ring, payload the mesh wire.
        Delegates to KVTransferEngine — decode-side SRQ pool + CQ-credit
        flow control come with it, and the transfer path lives in ONE
        place. `staged` sends through the replicate-then-move baseline."""
        fabric = self.fabric if self.fabric is not None else verbs.Fabric(
            pods=2, plan=self.plan, vectorized=self.vectorized,
            device=self.device)
        eng = KVTransferEngine(self.model, batch, seq_len, self.plan,
                               vectorized=self.vectorized, fabric=fabric)
        try:
            data = eng.transfer_staged(caches) if staged else \
                eng.transfer(caches)
        finally:
            if self.fabric is not None:
                # per-transfer engine on a LONG-LIVED shared fabric:
                # release its listener/QPs/routes or the fabric grows
                # per call
                eng.close()
        return data, eng.stats

    # -- decode pod (with paged ingest) ----------------------------------
    def ingest_and_decode(self, caches, first_tokens, prefill_len: int,
                          n_steps: int = 8, use_kernel: bool = False):
        """Ingest transferred caches through the paged pool (T2), gather
        back to the decode layout, then run greedy decode steps. Each
        leaf is padded as its cache spec says (`pad_caches`), and only
        the sequence-indexed leaves take the page round trip: window and
        state leaves pass through, where the reference pads a window
        leaf shorter than the window to `max_seq` and pages it.
        `use_kernel` is the reference's and is ignored: the device picks
        the route (the kernel on the card, the plain version on the
        CPU)."""
        del use_kernel
        B = first_tokens.shape[0]
        specs = self.model.cache_specs(B, self.max_seq)
        caches = pad_caches(caches, prefill_len, self.max_seq, specs)
        caches = page_roundtrip(caches, self.max_seq, self.page_tokens,
                                specs)
        toks = first_tokens.reshape(B, 1).to(torch.int32)
        out = [toks[:, 0].cpu().numpy()]
        pos = torch.full((B,), prefill_len, dtype=torch.int32,
                         device=self.device)
        for _ in range(n_steps):
            logits, caches = self.model.decode_step(self.params, toks,
                                                    caches, pos)
            toks = torch.argmax(logits[:, :1], dim=-1).to(torch.int32)
            out.append(toks[:, 0].cpu().numpy())
            pos = pos + 1
        return np.stack(out, 1)

    # -- end to end -------------------------------------------------------
    def serve(self, prompts: np.ndarray, n_steps: int = 8, staged=False,
              use_kernel: bool = False):
        first, caches, plen = self.prefill(prompts)
        caches, stats = self.transfer(caches, prompts.shape[0], plen,
                                      staged=staged)
        toks = self.ingest_and_decode(caches, first, plen, n_steps,
                                      use_kernel=use_kernel)
        return toks, stats


class PrefillPod:
    """One prefill pod of a disaggregated serving cluster.

    The pod owns a single-slot staging `PagePool` on its OWN protection
    domain: a prompt is prefilled here (bucketed to a power-of-two pad
    when the model allows), its caches land in staged pages, and the
    pages move to a decode pod as one-sided RDMA_WRITEs through
    `KVTransferEngine.migrate_pages` — one WR per page, fusing to ONE
    gather launch per cache leaf. The request then goes live with an
    inline OP_KV_ACTIVATE descriptor SENT to the decode engine's own
    notification ring (the same ring `submit()` uses), which is also the
    admission-counted traffic a seeded `FaultModel.kill_after` can take
    the decode pod down with mid-run: migration AND activation replay
    through the surviving pod, re-reserving pages there first.

    `reserve()` is called directly on the decode `ServeEngine` object —
    the control-plane RPC of the real system, kept as a method call on
    this in-process rig; the *data* plane (pages, activation) is all
    verbs traffic.

    `prefill_compiles` keeps its name and meaning: distinct padded
    prefill lengths, though nothing is compiled.
    """

    prefill_compiles = metrics.counter_attr()
    requests_processed = metrics.counter_attr()

    def __init__(self, model, params, *, fabric, gid: str,
                 decode_gids: list[str], max_seq: int = 256,
                 page_tokens: int = 16):
        metrics.instance_scope(self, "prefillpod", indexed=True)
        if not pageable(model):
            raise ValueError("PrefillPod needs a pageable cache")
        self.prefill_compiles = 0
        self.requests_processed = 0
        self.model = model
        self.params = params
        self.fabric = fabric
        self.device = fabric.device
        self.gid = gid
        self.max_seq = max_seq
        self.bucketed = bucketable(model)
        self.pool = PagePool(model, fabric.node(gid).pd, max_batch=1,
                             max_seq=max_seq, page_tokens=page_tokens)
        self.kv = KVTransferEngine(model, 1, max_seq, fabric=fabric,
                                   src_gid=gid, decode_gids=decode_gids)
        self._seen_lens: set[int] = set()
        # per-decode-gid activation endpoints (to the ENGINE listeners,
        # not the kv transfer listeners): gid -> (ep, lost-flag box)
        self._act_eps: dict[str, tuple] = {}

    def close(self):
        for ep, _ in self._act_eps.values():
            if ep.qp.qp_num in self.fabric.qps:
                self.fabric.disconnect(ep)
        self._act_eps.clear()
        self.kv.close()
        self.pool.close()
        return self

    def _run_prefill(self, prompt: np.ndarray):
        plen = int(prompt.size)
        pad = bucket_len(plen, self.max_seq) if self.bucketed else plen
        if pad not in self._seen_lens:
            self._seen_lens.add(pad)
            self.prefill_compiles += 1
        if self.bucketed:
            padded = np.zeros((1, pad), np.int32)
            padded[0, :plen] = prompt
            return self.model.prefill(
                self.params, _tokens(padded, self.device),
                last_pos=_tokens([plen - 1], self.device))
        return self.model.prefill(self.params,
                                  _tokens(prompt[None, :], self.device))

    def _engine_ep(self, engine):
        """The (cached) activation connection to a decode engine's
        listener — made through the fabric address, like any client."""
        ent = self._act_eps.get(engine.gid)
        if ent is not None and (ent[1][0] or
                                ent[0].qp.qp_num not in self.fabric.qps):
            if ent[0].qp.qp_num in self.fabric.qps:
                self.fabric.disconnect(ent[0])
            self._act_eps.pop(engine.gid)
            ent = None
        if ent is None:
            lost = [False]

            def on_lost(_ep, lost=lost):
                lost[0] = True
            ep = self.fabric.connect(engine._listen_addr, src_gid=self.gid,
                                     depth=64, on_disconnect=on_lost)
            ent = self._act_eps[engine.gid] = (ep, lost)
        return ent

    def _activate_once(self, engine, rid: int, plen: int) -> bool:
        """Send the go-live descriptor to the decode engine's ring. False
        means the decode pod died before (or during — the kill-mid-flush
        trigger) the SEND: the caller fails over and replays."""
        ep, lost = self._engine_ep(engine)
        if lost[0]:
            return False
        d = make_descriptor(OP_KV_ACTIVATE, src=rid, length=plen)
        try:
            ep.post_send(verbs.SendWR(wr_id=rid,
                                      payload=np.asarray(d, np.int64),
                                      inline=True, signaled=False))
            ep.flush()
        except verbs.QPStateError:
            return False
        if lost[0]:
            ep.poll()                       # drain WR_FLUSH_ERR
            return False
        return True

    def process(self, rid: int, prompt, max_new_tokens: int,
                engines: dict, *, decode_gid: str | None = None) -> str:
        """One disaggregated request end to end: prefill here, stage
        pages, migrate them into the pages the chosen decode engine
        `reserve()`d, activate. Returns the gid that owns the request
        (the survivor, if the chosen pod died mid-flight)."""
        prompt = np.asarray(prompt, np.int32).ravel()
        plen = int(prompt.size)
        logits, caches = self._run_prefill(prompt)
        first_tok = int(torch.argmax(logits[0, -1]))
        src_ids = self.pool.alloc(self.pool.pages_for(plen))
        self.pool.fill(src_ids, caches)
        if decode_gid is not None:
            self.kv.retarget(decode_gid)

        def reserve_on(gid):
            lease = engines[gid].reserve(rid, plen, max_new_tokens,
                                         first_tok)
            return [(mr, src_ids, rkey, dst_ids)
                    for mr, (rkey, dst_ids) in zip(self.pool.mrs, lease)]

        try:
            runs = reserve_on(self.kv.decode_gid)
            landed = self.kv.migrate_pages(runs, retarget=reserve_on)
            for _ in range(self.kv.replay_limit + 1):
                if self._activate_once(engines[landed], rid, plen):
                    break
                # pod died between migrate and activation: same replay
                # as a mid-migrate death — survivor re-reserves, pages
                # re-migrate, activation re-sends
                self.kv._failover()
                runs = reserve_on(self.kv.decode_gid)
                landed = self.kv.migrate_pages(runs, retarget=reserve_on)
            else:
                raise verbs.QPStateError(
                    f"request {rid}: activation failed after "
                    f"{self.kv.replay_limit + 1} attempts")
        finally:
            self.pool.free(src_ids)
        self.requests_processed += 1
        return landed
