"""Distributed attention strategies + partial-softmax merging.

The port of the reference's `repro.parallel.collectives`. Strategy
auto-selection for full-sequence attention on a `model` mesh axis of
size M (heads H, kv-heads KVH), as the reference's:

  M == 1                -> local chunked attention (the flash kernel)
  KVH % M == 0          -> head-TP, grouped KV stays grouped
  H % M == 0            -> head-TP with KV repeated to H heads
  S % M == 0            -> context parallelism: q sharded on sequence
                           (phi4 H=24, gemma H=8, whisper H=8,
                           recurrentgemma H=10 land here on a model=16
                           mesh)
  otherwise             -> local

Decode uses KV-sequence parallelism: each rank produces flash-decode
partials (acc, m, l) over its S/M cache positions, and `merge_partials`
combines them exactly (a MAX, then two SUM reductions). MLA's absorbed
mode (`v_dims`: the values are the latent's first columns) is kept. The
hybrids decode against a rolling window cache
(`window_decode_attention`), locally.

The functions keep the reference's global view: the same argument and
result shapes, so the model code calls them unchanged. The reference
partitions global arrays with `shard_map`; here every rank of the mesh
holds the whole (replicated) tensors, so nothing has to be gathered
before a rank computes: it takes its rows by its coordinate on `model`
(`sharding.axis_index`) and runs the local computation — `_cp_rank`,
the flash kernel over its query rows against the whole K/V at
`q_offset` = the shard's first row; `_decode_shard`, the partials over
its cache rows of the cache updated whole — and the collectives over
that axis's process group (`sharding.axis_group`) rebuild the global
result on every rank: the outputs all-gathered on the sequence, the
decode partials all-reduced (`_merge`). Batch axes (pod, data) are not
split: each data row computes the same values. The collectives are
`torch.distributed`'s and record no gradient (training on a mesh comes
later). The per-rank functions are plain, so one process can run every
rank of an axis in turn and merge with stacked reductions.

In this slice the head-TP branches compute the local result on the
whole tensors: the weights are replicated until the sharded FFN and
attention weights come (ROADMAP slice 8c), so they compute what the
reference computes. The K/V all-gather of context parallelism and the
per-shard cache writes come with the sharded caches there too.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import (chunked_attention, decode_partials,
                                          finalize_partials)
from repro_torch.parallel import sharding


# --------------------------------------------------------------------------
# Partial-softmax merge (numerically exact)
# --------------------------------------------------------------------------
def _merge(acc, m, l, reduce):
    """m_g = max m, l_g = sum l e^(m - m_g), acc_g likewise, where
    `reduce(t, op)` reduces t over the shards by op ("max" or "sum").
    Returns (acc_g, l_g)."""
    m_g = reduce(m, "max")
    c = torch.exp(m - m_g)
    l_g = reduce(l * c, "sum")
    acc_g = reduce(acc * c[..., None], "sum")
    return acc_g, l_g


def merge_partials(acc, m, l, group):
    """Combine per-shard (acc, m, l) over the ranks of `group`. Returns
    (acc_g, l_g), the same on every rank."""
    import torch.distributed as dist
    ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}

    def all_reduce(t, op):
        t = t.clone()
        dist.all_reduce(t, op=ops[op], group=group)
        return t
    return _merge(acc, m, l, all_reduce)


def _gather_seq(t, group, n):
    """The shards of `t` on dim 1 from the `n` ranks of `group`, in
    rank order, concatenated."""
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=1)


# --------------------------------------------------------------------------
# Full-sequence attention dispatcher
# --------------------------------------------------------------------------
def attend(q, k, v, *, causal=True, window=0, cap=0.0, sm_scale=None):
    """q: (B,S,KVH,G,Dk); k/v: (B,S,KVH,D*) -> (B,S,KVH,G,Dv)."""
    B, S, KVH, G, Dk = q.shape
    M = sharding.mesh_axis_size("model")
    kw = dict(causal=causal, window=window, cap=cap, sm_scale=sm_scale)
    if M > 1 and KVH % M and (KVH * G) % M and not S % M:
        return _context_parallel_attention(q, k, v, **kw)
    # M == 1, either head-TP branch (replicated weights) or no split
    return chunked_attention(q, k, v, **kw)


def _cp_rank(q, k, v, r, M, **kw):
    """Rank r's share of context parallelism over M ranks: its S/M
    query rows from s0 = r S/M, attended against the whole k/v at
    q_offset = s0. (B,S/M,KVH,G,Dv)."""
    n = q.shape[1] // M
    s0 = r * n
    return chunked_attention(q[:, s0:s0 + n], k, v, q_offset=s0, **kw)


def _context_parallel_attention(q, k, v, **kw):
    """Queries sharded on sequence over `model`: this rank attends its
    S/M rows (`_cp_rank`, against the K/V it holds whole); the rows are
    all-gathered back."""
    M = sharding.mesh_axis_size("model")
    r, group = sharding.axis_index("model"), sharding.axis_group("model")
    return _gather_seq(_cp_rank(q, k, v, r, M, **kw), group, M)


# --------------------------------------------------------------------------
# Decode: KV-sequence-parallel flash-decode
# --------------------------------------------------------------------------
def _update(cache, new, p):
    """Per-request write of `new` at index p (rows whose p lies outside
    the cache keep their content). A new tensor: the caller's cache is
    left as it was, as the reference's functional update leaves it."""
    S = cache.shape[1]
    in_range = (p >= 0) & (p < S)
    rows = torch.arange(cache.shape[0], device=cache.device)
    upd = cache.index_put((rows, p.clamp(0, S - 1)), new.to(cache.dtype))
    # a where, not a boolean index: no host sync on the card
    return torch.where(in_range[:, None, None, None], upd, cache)


def seqparallel_decode_attention(q, k_cache, v_cache, k_new, v_new, pos, *,
                                 cap=0.0, sm_scale=None, v_dims=None):
    """One-token decode against a sequence-sharded KV cache.

    q: (B,KVH,G,Dk); caches: (B,S,KVH,D*); new entries: (B,KVH,D*);
    pos: scalar or (B,) int (index where the new entry is written;
    attention covers positions [0, pos]). Returns (out (B,KVH,G,Dv),
    k_cache, v_cache).

    v_dims: MLA's absorbed mode — V is k_cache[..., :v_dims] (the
    shared latent); v_cache and v_new are ignored and v_cache comes
    back as None. With no mesh, M == 1 or S off a multiple of M, the
    whole cache is one shard.
    """
    B, S = k_cache.shape[:2]
    pos = torch.as_tensor(pos, device=q.device).long().broadcast_to((B,))
    M = sharding.mesh_axis_size("model")
    k_cache = _update(k_cache, k_new, pos)
    if v_dims is not None:
        v_eff, v_cache = k_cache[..., :v_dims], None
    else:
        v_cache = _update(v_cache, v_new, pos)
        v_eff = v_cache
    if M > 1 and not S % M:
        acc, l = _sharded_decode(q, k_cache, v_eff, pos, M, cap=cap,
                                 sm_scale=sm_scale)
    else:
        acc, _, l = decode_partials(q, k_cache, v_eff,
                                    torch.arange(S, device=q.device), pos,
                                    cap=cap, sm_scale=sm_scale)
    return finalize_partials(acc, l).to(q.dtype), k_cache, v_cache


def _decode_shard(q, k_cache, v_eff, pos, r, M, **kw):
    """Rank r's decode partials (acc, m, l) over its S/M cache rows from
    s0 = r S/M, at their absolute positions."""
    n = k_cache.shape[1] // M
    s0 = r * n
    return decode_partials(q, k_cache[:, s0:s0 + n], v_eff[:, s0:s0 + n],
                           s0 + torch.arange(n, device=q.device), pos, **kw)


def _sharded_decode(q, k_cache, v_eff, pos, M, **kw):
    """The sharded branch: this rank's partials (`_decode_shard`),
    merged over `model`. Returns (acc_g, l_g)."""
    r, group = sharding.axis_index("model"), sharding.axis_group("model")
    acc, m, l = _decode_shard(q, k_cache, v_eff, pos, r, M, **kw)
    return merge_partials(acc, m, l, group)


def window_decode_attention(q, k_win, v_win, k_new, v_new, pos, window: int,
                            *, cap=0.0, sm_scale=None):
    """One-token decode against a rolling window cache (B,W,KVH,D*):
    token p lives in slot p mod W. pos: scalar or (B,) per-request
    positions (the new entry's). Slot j of request b holds token
    pos - ((pos - j) mod W); the slots not yet written (a token before
    0) and, where W exceeds the window, the tokens that left it are
    masked. Returns (out (B,KVH,G,Dv), k_win, v_win), new tensors."""
    B, W = k_win.shape[0], k_win.shape[1]
    pos = torch.as_tensor(pos, device=q.device).long().broadcast_to((B,))
    slot = pos % W
    rows = torch.arange(B, device=q.device)
    k_win = k_win.index_put((rows, slot), k_new.to(k_win.dtype))
    v_win = v_win.index_put((rows, slot), v_new.to(v_win.dtype))
    slots = torch.arange(W, device=q.device)
    token_of_slot = pos[:, None] - ((pos[:, None] - slots[None]) % W)
    valid = token_of_slot >= 0
    if window < W:
        valid &= token_of_slot > pos[:, None] - window
    acc, m, l = decode_partials(q, k_win, v_win, token_of_slot, pos,
                                cap=cap, extra_mask=valid,
                                sm_scale=sm_scale)
    return finalize_partials(acc, l).to(q.dtype), k_win, v_win
