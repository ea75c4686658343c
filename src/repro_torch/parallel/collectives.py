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
(`window_decode_attention`; in a block program `blocks_window_decode`,
the rank's rows against its every-row block), locally.

The functions keep the reference's global view: the same argument and
result shapes, so the model code calls them unchanged. Each sharded
branch is a `sharding.shard_map` over one plain per-rank piece, as the
reference's is a `shard_map` over `lax` collectives:

  * head-TP (`_head_tp_attention`): K/V take the head-TP layout
    (`_head_tp_layout`: the kv heads grouped where M divides them, else
    K/V repeated to H heads, one query head a kv head), each rank runs
    the flash kernel over its block of heads, and the heads are
    gathered back; no collective inside;
  * context parallelism (`_context_parallel_attention`): each rank
    holds its S/M query rows; with K/V sequence-sharded the same way
    (`Sk == S`, `Sk % M == 0`) it all-gathers them, else it holds them
    whole, and attends at q_offset = its first row (`_cp_block`);
  * the sharded decode (`_sharded_decode`): each rank writes the new
    entry into its S/M cache rows at p - s0 and computes its partials
    over them (`_decode_shard`), and `merge_partials` combines them
    over `model`; with the "heads" cache layout (`force_local=`) each
    rank decodes its kv heads (`_local_decode`) with no collective.
    Every rank holds the whole caches, so the decode returns them
    updated by a local write of the new entry: no cache is gathered,
    only the attention output.

The per-rank pieces take the rank's block (and its first row s0), so
one process can run every rank of an axis in turn on the blocks and do
the collectives as stacked tensor ops (`chip_smoke.py` phases 12 and
13): `_cp_block`, `_decode_shard` with `_merge`, `_head_tp_layout` then
`chunked_attention`, `_local_decode`. Head-TP and context parallelism
carry gradients (`sharding.shard_map`'s transpose, the K/V all-gather's
psum_scatter; the flash kernel's forward on the card, its backward the
plain recompute at the rank's `q_offset`); the decodes run under
`torch.no_grad()` and their merge's `pmax` refuses an input that
requires grad.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.models.attention import (chunked_attention, decode_partials,
                                          finalize_partials)
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P


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


def merge_partials(acc, m, l, axis_name):
    """Combine per-shard (acc, m, l) over the ranks of mesh axis
    `axis_name` (a pmax, then two psums). Returns (acc_g, l_g), the
    same on every rank."""
    return _merge(acc, m, l, lambda t, op: (
        sharding.pmax if op == "max" else sharding.psum)(t, axis_name))


def _batch_spec_entry(B: int):
    axes = sharding.batch_axes_prefix(B)
    return axes if axes else None


# --------------------------------------------------------------------------
# Full-sequence attention dispatcher
# --------------------------------------------------------------------------
def attend(q, k, v, *, causal=True, window=0, cap=0.0, sm_scale=None):
    """q: (B,S,KVH,G,Dk); k/v: (B,Sk,KVH,D*) -> (B,S,KVH,G,Dv)."""
    S, KVH, G = q.shape[1:4]
    kw = dict(causal=causal, window=window, cap=cap, sm_scale=sm_scale)
    return {"local": chunked_attention, "head_tp": _head_tp_attention,
            "cp": _context_parallel_attention}[attend_branch(S, KVH, G)](
        q, k, v, **kw)


def attend_branch(S: int, KVH: int, G: int) -> str:
    """`attend`'s strategy on the mesh's `model` axis: "local",
    "head_tp" or "cp" (context parallelism), as the module docstring
    lists."""
    M = sharding.mesh_axis_size("model")
    if M == 1:
        return "local"
    if KVH % M == 0 or (KVH * G) % M == 0:
        return "head_tp"
    if S % M == 0:
        return "cp"
    return "local"


def _head_tp_layout(q, k, v, M: int):
    """The head-TP layout of q, k, v on M ranks: the kv heads grouped
    where M divides them, else K/V repeated to the H query heads, one
    query head a group (Megatron-style duplication)."""
    B, S, KVH, G, Dk = q.shape
    if KVH % M == 0:
        return q, k, v
    return (q.reshape(B, S, KVH * G, 1, Dk), k.repeat_interleave(G, dim=2),
            v.repeat_interleave(G, dim=2))


def _head_tp_attention(q, k, v, **kw):
    """Heads sharded over `model`: each rank attends its heads' block
    (no collective inside); the heads are gathered back."""
    B, S, KVH, G, _ = q.shape
    M = sharding.mesh_axis_size("model")
    b = _batch_spec_entry(B)
    ql, kl, vl = _head_tp_layout(q, k, v, M)
    qspec = P(b, None, "model", None, None)
    kvspec = P(b, None, "model", None)
    out = sharding.shard_map(partial(chunked_attention, **kw),
                             (qspec, kvspec, kvspec), qspec)(ql, kl, vl)
    return out.reshape(B, S, KVH, G, -1)


def head_tp_block_attention(q, k, v, G: int, r: int, lo: int = 0, **kw):
    """Rank r's head-TP attention in a block program, on its projections:
    q (B,S,H_loc,Dk), its H/M query heads; k/v (B,S,KVH_k,D*), its KVH/M
    kv heads (the grouped layout) or the kv heads from `lo` on (the
    repeated layout of `_head_tp_layout`: the one each of its query
    heads reads, one a query head). No collective; its heads' output."""
    B, S, H_loc, Dk = q.shape
    KVH_k = k.shape[2]
    if KVH_k * G == H_loc:
        return chunked_attention(q.reshape(B, S, KVH_k, G, Dk), k, v, **kw)
    idx = (r * H_loc + torch.arange(H_loc, device=q.device)) // G - lo
    return chunked_attention(q.reshape(B, S, H_loc, 1, Dk), k[:, :, idx],
                             v[:, :, idx], **kw)


def _cp_block(q_l, k, v, s0: int, **kw):
    """A rank's share of context parallelism: its query rows from s0,
    attended against the whole k/v at q_offset = s0."""
    return chunked_attention(q_l, k, v, q_offset=s0, **kw)


def cp_block_attention(q_l, k_l, v_l, **kw):
    """A block program's context parallelism: the rank's S/M rows of q,
    k and v; K/V all-gathered over `model`. Returns its rows' output and
    the gathered K and V (a window cache's source)."""
    k = sharding.all_gather(k_l, "model", 1)
    v = sharding.all_gather(v_l, "model", 1)
    return (_cp_block(q_l, k, v, sharding.axis_index("model") * q_l.shape[1],
                      **kw), k, v)


def _context_parallel_attention(q, k, v, **kw):
    """Queries sharded on sequence over `model`; K/V either sharded the
    same way and all-gathered inside (Sk == S, Sk % M == 0), or held
    whole (a key length off the query's or off a multiple of M)."""
    B, S = q.shape[:2]
    Sk = k.shape[1]
    M = sharding.mesh_axis_size("model")
    kv_sharded = Sk % M == 0 and Sk == S
    b = _batch_spec_entry(B)
    qspec = P(b, "model", None, None, None)
    kvspec = P(b, "model" if kv_sharded else None, None, None)

    def body(q_l, k_l, v_l):
        if kv_sharded:
            k_l = sharding.all_gather(k_l, "model", 1)
            v_l = sharding.all_gather(v_l, "model", 1)
        s0 = sharding.axis_index("model") * (S // M)
        return _cp_block(q_l, k_l, v_l, s0, **kw)
    return sharding.shard_map(body, (qspec, kvspec, kvspec), qspec)(q, k, v)


# --------------------------------------------------------------------------
# Decode: KV-sequence-parallel flash-decode
# --------------------------------------------------------------------------
def _update(cache, new, p, s0: int = 0):
    """Per-request write of `new` at local index p - s0 (rows whose
    index lies outside this cache block keep their content). A new
    tensor: the caller's cache is left as it was, as the reference's
    functional update leaves it."""
    S = cache.shape[1]
    idx = p - s0 if s0 else p          # no kernel for the whole cache
    in_range = (idx >= 0) & (idx < S)
    rows = torch.arange(cache.shape[0], device=cache.device)
    upd = cache.index_put((rows, idx.clamp(0, S - 1)), new.to(cache.dtype))
    # a where, not a boolean index: no host sync on the card
    return torch.where(in_range[:, None, None, None], upd, cache)


def seqparallel_decode_attention(q, k_cache, v_cache, k_new, v_new, pos, *,
                                 cap=0.0, sm_scale=None, v_dims=None,
                                 force_local=False):
    """One-token decode against a sequence-sharded KV cache.

    q: (B,KVH,G,Dk); caches: (B,S,KVH,D*); new entries: (B,KVH,D*);
    pos: scalar or (B,) int (index where the new entry is written;
    attention covers positions [0, pos]). Returns (out (B,KVH,G,Dv),
    k_cache, v_cache).

    v_dims: MLA's absorbed mode — V is k_cache[..., :v_dims] (the
    shared latent); v_cache and v_new are ignored and v_cache comes
    back as None. force_local: the head-sharded cache layout
    (`transformer.decode_heads_layout`) — each rank of `model` decodes
    its kv heads with no collective. With no mesh, M == 1 or S off a
    multiple of M, the whole cache is one shard.
    """
    B, S, KVH = k_cache.shape[:3]
    pos = torch.as_tensor(pos, device=q.device).long().broadcast_to((B,))
    M = sharding.mesh_axis_size("model")
    kw = dict(cap=cap, sm_scale=sm_scale, v_dims=v_dims)
    if M == 1 or (S % M and not force_local):
        return _local_decode(q, k_cache, v_cache, k_new, v_new, pos, **kw)
    if force_local:
        if KVH % M:
            raise ValueError(f"the heads layout needs the {KVH} kv heads "
                             f"to split over model = {M}")
        return _heads_decode(q, k_cache, v_cache, k_new, v_new, pos, **kw)
    return _sharded_decode(q, k_cache, v_cache, k_new, v_new, pos, **kw)


def _decode_shard(q, k_l, v_l, k_new, v_new, pos, s0: int, *, cap,
                  sm_scale, v_dims):
    """A rank's share of the decode on its block of cache rows from s0
    (the whole cache at s0 = 0): the new entry written at p - s0 where
    it falls in the block (`_update`), then the partials (acc, m, l)
    over the block at its absolute positions. Returns (acc, m, l, k_l,
    v_l), v_l None in MLA's absorbed mode (V is k_l[..., :v_dims])."""
    k_l = _update(k_l, k_new, pos, s0)
    if v_dims is not None:
        v_eff, v_l = k_l[..., :v_dims], None
    else:
        v_l = _update(v_l, v_new, pos, s0)
        v_eff = v_l
    acc, m, l = _decode_block(q, k_l, v_eff, pos, s0, cap=cap,
                              sm_scale=sm_scale)
    return acc, m, l, k_l, v_l


def _local_decode(q, k_cache, v_cache, k_new, v_new, pos, **kw):
    """The decode on the whole cache, merged: (out, k_cache, v_cache)."""
    acc, _, l, k_cache, v_cache = _decode_shard(q, k_cache, v_cache, k_new,
                                                v_new, pos, 0, **kw)
    return finalize_partials(acc, l).to(q.dtype), k_cache, v_cache


def _decode_block(q, k_l, v_l, pos, s0: int, **kw):
    """Partials (acc, m, l) over a block of cache rows from s0, at their
    absolute positions."""
    kv_pos = torch.arange(k_l.shape[1], device=q.device)
    return decode_partials(q, k_l, v_l, kv_pos + s0 if s0 else kv_pos, pos,
                           **kw)


def _decode_in_specs(B: int, mla: bool, seq_ax, head_ax):
    """The sharded decode's in-specs (q, caches, new entries, pos) and
    its output's spec."""
    b = _batch_spec_entry(B)
    qspec = P(b, head_ax, None, None)
    cspec = P(b, seq_ax, head_ax, None)
    nspec = P(b, head_ax, None)
    return (qspec, cspec, None if mla else cspec, nspec,
            None if mla else nspec, P(b)), qspec


def _whole_caches(k_cache, v_cache, k_new, v_new, pos, mla: bool):
    """The caches with the new entry written: what every rank, holding
    the whole caches, returns (a local write; no gather)."""
    return (_update(k_cache, k_new, pos),
            None if mla else _update(v_cache, v_new, pos))


def blocks_decode(q, k_cache, v_cache, k_new, v_new, pos, M: int, *,
                  cap=0.0, sm_scale=None, v_dims=None):
    """A block program's decode: q (b,KVH_l,G,Dk), the new entries
    (b,KVH_l,D*) and pos (scalar or (b,)) are the rank's b rows; the
    caches (B,S,KVH_l,D*) its block of every row under the param rules,
    every row's new entry (all-gathered over the batch axes) written
    into them in place, nothing else. The rank's rows attend its S/M
    cache positions, merged over `model` (M > 1), or every position
    (M = 1: its kv heads, or a cache that does not split). `v_dims`:
    MLA's absorbed mode (V is k_cache[..., :v_dims], the latent;
    v_cache and v_new None). Returns (out (b,KVH_l,G,Dv), k_cache,
    v_cache)."""
    b, n = q.shape[0], k_cache.shape[1] // M
    pos = torch.as_tensor(pos, device=q.device).long().broadcast_to((b,))
    ax = sharding.batch_axes_prefix(k_cache.shape[0])

    def every_row(t):
        return sharding.all_gather(t, ax, 0) if ax else t
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    p = every_row(pos)
    k_cache.index_put_((rows, p), every_row(k_new).to(k_cache.dtype))
    if v_dims is None:
        v_cache.index_put_((rows, p), every_row(v_new).to(v_cache.dtype))
    r0 = sharding.axis_index(ax) * b if ax else 0
    s0 = sharding.axis_index("model") * n if M > 1 else 0
    k_l = k_cache[r0:r0 + b, s0:s0 + n]
    v_l = (k_l[..., :v_dims] if v_dims is not None
           else v_cache[r0:r0 + b, s0:s0 + n])
    acc, m, l = _decode_block(q, k_l, v_l, pos, s0, cap=cap,
                              sm_scale=sm_scale)
    if M > 1:
        acc, l = merge_partials(acc, m, l, "model")
    return finalize_partials(acc, l).to(q.dtype), k_cache, v_cache


def _sharded_decode(q, k_cache, v_cache, k_new, v_new, pos, **kw):
    """The cache sequence-sharded over `model`: each rank writes the new
    entry into its S/M rows at p - s0 and computes its partials over
    them (`_decode_shard`); the partials are merged over `model`."""
    B, S = k_cache.shape[:2]
    M = sharding.mesh_axis_size("model")
    mla = kw["v_dims"] is not None

    def body(q_l, kc, vc, kn, vn, p):
        acc, m, l, _, _ = _decode_shard(
            q_l, kc, vc, kn, vn, p, sharding.axis_index("model") * (S // M),
            **kw)
        acc, l = merge_partials(acc, m, l, "model")
        return finalize_partials(acc, l).to(q_l.dtype)
    ins, ospec = _decode_in_specs(B, mla, "model", None)
    out = sharding.shard_map(body, ins, ospec)(q, k_cache, v_cache, k_new,
                                               v_new, pos)
    return (out,) + _whole_caches(k_cache, v_cache, k_new, v_new, pos, mla)


def _heads_decode(q, k_cache, v_cache, k_new, v_new, pos, **kw):
    """The cache head-sharded over `model`: each rank's decode over its
    kv heads, whole in sequence (`_local_decode`); no collective inside,
    the output's heads gathered back."""
    mla = kw["v_dims"] is not None
    ins, ospec = _decode_in_specs(k_cache.shape[0], mla, None, "model")

    def body(q_l, kc, vc, kn, vn, p):
        return _local_decode(q_l, kc, vc, kn, vn, p, **kw)[0]
    out = sharding.shard_map(body, ins, ospec)(q, k_cache, v_cache, k_new,
                                               v_new, pos)
    return (out,) + _whole_caches(k_cache, v_cache, k_new, v_new, pos, mla)


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
    return (_window_attend(q, k_win, v_win, pos, window, cap=cap,
                           sm_scale=sm_scale), k_win, v_win)


def blocks_window_decode(q, k_win, v_win, k_new, v_new, pos, window: int,
                         *, cap=0.0, sm_scale=None):
    """A block program's window decode: q (b,KVH_l,G,Dk), the new
    entries (b,KVH_l,D*) and pos are the rank's b rows; the window
    caches (B,W,KVH_l,D*) its param-rule block, every row (the window
    is whole over `model`), every row's new entry (all-gathered over
    the batch axes) written into them in place. The rank's rows attend
    their rows of the window; no other collective. Returns (out
    (b,KVH_l,G,Dv), k_win, v_win)."""
    b, (B, W) = q.shape[0], k_win.shape[:2]
    pos = torch.as_tensor(pos, device=q.device).long().broadcast_to((b,))
    p = sharding.every_row(pos, B)
    rows = torch.arange(B, device=q.device)
    k_win.index_put_((rows, p % W), sharding.every_row(k_new, B).to(
        k_win.dtype))
    v_win.index_put_((rows, p % W), sharding.every_row(v_new, B).to(
        v_win.dtype))
    out = _window_attend(q, sharding.own_rows(k_win, b),
                         sharding.own_rows(v_win, b), pos, window, cap=cap,
                         sm_scale=sm_scale)
    return out, k_win, v_win


def _window_attend(q, k_win, v_win, pos, window: int, *, cap, sm_scale):
    """The attention of q's rows at `pos` (B,) over their window caches,
    the new entry written: (B,KVH,G,Dv) in q's dtype."""
    W = k_win.shape[1]
    slots = torch.arange(W, device=q.device)
    token_of_slot = pos[:, None] - ((pos[:, None] - slots[None]) % W)
    valid = token_of_slot >= 0
    if window < W:
        valid &= token_of_slot > pos[:, None] - window
    acc, m, l = decode_partials(q, k_win, v_win, token_of_slot, pos,
                                cap=cap, extra_mask=valid,
                                sm_scale=sm_scale)
    return finalize_partials(acc, l).to(q.dtype)
