"""Attention strategies, as one process runs them.

The port of the reference's `repro.parallel.collectives` for the
branches a single process takes: with no `model` mesh axis (M == 1)
full-sequence attention is local chunked attention (the flash kernel),
and decode is the local branch of the KV-sequence-parallel flash-decode
— the per-request write of the new entry at `pos`, `decode_partials`
over the whole cache, `finalize_partials`, with MLA's absorbed mode
(`v_dims`: the values are the latent's first columns) — and the
hybrids' decode against a rolling window cache
(`window_decode_attention`).
`merge_partials` and the shard_map branches (head-TP, context
parallelism, the sharded decode) come with the parallelism slice
(ROADMAP slice 8).
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import (chunked_attention, decode_partials,
                                          finalize_partials)


def attend(q, k, v, *, causal=True, window=0, cap=0.0, sm_scale=None):
    """q: (B,S,KVH,G,Dk); k/v: (B,S,KVH,D*) -> (B,S,KVH,G,Dv)."""
    return chunked_attention(q, k, v, causal=causal, window=window, cap=cap,
                             sm_scale=sm_scale)


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
    """One-token decode against the whole KV cache (the local branch).

    q: (B,KVH,G,Dk); caches: (B,S,KVH,D*); new entries: (B,KVH,D*);
    pos: scalar or (B,) int (index where the new entry is written;
    attention covers positions [0, pos]). Returns (out (B,KVH,G,Dv),
    k_cache, v_cache).

    v_dims: MLA's absorbed mode — V is k_cache[..., :v_dims] (the
    shared latent); v_cache and v_new are ignored and v_cache comes
    back as None.
    """
    B, S = k_cache.shape[:2]
    pos = torch.as_tensor(pos, device=q.device).long().broadcast_to((B,))
    k_cache = _update(k_cache, k_new, pos)
    if v_dims is not None:
        v_eff = k_cache[..., :v_dims]
    else:
        v_cache = _update(v_cache, v_new, pos)
        v_eff = v_cache
    acc, m, l = decode_partials(q, k_cache, v_eff,
                                torch.arange(S, device=q.device), pos,
                                cap=cap, sm_scale=sm_scale)
    out = finalize_partials(acc, l).to(q.dtype)
    return out, k_cache, (None if v_dims is not None else v_cache)


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
