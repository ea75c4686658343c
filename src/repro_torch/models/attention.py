"""Attention: reference oracle, chunked (online-softmax) attention, and
single-token decode partials.

Layout conventions (the reference's `repro.models.attention`):
  q: (B, S, KVH, G, Dk)   grouped query heads (G = n_heads // n_kv_heads)
  k: (B, S, KVH, Dk)
  v: (B, S, KVH, Dv)
  out: (B, S, KVH, G, Dv)

`chunked_attention` is the flash attention kernel: it hands its operands
to `kernels.flash_attention.ops.attention` in the kernel's (B, H, S, D)
layout as strided views (no copy), which launches the hand-written
kernel for CUDA tensors and runs the plain version for CPU tensors. The
reference's `q_chunk` / `kv_chunk` / `block_skip` are its own tiling
knobs: they are accepted and do not change the result (the kernel has
fixed tiles and always skips dead tiles). `decode_partials` and
`finalize_partials` stay plain torch, as the reference computes them
outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import softcap as apply_softcap

NEG = -1e30


def _mask(qpos, kpos, *, causal: bool, window: int):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def reference_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                        q_offset=0, kv_valid=None, sm_scale=None):
    """Oracle: materializes the full score matrix. Tests only."""
    B, Sq, KVH, G, Dk = q.shape
    Sk = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if cap:
        s = apply_softcap(s, cap)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    m = _mask(qpos, kpos, causal=causal, window=window)
    if kv_valid is not None:
        m &= kv_valid[None, :]
    s = torch.where(m[None, None, None], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhe->bqhge", p, v.float())
    return o.to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                      q_chunk=512, kv_chunk=1024, q_offset=0,
                      block_skip=False, sm_scale=None):
    """Online-softmax attention through the flash kernel.

    q: (B,Sq,KVH,G,Dk); k/v: (B,Sk,KVH,D*) -> (B,Sq,KVH,G,Dv) in q's
    dtype. `q_offset` (context parallelism's shard offset) places query
    row r at position q_offset + r for the causal and window masks; the
    kernel takes it as it is."""
    del q_chunk, kv_chunk, block_skip      # the kernel's tiles are fixed
    B, Sq, KVH, G, Dk = q.shape
    H = KVH * G
    qh = q.reshape(B, Sq, H, Dk).transpose(1, 2)   # (B,H,Sq,Dk), a view
    out = fa_ops.attention(qh, k.transpose(1, 2), v.transpose(1, 2),
                           causal=causal, window=window, cap=cap,
                           sm_scale=sm_scale, q_offset=q_offset)
    return out.transpose(1, 2).reshape(B, Sq, KVH, G, out.shape[-1])


def decode_partials(q, k, v, kv_positions, pos, *, cap=0.0, extra_mask=None,
                    sm_scale=None):
    """Single-token attention partial stats over one KV shard.

    q: (B, KVH, G, Dk); k: (B, S_loc, KVH, Dk); v: (B, S_loc, KVH, Dv)
    kv_positions: (S_loc,) or (B, S_loc) global slot positions;
    pos: scalar or (B,) current position per request.
    Returns acc (B,KVH,G,Dv) f32, m (B,KVH,G), l (B,KVH,G). The products
    take float32 operands (the reference's preferred_element_type)."""
    B = q.shape[0]
    Dk = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dk)
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k.float()) * scale
    if cap:
        s = apply_softcap(s, cap)
    pos_b = torch.as_tensor(pos, device=q.device).broadcast_to((B,))
    kvp = torch.as_tensor(kv_positions, device=q.device)
    if kvp.ndim == 1:
        kvp = kvp[None].broadcast_to((B, kvp.shape[0]))
    valid = kvp <= pos_b[:, None]                       # (B, S_loc)
    if extra_mask is not None:
        em = torch.as_tensor(extra_mask, device=q.device)
        if em.ndim == 1:
            em = em[None].broadcast_to(valid.shape)
        valid = valid & em
    valid = valid[:, None, None, :]                     # (B,1,1,S_loc)
    s = torch.where(valid, s, NEG)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgk,bkhe->bhge", p, v.float())
    return acc, m, l


def finalize_partials(acc, l):
    return acc / torch.clamp(l[..., None], min=1e-30)
