"""Plain PyTorch version of the flash attention kernel (same layout).

The port of the reference's `kernels/flash_attention/ref.py::reference`:
it materialises the (Sq, Sk) scores, so it is for the CPU and for
`chip_smoke.py`'s comparison only. The wrapper in `ops.py` runs it for
CPU tensors.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def reference(q, k, v, *, causal=True, window=0, sm_scale=None, cap=0.0,
              q_offset=0):
    """q: (B,H,Sq,D); k/v: (B,KVH,Sk,D*) -> (B,H,Sq,Dv) in q's dtype;
    query row r at position q_offset + r for the masks (keys at 0 ..
    Sk - 1), as the reference's `chunked_attention(q_offset=)`."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = H // KVH
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kr = k.repeat_interleave(G, dim=1)
    vr = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * sm_scale
    if cap:
        s = cap * torch.tanh(s / cap)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhke->bhqe", p, vr.float())
    return o.to(q.dtype)


def split3(p):
    """float32 p as three bfloat16 terms, hi + mid + lo == p exactly
    (summed in float32, in that order) for normal p whose lo stays
    normal: the split the kernels apply to P before P V."""
    hi = p.to(torch.bfloat16)
    r = p - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def partial_state(q, k, v, k_lo, k_hi, *, q_lo=0, causal=True, window=0,
                  sm_scale=None, cap=0.0):
    """The online-softmax state one block of the split schedule leaves
    for the query rows q (at positions q_lo, q_lo + 1, ...) over the keys
    [k_lo, k_hi): float32 (m, l, acc) of shapes (B,H,Sq), (B,H,Sq),
    (B,H,Sq,Dv), unnormalised; a row with no live key keeps m = NEG,
    l = 0, acc = 0 (masked keys contribute an exact 0)."""
    B, H, Sq, D = q.shape
    G = H // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kr = k[:, :, k_lo:k_hi].repeat_interleave(G, dim=1).float()
    vr = v[:, :, k_lo:k_hi].repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * sm_scale
    if cap:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(q_lo, q_lo + Sq, device=q.device)[:, None]
    kpos = torch.arange(k_lo, k_hi, device=q.device)[None, :]
    live = torch.ones((Sq, k_hi - k_lo), dtype=torch.bool, device=q.device)
    if causal:
        live &= qpos >= kpos
    if window:
        live &= kpos > qpos - window
    s = torch.where(live[None, None], s, NEG)
    m = s.amax(dim=-1).clamp(min=NEG) if k_hi > k_lo else torch.full(
        (B, H, Sq), NEG, device=q.device)
    p = torch.where(live[None, None], torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("bhqk,bhke->bhqe", p, vr)


def merge_states(states, dtype):
    """The output from the states of a row's key splits, by the
    reference's online-softmax combination: m = max m_s, weights
    e^(m_s - m), l clamped at 1e-30."""
    m = torch.stack([s[0] for s in states]).amax(dim=0)
    w = [torch.exp(s[0] - m) for s in states]
    l = sum(wi * s[1] for wi, s in zip(w, states))
    acc = sum(wi[..., None] * s[2] for wi, s in zip(w, states))
    return (acc / l.clamp(min=1e-30)[..., None]).to(dtype)
