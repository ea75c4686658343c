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


def reference(q, k, v, *, causal=True, window=0, sm_scale=None, cap=0.0):
    """q: (B,H,Sq,D); k/v: (B,KVH,Sk,D*) -> (B,H,Sq,Dv) in q's dtype."""
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
    qpos = torch.arange(Sq, device=q.device)[:, None]
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
