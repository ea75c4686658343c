"""Mixture-of-Experts: the router (the dispatch "header") and the expert
FFNs, as one process runs them.

The port of the reference's `repro.models.moe` for the branch it takes
with no mesh: `moe_apply` routes every token (`route`: softmax or
sigmoid + bias, top-k, renormalised weights, the switch-style
load-balance aux) and runs `_moe_local`, a loop over all E experts in
which every token meets every expert and an expert's output counts with
the weight its token gave it (0 where it was not chosen), accumulated in
float32. `_capacity` and `_dispatch_indices` — the per-assignment slot
positions of capacity-bounded dispatch, the header the expert-parallel
paths move ahead of the payload — are ported and held exactly, for the
parallelism slice's `a2a` to reuse; one process never dispatches.

Differences from the reference, on purpose:

  * `_moe_a2a` and `_moe_replicated` (the expert-parallel all_to_all
    and the staged psum baseline) live inside a `shard_map` and come
    with the mesh (ROADMAP slice 8). `moe_apply` takes `_moe_local`
    whatever the config, as the reference does with no mesh.
  * `_capacity` reads `MoEConfig.capacity_factor` alone: the port has
    no `repro.perf` flags to override it.
  * `route` returns its expert ids as int32, as `lax.top_k` does.
    Where two scores tie exactly, `torch.topk` may order them otherwise
    than `lax.top_k` (lower index first).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import ffn
from repro_torch.models.layers import act_fn
from repro_torch.models.module import Spec


# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------
def moe_spec(cfg) -> dict:
    m = cfg.moe
    E, D, Fw = m.n_experts, cfg.d_model, m.d_ff_expert
    s = {
        # the router stays float32: every token's logits over all experts
        "router": {"w": Spec((D, E), (None, None), dtype="float32")},
        "experts": {
            "gate": Spec((E, D, Fw), ("expert", "embed", "expert_mlp")),
            "up": Spec((E, D, Fw), ("expert", "embed", "expert_mlp")),
            "down": Spec((E, Fw, D), ("expert", "expert_mlp", "embed")),
        },
    }
    if _router_type(cfg) == "sigmoid_bias":
        s["router"]["bias"] = Spec((E,), (None,), init="zeros",
                                   dtype="float32")
    if m.n_shared:
        s["shared"] = ffn.ffn_spec(D, m.n_shared * m.d_ff_shared, cfg.act)
    return s


def _router_type(cfg) -> str:
    # deepseek-style sigmoid + bias routing for MLA archs, softmax otherwise
    return "sigmoid_bias" if cfg.use_mla else "softmax"


# --------------------------------------------------------------------------
# Routing (the "header" computation)
# --------------------------------------------------------------------------
def route(params, x, cfg):
    """x: (..., D) -> (weights (..., k) f32, idx (..., k) i32, aux f32)."""
    m = cfg.moe
    logits = x.float() @ params["router"]["w"]
    if _router_type(cfg) == "sigmoid_bias":
        scores = torch.sigmoid(logits)
        sel = scores + params["router"]["bias"]
        idx = torch.topk(sel, m.top_k, dim=-1).indices
        w = torch.gather(scores, -1, idx)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-20)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(probs, m.top_k, dim=-1)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-20)
    # switch-style load-balance aux: E * sum_e f_e * p_e, counted by a
    # scatter-add (no (T, E) one-hot)
    E = m.n_experts
    idx_f = idx.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.float32,
                         device=x.device).index_add_(
        0, idx_f, torch.ones_like(idx_f, dtype=torch.float32))
    f_e = counts / max(idx_f.shape[0], 1)
    p_e = probs.reshape(-1, E).mean(0)
    aux = E * torch.sum(f_e * p_e)
    return w, idx.to(torch.int32), aux


# --------------------------------------------------------------------------
# Expert FFN on capacity slots
# --------------------------------------------------------------------------
def _experts_ffn(w_gate, w_up, w_down, h, act):
    """h: (E, C, D) capacity slots -> (E, C, D): expert e's FFN on its
    slots (`einsum("ecd,edf->ecf")` as batched products)."""
    f = act_fn(act)
    g = torch.bmm(h, w_gate)
    u = torch.bmm(h, w_up)
    return torch.bmm(f(g) * u, w_down)


def _capacity(tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(math.ceil(tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(4, -(-c // 4) * 4)      # round up to a multiple of 4


def _dispatch_indices(idx_flat, w_flat, E: int, C: int):
    """Per-assignment slot positions (the header's 'WQE').

    idx_flat: (A,) expert id per assignment, in token-major order.
    Returns (slot (A,) int32, keep (A,) bool): the a-th assignment's
    slot is idx * C + (its rank among the earlier assignments to the
    same expert), or E * C (out of range: dropped) past capacity."""
    del w_flat                          # the reference's signature
    idx = idx_flat.long()
    one_hot = F.one_hot(idx, E).to(torch.int32)                     # (A, E)
    pos = torch.cumsum(one_hot, dim=0, dtype=torch.int32) - 1       # (A, E)
    pos = torch.gather(pos, 1, idx[:, None])[:, 0]                  # (A,)
    keep = pos < C
    slot = torch.where(keep, idx.to(torch.int32) * C + pos,
                       torch.full_like(pos, E * C))                 # OOB drop
    return slot, keep


# --------------------------------------------------------------------------
# Implementation
# --------------------------------------------------------------------------
def moe_apply(params, x, cfg):
    """x: (B, S, D) -> (y, aux_loss). One process has no expert axis, so
    this is the reference's `_moe_local` branch (plus shared experts)."""
    m = cfg.moe
    w, idx, aux = route(params, x, cfg)          # header: control path
    y = _moe_local(params, x, w, idx, cfg)
    if m.n_shared:
        y = y + ffn.ffn_apply(params["shared"], x, cfg.act)
    return y, aux


def _moe_local(params, x, w, idx, cfg):
    """Dense loop over the experts: every token through every expert,
    weighted by the gate it gave that expert (0 if unchosen), summed in
    float32."""
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    ex = params["experts"]
    f = act_fn(cfg.act)
    for e in range(cfg.moe.n_experts):
        we = torch.where(idx == e, w, 0.0).sum(-1)            # (B, S)
        h = f(x @ ex["gate"][e]) * (x @ ex["up"][e])
        he = h @ ex["down"][e]
        y = y + we[..., None] * he.float()
    return y.to(x.dtype)
