"""Mixture-of-Experts with FlexiNS-style header/payload-split dispatch.

The paper's T1 (header-only offloading TX) maps onto MoE dispatch:

  * header  = routing metadata (top-k expert ids, weights, slot
    positions), computed on the control path, outside the payload's
    sharded region, tiny;
  * payload = hidden states, moved exactly once, directly, by an
    all_to_all over the expert-parallel axis into per-expert capacity
    slots, with no staging through a replicated buffer.

The port of the reference's `repro.models.moe`. Three implementations,
chosen by `moe_apply` as the reference chooses:

  'a2a'        — sequence-parallel tokens, direct all_to_all dispatch
                 (`_moe_a2a`; the default on a mesh);
  'replicated' — tokens replicated over the expert axis; each rank
                 gathers its experts' tokens locally and the combined
                 output is psum'd (`_moe_replicated`, the staged
                 baseline);
  'local'      — no mesh: a loop over all E experts in which every token
                 meets every expert and counts with the weight its token
                 gave it, accumulated in float32 (`_moe_local`).

The mesh branches take `moe_impl` and `capacity_factor` from
`sharding.use_mesh` (the reference's `perf.FLAGS`). Each is a
`sharding.shard_map` over plain per-rank pieces: `dispatch` (slots by
`_dispatch_indices` on the rank's own tokens in (token, k) order; a
slot past capacity is dropped into a spill row, the reference's
`mode="drop"`), `_experts_ffn` (a batched product over the rank's
experts' slots) and `combine` (a gather with a zero row for the
dropped, the reference's `mode="fill"`; the weight cast to the
activations' dtype before the sum over k, where `_moe_local` sums in
float32). Dispatch and combine stay plain torch, as the reference runs
them outside any kernel; the row-copy kernels raise on an out-of-range
id where dispatch must drop it.

Differences from the reference, on purpose: `route` returns its expert
ids as int32, as `lax.top_k` does; where two scores tie exactly,
`torch.topk` may order them otherwise than `lax.top_k` (lower index
first).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import ffn
from repro_torch.models.layers import act_fn
from repro_torch.models.module import Spec
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P


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
def route(params, x, cfg, *, token_axes=None):
    """x: (..., D) -> (weights (..., k) f32, idx (..., k) i32, aux f32).
    `token_axes` (a block program: the mesh axes over which the tokens
    of x are this rank's share) makes the aux loss the reference's
    global one: the counts and the probability sums psummed over them,
    over the global count (a row replicated on some ranks counted on
    each, in the sums and the count alike)."""
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
    if token_axes is None:
        f_e = counts / max(idx_f.shape[0], 1)
        p_e = probs.reshape(-1, E).mean(0)
    else:
        p_sum = probs.reshape(-1, E).sum(0)
        n = sharding.axis_size(token_axes)
        if token_axes:
            counts = sharding.psum(counts, token_axes)
            p_sum = sharding.psum(p_sum, token_axes)
        f_e = counts / max(idx_f.shape[0] * n, 1)
        p_e = p_sum / max(probs.numel() // E * n, 1)
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


def _gather_fsdp(w, spec_axes, shape):
    """All-gather away any non-expert-dim param sharding inside
    shard_map (ZeRO-3 weight gather), the spec resolved on the global
    `shape`. The expert dim stays sharded."""
    return sharding.gather_param(w, spec_axes, shape=shape, skip=("expert",))


def _capacity(tokens: int, cfg) -> int:
    """Slots an expert takes from `tokens` tokens: the mesh's
    `capacity_factor` where `use_mesh` set one, else the config's."""
    m = cfg.moe
    ctx = sharding.current()
    cf = m.capacity_factor if ctx is None or ctx.capacity_factor is None \
        else ctx.capacity_factor
    c = int(math.ceil(tokens * m.top_k * cf / m.n_experts))
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


def dispatch(x, idx, E: int, C: int, k: int):
    """Tokens x (T, D) into E x C capacity slots by their k expert ids
    (T, k): ((E, C, D) slots, slot (T k,)). Assignments past an
    expert's capacity, or to an id >= E, land in a spill row that is
    cut off (dropped)."""
    slot, _ = _dispatch_indices(idx.reshape(-1), None, E + 1, C)
    slot = torch.clamp(slot, max=E * C).long()        # the spill row
    buf = x.new_zeros((E * C + 1, x.shape[-1]))
    buf.index_copy_(0, slot, x.repeat_interleave(k, dim=0))
    return buf[:E * C].reshape(E, C, -1), slot


def combine(out, slot, w, k: int):
    """The expert outputs (E, C, D) back to their T tokens: each
    assignment's slot (zero where it was dropped) times its weight, in
    the outputs' dtype, summed over k. (T, D)."""
    D = out.shape[-1]
    rows = torch.cat([out.reshape(-1, D), out.new_zeros((1, D))])
    got = rows.index_select(0, slot) * w.reshape(-1, 1).to(out.dtype)
    return got.reshape(-1, k, D).sum(1)


# --------------------------------------------------------------------------
# Implementations
# --------------------------------------------------------------------------
def moe_apply(params, x, cfg, *, sp: bool = False, S: int | None = None):
    """x: (B, S, D) -> (y, aux_loss). With no mesh, M == 1 or experts
    off a multiple of M: `_moe_local`; else `_moe_a2a` where the
    sequence splits over `model` and the mesh's `moe_impl` is 'a2a',
    else `_moe_replicated`. `sp`: the shared experts' FFN is
    sequence-parallel. `S`: the sequence's tokens, x's own but in a
    block program's Megatron-SP stream, where x holds the rank's S/M
    positions.

    In a block program x is the rank's rows and the weights its blocks:
    `_moe_a2a` and its router on its S/M positions (cut from a stream
    whole over `model`, the output all-gathered back), `_moe_replicated`
    and its router on its rows' whole sequence (gathered from a
    Megatron-SP stream, the output cut back), `_moe_local` (M == 1, or
    experts off a multiple of M) on its tokens with the experts gathered
    whole; the aux loss global
    (`route`); the shared experts through the block program's FFN."""
    m = cfg.moe
    S = x.shape[1] if S is None else S
    branch = moe_branch(cfg, S)
    impl = {"local": _moe_local, "a2a": _moe_a2a,
            "replicated": _moe_replicated}[branch]
    if not sharding.in_blocks():
        w, idx, aux = route(params, x, cfg)          # header: control path
        y = impl(params, x, w, idx, cfg)
    else:
        M = sharding.mesh_axis_size("model")
        r, n = (sharding.axis_index("model") if M > 1 else 0), S // M
        whole = x.shape[1] == S
        # the tokens the rank routes: a2a's are its S/M positions
        x_r = x[:, r * n:(r + 1) * n] if branch == "a2a" and whole else x
        w, idx, aux = route(params, x_r, cfg, token_axes=(
            sharding.batch_axes() + (("model",) if x_r.shape[1] != S
                                     else ())))
        if branch == "replicated" and not whole:
            x_f, w_f, idx_f = (sharding.all_gather(t, "model", 1)
                               for t in (x, w, idx))
            y = impl(params, x_f, w_f, idx_f, cfg)[:, r * n:(r + 1) * n]
        else:
            y = impl(params, x_r, w, idx, cfg)
            if x_r is not x:
                y = sharding.all_gather(y, "model", 1)
    if m.n_shared:
        y = y + ffn.ffn_apply(params["shared"], x, cfg.act, sp=sp,
                              spec=ffn.ffn_spec(cfg.d_model, m.n_shared
                                                * m.d_ff_shared, cfg.act))
    return y, aux


def moe_branch(cfg, S: int) -> str:
    """`moe_apply`'s implementation for S tokens a sequence: "local"
    with no mesh, M == 1 or experts off a multiple of M; else "a2a"
    where the sequence splits over `model` and the mesh's `moe_impl` is
    'a2a'; else "replicated"."""
    ctx = sharding.current()
    M = sharding.mesh_axis_size("model")
    if ctx is None or M == 1 or cfg.moe.n_experts % M:
        return "local"
    if S % M == 0 and ctx.moe_impl == "a2a":
        return "a2a"
    return "replicated"


def _moe_local(params, x, w, idx, cfg):
    """Dense loop over the experts: every token through every expert,
    weighted by the gate it gave that expert (0 if unchosen), summed in
    float32. In a block program (GSPMD's partition of this loop: a model
    axis of 1, or experts off a multiple of M, which `resolve_spec`
    leaves replicated over `model`) x is the rank's rows and the experts
    are gathered whole from their blocks; each rank of `model` runs the
    same loop on the same rows, its gradient its share of theirs."""
    ex = params["experts"]
    if sharding.in_blocks():
        ex = {n: sharding.gather_param(ex[n], EXPERT_AXES[n], shape=shape)
              for n, shape in zip(("gate", "up", "down"),
                                  _expert_shapes(cfg))}
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    f = act_fn(cfg.act)
    for e in range(cfg.moe.n_experts):
        we = torch.where(idx == e, w, 0.0).sum(-1)            # (B, S)
        h = f(x @ ex["gate"][e]) * (x @ ex["up"][e])
        he = h @ ex["down"][e]
        y = y + we[..., None] * he.float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# Expert parallelism
# --------------------------------------------------------------------------
EXPERT_AXES = {"gate": ("expert", "embed", "expert_mlp"),
               "up": ("expert", "embed", "expert_mlp"),
               "down": ("expert", "expert_mlp", "embed")}


def _batch_shards(B: int) -> int:
    return sharding.axis_size(sharding.batch_axes_prefix(B))


def _ep_axes(cfg) -> tuple:
    """Mesh axes the expert dim shards over (('model',) or ('model',
    'data'))."""
    ent = sharding.resolve_spec(EXPERT_AXES["gate"], _expert_shapes(cfg)[0],
                                "param")[0]
    if ent is None:
        return ("model",)
    return (ent,) if isinstance(ent, str) else tuple(ent)


def _expert_shapes(cfg) -> tuple:
    """The global shapes of the gate, up and down expert weights."""
    E, D, Fw = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    return (E, D, Fw), (E, D, Fw), (E, Fw, D)


def _expert_specs(cfg) -> tuple:
    return tuple(sharding.resolve_spec(EXPERT_AXES[n], shape, "param")
                 for n, shape in zip(("gate", "up", "down"),
                                     _expert_shapes(cfg)))


def _expert_blocks(cfg, wg, wu, wd) -> tuple:
    """The rank's experts' weights, FSDP-gathered (specs by the global
    shapes: a block program's weights are blocks)."""
    return tuple(_gather_fsdp(w, EXPERT_AXES[n], shape)
                 for n, w, shape in zip(("gate", "up", "down"),
                                        (wg, wu, wd), _expert_shapes(cfg)))


def _moe_a2a(params, x, w, idx, cfg):
    """FlexiNS path: sequence-parallel tokens and a direct all_to_all of
    the payload over the whole expert-parallel group (model, or model x
    data for EP over data). Capacity is per rank: the tokens it owns
    after the sequence split (in a block program, x's own: the rank's
    rows and S/M positions)."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    ep = _ep_axes(cfg)
    M = sharding.mesh_axis_size("model")
    C = _capacity(B * S if sharding.in_blocks()
                  else (B // _batch_shards(B)) * (S // M), cfg)
    b = sharding.batch_axes_prefix(B) or None
    xspec = P(b, "model", None)
    ex = params["experts"]
    axis = ep if len(ep) > 1 else ep[0]

    def body(x_l, w_l, idx_l, wg, wu, wd):
        Bl, Sl, _ = x_l.shape
        disp, slot = dispatch(x_l.reshape(Bl * Sl, D), idx_l, E, C, k)
        # the wire: the payload moves once, source rank -> expert's rank
        disp = sharding.all_to_all(disp, axis, 0, 1)    # (E_loc, ep C, D)
        wg, wu, wd = _expert_blocks(cfg, wg, wu, wd)
        out = _experts_ffn(wg, wu, wd, disp, cfg.act)
        del wg, wu, wd, disp
        out = sharding.all_to_all(out, axis, 1, 0)      # (E, C, D)
        return combine(out, slot, w_l, k).reshape(Bl, Sl, D)
    f = sharding.shard_map(body, (xspec, xspec, xspec) + _expert_specs(cfg),
                           xspec)
    return f(x, w.to(x.dtype), idx, ex["gate"], ex["up"], ex["down"])


def replicated_rank(x, w, idx, wg, wu, wd, r: int, E_loc: int, C: int,
                    cfg):
    """Rank r's share of the staged baseline: its experts [r E_loc,
    (r + 1) E_loc) on the assignments bound for them (the others go to
    a dummy expert E_loc, whose slots are dropped), combined to this
    rank's partial output (B, S, D)."""
    B, S, D = x.shape
    k = cfg.moe.top_k
    idx = idx.reshape(-1)
    loc = (idx >= r * E_loc) & (idx < (r + 1) * E_loc)
    idx_f = torch.where(loc, idx - r * E_loc, E_loc)
    w_f = torch.where(loc, w.reshape(-1), 0.0)
    disp, slot = dispatch(x.reshape(B * S, D), idx_f, E_loc, C, k)
    out = _experts_ffn(wg, wu, wd, disp, cfg.act)
    return combine(out, slot, w_f, k).reshape(B, S, D)


def _moe_replicated(params, x, w, idx, cfg):
    """Staged baseline: tokens replicated over the expert axis, each
    rank's partial output psum'd; under EP over data the tokens are
    first gathered over data where the batch splits there, and the
    rank's batch rows sliced back (in a block program x is the rank's
    rows, split over the axes `sharding.row_axes` names: a batch too
    small to split over data, whole on its ranks, is not gathered)."""
    m = cfg.moe
    B, S = x.shape[:2]
    ep = _ep_axes(cfg)
    E_loc = m.n_experts // sharding.axis_size(ep)
    blocks = sharding.in_blocks()
    b_axes = sharding.row_axes() if blocks else \
        sharding.batch_axes_prefix(B)
    # EP over data: tokens are gathered over data iff the batch shards there
    gather_data = "data" in ep and "data" in b_axes
    nd = sharding.mesh_axis_size("data")
    C = _capacity((B if blocks else B // _batch_shards(B))
                  * (nd if gather_data else 1) * S, cfg)
    xspec = P(b_axes or None, None, None)
    ex = params["experts"]

    def body(x_l, w_l, idx_l, wg, wu, wd):
        wg, wu, wd = _expert_blocks(cfg, wg, wu, wd)
        if gather_data:
            x_l, w_l, idx_l = (sharding.all_gather(t, "data", 0)
                               for t in (x_l, w_l, idx_l))
        y = replicated_rank(x_l, w_l, idx_l, wg, wu, wd,
                            sharding.axis_index(ep), E_loc, C, cfg)
        del wg, wu, wd
        y = sharding.psum(y, ep)                        # staged combine
        if gather_data:
            n = y.shape[0] // nd
            y = y[sharding.axis_index("data") * n:][:n]
        return y
    f = sharding.shard_map(body, (xspec, xspec, xspec) + _expert_specs(cfg),
                           xspec)
    return f(x, w.to(x.dtype), idx, ex["gate"], ex["up"], ex["down"])
