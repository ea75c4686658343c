"""Decoder-only LM: layer plan -> groups -> step functions.

The port of the reference's `repro.models.transformer` for the
decoder families one process serves: the dense attention decoders
(gemma-2b and the other `attn` + dense-FFN configurations), the MoE
decoders (granite-moe: `attn` + `moe`; deepseek-v3: `mla` with the
`dense_big` FFN first, then `moe`, and the multi-token-prediction
head), the Griffin hybrid (recurrentgemma: `rec` RG-LRU blocks and
`attn_win` local attention) and the SSM (mamba2: `ssm` blocks, no
FFN). The parameter and cache specs, the GQA attention block (train /
prefill through the flash kernel, windowed or not; decode through the
local flash-decode or the rolling window), `block_apply`, and
`DecoderLM`'s `init` / `forward` / `prefill` / `decode_step`.

`forward` is the training forward: it records gradients where the
parameters require them (`train.train_loop` differentiates it), and with
`cfg.remat` each layer of a training forward under grad mode is
recomputed in the backward (`torch.utils.checkpoint`, the reference's
`jax.checkpoint`) under the model's `remat_policy`: "nothing" saves
nothing (`nothing_saveable`), "dots" saves the outputs of the matrix
products without batch dimensions (`aten.mm`, `aten.addmm`: JAX's
`dots_with_no_batch_dims_saveable`) and recomputes the rest, the batched
products (`bmm`: the attention scores, the experts) included. `prefill`
and `decode_step` run under `torch.no_grad()`. A frontend config
(internvl2-2b's patches) splices its embeddings over the first token
rows, as the reference does.

Under a `DeviceMesh` the dense, MoE, SSM and hybrid decoders
(`sharding.BLOCK_FAMILIES`) run the block program (`sharding.program`):
`forward`, `prefill` and `decode_step` take and give this rank's blocks,
the residual stream its rows (B/dp, S, D), or its S/M positions under
Megatron-SP; GQA attention, windowed or not, through `_attn_blocks`,
MLA through `mla`'s block functions (`mla_apply`), the FFN through
`ffn._ffn_blocks`, the MoE through `moe.moe_apply` on the rank's tokens
(the aux loss global), mamba2's mixer and the RG-LRU block on the
rank's heads or channels (`ssm`, `rglru`), the MTP head on the rank's
rows, the embedding and logits vocab-parallel (`layers.embed` /
`unembed`); `decode_caches` turns a prefill's cache blocks (GQA,
latent, window, state) into the decode's.

Differences from the reference, on purpose:

  * `_run_groups` is a Python loop over the stacked layer dimension
    where the reference scans with `lax.scan`; PyTorch runs eagerly.
    Each group's stacked leaves are unbound once into per-layer views,
    so a backward stacks each leaf's gradient once (indexing layer by
    layer would build a zero tensor of the whole stack per layer). New
    caches are stacked back per group, as the reference's scan stacks
    them.
  * The reference's `perf.FLAGS` branches come from the mesh
    (`sharding.use_mesh(seq_parallel=, decode_layout=, ...)`): `use_sp`
    (Megatron-SP: `attn_apply_sp`, `mla.mla_forward_sp`, the SP FFN
    and MoE) and `decode_heads_layout` (the head-sharded KV cache).
    `_residual_constrain` resolves the residual stream's layout and
    changes no value (`sharding.constrain`). The reference's
    `FLAGS.remat_policy` is an argument of the model
    (`DecoderLM(cfg, remat_policy=)`, `registry.build_model`). `forward`
    returns the multi-token-prediction head's logits (``mtp_logits``)
    as the reference's does; serving never runs the head.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree
from repro_torch.models import ffn, mla, moe, rglru, ssm
from repro_torch.models.attention import chunked_attention
from repro_torch.models.layers import (apply_rope, embed, embedding_spec,
                                       proj_spec, rmsnorm, rmsnorm_spec,
                                       softcap, unembed)
from repro_torch.models.module import (Spec, init_params, stack_specs,
                                       torch_dtype)
from repro_torch.parallel import collectives, sharding
from repro_torch.parallel.sharding import P

_MIXERS = ("attn", "attn_win", "mla", "rec", "ssm")
_FFNS = ("dense", "dense_big", "moe", "none")


# --------------------------------------------------------------------------
# Layer plan
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerKind:
    mix: str          # attn | attn_win | mla | rec | ssm
    ffn: str          # dense | dense_big | moe | none


def layer_plan(cfg) -> list[LayerKind]:
    L = cfg.n_layers
    if cfg.family == "ssm":
        return [LayerKind("ssm", "none")] * L
    if cfg.hybrid is not None:
        p = cfg.hybrid.pattern
        kinds = {"rec": LayerKind("rec", "dense"),
                 "attn": LayerKind("attn_win", "dense")}
        return [kinds[p[i % len(p)]] for i in range(L)]
    mix = "mla" if cfg.use_mla else "attn"
    if cfg.moe is not None:
        plan = []
        for i in range(L):
            f = "dense_big" if i < cfg.moe.first_dense else "moe"
            plan.append(LayerKind(mix, f))
        return plan
    return [LayerKind(mix, "dense")] * L


def group_plan(cfg) -> list[tuple[tuple[LayerKind, ...], int]]:
    plan = layer_plan(cfg)
    if cfg.hybrid is not None:
        p = len(cfg.hybrid.pattern)
        n_super, rem = divmod(len(plan), p)
        groups = []
        if n_super:
            groups.append((tuple(plan[:p]), n_super))
        i = n_super * p
        while i < len(plan):                      # group the ragged tail
            j = i
            while j < len(plan) and plan[j] == plan[i]:
                j += 1
            groups.append(((plan[i],), j - i))
            i = j
        return groups
    groups = []
    i = 0
    while i < len(plan):
        j = i
        while j < len(plan) and plan[j] == plan[i]:
            j += 1
        groups.append(((plan[i],), j - i))
        i = j
    return groups


# --------------------------------------------------------------------------
# GQA attention block
# --------------------------------------------------------------------------
def attn_spec(cfg) -> dict:
    D, H, KVH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    bd = (1, 2) if cfg.qkv_bias else None
    return {
        "wq": proj_spec((D, H, hd), ("embed", "heads", "head_dim"),
                        bias_dims=bd),
        "wk": proj_spec((D, KVH, hd), ("embed", "kv_heads", "head_dim"),
                        bias_dims=bd),
        "wv": proj_spec((D, KVH, hd), ("embed", "kv_heads", "head_dim"),
                        bias_dims=bd),
        "wo": proj_spec((H, hd, D), ("heads", "head_dim", "embed")),
    }


def _project(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    D, H, K = w.shape
    return (x @ w.reshape(D, H * K)).unflatten(-1, (H, K))


def _proj(w, x):
    """A projection's einsum (`_project`) plus its bias, if any."""
    y = _project(x, w["w"])
    if "b" in w:
        y = y + w["b"].to(y.dtype)
    return y


def _qkv(params, x, positions, cfg, *, split_in=None, split=(True,) * 3):
    """q, k, v of x, roped. `split_in` (M, r): the projections whose
    heads `split` does not mark as split over `model` contract over the
    rank's d_model/M columns (`_proj_split`)."""
    q, k, v = (_proj_split(params[n], x, None if sp else split_in)
               for n, sp in zip(("wq", "wk", "wv"), split))
    return _roped(q, positions, cfg), _roped(k, positions, cfg), v


def _proj_split(w, x, split_in=None):
    """`_proj`; with `split_in` (M, r) the contraction over the rank's
    d_model/M columns of x and rows of the weight, the partials psummed
    over `model` (a block program's decode: its rows are too few to
    repeat the whole contraction on every rank, as the reference's
    partitioner chooses too)."""
    if split_in is None:
        return _proj(w, x)
    M, r = split_in
    n = x.shape[-1] // M
    y = sharding.psum(_project(x[..., r * n:(r + 1) * n],
                               w["w"][r * n:(r + 1) * n]), "model")
    return y + w["b"].to(y.dtype) if "b" in w else y


def _roped(y, positions, cfg):
    return apply_rope(y, positions, cfg.rope_theta) if cfg.rope_theta else y


def _out_proj(params, y):
    """einsum("bshk,hkd->bsd", y, params["wo"]["w"])."""
    H, K, D = params["wo"]["w"].shape
    return y.flatten(-2) @ params["wo"]["w"].reshape(H * K, D)


class _ColumnGrad(torch.autograd.Function):
    """x @ w, w (K, N) whole over `model`, on every rank of `model`: a
    projection whose output does not split there (an attention whose
    heads and queries stay whole: the encoder's, a cross-attention's
    frame K/V). As GSPMD partitions it: x's gradient whole on every rank
    (its share, from its cotangent), the weight's in this rank's N/M
    output columns only, from the cotangent psum-scattered over `model`
    there (1/M of the work), zeros elsewhere; the replicas' sum
    (`sharding.reduce_replicas`) is the weight's gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        ctx.mesh = sharding.current()
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with sharding.use_context(ctx.mesh):
            gs = sharding.psum_scatter(g, "model", g.ndim - 1)
            c0 = sharding.axis_index("model") * gs.shape[-1]
        gw = torch.zeros_like(w)
        gw[:, c0:c0 + gs.shape[-1]] = (
            x.reshape(-1, x.shape[-1]).T @ gs.reshape(-1, gs.shape[-1]))
        return g @ w.T, gw


def _replicated(x, w):
    """x @ w (w (K, N)) computed whole on every rank of `model`: in a
    block program with a model axis whose size divides N, its weight
    gradient by output columns (`_ColumnGrad`); else the product."""
    M = sharding.mesh_axis_size("model")
    if (M > 1 and w.shape[-1] % M == 0 and sharding.in_blocks()
            and torch.is_grad_enabled() and (x.requires_grad
                                             or w.requires_grad)):
        return _ColumnGrad.apply(x, w)
    return x @ w


def _proj_replicated(w, x):
    """`_proj` of a projection whose heads stay whole on every rank of
    `model` (`_replicated`)."""
    D, H, K = w["w"].shape
    y = _replicated(x, w["w"].reshape(D, H * K)).unflatten(-1, (H, K))
    return y + w["b"].to(y.dtype) if "b" in w else y


def _out_proj_replicated(params, y):
    """`_out_proj` of heads whole on every rank of `model`
    (`_replicated`)."""
    H, K, D = params["wo"]["w"].shape
    return _replicated(y.flatten(-2), params["wo"]["w"].reshape(H * K, D))


ATTN_AXES = {"wq": ("embed", "heads", "head_dim"),
             "wk": ("embed", "kv_heads", "head_dim"),
             "wv": ("embed", "kv_heads", "head_dim"),
             "wo": ("heads", "head_dim", "embed")}


def attn_sp_rank(x, positions, wq, wk, wv, wo, r: int, cfg, kv_sharded):
    """Rank r's share of `attn_apply_sp` on the gathered sequence: its
    H/M query heads' projections (and its kv heads', or every kv head
    where they did not split), the flash kernel over the kv heads its
    query heads group into, and its heads' partial out-projection
    (B, S, D)."""
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    G = H // KVH
    hd = cfg.resolved_head_dim
    q, k, v = _project(x, wq), _project(x, wk), _project(x, wv)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    B, S, H_loc = q.shape[:3]
    if not kv_sharded:
        # wk whole: the kv heads this rank's query heads group into
        kv_w = max(1, H_loc // G)
        start = (r * H_loc) // G
        k, v = k[:, :, start:start + kv_w], v[:, :, start:start + kv_w]
    kvh = k.shape[2]
    out = chunked_attention(
        q.reshape(B, S, kvh, H_loc // kvh, hd), k, v, causal=True)
    return out.reshape(B, S, H_loc * hd) @ wo.reshape(H_loc * hd, -1)


def attn_apply_sp(params, x, positions, cfg):
    """Megatron-SP attention for head-TP archs: one shard_map — the
    sequence-sharded residual all-gathered over `model`, head-local
    projections and flash attention (`attn_sp_rank`), the partial
    out-projection reduce-scattered back to the sequence blocks."""
    B = x.shape[0]
    b = sharding.batch_axes_prefix(B) or None
    xspec, pspec = P(b, "model", None), P(b, "model")
    names = tuple(ATTN_AXES)
    # specs by the global shapes: a block program's params are blocks
    spec = attn_spec(cfg)
    wspecs = tuple(sharding.resolve_spec(
        ATTN_AXES[n], spec[n]["w"].shape, "param") for n in names)
    kv_sharded = wspecs[1][1] is not None             # KVH % M == 0

    def body(x_l, pos_l, *ws):
        ws = [sharding.gather_param(w, ATTN_AXES[n])
              for n, w in zip(names, ws)]
        x_f = sharding.all_gather(x_l, "model", 1)
        pos_f = sharding.all_gather(pos_l, "model", 1)
        y = attn_sp_rank(x_f, pos_f, *ws, sharding.axis_index("model"), cfg,
                         kv_sharded)
        return sharding.psum_scatter(y, "model", 1)
    y = sharding.shard_map(body, (xspec, pspec) + wspecs, xspec)(
        x, positions, *(params[n]["w"] for n in names))
    return y, None


def attn_apply(params, x, positions, cfg, *, window=0, mode="train",
               cache=None, pos=None):
    """Returns (y, new_cache): the cache rows of a prefill, the updated
    cache of a decode step, None in training. With a `window`, the
    prefill attends through the flash kernel's window mask and keeps
    the last min(window, S) keys in the rolling layout (token p in slot
    p mod W), and decode writes and reads that window. The reference's
    `q_chunk` / `kv_chunk` / `block_skip` (read from its `repro.perf`
    flags) tile its chunked attention; the flash kernel's tiles are
    fixed, so the port has neither the flags nor the knobs."""
    B, S, D = x.shape
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    G = H // KVH
    hd = cfg.resolved_head_dim
    if sharding.in_blocks():
        S = positions.shape[1]
        if x.shape[1] == S:
            return _attn_blocks(params, x, positions, cfg, mode=mode,
                                cache=cache, pos=pos, window=window)
        # Megatron-SP: x is the rank's S/M positions of the stream
        n, r = x.shape[1], sharding.axis_index("model")
        mine = positions[:, r * n:(r + 1) * n]
        if takes_attn_sp(cfg, S, mode=mode, window=window):
            return attn_apply_sp(params, x, mine, cfg)
        y, new_cache = _attn_blocks(params, sharding.all_gather(x, "model", 1),
                                    positions, cfg, mode=mode, cache=cache,
                                    pos=pos, window=window)
        return sharding.relayout(y, P(), P(None, "model")), new_cache
    if takes_attn_sp(cfg, S, mode=mode, window=window):
        return attn_apply_sp(params, x, positions, cfg)
    q, k, v = _qkv(params, x, positions, cfg)

    if mode in ("train", "prefill"):
        qg = q.reshape(B, S, KVH, G, hd)
        out = collectives.attend(qg, k, v, causal=True, window=window)
        y = _out_proj(params, out.reshape(B, S, H, hd))
        new_cache = None
        if mode == "prefill":
            if window:
                W = min(window, S)
                idxs = S - W + ((torch.arange(W, device=x.device) - S) % W)
                new_cache = {"k": k[:, idxs], "v": v[:, idxs]}
            else:
                new_cache = {"k": k, "v": v}
        return y, new_cache

    # decode
    q1 = q[:, 0].reshape(B, KVH, G, hd)
    if window:
        out, kc, vc = collectives.window_decode_attention(
            q1, cache["k"], cache["v"], k[:, 0], v[:, 0], pos, window)
    else:
        out, kc, vc = collectives.seqparallel_decode_attention(
            q1, cache["k"], cache["v"], k[:, 0], v[:, 0], pos,
            force_local=decode_heads_layout(cfg))
    y = _out_proj(params, out.reshape(B, 1, H, hd))
    return y, {"k": kc, "v": vc}


def _attn_blocks(params, x, positions, cfg, *, mode, cache, pos, window=0,
                 causal=True):
    """`attn_apply` in a block program, on the rank's rows x (B/dp, S, D)
    (whole over `model`) and its parameter blocks, each gathered over
    data inside the layer (FSDP). q/k/v are column-parallel over the
    heads the branch splits and the out-projection row-parallel:

      * head-TP: the rank's H/M query heads and its kv heads (grouped)
        or every kv head (repeated), `collectives.head_tp_block_attention`;
        its heads' partial out-projection psummed over `model`;
      * context parallelism: q/k/v and the out-projection on the rank's
        S/M rows (`collectives.cp_block_attention` all-gathers K/V), the
        output all-gathered over `model`;
      * local (the heads and the sequence off a multiple of M): the
        whole attention on every rank, each weight's gradient by its
        output columns (`_ColumnGrad`), as GSPMD shares it;
      * decode: the rank's rows against its block of the caches, every
        row (`collectives.blocks_decode`): its kv heads where they
        split (no collective), else its S/M positions merged over
        `model`; a partial out-projection psummed where the heads split.
        With a `window`, the rank's rows against their rows of the
        window, whole over `model` (`collectives.blocks_window_decode`).
        Where the rows are whole over data (`sharding.rows_in_place`)
        the projections contract each weight block where it lies
        (`sharding.matmul_block`).

    A `window` masks every branch's flash call (context parallelism's at
    the rank's q_offset); `causal=False` (the encoder-decoder's encoder)
    unmasks them. A prefill's caches are laid out as the
    reference constrains them: (B/dp, S/M, KVH, hd) where the sequence
    splits over `model`; a window's, the rolling layout of the last
    min(W, S) keys (token p in slot p mod W) cut from the whole K/V,
    whole over `model` (its kv heads split where they divide it)."""
    b, S, _ = x.shape
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    G, hd = H // KVH, cfg.resolved_head_dim
    M = sharding.mesh_axis_size("model")
    r = sharding.axis_index("model") if M > 1 else 0
    spec = attn_spec(cfg)
    heads_split = params["wq"]["w"].shape[1] != H
    kv_split = params["wk"]["w"].shape[1] != KVH
    # a decode whose rows are whole over data keeps its weights in place
    in_place = mode == "decode" and sharding.current().in_place
    if not in_place:
        w = {n: {k: sharding.gather_param(a, spec[n][k].axes,
                                          shape=spec[n][k].shape)
                 for k, a in params[n].items()} for n in params}
    if mode == "decode":
        if in_place:
            def proj(n):
                y = sharding.matmul_block(x, params[n]["w"], ATTN_AXES[n],
                                          spec[n]["w"].shape)
                return (y + params[n]["b"].to(y.dtype) if "b" in params[n]
                        else y)
            q, k, v = proj("wq"), proj("wk"), proj("wv")
            q, k = _roped(q, positions, cfg), _roped(k, positions, cfg)
        else:
            q, k, v = _qkv(w, x, positions, cfg, split_in=(
                (M, r) if M > 1 and x.shape[-1] % M == 0 else None),
                split=(heads_split, kv_split, kv_split))
        if heads_split and not kv_split:
            q = sharding.all_gather(q, "model", 2)
        q1 = q[:, 0].reshape(b, -1, G, hd)
        if window:
            out, kc, vc = collectives.blocks_window_decode(
                q1, cache["k"], cache["v"], k[:, 0], v[:, 0], pos, window)
        else:
            # its S/M cache positions where the kv heads do not split
            seq_split = (M > 1 and not kv_split
                         and cache["k"].shape[1] % M == 0)
            out, kc, vc = collectives.blocks_decode(
                q1, cache["k"], cache["v"], k[:, 0], v[:, 0], pos,
                M if seq_split else 1)
        out = out.reshape(b, 1, -1, hd)
        if heads_split and not kv_split:
            n = H // M
            out = out[:, :, r * n:(r + 1) * n]
        y = (sharding.matmul_block(out, params["wo"]["w"], ATTN_AXES["wo"],
                                   spec["wo"]["w"].shape, contract=2)
             if in_place else _out_proj(w, out))
        return (sharding.psum(y, "model") if heads_split else y,
                {"k": kc, "v": vc})
    branch = collectives.attend_branch(S, KVH, G)
    s_split = M > 1 and S % M == 0          # the cache's kv_seq -> model
    n = S // M if s_split else S
    mine = slice(r * n, (r + 1) * n)
    if branch == "cp":
        x, positions = x[:, mine], positions[:, mine]
    # the local branch: every head on every rank of model
    proj = _proj_replicated if branch == "local" else _proj
    q = _roped(proj(w["wq"], x), positions, cfg)
    repeated = branch == "head_tp" and not kv_split
    lo, kvw = 0, (w["wk"], w["wv"])
    if repeated and mode == "prefill" and s_split:
        # every kv head on the cache's S/M rows, all-gathered over model
        kc = _roped(_proj(kvw[0], x[:, mine]), positions[:, mine], cfg)
        vc = _proj(kvw[1], x[:, mine])
        k, v = (sharding.all_gather(t, "model", 1) for t in (kc, vc))
    else:
        if repeated and mode == "train":
            # only the kv heads this rank's query heads read
            Hl = H // M
            lo, hi = r * Hl // G, ((r + 1) * Hl - 1) // G + 1
            kvw = tuple({k_: a[:, lo:hi] if k_ == "w" else a[lo:hi]
                         for k_, a in w_.items()} for w_ in kvw)
        k = _roped(proj(kvw[0], x), positions, cfg)
        v = proj(kvw[1], x)
        kc, vc = k, v
    Sq = q.shape[1]
    if branch == "head_tp":
        out = collectives.head_tp_block_attention(
            q, k, v, G, r, lo, causal=causal, window=window)
    elif branch == "cp":
        out, kw_, vw_ = collectives.cp_block_attention(
            q.reshape(b, Sq, KVH, G, hd), k, v, causal=causal,
            window=window)
    else:
        out = chunked_attention(q.reshape(b, Sq, KVH, G, hd), k, v,
                                causal=causal, window=window)
    y = (_out_proj_replicated if branch == "local" else _out_proj)(
        w, out.reshape(b, Sq, -1, hd))
    if heads_split:
        y = sharding.psum(y, "model")
    if branch == "cp":
        y = sharding.all_gather(y, "model", 1)
    if mode != "prefill":
        return y, None
    if window:
        # the rolling window of the whole keys: whole over model
        if branch != "cp":
            kw_, vw_ = k, v
        W = min(window, S)
        idxs = S - W + ((torch.arange(W, device=x.device) - S) % W)
        return y, {"k": kw_[:, idxs], "v": vw_[:, idxs]}
    src = (P(None, "model") if branch == "cp" or (repeated and s_split)
           else P(None, None, "model") if kv_split else P())
    dst = P(None, "model") if s_split else P()
    return y, {"k": sharding.relayout(kc, src, dst),
               "v": sharding.relayout(vc, src, dst)}


def mla_apply(params, x, positions, cfg, *, mode="train", cache=None,
              pos=None):
    """The MLA mixer of `block_apply`: (y, new_cache), the latent cache
    {"ckv"} of a prefill or a decode, None in training. Megatron-SP
    training takes `mla.mla_forward_sp`. In a block program x is the
    rank's rows, its S/M positions under Megatron-SP, which a prefill's
    `mla.mla_forward` takes as they are (its latents from them, its
    output psum-scattered back to them)."""
    if mode == "decode":
        a, ckv = mla.mla_decode(params, x, cache["ckv"], pos, cfg)
        return a, {"ckv": ckv}
    if takes_mla_sp(cfg, positions.shape[1], mode=mode):
        if sharding.in_blocks():        # x: the rank's S/M positions
            n, r = x.shape[1], sharding.axis_index("model")
            positions = positions[:, r * n:(r + 1) * n]
        return mla.mla_forward_sp(params, x, positions, cfg), None
    if mode == "prefill":
        a, ckv = mla.mla_forward(params, x, positions, cfg,
                                 return_cache=True)
        return a, {"ckv": ckv}
    return mla.mla_forward(params, x, positions, cfg), None


# --------------------------------------------------------------------------
# Cache specs
# --------------------------------------------------------------------------
def decode_heads_layout(cfg) -> bool:
    """Head-sharded KV cache layout, where the mesh's `decode_layout` is
    "heads" and the kv heads divide the model axis: each rank decodes
    its kv heads with no collective inside the attention; only the
    output's heads are gathered back."""
    ctx = sharding.current()
    M = sharding.mesh_axis_size("model")
    return (ctx is not None and ctx.decode_layout == "heads" and M > 1
            and cfg.n_kv_heads % M == 0)


def use_sp(cfg, S: int) -> bool:
    """Megatron-SP residual applies: the mesh's `seq_parallel` on, a
    sequence that splits over `model`, and an arch family whose blocks
    tolerate a sequence-sharded stream (the dense and MoE decoders, whose
    block program then holds the rank's S/M positions of the stream; the
    SSM and the hybrid keep it whole, as the reference's do)."""
    ctx = sharding.current()
    M = sharding.mesh_axis_size("model")
    return (ctx is not None and ctx.seq_parallel and M > 1 and S % M == 0
            and cfg.family not in ("ssm", "hybrid", "encdec"))


def takes_attn_sp(cfg, S: int, *, mode="train", window=0) -> bool:
    """`attn_apply` runs `attn_apply_sp`: a training forward with no
    window under `use_sp`, query heads that split over `model` into
    whole groups a rank (or a rank's heads within one group), and no
    qkv bias."""
    M = sharding.mesh_axis_size("model")
    H, G = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
    H_loc = max(1, H // M)
    return (mode == "train" and not window and use_sp(cfg, S) and H % M == 0
            and not cfg.qkv_bias and (H_loc % G == 0 or G % H_loc == 0))


def takes_mla_sp(cfg, S: int, *, mode="train") -> bool:
    """`block_apply` runs `mla.mla_forward_sp`: a training forward under
    `use_sp`, q-lora, and query heads that split over `model`."""
    return (mode == "train" and use_sp(cfg, S) and bool(cfg.mla.q_lora_rank)
            and cfg.n_heads % sharding.mesh_axis_size("model") == 0)


def takes_ffn_sp(cfg, S: int, d_ff: int, *, mode="train",
                 bias=False) -> bool:
    """`block_apply`'s FFN of width `d_ff` (a dense FFN, or the MoE's
    shared experts) runs `ffn_apply(sp=True)`: no decode, `use_sp`, an
    `mlp` dim that splits over `model`, and no bias."""
    return (mode != "decode" and use_sp(cfg, S) and not bias
            and d_ff % sharding.mesh_axis_size("model") == 0)


def attn_cache_spec(cfg, batch: int, seq_len: int, *, window=0) -> dict:
    KVH, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if window:
        W = min(window, seq_len)
        return {"k": Spec((batch, W, KVH, hd),
                          ("batch", "window", "kv_heads", "head_dim"),
                          init="zeros"),
                "v": Spec((batch, W, KVH, hd),
                          ("batch", "window", "kv_heads", "head_dim"),
                          init="zeros")}
    seq_ax = "seq" if decode_heads_layout(cfg) else "kv_seq"
    return {"k": Spec((batch, seq_len, KVH, hd),
                      ("batch", seq_ax, "kv_heads", "head_dim"),
                      init="zeros"),
            "v": Spec((batch, seq_len, KVH, hd),
                      ("batch", seq_ax, "kv_heads", "head_dim"),
                      init="zeros")}


def block_cache_spec(cfg, kind: LayerKind, batch: int, seq_len: int) -> dict:
    if kind.mix == "attn":
        return attn_cache_spec(cfg, batch, seq_len)
    if kind.mix == "attn_win":
        return attn_cache_spec(cfg, batch, seq_len,
                               window=cfg.hybrid.window)
    if kind.mix == "mla":
        return {"ckv": mla.mla_cache_spec(cfg, batch, seq_len)}
    if kind.mix == "rec":
        return rglru.rglru_cache_spec(cfg, batch)
    if kind.mix == "ssm":
        return ssm.mamba2_cache_spec(cfg, batch)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# Block = mixer + FFN
# --------------------------------------------------------------------------
def _check_kind(kind: LayerKind):
    if kind.mix not in _MIXERS or kind.ffn not in _FFNS:
        raise ValueError(kind)


def block_spec(cfg, kind: LayerKind) -> dict:
    _check_kind(kind)
    D = cfg.d_model
    s: dict = {"ln1": rmsnorm_spec(D)}
    if kind.mix in ("attn", "attn_win"):
        s["attn"] = attn_spec(cfg)
    elif kind.mix == "mla":
        s["mla"] = mla.mla_spec(cfg)
    elif kind.mix == "rec":
        s["rec"] = rglru.rglru_block_spec(cfg)
    else:
        s["ssm"] = ssm.mamba2_spec(cfg)
    if kind.ffn == "dense":
        s["ln2"] = rmsnorm_spec(D)
        s["ffn"] = ffn.ffn_spec(D, cfg.d_ff, cfg.act)
    elif kind.ffn == "dense_big":
        s["ln2"] = rmsnorm_spec(D)
        s["ffn"] = ffn.ffn_spec(D, cfg.moe.d_ff_dense, cfg.act)
    elif kind.ffn == "moe":
        s["ln2"] = rmsnorm_spec(D)
        s["moe"] = moe.moe_spec(cfg)
    return s


def block_apply(params, x, positions, cfg, kind: LayerKind, *, mode="train",
                cache=None, pos=None):
    """Returns (x, aux, new_cache). In a block program (the dense, MoE,
    SSM and hybrid decoders, `sharding.BLOCK_FAMILIES`) x is the rank's
    rows, its S/M positions under Megatron-SP, and every branch reads
    its blocks: attention (windowed or not), MLA, the RG-LRU and mamba2
    mixers, the FFN and the MoE."""
    _check_kind(kind)
    zc = cfg.zero_centered_norm
    eps = cfg.norm_eps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(params["ln1"], x, eps, zero_centered=zc)
    new_cache = None
    if kind.mix in ("attn", "attn_win"):
        window = cfg.hybrid.window if kind.mix == "attn_win" else 0
        a, new_cache = attn_apply(params["attn"], h, positions, cfg,
                                  window=window, mode=mode, cache=cache,
                                  pos=pos)
    elif kind.mix == "mla":
        a, new_cache = mla_apply(params["mla"], h, positions, cfg,
                                 mode=mode, cache=cache, pos=pos)
    elif kind.mix == "rec":
        if mode == "decode":
            a, new_cache = rglru.rglru_decode(params["rec"], h, cache, cfg)
        elif mode == "prefill":
            a, new_cache = rglru.rglru_forward(params["rec"], h, cfg,
                                               return_cache=True)
        else:
            a = rglru.rglru_forward(params["rec"], h, cfg)
    elif mode == "decode":
        a, new_cache = ssm.mamba2_decode(params["ssm"], h, cache, cfg)
    elif mode == "prefill":
        a, new_cache = ssm.mamba2_forward(params["ssm"], h, cfg,
                                          return_cache=True)
    else:
        a = ssm.mamba2_forward(params["ssm"], h, cfg)
    x = x + a
    S = positions.shape[1]      # x's own in a block program's SP stream
    if kind.ffn in ("dense", "dense_big"):
        h = rmsnorm(params["ln2"], x, eps, zero_centered=zc)
        d_ff = cfg.d_ff if kind.ffn == "dense" else cfg.moe.d_ff_dense
        x = x + ffn.ffn_apply(params["ffn"], h, cfg.act, sp=takes_ffn_sp(
            cfg, S, d_ff, mode=mode, bias="b" in params["ffn"]["up"]),
            spec=ffn.ffn_spec(cfg.d_model, d_ff, cfg.act))
    elif kind.ffn == "moe":
        h = rmsnorm(params["ln2"], x, eps, zero_centered=zc)
        y, aux_moe = moe.moe_apply(params["moe"], h, cfg, sp=takes_ffn_sp(
            cfg, S, cfg.moe.n_shared * cfg.moe.d_ff_shared, mode=mode), S=S)
        aux = aux + aux_moe
        x = x + y
    return x, aux, new_cache


def superblock_apply(params, x, positions, cfg, subplan, *, mode="train",
                     cache=None, pos=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {}
    for i, kind in enumerate(subplan):
        key = f"b{i}"
        c = cache[key] if cache is not None else None
        x, a, nc = block_apply(params[key], x, positions, cfg, kind,
                               mode=mode, cache=c, pos=pos)
        aux = aux + a
        new_cache[key] = nc if nc is not None else {}
    return x, aux, new_cache


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------
REMAT_POLICIES = ("nothing", "dots")
# the matrix products without batch dimensions: "dots" saves their outputs
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy of a selective checkpoint."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_kwargs(policy: str) -> dict:
    """`torch.utils.checkpoint` arguments for a remat policy."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} is not one of "
                         f"{REMAT_POLICIES}")
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _save_dots)
    return kw


class DecoderLM:
    def __init__(self, cfg, *, remat_policy: str = "nothing"):
        self.cfg = cfg
        self.groups = group_plan(cfg)
        self.remat_policy = remat_policy
        self._remat = remat_kwargs(remat_policy)

    # -- specs ------------------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        s: dict = {"embed": embedding_spec(cfg.vocab_size, cfg.d_model),
                   "final_norm": rmsnorm_spec(cfg.d_model),
                   "groups": []}
        for subplan, count in self.groups:
            g = {f"b{i}": block_spec(cfg, k) for i, k in enumerate(subplan)}
            s["groups"].append(stack_specs(g, count))
        if not cfg.tie_embeddings:
            s["out_embed"] = embedding_spec(cfg.vocab_size, cfg.d_model)
        if cfg.mtp_depth:
            kind = layer_plan(cfg)[-1]
            s["mtp"] = {
                "proj": Spec((2 * cfg.d_model, cfg.d_model),
                             (None, "embed")),
                "norm_h": rmsnorm_spec(cfg.d_model),
                "norm_e": rmsnorm_spec(cfg.d_model),
                "block": block_spec(cfg, kind),
            }
        return s

    def cache_specs(self, batch: int, seq_len: int) -> list:
        cfg = self.cfg
        out = []
        for subplan, count in self.groups:
            g = {f"b{i}": block_cache_spec(cfg, k, batch, seq_len)
                 for i, k in enumerate(subplan)}
            out.append(stack_specs(g, count))
        return out

    def init(self, generator: torch.Generator, dtype=None, *, device=None):
        """Parameters on `device` (None: the package default, the card),
        the random leaves drawn in tree order from `generator`, which
        must live on that device."""
        return init_params(self.param_specs(), dtype or self.cfg.dtype,
                           device=device, generator=generator)

    def init_cache(self, batch: int, seq_len: int, *, device=None):
        """Zero decode caches on `device` (None: the package default)."""
        return init_params(self.cache_specs(batch, seq_len),
                           self.cfg.dtype, device=device)

    # -- the block program --------------------------------------------------
    def prefill_cache_pspecs(self, batch: int, seq_len: int):
        """The layout of a block program's prefill caches (`batch` rows
        of `seq_len` tokens): each leaf's own axes under the activation
        rules (the rank's rows; its ssm heads, d_inner or lru channels;
        a window's kv heads where they split), a full-attention or
        latent cache by (batch, kv_seq) alone, as `_attn_blocks` lays
        it out."""
        from repro_torch.models import module as mod

        def spec(s_):
            axes = s_.axes
            if "kv_seq" in axes or "seq" in axes:
                axes = tuple("kv_seq" if a == "seq" else
                             a if a in ("batch", "kv_seq") else None
                             for a in axes)
            return sharding.resolve_spec(axes, s_.shape, "act")
        return mod.tree_map_specs(spec, self.cache_specs(batch, seq_len))

    def decode_caches(self, caches, batch: int, seq_len: int, max_seq: int):
        """A prefill's caches (`batch` rows of `seq_len` tokens) padded to
        the decode caches of `max_seq`. In a block program the prefill's
        are the rank's blocks (`prefill_cache_pspecs`, each leaf
        all-gathered whole here by its own spec) and the decode's its
        block under the param rules, every row, as the reference
        resolves its decode's caches."""
        from repro_torch.serve.kvcache import pad_caches
        specs = self.cache_specs(batch, max_seq)
        if not sharding.runs_blocks(self.cfg):
            return pad_caches(caches, seq_len, max_seq, specs)
        with torch.no_grad():
            whole = tree.map(sharding.unblock, caches,
                             self.prefill_cache_pspecs(batch, seq_len))
            return sharding.shard_tree(pad_caches(whole, seq_len, max_seq,
                                                  specs), specs)

    # -- shared trunk ------------------------------------------------------
    def _residual_constrain(self, x):
        """Megatron-SP keeps the residual stream sequence-sharded over
        `model` (the mesh's `seq_parallel`); a layout, no value change.
        A block program holds its layout itself (`_stream_in`)."""
        if sharding.in_blocks():
            return x
        if use_sp(self.cfg, x.shape[1]):
            return sharding.constrain(x, "batch", "kv_seq", None)
        return sharding.constrain(x, "batch", "seq", "embed")

    def _embed_in(self, params, tokens, embeddings=None):
        """Token embeddings; a frontend config's `embeddings` (B, n, D)
        replace the first n rows (the reference's splice)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, shape=self._table_shape).to(
            torch_dtype(cfg.dtype))
        if cfg.scale_embeddings:
            # the reference multiplies by a weakly typed scalar, which JAX
            # rounds to the model dtype first: so does this
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        if cfg.frontend.kind != "none" and embeddings is not None:
            n = embeddings.shape[1]
            x = torch.cat([embeddings.to(x.dtype), x[:, n:]], dim=1)
        return self._stream_in(self._residual_constrain(x))

    def _stream_in(self, x):
        """A block program's residual stream under Megatron-SP: the
        rank's S/M positions (the reference's constrain to (batch,
        kv_seq)); else x as it is."""
        if sharding.in_blocks() and use_sp(self.cfg, x.shape[1]):
            return sharding.relayout(x, P(), P(None, "model"))
        return x

    def _stream_out(self, x, S: int):
        """The whole sequence of a block program's residual stream (an
        all-gather over `model` where Megatron-SP split it)."""
        if x.shape[1] != S:
            return sharding.all_gather(x, "model", 1)
        return x

    def _run_groups(self, params, x, positions, *, mode, caches=None,
                    pos=None):
        cfg = self.cfg
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = []
        remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
        in_place = mode == "decode" and sharding.in_blocks()
        for gi, (subplan, count) in enumerate(self.groups):
            p_ls = unbind_layers(params["groups"][gi], count)
            c_ls = (unbind_layers(caches[gi], count) if caches is not None
                    else [None] * count)
            # a recompute in the backward re-enters this mesh context
            fn = partial(_in_context, sharding.current(), partial(
                superblock_apply, cfg=cfg, subplan=subplan, mode=mode,
                pos=pos))
            ncs = []
            stack = None
            for li, (p_l, c_l) in enumerate(zip(p_ls, c_ls)):
                if remat:
                    x, a, nc = checkpoint(fn, p_l, x, positions, cache=c_l,
                                          **self._remat)
                else:
                    x, a, nc = fn(p_l, x, positions, cache=c_l)
                if mode != "decode":
                    x = self._residual_constrain(x)
                aux_total = aux_total + a
                if mode == "prefill" and tree.leaves(nc):
                    # each layer's cache goes into the group's stack as it
                    # comes: no second copy of the caches at the end
                    if stack is None:
                        stack = tree.map(lambda c: c.new_empty(
                            (count,) + c.shape), nc)
                    tree.map(lambda s_, c: s_[li].copy_(c), stack, nc)
                    nc = None
                ncs.append(nc)
            if in_place:
                new_caches.append(caches[gi])       # written in place
            elif stack is not None:
                new_caches.append(stack)
            elif ncs and tree.leaves(ncs[0]):
                new_caches.append(tree.map(lambda *xs: torch.stack(xs),
                                           *ncs))
            else:
                new_caches.append(_empty_stack(subplan))
        return x, aux_total, new_caches

    def _logits(self, params, h, *, decode=False):
        cfg = self.cfg
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps,
                    zero_centered=cfg.zero_centered_norm)
        table = params["embed"] if cfg.tie_embeddings else params["out_embed"]
        return softcap(unembed(table, h, shape=self._table_shape,
                               split_in=decode,
                               split_dx=self._split_dx(h.shape[1])),
                       cfg.logit_softcap)

    def _split_dx(self, S: int) -> bool:
        """`unembed`'s `split_dx`: a tied table's input gradient splits
        over `model` where the trunk runs its MoE on the rank's S/M
        positions (`moe.moe_branch` "a2a"), a token split GSPMD carries
        into the logits' backward; else it stays whole on every rank."""
        cfg = self.cfg
        return (cfg.tie_embeddings and cfg.moe is not None
                and moe.moe_branch(cfg, S) == "a2a")

    @property
    def _table_shape(self) -> tuple:
        return (self.cfg.vocab_size, self.cfg.d_model)

    @staticmethod
    def _positions(B: int, S: int, device) -> torch.Tensor:
        return torch.arange(S, dtype=torch.int32,
                            device=device).broadcast_to((B, S))

    # -- public step functions ---------------------------------------------
    def forward(self, params, tokens, *, embeddings=None):
        """Full-sequence logits (training). Returns (logits, extras): the
        MoE aux loss and, with an MTP head, its logits (``mtp_logits``,
        one row fewer)."""
        with sharding.program(self.cfg):
            B, S = tokens.shape
            positions = self._positions(B, S, tokens.device)
            x = self._embed_in(params, tokens, embeddings)
            x, aux, _ = self._run_groups(params, x, positions, mode="train")
            x = self._stream_out(x, S)
            extras = {"moe_aux": aux}
            if self.cfg.mtp_depth:
                extras["mtp_logits"] = self._mtp(params, x, tokens,
                                                 positions)
            return self._logits(params, x), extras

    def _mtp(self, params, h, tokens, positions):
        """DeepSeek-style 1-depth multi-token prediction head: the trunk's
        hidden state at t and the embedding of token t + 1, normed,
        concatenated and projected, through one block of the last
        layer's kind, to logits for token t + 2. In a block program: the
        rank's rows, the embedding and the logits vocab-parallel, the
        projection gathered over data, the block on blocks (its stream
        the rank's S/M positions where Megatron-SP splits S - 1)."""
        cfg = self.cfg
        mp = params["mtp"]
        emb_next = embed(params["embed"], tokens[:, 1:],
                         shape=self._table_shape).to(h.dtype)
        hh = rmsnorm(mp["norm_h"], h[:, :-1], cfg.norm_eps)
        ee = rmsnorm(mp["norm_e"], emb_next, cfg.norm_eps)
        proj = mp["proj"]
        if sharding.in_blocks():
            proj = sharding.gather_param(proj, (None, "embed"), shape=(
                2 * cfg.d_model, cfg.d_model))
        z = self._stream_in(torch.cat([hh, ee], dim=-1) @ proj)
        kind = layer_plan(cfg)[-1]
        z, _, _ = block_apply(mp["block"], z, positions[:, 1:], cfg, kind,
                              mode="train")
        z = self._stream_out(z, positions.shape[1] - 1)
        z = rmsnorm(params["final_norm"], z, cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["out_embed"]
        return softcap(unembed(table, z, shape=self._table_shape,
                               split_dx=self._split_dx(positions.shape[1])),
                       cfg.logit_softcap)

    @torch.no_grad()
    def prefill(self, params, tokens, *, embeddings=None, last_pos=None):
        """Full-sequence forward that emits the decode cache.

        Returns (last_token_logits (B,1,V), caches). `last_pos` (B,)
        selects which row's logits are "last" — the real prompt end when
        `tokens` is right-padded to a bucketed length. Rows at positions
        <= last_pos never see the pad rows (causal masking adds exact
        zeros), so the selected logits — and the cache rows a later
        decode step attends to — match an unpadded prefill. In a block
        program (`sharding.program`) `last_pos` is the rank's rows'."""
        with sharding.program(self.cfg):
            B, S = tokens.shape
            positions = self._positions(B, S, tokens.device)
            x = self._embed_in(params, tokens, embeddings)
            x, _, caches = self._run_groups(params, x, positions,
                                            mode="prefill")
            x = self._stream_out(x, S)
            if last_pos is None:
                x_last = x[:, -1:]
            else:
                lp = torch.as_tensor(last_pos, device=x.device).long()
                x_last = x[torch.arange(B, device=x.device),
                           lp.reshape(B)][:, None]
            return self._logits(params, x_last), caches

    @torch.no_grad()
    def decode_step(self, params, tokens, caches, pos):
        """One decode step. tokens: (B,1); pos: scalar or (B,) int (write
        index). Returns (logits (B,1,V), caches); the caches passed in
        are left as they were, but in a block program (`sharding.program`:
        pos the rank's rows', the caches written in place and handed
        back)."""
        with sharding.program(self.cfg), self._rows_in_place(caches):
            B = tokens.shape[0]
            pos = torch.as_tensor(pos, dtype=torch.int32,
                                  device=tokens.device)
            positions = pos.broadcast_to((B,))[:, None]
            x = self._embed_in(params, tokens)
            x, _, caches = self._run_groups(params, x, positions,
                                            mode="decode", caches=caches,
                                            pos=pos)
            return self._logits(params, x, decode=True), caches

    @staticmethod
    def _rows_in_place(caches):
        """A block program's decode keeps its weights in place where its
        rows (the caches hold every row) do not split over data
        (`sharding.rows_in_place`)."""
        if not sharding.in_blocks():
            return contextlib.nullcontext()
        return sharding.rows_in_place(tree.leaves(caches)[0].shape[1])


def _in_context(ctx, fn, *args, **kwargs):
    with sharding.use_context(ctx):
        return fn(*args, **kwargs)


def _empty_stack(subplan):
    return {f"b{i}": {} for i in range(len(subplan))}


def unbind_layers(stacked, count: int) -> list:
    """The per-layer trees of a tree whose leaves stack `count` layers
    on dim 0: each leaf unbound once, so autograd stacks its gradient
    once for the group."""
    cols = [a.unbind(0) for a in tree.leaves(stacked)]
    return [tree.unflatten(stacked, [c[li] for c in cols])
            for li in range(count)]
