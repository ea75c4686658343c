"""Multi-head Latent Attention (DeepSeek-V2/V3). [arXiv:2412.19437]

Prefill and training run the *expanded* form: the latent is
up-projected to per-head K/V and attention runs through the flash
kernel over qk_dim = nope + rope (192) for the keys and v_head_dim
(128) for the values. Decode runs the *absorbed* form: the queries are
pulled into latent space through W_UK and attention runs against the
cached 576-value-per-token latent — the KV-transfer payload for MLA is
the latent, 10-60x smaller than the expanded KV.

The port of the reference's `repro.models.mla`. The expanded keys are
the nope part and the shared rope part concatenated into a tensor of
their own: a broadcast view would have stride 0 over the heads, which
no TMA tensor map reads. `mla_forward_sp` is the Megatron-SP form over
a `model` mesh axis: `sp_latents` (pointwise over the tokens, computed
before the region as the reference's are, so a rank's block of them is
its tokens' latents) and one `sharding.shard_map` of the per-rank piece
that follows the latents' all-gather, `sp_heads` (the rank's H/M heads
over the whole sequence through the flash kernel, and their partial
out-projection), whose partials are reduce-scattered back to the
sequence blocks.

In a block program (`sharding.in_blocks`) each function runs on the
rank's rows and its weight blocks, each gathered over data inside the
layer (FSDP, `_gathered`): `mla_forward` the latents of its S/M
positions, all-gathered over `model`, and its H/M heads through the
flash kernel at Dk 192 / Dv 128, its heads' partial out-projection
psummed over `model`; `mla_forward_sp` its S/M
positions' latents; `mla_decode` every head's absorbed query (all-
gathered over `model`) against its S/M positions of its block of the
latent cache (every row), merged over `model`, then its heads' values
and out-projection. A prefill's latent cache comes out as the reference
constrains it: (B/dp, S/M, 1, C).
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree
from repro_torch.models import attention
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_spec
from repro_torch.models.module import Spec, is_spec
from repro_torch.parallel import collectives, sharding
from repro_torch.parallel.sharding import P


def latent_dim(cfg) -> int:
    a = cfg.mla
    return a.kv_lora_rank + a.qk_rope_head_dim


def mla_spec(cfg) -> dict:
    a = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
    s: dict = {}
    if a.q_lora_rank:
        s["w_dq"] = Spec((D, a.q_lora_rank), ("embed", "q_lora"))
        s["q_norm"] = rmsnorm_spec(a.q_lora_rank)
        s["w_uq"] = Spec((a.q_lora_rank, H, qk), ("q_lora", "heads", "head_dim"))
    else:
        s["w_q"] = Spec((D, H, qk), ("embed", "heads", "head_dim"))
    s["w_dkv"] = Spec((D, a.kv_lora_rank), ("embed", "kv_lora"))
    s["kv_norm"] = rmsnorm_spec(a.kv_lora_rank)
    s["w_kr"] = Spec((D, a.qk_rope_head_dim), ("embed", None))
    s["w_uk"] = Spec((a.kv_lora_rank, H, a.qk_nope_head_dim),
                     ("kv_lora", "heads", "head_dim"))
    s["w_uv"] = Spec((a.kv_lora_rank, H, a.v_head_dim),
                     ("kv_lora", "heads", "head_dim"))
    s["w_o"] = Spec((H, a.v_head_dim, D), ("heads", "head_dim", "embed"))
    return s


def _up(x, w):
    """einsum("bsr,rhk->bshk", x, w) as one matrix product."""
    R, H, K = w.shape
    return (x @ w.reshape(R, H * K)).unflatten(-1, (H, K))


def _queries(params, x, positions, cfg):
    a = cfg.mla
    if a.q_lora_rank:
        ql = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
        q = _up(ql, params["w_uq"])
    else:
        q = _up(x, params["w_q"])
    qn = q[..., :a.qk_nope_head_dim]
    qr = apply_rope(q[..., a.qk_nope_head_dim:], positions, cfg.rope_theta)
    return qn, qr


def _latent(params, x, positions, cfg):
    ckv = rmsnorm(params["kv_norm"], x @ params["w_dkv"], cfg.norm_eps)
    kr = apply_rope(x @ params["w_kr"], positions, cfg.rope_theta)
    return ckv, kr


def _out(o, w_o):
    """einsum("bshv,hvd->bsd", o, w_o)."""
    H, V, D = w_o.shape
    return o.flatten(-2) @ w_o.reshape(H * V, D)


HEAD_AXES = {"w_uq": ("q_lora", "heads", "head_dim"),
             "w_uk": ("kv_lora", "heads", "head_dim"),
             "w_uv": ("kv_lora", "heads", "head_dim"),
             "w_o": ("heads", "head_dim", "embed")}


def _gathered(params, cfg, names=None):
    """A block program's MLA weights (those of `names`, or all), each
    block gathered over data (FSDP), a head dim's split over `model`
    kept; the specs by the global shapes."""
    spec = mla_spec(cfg)
    names = tuple(params) if names is None else names
    return {n: tree.map(lambda s_, a: sharding.gather_param(
        a, s_.axes, shape=s_.shape), spec[n], params[n], is_leaf=is_spec)
        for n in names}


LATENT_NAMES = ("w_dq", "q_norm", "w_dkv", "kv_norm", "w_kr")


def sp_latents(params, x, positions, cfg):
    """The latents of a block of tokens (pointwise over the sequence):
    the normed q-lora latent, the normed kv latent and the roped shared
    key, concatenated on the last dim: (B, s, q_lora + kv_lora + rope)."""
    ql = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
    ckv, kr = _latent(params, x, positions, cfg)
    return torch.cat([ql, ckv, kr], dim=-1)


def sp_heads(lat, positions, w_uq, w_uk, w_uv, w_o, cfg):
    """One rank's heads over the whole sequence, from the gathered
    latents: its queries and expanded keys and values, flash attention
    (B, S, H/M, 1, 192 / 128), and its heads' partial out-projection
    (B, S, D), in the latents' dtype."""
    a = cfg.mla
    B, S = lat.shape[:2]
    ql, ckv, kr = lat.split([a.q_lora_rank, a.kv_lora_rank,
                             a.qk_rope_head_dim], dim=-1)
    q = _up(ql, w_uq)                                     # (B,S,H_loc,qk)
    qr = apply_rope(q[..., a.qk_nope_head_dim:], positions, cfg.rope_theta)
    q = torch.cat([q[..., :a.qk_nope_head_dim], qr], dim=-1)
    H_loc = q.shape[2]
    k = torch.cat([_up(ckv, w_uk), kr[:, :, None].expand(
        B, S, H_loc, a.qk_rope_head_dim)], dim=-1)        # materialised
    out = attention.chunked_attention(q.unsqueeze(3), k, _up(ckv, w_uv),
                                      causal=True)
    return _out(out.reshape(B, S, H_loc, a.v_head_dim), w_o).to(lat.dtype)


def mla_forward_sp(params, x, positions, cfg, *, q_chunk=512, kv_chunk=1024):
    """Megatron-SP MLA: the residual stream stays sequence-sharded over
    `model`; only the latents (q_lora + kv_lora + rope, 2176 values a
    token for deepseek-v3, vs 7168 of residual) are all-gathered; the
    heads are local; the out-projection is reduce-scattered back to the
    sequence blocks. The reference's `q_chunk` / `kv_chunk` tile its
    chunked attention; the flash kernel's tiles are fixed."""
    del q_chunk, kv_chunk
    if not cfg.mla.q_lora_rank:
        raise ValueError("the SP path assumes q-lora (deepseek-v3's config)")
    B = x.shape[0]
    b = sharding.batch_axes_prefix(B) or None
    lspec, pspec = P(b, "model", None), P(b, "model")
    names = tuple(HEAD_AXES)
    wspecs = tuple(sharding.resolve_spec(HEAD_AXES[n], params[n].shape,
                                         "param") for n in names)

    def body(lat_l, pos_l, *ws):
        ws = [sharding.gather_param(w, HEAD_AXES[n]) for n, w in zip(names, ws)]
        lat = sharding.all_gather(lat_l, "model", 1)
        pos = sharding.all_gather(pos_l, "model", 1)
        return sharding.psum_scatter(sp_heads(lat, pos, *ws, cfg), "model",
                                     1)
    # the latents are pointwise over the sequence: computed whole, as the
    # reference computes them outside its region, and entered by block
    # (in a block program, on the rank's S/M positions: its block)
    lat = sp_latents(_gathered(params, cfg, LATENT_NAMES)
                     if sharding.in_blocks() else params, x, positions, cfg)
    return sharding.shard_map(body, (lspec, pspec) + wspecs, lspec)(
        lat, positions, *(params[n] for n in names))


def mla_forward(params, x, positions, cfg, *, return_cache: bool = False,
                q_chunk=512, kv_chunk=1024):
    """Expanded-form MLA over a full sequence. x: (B,S,D). The cache of
    a prefill is the latent, (B,S,1,kv_lora_rank + qk_rope). The
    reference's `q_chunk` / `kv_chunk` tile its chunked attention; the
    flash kernel's tiles are fixed, so they change nothing."""
    del q_chunk, kv_chunk
    if sharding.in_blocks():
        return _forward_blocks(params, x, positions, cfg, return_cache)
    a = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    qn, qr = _queries(params, x, positions, cfg)
    ckv, kr = _latent(params, x, positions, cfg)

    kn = _up(ckv, params["w_uk"])
    v = _up(ckv, params["w_uv"])
    q = torch.cat([qn, qr], dim=-1)                         # (B,S,H,qk)
    k = torch.cat([kn, kr[:, :, None].expand(B, S, H, a.qk_rope_head_dim)],
                  dim=-1)                                   # materialised
    out = collectives.attend(q.unsqueeze(3), k, v, causal=True)
    y = _out(out.reshape(B, S, H, a.v_head_dim), params["w_o"])
    if not return_cache:
        return y
    return y, torch.cat([ckv, kr], dim=-1)[:, :, None, :]


def _forward_blocks(params, x, positions, cfg, return_cache: bool):
    """`mla_forward` in a block program, on the rank's rows x: (b, S, D)
    whole over `model`, or under Megatron-SP its S/M positions (b, S/M,
    D). The latents (pointwise over the tokens) of its S/M positions,
    all-gathered over `model` (where S splits), then its H/M heads'
    queries, expanded keys and values (every head where they do not
    split) from them, the flash kernel over them, and its heads' partial
    out-projection psummed over `model` (psum-scattered back to its S/M
    positions under Megatron-SP). A prefill's latent cache is the rank's
    S/M positions' latents (the reference's constraint to (batch,
    kv_seq))."""
    a = cfg.mla
    w = _gathered(params, cfg)
    b, S = x.shape[0], positions.shape[1]
    M = sharding.mesh_axis_size("model")
    sp = x.shape[1] != S
    split = M > 1 and S % M == 0
    xs, ps = x, positions
    if split:
        n, r = S // M, sharding.axis_index("model")
        xs, ps = (x if sp else x[:, r * n:(r + 1) * n],
                  positions[:, r * n:(r + 1) * n])
    ckv, kr = _latent(w, xs, ps, cfg)
    lat = [ckv, kr]
    if a.q_lora_rank:
        lat.insert(0, rmsnorm(w["q_norm"], xs @ w["w_dq"], cfg.norm_eps))
    mine = torch.cat([ckv, kr], dim=-1)[:, :, None, :]
    lat = torch.cat(lat, dim=-1)
    if split:
        lat = sharding.all_gather(lat, "model", 1)
    *ql, ckv, kr = lat.split(([a.q_lora_rank] if a.q_lora_rank else [])
                             + [a.kv_lora_rank, a.qk_rope_head_dim], dim=-1)
    q = (_up(ql[0], w["w_uq"]) if ql else _up(
        sharding.all_gather(x, "model", 1) if sp else x, w["w_q"]))
    qr = apply_rope(q[..., a.qk_nope_head_dim:], positions, cfg.rope_theta)
    Hl = q.shape[2]
    q = torch.cat([q[..., :a.qk_nope_head_dim], qr], dim=-1)  # (b,S,Hl,qk)
    k = torch.cat([_up(ckv, w["w_uk"]), kr[:, :, None].expand(
        b, S, Hl, a.qk_rope_head_dim)], dim=-1)             # materialised
    out = attention.chunked_attention(q.unsqueeze(3), k, _up(ckv, w["w_uv"]),
                                      causal=True)
    del q, qr, k, lat, ql, ckv, kr
    y = _out(out.reshape(b, S, Hl, a.v_head_dim), w["w_o"])
    del out
    if sp and Hl != cfg.n_heads:
        y = sharding.psum_scatter(y, "model", 1)
    elif sp:
        y = sharding.relayout(y, P(), P(None, "model"))
    elif Hl != cfg.n_heads:
        y = sharding.psum(y, "model")
    return (y, mine) if return_cache else y


def _decode_blocks(params, x, cache, pos, cfg):
    """`mla_decode` in a block program: the rank's rows x (b, 1, D), its
    block of the latent cache (every row, written in place). Every
    head's absorbed query (the rank's H/M heads', all-gathered over
    `model`) against its S/M cache positions, merged over `model`
    (`collectives.blocks_decode`); then its heads' values and partial
    out-projection, psummed over `model`. Where the heads or the cache
    do not split, a rank does the whole of that part."""
    a = cfg.mla
    w = _gathered(params, cfg)
    b = x.shape[0]
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=x.device).broadcast_to((b,))[:, None]
    qn, qr = _queries(w, x, positions, cfg)                 # (b,1,Hl,*)
    q_eff = torch.einsum("bhn,rhn->bhr", qn[:, 0], w["w_uk"])
    q_full = torch.cat([q_eff, qr[:, 0]], dim=-1)           # (b,Hl,C)
    ckv, kr = _latent(w, x, positions, cfg)
    new = torch.cat([ckv, kr], dim=-1)[:, 0]
    Hl = q_full.shape[1]
    M = sharding.mesh_axis_size("model")
    seq_split = M > 1 and cache.shape[1] % M == 0
    gather = Hl != cfg.n_heads and seq_split
    if gather:
        q_full = sharding.all_gather(q_full, "model", 1)
    qk_dim = a.qk_nope_head_dim + a.qk_rope_head_dim
    out, cache, _ = collectives.blocks_decode(
        q_full[:, None], cache, None, new[:, None], None, pos,
        M if seq_split else 1, sm_scale=1.0 / math.sqrt(qk_dim),
        v_dims=a.kv_lora_rank)
    out = out[:, 0]
    if gather:
        r = sharding.axis_index("model")
        out = out[:, r * Hl:(r + 1) * Hl]
    o = torch.einsum("bhr,rhv->bhv", out.float(),
                     w["w_uv"].float()).to(x.dtype)
    y = _out(o[:, None], w["w_o"])
    return (sharding.psum(y, "model") if Hl != cfg.n_heads else y), cache


def mla_decode(params, x, cache, pos, cfg):
    """Absorbed-form single-token decode. x: (B,1,D); cache: (B,S,1,C);
    pos: scalar or (B,) write index. In a block program the cache is
    the rank's block, written in place (`_decode_blocks`)."""
    if sharding.in_blocks():
        return _decode_blocks(params, x, cache, pos, cfg)
    a = cfg.mla
    B = x.shape[0]
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=x.device).broadcast_to((B,))[:, None]
    qn, qr = _queries(params, x, positions, cfg)             # (B,1,H,*)
    # absorb W_UK: q_eff[h] = qn[h] @ W_UK[:,h,:]^T  -> latent space
    q_eff = torch.einsum("bhn,rhn->bhr", qn[:, 0], params["w_uk"])
    q_full = torch.cat([q_eff, qr[:, 0]], dim=-1)            # (B,H,C)
    ckv, kr = _latent(params, x, positions, cfg)
    new = torch.cat([ckv, kr], dim=-1)[:, 0]                 # (B,C)

    qk_dim = a.qk_nope_head_dim + a.qk_rope_head_dim
    # q grouped as (B, KVH=1, G=H, C): the latent cache is MQA-like
    out, cache, _ = collectives.seqparallel_decode_attention(
        q_full[:, None], cache, None, new[:, None], None, pos,
        sm_scale=1.0 / math.sqrt(qk_dim), v_dims=a.kv_lora_rank)
    o = torch.einsum("bhr,rhv->bhv", out[:, 0].float(),
                     params["w_uv"].float()).to(x.dtype)     # (B,H,v)
    return _out(o[:, None], params["w_o"]), cache


def mla_cache_spec(cfg, batch: int, seq_len: int) -> Spec:
    return Spec((batch, seq_len, 1, latent_dim(cfg)),
                ("batch", "kv_seq", None, None), init="zeros")
