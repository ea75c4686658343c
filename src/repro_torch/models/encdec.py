"""Encoder-decoder transformer (whisper-base backbone).

The port of the reference's `repro.models.encdec`. The audio conv
frontend is a stub there and here: the caller hands precomputed frame
embeddings (B, n_frames, d_model), the output the two conv layers would
give. Positions are sinusoidal (whisper learns its decoder positions; the
reference's recorded deviation), norms are LayerNorm.

Self-attention (the encoder's non-causal, the decoder's causal) and the
decoder's cross-attention (its queries against every frame, Sq != Sk,
non-causal) run through `collectives.attend`, the flash kernel; decode
runs the decoder's self-attention through
`collectives.seqparallel_decode_attention` and the cross-attention
through `decode_partials` / `finalize_partials` over the frame keys the
prefill cached (``xk`` / ``xv``).

Under a `DeviceMesh` the encoder-decoder runs the block program
(`sharding.BLOCK_FAMILIES`, `sharding.program`): `forward`, `prefill`
and `decode_step` take and give this rank's blocks, as `DecoderLM`'s
do. The tokens and the frame embeddings are the rank's rows; each
attention takes `attend` 's branch on its own query length
(`transformer._attn_blocks` for the encoder's and the decoder's
self-attention, `_cross_blocks` for the cross-attention: head-TP,
context parallelism at the rank's q_offset against every frame's K/V,
or local), a projection computed whole on every rank of `model` taking
its weight's gradient by output columns (`transformer._ColumnGrad`);
the FFN on the rank's `mlp` columns, its `down` bias added once after
the psum (`ffn._ffn_blocks`); the tied table vocab-parallel, or whole
over `model` (`layers.unembed`). A prefill's caches are the rank's
blocks (`prefill_cache_pspecs`: the self-attention's (B/dp, S/M), the
frame caches (B/dp, F, KVH/M or KVH)); `decode_caches` makes the
decode's, every row under the param rules, which a decode step writes
in place.

Differences from the reference, on purpose: its three `lax.scan` stacks
are Python loops over the stacked layer dimension (each group's leaves
unbound once, as `DecoderLM._run_groups` does); with `cfg.remat` each
decoder layer of a `forward` under grad mode is recomputed in the
backward (`torch.utils.checkpoint`, the reference's `jax.checkpoint` of
the decoder body); `prefill` and `decode_step` run under
`torch.no_grad()`.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import ffn
from repro_torch.models.attention import (chunked_attention, decode_partials,
                                          finalize_partials)
from repro_torch.models.layers import (embed, embedding_spec, layernorm,
                                       layernorm_spec, sinusoidal_positions,
                                       unembed)
from repro_torch.models.module import (Spec, init_params, stack_specs,
                                       torch_dtype)
from repro_torch.models.transformer import (ATTN_AXES, DecoderLM, _attn_blocks,
                                            _in_context, _out_proj,
                                            _out_proj_replicated, _proj,
                                            _proj_replicated, _proj_split,
                                            attn_cache_spec, attn_spec,
                                            unbind_layers)
from repro_torch.parallel import collectives, sharding


def _self_attention(params, x, cfg, *, causal, mode="train", cache=None,
                    pos=None):
    B, S, _ = x.shape
    if sharding.in_blocks():
        positions = (pos.broadcast_to((B,))[:, None] if mode == "decode"
                     else torch.arange(S, device=x.device).broadcast_to(
                         (B, S)))
        return _attn_blocks(params, x, positions, cfg, mode=mode,
                            cache=cache, pos=pos, causal=causal)
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    q = _proj(params["wq"], x)
    k = _proj(params["wk"], x)
    v = _proj(params["wv"], x)
    if mode in ("train", "prefill"):
        out = collectives.attend(q.reshape(B, S, KVH, H // KVH, hd), k, v,
                                 causal=causal)
        y = _out_proj(params, out.reshape(B, S, H, hd))
        return y, ({"k": k, "v": v} if mode == "prefill" else None)
    out, kc, vc = collectives.seqparallel_decode_attention(
        q[:, 0].reshape(B, KVH, H // KVH, hd), cache["k"], cache["v"],
        k[:, 0], v[:, 0], pos)
    return _out_proj(params, out.reshape(B, 1, H, hd)), {"k": kc, "v": vc}


def _cross_attention(params, x, kv_or_cache, cfg, *, mode="train"):
    """kv_or_cache: the encoder's output (train / prefill) or the
    {'k', 'v'} frame keys a prefill cached (decode)."""
    if sharding.in_blocks():
        return _cross_blocks(params, x, kv_or_cache, cfg, mode=mode)
    B, S, _ = x.shape
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    q = _proj(params["wq"], x)
    if mode == "decode":
        k, v = kv_or_cache["k"], kv_or_cache["v"]
        F = k.shape[1]
        acc, _, l = decode_partials(
            q[:, 0].reshape(B, KVH, H // KVH, hd), k, v,
            torch.arange(F, device=x.device), F)
        out = finalize_partials(acc, l).to(x.dtype)
        return _out_proj(params, out.reshape(B, 1, H, hd)), None
    k = _proj(params["wk"], kv_or_cache)
    v = _proj(params["wv"], kv_or_cache)
    out = collectives.attend(q.reshape(B, S, KVH, H // KVH, hd), k, v,
                             causal=False)
    y = _out_proj(params, out.reshape(B, S, H, hd))
    return y, ({"k": k, "v": v} if mode == "prefill" else None)


def _cross_blocks(params, x, kv_or_cache, cfg, *, mode):
    """`_cross_attention` in a block program: the rank's rows x (b, S, D)
    against the frames of the same rows (the encoder's output (b, F, D),
    or in decode the rank's block of the frame caches: every row, its kv
    heads where they split), each weight block gathered over data inside
    the layer (FSDP). The branch is `attend` 's on the queries' S:

      * head-TP: q column-parallel over the rank's H/M query heads, K/V
        over its KVH/M kv heads (grouped) or the kv heads its query heads
        read (repeated); its heads' partial out-projection psummed over
        `model`;
      * context parallelism: the rank's S/M query rows against every
        frame's K/V, projected whole on every rank of `model` (the
        reference's `_context_parallel_attention` holds a key length
        off the query's whole), the output all-gathered over `model`;
      * local: the whole attention on every rank of `model`.

    A projection computed whole on every rank of `model` (the frame K/V
    but under head-TP, every one in the local branch) takes its weight's
    gradient by output columns (`transformer._ColumnGrad`), as GSPMD
    shares it.

    Decode: the rank's rows of the frame caches, every frame, locally
    (`decode_partials`); q projected as `_attn_blocks` projects a
    decode's (column-parallel where the heads split, else contracted
    over the rank's d_model/M columns and psummed; in place where the
    rows are whole over data). A prefill's frame caches (b, F, KVH, hd)
    are the K/V as projected: the rank's rows, its kv heads where they
    split, as the spec ("batch", None, "kv_heads", "head_dim") lays them
    out."""
    b, S, D = x.shape
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    G, hd = H // KVH, cfg.resolved_head_dim
    M = sharding.mesh_axis_size("model")
    r = sharding.axis_index("model") if M > 1 else 0
    spec = attn_spec(cfg)
    heads_split = params["wq"]["w"].shape[1] != H
    # a decode reads the frame caches, not the K/V projections
    kv_split = (kv_or_cache["k"].shape[2] if mode == "decode"
                else params["wk"]["w"].shape[1]) != KVH
    in_place = mode == "decode" and sharding.current().in_place
    if not in_place:
        w = {n: {k: sharding.gather_param(a, spec[n][k].axes,
                                          shape=spec[n][k].shape)
                 for k, a in params[n].items()}
             for n in (("wq", "wo") if mode == "decode" else params)}
    if mode == "decode":
        if in_place:
            q = sharding.matmul_block(x, params["wq"]["w"], ATTN_AXES["wq"],
                                      spec["wq"]["w"].shape)
            if "b" in params["wq"]:
                q = q + params["wq"]["b"].to(q.dtype)
        else:
            q = _proj_split(w["wq"], x, None if heads_split or M == 1
                            or D % M else (M, r))
        if heads_split and not kv_split:
            q = sharding.all_gather(q, "model", 2)
        k = sharding.own_rows(kv_or_cache["k"], b)
        v = sharding.own_rows(kv_or_cache["v"], b)
        F = k.shape[1]
        acc, _, l = decode_partials(
            q[:, 0].reshape(b, -1, G, hd), k, v,
            torch.arange(F, device=x.device), F)
        out = finalize_partials(acc, l).to(x.dtype).reshape(b, 1, -1, hd)
        if heads_split and not kv_split:
            n = H // M
            out = out[:, :, r * n:(r + 1) * n]
        y = (sharding.matmul_block(out, params["wo"]["w"], ATTN_AXES["wo"],
                                   spec["wo"]["w"].shape, contract=2)
             if in_place else _out_proj(w, out))
        return (sharding.psum(y, "model") if heads_split else y), None
    branch = collectives.attend_branch(S, KVH, G)
    n = S // M if branch == "cp" else S
    if branch == "cp":
        x = x[:, r * n:(r + 1) * n]
    # a projection whole on every rank of model: its weight gradient by
    # output columns (`_proj_replicated`)
    q = (_proj_replicated if branch == "local" else _proj)(w["wq"], x)
    lo, kvw = 0, (w["wk"], w["wv"])
    if branch == "head_tp" and not kv_split and mode == "train":
        # only the kv heads this rank's query heads read
        Hl = H // M
        lo, hi = r * Hl // G, ((r + 1) * Hl - 1) // G + 1
        kvw = tuple({k_: a[:, lo:hi] if k_ == "w" else a[lo:hi]
                     for k_, a in w_.items()} for w_ in kvw)
    kv_proj = _proj if branch == "head_tp" else _proj_replicated
    k, v = kv_proj(kvw[0], kv_or_cache), kv_proj(kvw[1], kv_or_cache)
    if branch == "head_tp":
        out = collectives.head_tp_block_attention(q, k, v, G, r, lo,
                                                  causal=False)
    elif branch == "cp":
        out = collectives._cp_block(q.reshape(b, n, KVH, G, hd), k, v,
                                    r * n, causal=False)
    else:
        out = chunked_attention(q.reshape(b, n, KVH, G, hd), k, v,
                                causal=False)
    y = (_out_proj_replicated if branch == "local" else _out_proj)(
        w, out.reshape(b, n, -1, hd))
    if heads_split:
        y = sharding.psum(y, "model")
    if branch == "cp":
        y = sharding.all_gather(y, "model", 1)
    return y, ({"k": k, "v": v} if mode == "prefill" else None)


def enc_block_spec(cfg) -> dict:
    D = cfg.d_model
    return {"ln1": layernorm_spec(D), "attn": attn_spec(cfg),
            "ln2": layernorm_spec(D),
            "ffn": ffn.ffn_spec(D, cfg.d_ff, "gelu", bias=True)}


def dec_block_spec(cfg) -> dict:
    D = cfg.d_model
    return {"ln1": layernorm_spec(D), "attn": attn_spec(cfg),
            "lnx": layernorm_spec(D), "xattn": attn_spec(cfg),
            "ln2": layernorm_spec(D),
            "ffn": ffn.ffn_spec(D, cfg.d_ff, "gelu", bias=True)}


def _ffn(p, x, cfg):
    """The layer's FFN (gelu, biased); in a block program on the rank's
    blocks (`ffn._ffn_blocks`: `up` and its bias column-parallel, `down`
    row-parallel, its bias added once after the psum)."""
    return ffn.ffn_apply(p, x, "gelu", spec=ffn.ffn_spec(
        cfg.d_model, cfg.d_ff, "gelu", bias=True))


def _enc_layer(p, x, cfg):
    h = layernorm(p["ln1"], x, cfg.norm_eps)
    x = x + _self_attention(p["attn"], h, cfg, causal=False)[0]
    h = layernorm(p["ln2"], x, cfg.norm_eps)
    return x + _ffn(p["ffn"], h, cfg)


def _dec_layer(p, x, enc_or_cache, cfg, *, mode="train", cache=None,
               pos=None):
    """One decoder layer: (x, the layer's new cache or None)."""
    h = layernorm(p["ln1"], x, cfg.norm_eps)
    a, kv = _self_attention(p["attn"], h, cfg, causal=True, mode=mode,
                            cache=cache, pos=pos)
    x = x + a
    h = layernorm(p["lnx"], x, cfg.norm_eps)
    a, xkv = _cross_attention(p["xattn"], h, enc_or_cache, cfg, mode=mode)
    x = x + a
    h = layernorm(p["ln2"], x, cfg.norm_eps)
    x = x + _ffn(p["ffn"], h, cfg)
    if mode == "train":
        return x, None
    if mode == "prefill":
        return x, {"k": kv["k"], "v": kv["v"], "xk": xkv["k"],
                   "xv": xkv["v"]}
    return x, {"k": kv["k"], "v": kv["v"], "xk": cache["xk"],
               "xv": cache["xv"]}


class EncDecLM:
    def __init__(self, cfg):
        self.cfg = cfg

    def param_specs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embedding_spec(cfg.vocab_size, cfg.d_model),
            "enc": stack_specs(enc_block_spec(cfg), cfg.enc_layers),
            "enc_ln": layernorm_spec(cfg.d_model),
            "dec": stack_specs(dec_block_spec(cfg), cfg.n_layers),
            "final_norm": layernorm_spec(cfg.d_model),
        }

    def cache_specs(self, batch: int, seq_len: int) -> list:
        cfg = self.cfg
        F = cfg.frontend.n_tokens
        KVH, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        per_layer = dict(attn_cache_spec(cfg, batch, seq_len))
        for name in ("xk", "xv"):
            per_layer[name] = Spec((batch, F, KVH, hd),
                                   ("batch", None, "kv_heads", "head_dim"),
                                   init="zeros")
        return [stack_specs(per_layer, cfg.n_layers)]

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

    # -- the block program ---------------------------------------------
    # a prefill's cache blocks and the decode's are laid out as the
    # decoder-only models' (the frame caches by their own spec: the
    # rank's rows, its kv heads where they split)
    prefill_cache_pspecs = DecoderLM.prefill_cache_pspecs
    decode_caches = DecoderLM.decode_caches
    _rows_in_place = staticmethod(DecoderLM._rows_in_place)

    # ------------------------------------------------------------------
    def _encode(self, params, frames):
        cfg = self.cfg
        F, D = frames.shape[1:]
        x = frames.to(torch_dtype(cfg.dtype))
        x = x + sinusoidal_positions(torch.arange(F, device=x.device),
                                     D).to(x.dtype)
        for p in unbind_layers(params["enc"], cfg.enc_layers):
            x = _enc_layer(p, x, cfg)
        return layernorm(params["enc_ln"], x, cfg.norm_eps)

    def _dec_embed(self, params, tokens, positions):
        cfg = self.cfg
        x = embed(params["embed"], tokens, shape=self._table_shape).to(
            torch_dtype(cfg.dtype))
        return x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)

    def _logits(self, params, h, *, decode=False):
        """The final norm and the tied table's logits. In a block program
        a table whole over `model` (`layers.unembed`) takes its input's
        gradient by vocab rows where the decoder's self-attention is
        context-parallel: GSPMD carries that token split into the
        logits' backward, the same work."""
        cfg = self.cfg
        h = layernorm(params["final_norm"], h, cfg.norm_eps)
        split_dx = collectives.attend_branch(
            h.shape[1], cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads) == "cp"
        return unembed(params["embed"], h, shape=self._table_shape,
                       split_in=decode, split_dx=split_dx)

    @property
    def _table_shape(self) -> tuple:
        return (self.cfg.vocab_size, self.cfg.d_model)

    def _positions(self, tokens):
        B, S = tokens.shape
        return torch.arange(S, dtype=torch.int32,
                            device=tokens.device).broadcast_to((B, S))

    def forward(self, params, tokens, *, embeddings):
        """Teacher-forced logits (training); `embeddings` are the frame
        embeddings (the stubbed conv frontend). Returns (logits,
        {"moe_aux": 0}). In a block program (`sharding.program`) the
        tokens and frames are the rank's rows, and so are the logits
        (its vocab columns where the vocab splits over `model`)."""
        cfg = self.cfg
        with sharding.program(cfg):
            enc_out = self._encode(params, embeddings)
            x = self._dec_embed(params, tokens, self._positions(tokens))
            remat = cfg.remat and torch.is_grad_enabled()
            # a recompute in the backward re-enters this mesh context
            layer = partial(_in_context, sharding.current(), _dec_layer)
            for p in unbind_layers(params["dec"], cfg.n_layers):
                if remat:
                    x, _ = checkpoint(layer, p, x, enc_out, cfg,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
                else:
                    x, _ = layer(p, x, enc_out, cfg)
            return self._logits(params, x), {
                "moe_aux": torch.zeros((), dtype=torch.float32,
                                       device=x.device)}

    @torch.no_grad()
    def prefill(self, params, tokens, *, embeddings):
        """Returns (last_token_logits (B,1,V), caches): the decoder's
        keys and values of the prompt and the frame keys and values of
        every layer's cross-attention. In a block program the rank's
        rows and its cache blocks (`prefill_cache_pspecs`)."""
        cfg = self.cfg
        with sharding.program(cfg):
            enc_out = self._encode(params, embeddings)
            x = self._dec_embed(params, tokens, self._positions(tokens))
            ncs = []
            for p in unbind_layers(params["dec"], cfg.n_layers):
                x, nc = _dec_layer(p, x, enc_out, cfg, mode="prefill")
                ncs.append(nc)
            caches = {k: torch.stack([nc[k] for nc in ncs]) for k in ncs[0]}
            return self._logits(params, x[:, -1:]), [caches]

    @torch.no_grad()
    def decode_step(self, params, tokens, caches, pos):
        """One decode step. tokens: (B,1); pos: scalar or (B,) int (the
        write index). Returns (logits (B,1,V), caches); the caches
        passed in are left as they were, but in a block program (pos
        the rank's rows', the caches its param-rule blocks, every row,
        written in place and handed back)."""
        cfg = self.cfg
        with sharding.program(cfg), self._rows_in_place(caches):
            B = tokens.shape[0]
            pos = torch.as_tensor(pos, dtype=torch.int32,
                                  device=tokens.device)
            x = self._dec_embed(params, tokens,
                                pos.broadcast_to((B,))[:, None])
            ncs = []
            for p, c in zip(unbind_layers(params["dec"], cfg.n_layers),
                            unbind_layers(caches[0], cfg.n_layers)):
                x, nc = _dec_layer(p, x, {"k": c["xk"], "v": c["xv"]}, cfg,
                                   mode="decode", cache=c, pos=pos)
                ncs.append(nc)
            if sharding.in_blocks():
                return self._logits(params, x, decode=True), caches
            caches = {k: torch.stack([nc[k] for nc in ncs]) for k in ncs[0]}
            return self._logits(params, x, decode=True), [caches]
