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

Differences from the reference, on purpose: its three `lax.scan` stacks
are Python loops over the stacked layer dimension (each group's leaves
unbound once, as `DecoderLM._run_groups` does); with `cfg.remat` each
decoder layer of a `forward` under grad mode is recomputed in the
backward (`torch.utils.checkpoint`, the reference's `jax.checkpoint` of
the decoder body); `prefill` and `decode_step` run under
`torch.no_grad()`.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import ffn
from repro_torch.models.attention import decode_partials, finalize_partials
from repro_torch.models.layers import (embed, embedding_spec, layernorm,
                                       layernorm_spec, sinusoidal_positions,
                                       unembed)
from repro_torch.models.module import (Spec, init_params, stack_specs,
                                       torch_dtype)
from repro_torch.models.transformer import (_out_proj, _proj, attn_cache_spec,
                                            attn_spec, unbind_layers)
from repro_torch.parallel import collectives


def _self_attention(params, x, cfg, *, causal, mode="train", cache=None,
                    pos=None):
    B, S, _ = x.shape
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


def _enc_layer(p, x, cfg):
    h = layernorm(p["ln1"], x, cfg.norm_eps)
    x = x + _self_attention(p["attn"], h, cfg, causal=False)[0]
    h = layernorm(p["ln2"], x, cfg.norm_eps)
    return x + ffn.ffn_apply(p["ffn"], h, "gelu")


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
    x = x + ffn.ffn_apply(p["ffn"], h, "gelu")
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
        x = embed(params["embed"], tokens).to(torch_dtype(cfg.dtype))
        return x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)

    def _positions(self, tokens):
        B, S = tokens.shape
        return torch.arange(S, dtype=torch.int32,
                            device=tokens.device).broadcast_to((B, S))

    def forward(self, params, tokens, *, embeddings):
        """Teacher-forced logits (training); `embeddings` are the frame
        embeddings (the stubbed conv frontend). Returns (logits,
        {"moe_aux": 0})."""
        cfg = self.cfg
        enc_out = self._encode(params, embeddings)
        x = self._dec_embed(params, tokens, self._positions(tokens))
        remat = cfg.remat and torch.is_grad_enabled()
        for p in unbind_layers(params["dec"], cfg.n_layers):
            if remat:
                x, _ = checkpoint(_dec_layer, p, x, enc_out, cfg,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, _ = _dec_layer(p, x, enc_out, cfg)
        h = layernorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], h), {
            "moe_aux": torch.zeros((), dtype=torch.float32,
                                   device=x.device)}

    @torch.no_grad()
    def prefill(self, params, tokens, *, embeddings):
        """Returns (last_token_logits (B,1,V), caches): the decoder's
        keys and values of the prompt and the frame keys and values of
        every layer's cross-attention."""
        cfg = self.cfg
        enc_out = self._encode(params, embeddings)
        x = self._dec_embed(params, tokens, self._positions(tokens))
        ncs = []
        for p in unbind_layers(params["dec"], cfg.n_layers):
            x, nc = _dec_layer(p, x, enc_out, cfg, mode="prefill")
            ncs.append(nc)
        h = layernorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        caches = {k: torch.stack([nc[k] for nc in ncs]) for k in ncs[0]}
        return unembed(params["embed"], h), [caches]

    @torch.no_grad()
    def decode_step(self, params, tokens, caches, pos):
        """One decode step. tokens: (B,1); pos: scalar or (B,) int (the
        write index). Returns (logits (B,1,V), caches); the caches
        passed in are left as they were."""
        cfg = self.cfg
        B = tokens.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        x = self._dec_embed(params, tokens, pos.broadcast_to((B,))[:, None])
        ncs = []
        for p, c in zip(unbind_layers(params["dec"], cfg.n_layers),
                        unbind_layers(caches[0], cfg.n_layers)):
            x, nc = _dec_layer(p, x, {"k": c["xk"], "v": c["xv"]}, cfg,
                               mode="decode", cache=c, pos=pos)
            ncs.append(nc)
        h = layernorm(params["final_norm"], x, cfg.norm_eps)
        caches = {k: torch.stack([nc[k] for nc in ncs]) for k in ncs[0]}
        return unembed(params["embed"], h), [caches]
