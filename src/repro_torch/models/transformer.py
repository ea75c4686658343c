"""Decoder-only LM: the spec layer (layer plan, scan groups, cache specs).

The port of the reference's `repro.models.transformer` up to what the
KV-cache transfer leg needs: `KVTransferEngine` reads only
``model.cache_specs`` (its wire spec tree), and the decode caches are
built from them. The forward (`prefill`, `decode_step`, the parameter
specs and the attention math) comes with the serving model, ROADMAP
slice 4; the cache specs of the mla, rec and ssm mixers with the other
model families, slice 6.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.module import Spec, init_params, stack_specs


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
# Cache specs
# --------------------------------------------------------------------------
def decode_heads_layout(cfg) -> bool:
    """Head-sharded KV cache layout: the reference takes it only when a
    `model` mesh axis of size > 1 divides the kv heads. One process has
    no model axis, so the cache is sequence-laid (``kv_seq``)."""
    return False


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
    if kind.mix in ("mla", "rec", "ssm"):
        raise NotImplementedError(
            f"the {kind.mix} cache comes with the remaining model "
            "families (ROADMAP slice 6)")
    raise ValueError(kind)


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------
class DecoderLM:
    """The decoder's spec layer. The forward (`prefill`, `decode_step`)
    and the parameters come with the serving model, ROADMAP slice 4."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.groups = group_plan(cfg)

    def cache_specs(self, batch: int, seq_len: int) -> list:
        cfg = self.cfg
        out = []
        for subplan, count in self.groups:
            g = {f"b{i}": block_cache_spec(cfg, k, batch, seq_len)
                 for i, k in enumerate(subplan)}
            out.append(stack_specs(g, count))
        return out

    def init_cache(self, batch: int, seq_len: int, *, device=None):
        """Zero decode caches on `device` (None: the package default)."""
        return init_params(self.cache_specs(batch, seq_len),
                           self.cfg.dtype, device=device)
