"""Analytic HBM-traffic model for the memory roofline term.

The port of the reference's `repro.utils.costmodel`, the same napkin
model with the same constants (the reference validated it against XLA's
`cost_analysis` on unrolled single-layer probes; torch has no byte
count of its own that would replace it, so the dry-run's memory term is
this model in both packages):

  train:   weights 3x bf16 (fwd + remat re-read + bwd) + grad f32 w+r
           + moments r+w + param w  ~= 6*P + 12..20*P bytes
           activations ~= c_act * L * tokens * d_model * 2 (c_act ~ 8:
           residual r/w, norms, block internals, bwd re-reads)
  prefill: weights 1x + activations (c_act ~ 4) + cache write
  decode:  weights 1x + full cache read + O(B) writes
"""
from __future__ import annotations

import numpy as np

from repro_torch import tree
from repro_torch.models import module as mod

C_ACT_TRAIN = 8.0
C_ACT_PREFILL = 4.0


def cache_bytes_total(model, batch: int, seq_len: int) -> int:
    total = 0
    for leaf in tree.leaves(model.cache_specs(batch, seq_len),
                            is_leaf=mod.is_spec):
        itemsize = mod.torch_dtype(leaf.dtype or "bfloat16").itemsize
        total += int(np.prod(leaf.shape)) * itemsize
    return total


def hbm_bytes_per_device(cfg, shape, chips: int, model,
                         n_params: int, n_active: int,
                         moment_bytes: int = 4) -> float:
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, max(cfg.n_layers, 1)
    if shape.kind == "train":
        weights = 3 * 2 * n_params                    # bf16 fwd/remat/bwd
        optim = (4 + 4 + 4 * moment_bytes) * n_params  # grad w+r f32, m/v r+w
        acts = C_ACT_TRAIN * L * B * S * D * 2
        return (weights + optim + acts) / chips
    if shape.kind == "prefill":
        weights = 2 * n_params
        acts = C_ACT_PREFILL * L * B * S * D * 2
        cache = cache_bytes_total(model, B, S)
        return (weights + acts + cache) / chips
    # decode: every step streams the weight shard + the whole cache shard
    weights = 2 * n_active if cfg.moe is None else 2 * n_params
    cache = cache_bytes_total(model, B, S)
    return (weights + cache) / chips
