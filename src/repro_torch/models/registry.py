"""Model registry: config -> model (the decoder families: dense, MoE,
MLA, hybrid, SSM, the vision-language decoder; the encoder-decoder),
parameter accounting."""
from __future__ import annotations

import numpy as np

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import module as mod


def build_model(cfg: ModelConfig, *, remat_policy: str = "nothing"):
    """The port's model for `cfg`: `EncDecLM` for the encoder-decoder
    family, `DecoderLM` for every other, which recomputes its layers
    under `remat_policy` ("nothing" or "dots"; the reference's
    `FLAGS.remat_policy`, which its encoder-decoder ignores)."""
    from repro_torch.models.transformer import DecoderLM, remat_kwargs
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        remat_kwargs(remat_policy)          # a known policy, unused
        return EncDecLM(cfg)
    return DecoderLM(cfg, remat_policy=remat_policy)


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters in `cfg`'s specs; with `active_only`, an expert leaf
    counts top_k / n_experts of its size (the parameters one token
    meets)."""
    specs = build_model(cfg).param_specs()
    total = 0
    for leaf in tree.leaves(specs, is_leaf=mod.is_spec):
        n = int(np.prod(leaf.shape))
        if active_only and "expert" in leaf.axes:
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        total += n
    return total
