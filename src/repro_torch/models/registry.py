"""Model registry: config -> model (the decoder families: dense, MoE,
MLA, hybrid, SSM, the vision-language decoder; the encoder-decoder),
parameter accounting, dry-run input stand-ins."""
from __future__ import annotations

import numpy as np

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeConfig
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


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                device=None, microbatches: int = 1) -> tuple[dict, dict]:
    """(stand-ins, specs): fake tensors for every step-function input
    (allocating nothing, `sharding.abstract_with_shardings`) and their
    resolved PartitionSpecs, with the reference's shapes, dtypes and
    specs (`repro.models.registry.input_specs`): tokens and labels
    (B, S) int32 by ("batch", "seq"), a frontend's embeddings (B, F,
    d_input) by ("batch", "seq", "embed"), the decode cache by its param
    specs and `pos`. Where the model runs the block program
    (`sharding.runs_blocks`) each tensor is this rank's block: the
    batch's rows, the decode cache's block under the param rules (as the
    reference resolves it: every row; a train batch of `microbatches`
    its share of each, `sharding.rows`). Else they are global (the global
    view takes the batch and the caches whole). They belong to the
    active `FakeTensorMode`, or to one new mode."""
    import torch

    from repro_torch import device as tdevice
    from repro_torch.models.module import torch_dtype
    from repro_torch.parallel import sharding
    B, S = shape.global_batch, shape.seq_len
    dev = torch.device(device if device is not None
                       else tdevice.get_default())
    ins, specs = {}, {}

    blocks = sharding.runs_blocks(cfg)

    def sds(name, shp, dt, axes=None):
        specs[name] = (sharding.resolve_spec(axes, shp, table="act")
                       if axes else sharding.P())
        if blocks and axes:
            # the rank's share of each microbatch (`sharding.rows`)
            m = microbatches if axes[0] == "batch" else 1
            mb = (shp[0] // m,) + tuple(shp[1:])
            blk = sharding.block_shape(mb, sharding.resolve_spec(
                axes, mb, table="act"))
            shp = (m * blk[0],) + tuple(blk[1:])
        ins[name] = torch.empty(shp, dtype=dt, device=dev)

    with sharding.fake_mode():
        if shape.kind in ("train", "prefill"):
            sds("tokens", (B, S), torch.int32, ("batch", "seq"))
            if shape.kind == "train":
                sds("labels", (B, S), torch.int32, ("batch", "seq"))
            if cfg.frontend.kind != "none":
                F = cfg.frontend.n_tokens
                sds("embeddings", (B, F, cfg.frontend.d_input),
                    torch_dtype(cfg.dtype), ("batch", "seq", "embed"))
            return ins, specs
        # decode: one new token against a cache of seq_len
        sds("tokens", (B, 1), torch.int32, ("batch", "seq"))
        ins["cache"], specs["cache"] = sharding.abstract_with_shardings(
            build_model(cfg).cache_specs(B, S), cfg.dtype,
            whole=not blocks, device=dev)
        sds("pos", (), torch.int32)
    return ins, specs
