"""Model registry: config -> model (the decoder families)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig):
    """The port's model for `cfg`. The encoder-decoder family comes with
    the remaining model families (ROADMAP slice 6)."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder family comes with ROADMAP slice 6")
    from repro_torch.models.transformer import DecoderLM
    return DecoderLM(cfg)
