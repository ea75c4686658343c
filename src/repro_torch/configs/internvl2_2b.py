"""internvl2-2b [vlm] — InternViT frontend STUB + InternLM2-1.8B backbone
(input_specs() provides 256 precomputed patch embeddings).
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register_arch


@register_arch("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        act="swiglu",
        rope_theta=1000000.0,
        frontend=FrontendConfig(kind="vision", n_tokens=256, d_input=2048),
        citation="arXiv:2404.16821",
    )
