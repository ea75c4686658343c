"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1). [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ModelConfig, register_arch


@register_arch("gemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        act="geglu",
        rope_theta=10000.0,
        tie_embeddings=True,
        norm_eps=1e-6,
        scale_embeddings=True,
        zero_centered_norm=True,
        citation="arXiv:2403.08295",
    )
