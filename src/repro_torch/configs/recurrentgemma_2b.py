"""recurrentgemma-2b [hybrid] — Griffin: RG-LRU + local attention, 2:1
pattern (rec, rec, attn). [arXiv:2402.19427; hf]"""
from repro_torch.configs.base import HybridConfig, ModelConfig, register_arch


@register_arch("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        act="geglu",
        rope_theta=10000.0,
        tie_embeddings=True,
        norm_eps=1e-6,
        scale_embeddings=True,
        zero_centered_norm=True,
        logit_softcap=30.0,
        hybrid=HybridConfig(pattern=("rec", "rec", "attn"), window=2048,
                            lru_width=2560, conv_width=4),
        citation="arXiv:2402.19427",
    )
