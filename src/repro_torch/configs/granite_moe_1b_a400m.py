"""granite-moe-1b-a400m [moe] — 32 experts top-8, GQA kv=8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register_arch


@register_arch("granite-moe-1b-a400m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=512,                       # per-expert width (all FFNs are MoE)
        vocab_size=49155,
        act="swiglu",
        rope_theta=10000.0,
        tie_embeddings=True,
        moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
        citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
