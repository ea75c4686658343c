"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8, MTP.
[arXiv:2412.19437; hf]"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, register_arch


@register_arch("deepseek-v3-671b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,                 # MLA: latent is shared; heads expand from it
        d_ff=2048,                      # routed expert width
        vocab_size=129280,
        act="swiglu",
        rope_theta=10000.0,
        use_mla=True,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                      n_shared=1, d_ff_shared=2048,
                      first_dense=3, d_ff_dense=18432),
        mtp_depth=1,
        citation="arXiv:2412.19437",
    )
