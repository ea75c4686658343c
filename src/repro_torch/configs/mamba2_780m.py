"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register_arch


@register_arch("mamba2-780m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,                      # attention-free
        n_kv_heads=0,
        d_ff=0,                         # mamba block subsumes the FFN
        vocab_size=50280,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                      d_conv=4, chunk_size=256),
        tie_embeddings=True,
        citation="arXiv:2405.21060",
    )
