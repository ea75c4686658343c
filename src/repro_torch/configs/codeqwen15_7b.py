"""codeqwen1.5-7b [dense] — qwen1.5 arch (MHA kv=32, qkv bias).
[hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs.base import ModelConfig, register_arch


@register_arch("codeqwen1.5-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        act="swiglu",
        rope_theta=1000000.0,
        qkv_bias=True,
        citation="hf:Qwen/CodeQwen1.5-7B",
    )
