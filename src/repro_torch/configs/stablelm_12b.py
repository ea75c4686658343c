"""stablelm-12b [dense] — GQA kv=8. [hf:stabilityai/stablelm-2-12b; hf]"""
from repro_torch.configs.base import ModelConfig, register_arch


@register_arch("stablelm-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab_size=100352,
        act="swiglu",
        rope_theta=10000.0,
        citation="hf:stabilityai/stablelm-2-12b",
    )
