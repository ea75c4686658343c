"""whisper-base [audio] — encoder-decoder transformer backbone; the conv
audio frontend is a STUB (input_specs() provides precomputed 1500-frame
embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register_arch


@register_arch("whisper-base")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        n_layers=6,                     # decoder depth
        enc_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        act="gelu",
        rope_theta=0.0,                 # whisper uses learned/sinusoidal pos-emb
        frontend=FrontendConfig(kind="audio", n_tokens=1500, d_input=512),
        citation="arXiv:2212.04356",
    )
