"""Configuration system: model/shape/mesh configs + the arch registry.

Every assigned architecture gets one module in this package that builds a
``ModelConfig`` with the exact published dimensions; ``reduced()`` shrinks
any config to a CPU-smoke-testable size while preserving the family's
structure (MoE stays MoE, the hybrid block pattern stays 2:1, ...).

A copy of the reference's `repro.configs`. `ModelConfig.param_count` /
`active_param_count` count the port's parameter specs
(`models.registry.count_params_analytic`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Optional


# --------------------------------------------------------------------------
# Model config
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    top_k: int = 0
    d_ff_expert: int = 0            # per-expert FF width
    n_shared: int = 0               # shared (always-on) experts
    d_ff_shared: int = 0            # shared expert FF width
    first_dense: int = 0            # leading dense layers (deepseek: 3)
    d_ff_dense: int = 0             # FF width of those dense layers
    capacity_factor: float = 1.25   # dispatch capacity (GShard-style)
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 0            # 0 => full-rank Q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class HybridConfig:
    # Griffin/RecurrentGemma: repeating block pattern, e.g. ("rec","rec","attn")
    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    window: int = 2048              # local-attention window
    lru_width: int = 0              # 0 => d_model
    conv_width: int = 4


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() provides precomputed embeddings."""
    kind: str = "none"              # "none" | "audio" | "vision"
    n_tokens: int = 0               # frames (whisper: 1500) or patches (internvl: 256)
    d_input: int = 0                # embedding dim delivered by the stub (== d_model)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // n_heads
    act: str = "swiglu"             # swiglu | geglu | gelu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    use_mla: bool = False
    logit_softcap: float = 0.0      # gemma-2-style softcap (0 = off)
    scale_embeddings: bool = False  # multiply embeddings by sqrt(d_model)
    zero_centered_norm: bool = False  # gemma-style (1 + scale) RMSNorm
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # encoder-decoder (whisper): n_layers is the DECODER depth
    enc_layers: int = 0
    # deepseek multi-token prediction: extra MTP blocks appended (0 = off)
    mtp_depth: int = 0
    # numerics / compile scalability
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode with O(window+state) memory at 500k context?"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        from repro_torch.models.registry import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import count_params_analytic
        return count_params_analytic(self, active_only=True)


# --------------------------------------------------------------------------
# Shapes (assigned per-arch shape set — shared by all 10 LM-family archs)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) a runnable dry-run cell? (brief's skip rules)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention; " \
                      f"{cfg.name} is full-attention (skip noted in DESIGN.md §5)"
    return True, ""


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register_arch(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import the per-arch modules exactly once (they self-register)
    import importlib
    for mod in (
        "phi4_mini_3_8b", "stablelm_12b", "codeqwen15_7b", "gemma_2b",
        "recurrentgemma_2b", "granite_moe_1b_a400m", "deepseek_v3_671b",
        "whisper_base", "mamba2_780m", "internvl2_2b",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")


# --------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# --------------------------------------------------------------------------
def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to smoke-test size, preserving family structure."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 3 if cfg.hybrid is None else len(cfg.hybrid.pattern)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else cfg.n_kv_heads,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        scan_layers=False,
        remat=False,
    )
    if cfg.family == "ssm":
        kw["n_heads"] = 0
        kw["n_kv_heads"] = 0
        kw["ssm"] = SSMConfig(d_state=16, expand=2, head_dim=8, n_groups=1,
                              d_conv=4, chunk_size=16)
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=4, top_k=2, d_ff_expert=32,
            n_shared=min(cfg.moe.n_shared, 1), d_ff_shared=32,
            first_dense=min(cfg.moe.first_dense, 1), d_ff_dense=64,
        )
        kw["n_layers"] = 3 if cfg.moe.first_dense else 2
    if cfg.hybrid is not None:
        kw["hybrid"] = replace(cfg.hybrid, window=8, lru_width=64)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.enc_layers:
        kw["enc_layers"] = 2
    if cfg.frontend.kind != "none":
        kw["frontend"] = FrontendConfig(kind=cfg.frontend.kind, n_tokens=8, d_input=64)
    if cfg.mtp_depth:
        kw["mtp_depth"] = 1
    return replace(cfg, **kw)


def reduced_shape(shape: ShapeConfig) -> ShapeConfig:
    seq = {"train_4k": 32, "prefill_32k": 64, "decode_32k": 64, "long_500k": 128}
    return ShapeConfig(shape.name, seq[shape.name], 4 if shape.global_batch > 1 else 1,
                       shape.kind)
