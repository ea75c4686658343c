"""Shared layers: norms, linear/einsum projections, embeddings, RoPE,
sinusoidal positions, acts.

The port of the reference's `repro.models.layers`. Parameters are
nested dicts of tensors, as there; norms, RoPE and the sinusoidal
positions compute in float32 (the norms' scale and bias are float32
leaves) and cast back, as there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.module import Spec


# --------------------------------------------------------------------------
# Norms (computed in f32, cast back)
# --------------------------------------------------------------------------
def rmsnorm_spec(dim: int) -> dict:
    return {"scale": Spec((dim,), (None,), init="ones", dtype="float32")}


def rmsnorm(params, x, eps: float = 1e-5, *, zero_centered: bool = False):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = params["scale"]
    if zero_centered:          # gemma-style (1 + scale)
        scale = 1.0 + scale
    return (y * scale).to(dt)


def layernorm_spec(dim: int) -> dict:
    return {"scale": Spec((dim,), (None,), init="ones", dtype="float32"),
            "bias": Spec((dim,), (None,), init="zeros", dtype="float32")}


def layernorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


# --------------------------------------------------------------------------
# Linear / einsum projections
# --------------------------------------------------------------------------
def linear_spec(d_in: int, d_out: int, axes=("embed", "mlp"), *,
                bias: bool = False, scale: float | None = None) -> dict:
    s = {"w": Spec((d_in, d_out), axes, scale=scale)}
    if bias:
        s["b"] = Spec((d_out,), (axes[1],), init="zeros")
    return s


def linear(params, x):
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def proj_spec(shape: tuple, axes: tuple, *, bias_dims: tuple | None = None,
              scale: float | None = None) -> dict:
    """General einsum weight, e.g. (d_model, heads, head_dim)."""
    s = {"w": Spec(shape, axes, scale=scale)}
    if bias_dims is not None:
        s["b"] = Spec(tuple(shape[i] for i in bias_dims),
                      tuple(axes[i] for i in bias_dims), init="zeros")
    return s


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------
def embedding_spec(vocab: int, dim: int) -> dict:
    return {"table": Spec((vocab, dim), ("vocab", "embed"), scale=1.0)}


def embed(params, tokens):
    """The table's rows; `F.embedding`, whose backward sums a repeated
    token's gradients in a fixed order on either device (an indexing
    backward accumulates in a racing order on the CPU), so a replayed
    train step is bit-equal."""
    return F.embedding(tokens.long(), params["table"])


def unembed(params, x):
    """Logits via the (possibly tied) embedding table."""
    return x @ params["table"].T


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------
def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu(approximate=True)


def act_fn(name: str):
    return {
        "swiglu": F.silu,
        "geglu": _gelu_tanh,
        "gelu": _gelu_tanh,
        "silu": F.silu,
        "relu": F.relu,
    }[name]


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) int. Rotates
    the split halves (not interleaved pairs), in float32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)               # (d/2,)
    angles = positions.float()[..., None] * freqs              # (..., S, d/2)
    if x.ndim == angles.ndim + 1:                              # (..., S, H, D)
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Sinusoidal absolute positions (whisper)
# --------------------------------------------------------------------------
def sinusoidal_positions(positions, dim: int) -> torch.Tensor:
    """positions: (...,) int -> (..., dim) float32 sinusoid embedding."""
    half = dim // 2
    inv = torch.exp(-torch.arange(half, dtype=torch.float32,
                                  device=positions.device)
                    * (math.log(10000.0) / max(1, half - 1)))
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
