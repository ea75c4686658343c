"""Dense feed-forward blocks (GLU variants + plain MLP).

The port of the reference's `repro.models.ffn` without its Megatron-SP
variants (`sp=True`: the weight-gathered and sequence-parallel
shard_map bodies): one process has no `model` mesh axis, and they come
with the parallelism slice (ROADMAP slice 8).
"""
from __future__ import annotations

from repro_torch.models.layers import act_fn, linear, linear_spec


def ffn_spec(d_model: int, d_ff: int, act: str, *, bias: bool = False) -> dict:
    if act in ("swiglu", "geglu"):
        return {
            "gate": linear_spec(d_model, d_ff, ("embed", "mlp"), bias=bias),
            "up": linear_spec(d_model, d_ff, ("embed", "mlp"), bias=bias),
            "down": linear_spec(d_ff, d_model, ("mlp", "embed"), bias=bias),
        }
    return {
        "up": linear_spec(d_model, d_ff, ("embed", "mlp"), bias=bias),
        "down": linear_spec(d_ff, d_model, ("mlp", "embed"), bias=bias),
    }


def ffn_apply(params, x, act: str):
    f = act_fn(act)
    if "gate" in params:
        h = f(linear(params["gate"], x)) * linear(params["up"], x)
    else:
        h = f(linear(params["up"], x))
    return linear(params["down"], h)
