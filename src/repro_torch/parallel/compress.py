"""Compressed cross-replica reduction (int8 on the wire).

The port of the reference's `repro.parallel.compress`.
`compressed_psum_mean` is a reduce-scatter and an all-gather with int8
payloads and per-chunk float32 scales: each rank quantizes its
chunks, exchanges them with `all_to_all_single` (the RS half),
dequant-accumulates its shard in float32, re-quantizes the partial sum
and all-gathers the shards (the AG half). Wire bytes are ~4x less than
a float32 ring all-reduce (~2x less than bf16).

Where the reference calls it inside `shard_map` over a mesh axis name,
the port calls it on each rank's own tensor with the process group of
that axis (`sharding.axis_group(name)`; None: the default group).
Rounding is the reference's: `torch.round` rounds half to even, as
`jnp.round`. Error feedback is the caller's choice: with
`return_residual` the function also returns the exact mean (an
all-reduce) minus the result.
"""
from __future__ import annotations

import torch


def _quant(x, dim=-1):
    scale = x.abs().amax(dim=dim, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.to(torch.float32) * scale


def _all_gather(t, group, n):
    import torch.distributed as dist
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.cat(out)


def compressed_psum_mean(x, group=None, *, return_residual: bool = False):
    """The mean of `x` over the ranks of `group` with int8 wire traffic.

    x: (..., F) float32, its element count divisible by the group
    size."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    flat = x.reshape(-1)
    F = flat.shape[0]
    if F % n:
        raise ValueError(f"{F} elements do not split over {n} ranks")
    chunks = flat.reshape(n, F // n)

    # RS half: quantize chunks, exchange, dequant-accumulate in f32
    q, s = _quant(chunks)
    q_in, s_in = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(q_in, q.contiguous(), group=group)
    dist.all_to_all_single(s_in, s.contiguous(), group=group)
    part = _dequant(q_in, s_in).sum(0) / n

    # AG half: quantize the reduced shard, gather all shards
    q2, s2 = _quant(part[None])
    out = _dequant(_all_gather(q2, group, n),
                   _all_gather(s2, group, n)).reshape(x.shape)
    if not return_residual:
        return out
    exact = x.to(torch.float32).clone()
    dist.all_reduce(exact, group=group)
    return out, exact / n - out


def wire_bytes_ratio(dtype_bytes: int = 4) -> float:
    """Wire savings vs a same-shape ring all-reduce of `dtype_bytes`."""
    return dtype_bytes / 1.0   # int8 payload; scales are negligible
