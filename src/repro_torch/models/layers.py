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
from repro_torch.parallel import sharding


# --------------------------------------------------------------------------
# Norms (computed in f32, cast back)
# --------------------------------------------------------------------------
def rmsnorm_spec(dim: int) -> dict:
    return {"scale": Spec((dim,), (None,), init="ones", dtype="float32")}


def rmsnorm(params, x, eps: float = 1e-5, *, zero_centered: bool = False):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    scale = params["scale"]
    if zero_centered:          # gemma-style (1 + scale)
        scale = 1.0 + scale
    if xf is not x and not (torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad)):
        # no graph: the float32 copy is scaled in place (the same values)
        return xf.mul_(torch.rsqrt(var + eps)).mul_(scale).to(dt)
    y = xf * torch.rsqrt(var + eps)
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
EMBED_AXES = ("vocab", "embed")


def embedding_spec(vocab: int, dim: int) -> dict:
    return {"table": Spec((vocab, dim), EMBED_AXES, scale=1.0)}


def embed(params, tokens, *, shape: tuple | None = None):
    """The table's rows; `F.embedding`, whose backward sums a repeated
    token's gradients in a fixed order on either device (an indexing
    backward accumulates in a racing order on the CPU), so a replayed
    train step is bit-equal.

    In a block program (`shape`, the table's global (V, D), given) the table
    is this rank's block: gathered over data (FSDP), and where its vocab
    is split over `model` the rows outside the rank's range read zero and
    the rows are psummed over `model` (vocab-parallel). A table whole
    over `model` whose rows are cheaper to move than it (`_in_place`)
    stays in place: the data line's tokens read the rank's embed
    columns, and an all-to-all over data gives each rank its rows'
    every column. Where the rows are whole over data (`_rows_whole`)
    any table's block is read in place, its columns all-gathered over
    data."""
    if shape is None or not sharding.in_blocks():
        return F.embedding(tokens.long(), params["table"])
    if _rows_whole(shape):         # the rank's columns, gathered over data
        table, v0 = params["table"], _vocab_start(params["table"], shape)
    elif _in_place(shape, tokens.numel() * shape[1]):
        e = F.embedding(sharding.all_gather(tokens.long(), "data", 0),
                        params["table"])
        return sharding.all_to_all(e, "data", 0, e.ndim - 1)
    else:
        table, v0 = _table_block(params["table"], shape)
    if v0 is None:
        e = F.embedding(tokens.long(), table)
    else:
        loc = tokens.long() - v0
        mine = (loc >= 0) & (loc < table.shape[0])
        e = torch.where(mine[..., None], F.embedding(
            loc.clamp(0, table.shape[0] - 1), table), 0)
    if table.shape[1] != shape[1]:
        e = sharding.all_gather(e, "data", e.ndim - 1)
    return e if v0 is None else sharding.psum(e, "model")


def unembed(params, x, *, shape: tuple | None = None, split_in=False,
            split_dx=False):
    """Logits via the (possibly tied) embedding table; in a block program
    (`shape` given) the rank's vocab columns (B, S, V/M) where the vocab
    is split over `model`, from the table gathered over data. Where the
    vocab is whole on every rank of `model` (it does not split) the ranks
    share the work the reference's partitioner shares: the table's
    gradient by columns (`_WholeVocab`), with `split_dx` the input's
    gradient by vocab rows (a tied table under a trunk whose tokens split
    over `model`: GSPMD splits it by those tokens, the same work), and
    with `split_in` (a decode's few rows) the product's contraction,
    psummed over `model`. Such a table whose rows and logits are cheaper
    to move than it (`_in_place`: a decode's, a prefill's last rows) is
    contracted in place, as the reference's partition does: the data
    line's rows over the rank's embed columns (and with `split_in` its
    part of them over `model`), the partial logits psum-scattered back
    to the rank's rows over data (and psummed over `model`). Where the
    rows are whole over data (`_rows_whole`) any table is contracted
    over the rank's embed columns and psummed over data."""
    if shape is None or not sharding.in_blocks():
        return x @ params["table"].T
    M = sharding.mesh_axis_size("model")
    if _rows_whole(shape):      # the rank's columns, psummed over data
        n = params["table"].shape[1]
        c0 = sharding.axis_index("data") * n
        return sharding.psum(x[..., c0:c0 + n] @ params["table"].T, "data")
    if _in_place(shape, sharding.mesh_axis_size("data")
                 * x.shape[:-1].numel() * (shape[0] + shape[1])):
        return _unembed_in_place(params["table"], x, shape, M, split_in)
    table, v0 = _table_block(params["table"], shape)
    if v0 is not None or M == 1 or x.shape[-1] % M:
        return x @ table.T
    n = x.shape[-1] // M
    r = sharding.axis_index("model")
    cols = slice(r * n, (r + 1) * n)
    if split_in:
        return sharding.psum(x[..., cols] @ table[:, cols].T, "model")
    V = table.shape[0]
    rows = slice(r * V // M, (r + 1) * V // M) if split_dx else None
    return _WholeVocab.apply(x, table, cols, rows, M)


class _WholeVocab(torch.autograd.Function):
    """x @ table.T on every rank of `model`, the table's gradient only in
    this rank's `cols` (zeros elsewhere). The logits feed the loss alone,
    the same on every rank of `model`, so each rank's cotangent is the
    same 1/M share of the whole: M times this rank's share in its columns
    is their whole gradient, and the replicas' sum over `model`
    (`sharding.reduce_replicas`) the table's, each rank having computed
    1/M of it. With `rows` (a vocab range a rank) x's gradient is M times
    this rank's rows' part of the contraction: the ranks' shares of it
    sum to the whole at the collectives' transposes below, every
    backward being linear in its cotangent."""

    @staticmethod
    def forward(ctx, x, table, cols, rows, M: int):
        ctx.save_for_backward(x, table)
        ctx.cols, ctx.rows, ctx.M = cols, rows, M
        return x @ table.T

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        xc = x[..., ctx.cols]
        gt = torch.zeros_like(table)
        gt[:, ctx.cols] = (g.reshape(-1, g.shape[-1]).T
                           @ xc.reshape(-1, xc.shape[-1])) * ctx.M
        if ctx.rows is None:
            return g @ table, gt, None, None, None
        gx = (g[..., ctx.rows] @ table[ctx.rows]) * ctx.M
        return gx, gt, None, None, None


def _in_place(shape: tuple, moved: int) -> bool:
    """A block program's table of global `shape` (V, D), whole over
    `model` and split over data by its embed columns, stays in place
    where doing so moves fewer elements over data (`moved`, to the same
    factor (dp - 1) / dp: the embedding's rows, B S D; the logits' rows
    and partial logits, dp B S (D + V)) than gathering it would (V D)."""
    spec = sharding.resolve_spec(EMBED_AXES, shape, "param")
    return spec[0] is None and spec[1] == "data" and moved < math.prod(shape)


def _unembed_in_place(table, x, shape: tuple, M: int, split_in: bool):
    """The logits of the rank's rows x (b, S, D) through its block
    (V, D/dp) of a table whole over `model`: the data line's rows
    contracted over the block's columns (with `split_in` and D/dp a
    multiple of M, over the rank's D/(dp M) of them, psummed over
    `model`), psum-scattered over data back to the rank's rows."""
    n = table.shape[1]
    c0 = sharding.axis_index("data") * n
    xs = sharding.all_gather(x, "data", 0)[..., c0:c0 + n]
    if split_in and M > 1 and n % M == 0:
        k = n // M
        m0 = sharding.axis_index("model") * k
        part = xs[..., m0:m0 + k] @ table[:, m0:m0 + k].T
        return sharding.psum(sharding.psum_scatter(part, "data", 0), "model")
    return sharding.psum_scatter(xs @ table.T, "data", 0)


def _rows_whole(shape: tuple) -> bool:
    """A table of global `shape` split over data by its embed columns, in
    a block program whose rows are whole over data
    (`sharding.rows_in_place`): it is read where it lies."""
    return (sharding.current().in_place and sharding.resolve_spec(
        EMBED_AXES, shape, "param")[1] == "data")


def _vocab_start(table, shape: tuple):
    """The first vocab row of a table block, None where the vocab is
    whole over `model`."""
    if table.shape[0] == shape[0]:
        return None
    return sharding.axis_index("model") * table.shape[0]


def _table_block(table, shape: tuple):
    """(the rank's block of a (V, D) table gathered over data, its first
    vocab row, or None where the vocab is not split over `model`)."""
    table = sharding.gather_param(table, EMBED_AXES, shape=shape)
    return table, _vocab_start(table, shape)


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
