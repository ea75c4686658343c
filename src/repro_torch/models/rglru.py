"""Griffin / RecurrentGemma recurrent block: Conv1D + RG-LRU gated linear
recurrence, with a parallel GeLU gate branch. [arXiv:2402.19427]

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate, block-diagonal)
    i_t = sigmoid(W_x x_t + b_x)          (input gate, block-diagonal)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The port of the reference's `repro.models.rglru`, function by function.
The gate matrices are block-diagonal with the reference's block count
(`_nb`: 16 blocks where the lru width allows, a recorded deviation from
RecurrentGemma's width/256 there). The recurrence state `h` and the
conv history are float32 whatever the model dtype.

Differences from the reference, on purpose:

  * `rglru_scan` is an inclusive Hillis–Steele scan: ceil(log2 S)
    whole-tensor steps with the reference's combine (al·ar, bl·ar + br),
    in float32, where the reference runs `lax.associative_scan` (a
    Blelloch tree). Both are exact reassociations of the same
    recurrence; float32 sums differ in order only (held at 1e-5).
  * A prompt shorter than the conv history (S < conv_width - 1) leaves a
    conv state of conv_width - 1 rows, the missing ones zero (what
    `_dconv` reads before the sequence's start). The reference keeps the
    S rows it has, and its decode then fails on the short history.

In a block program (`sharding.in_blocks`) the block runs on the rank's
rows and its R/M channels of the lru width, the partition GSPMD gives
the reference: each weight gathered over data inside the layer (FSDP),
`w_x` and `w_gate` column-parallel, the conv, `lam` and the gates'
blocks (`_nb` blocks on the lru width split over `model` with it) the
rank's own, the scan with no collective, `out` row-parallel and psummed
over `model`. A prefill's cache is the rank's rows and channels; a
decode writes every row's new state and conv history into its
param-rule block of the caches (every row), in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.models import module as mod
from repro_torch.models.layers import linear, linear_spec
from repro_torch.models.module import Spec
from repro_torch.parallel import sharding

C_EXP = 8.0


def _nb(cfg) -> int:
    R = cfg.hybrid.lru_width or cfg.d_model
    M = 16  # the reference's production model-axis size
    if R % M == 0:
        return M
    for nb in (8, 4, 2, 1):
        if R % nb == 0:
            return nb
    return 1


def rglru_block_spec(cfg) -> dict:
    D = cfg.d_model
    R = cfg.hybrid.lru_width or D
    K = cfg.hybrid.conv_width
    nb = _nb(cfg)
    bw = R // nb
    return {
        "w_x": linear_spec(D, R, ("embed", "rnn")),
        "w_gate": linear_spec(D, R, ("embed", "rnn")),
        "conv": Spec((K, R), ("conv", "rnn")),
        "conv_b": Spec((R,), ("rnn",), init="zeros"),
        "gate_a": Spec((nb, bw, bw), ("rnn", None, None)),
        "gate_a_b": Spec((R,), ("rnn",), init="zeros"),
        "gate_x": Spec((nb, bw, bw), ("rnn", None, None)),
        "gate_x_b": Spec((R,), ("rnn",), init="zeros"),
        "lam": Spec((R,), ("rnn",), init="rglru_a", dtype="float32"),
        "out": linear_spec(R, D, ("rnn", "embed")),
    }


# the projections: `_linear` gathers or reads them where they lie
_PROJS = ("w_x", "w_gate", "out")


def layer_params(params, cfg):
    """One layer's weights as the block reads them: in a block program
    each block but the projections' gathered over data (FSDP; `_linear`
    reads those), else `params` as they are."""
    if not sharding.in_blocks():
        return params
    spec = rglru_block_spec(cfg)
    return {k: v if k in _PROJS else tree.map(
        lambda s_, a: sharding.gather_param(a, s_.axes, shape=s_.shape),
        spec[k], v, is_leaf=mod.is_spec) for k, v in params.items()}


def _linear(params, x, name, cfg):
    """`linear` through the projection `name` (`sharding.matmul_block`:
    in a block program its block gathered over data, or contracted where
    it lies)."""
    s_ = rglru_block_spec(cfg)[name]["w"]
    y = sharding.matmul_block(x, params[name]["w"], s_.axes, s_.shape)
    return y + params[name]["b"].to(y.dtype) if "b" in params[name] else y


def _out(params, y, cfg):
    """The out-projection; row-parallel where the lru width splits."""
    out = _linear(params, y, "out", cfg)
    if y.shape[-1] != (cfg.hybrid.lru_width or cfg.d_model):
        out = sharding.psum(out, "model")
    return out


def _block_diag(w, b, x, nb: int):
    """x: (..., R) -> (..., R) via block-diagonal matmul."""
    shp = x.shape
    xb = x.reshape(*shp[:-1], nb, shp[-1] // nb)
    y = torch.einsum("...ni,nio->...no", xb, w)
    return y.reshape(shp) + b.to(x.dtype)


def _dconv(x, w, b):
    """Depthwise causal conv along axis 1: x (B, S, R), w (K, R)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, j:j + S] * w[j] for j in range(K))
    return y + b.to(y.dtype)


def _conv_tail(t, K: int):
    """The conv history a prefill leaves: the last K - 1 pre-conv rows
    of t (B, S, F) as float32, zero rows first when S < K - 1 (what
    `_dconv` reads before the sequence's start)."""
    tail = t[:, -(K - 1):].float()
    if tail.shape[1] < K - 1:
        tail = F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))
    return tail


def _gates(params, xr, nb: int):
    r = torch.sigmoid(_block_diag(params["gate_a"], params["gate_a_b"],
                                  xr, nb).float())
    i = torch.sigmoid(_block_diag(params["gate_x"], params["gate_x_b"],
                                  xr, nb).float())
    log_a = -C_EXP * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = beta * i * xr.float()
    return a, gated


def rglru_scan(a, b, h0=None):
    """Linear recurrence h_t = a_t h_{t-1} + b_t along axis 1 (f32).

    An inclusive Hillis–Steele scan: at stride d every position t >= d
    folds in the prefix ending at t - d with the combine (al·ar,
    bl·ar + br), so after ceil(log2 S) steps position t holds the
    composition of steps 0..t — O(log S) launches, not O(S)."""
    S = a.shape[1]
    aa, hh = a, b
    d = 1
    while d < S:
        hh = torch.cat([hh[:, :d], hh[:, :-d] * aa[:, d:] + hh[:, d:]], 1)
        if 2 * d < S or h0 is not None:
            aa = torch.cat([aa[:, :d], aa[:, :-d] * aa[:, d:]], 1)
        d *= 2
    if h0 is not None:
        hh = hh + aa * h0[:, None]
    return hh


def rglru_forward(params, x, cfg, *, return_cache: bool = False,
                  h0=None, conv0=None):
    """x: (B,S,D) -> (B,S,D) [, cache]."""
    params = layer_params(params, cfg)
    nb = params["gate_a"].shape[0]          # the rank's blocks
    gate = F.gelu(_linear(params, x, "w_gate", cfg), approximate="tanh")
    xr = _linear(params, x, "w_x", cfg)
    xr_raw = xr
    if conv0 is not None:
        ext = torch.cat([conv0.to(xr.dtype), xr], dim=1)
        xr = _dconv(ext, params["conv"], params["conv_b"])[:, conv0.shape[1]:]
    else:
        xr = _dconv(xr, params["conv"], params["conv_b"])
    a, gated = _gates(params, xr, nb)
    h = rglru_scan(a, gated, h0)
    y = h.to(x.dtype) * gate
    out = _out(params, y, cfg)
    if not return_cache:
        return out
    return out, {"h": h[:, -1],
                 "conv": _conv_tail(xr_raw, cfg.hybrid.conv_width)}


def rglru_decode(params, x, cache, cfg):
    """x: (B,1,D) single-token step. In a block program x is the rank's
    rows and `cache` its param-rule block (every row, its channels): the
    rank's rows step, and every row's new state and history are written
    into `cache` in place."""
    blocks = sharding.in_blocks()
    if blocks:
        every = cache
        cache = {k: sharding.own_rows(c, x.shape[0]) for k, c in cache.items()}
    params = layer_params(params, cfg)
    nb = params["gate_a"].shape[0]
    gate = F.gelu(_linear(params, x, "w_gate", cfg), approximate="tanh")
    xr_new = _linear(params, x, "w_x", cfg)                 # (B,1,R)
    hist = torch.cat([cache["conv"].to(xr_new.dtype), xr_new],
                     dim=1)                                 # (B,K,R)
    xr = torch.einsum("bkr,kr->br", hist, params["conv"]) \
        + params["conv_b"].to(x.dtype)
    a, gated = _gates(params, xr[:, None], nb)
    h = a[:, 0] * cache["h"] + gated[:, 0]                  # (B,R)
    y = h.to(x.dtype)[:, None] * gate
    out = _out(params, y, cfg)
    new_cache = {"h": h, "conv": hist[:, 1:].float()}
    if blocks:
        for k, c in every.items():
            c.copy_(sharding.every_row(new_cache[k], c.shape[0]))
        new_cache = every
    return out, new_cache


def rglru_cache_spec(cfg, batch: int) -> dict:
    R = cfg.hybrid.lru_width or cfg.d_model
    K = cfg.hybrid.conv_width
    return {
        "h": Spec((batch, R), ("batch", "rnn"), init="zeros", dtype="float32"),
        "conv": Spec((batch, K - 1, R), ("batch", None, "rnn"), init="zeros",
                     dtype="float32"),
    }
