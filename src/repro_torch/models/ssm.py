"""Mamba-2 block: SSD (state-space duality) chunked scan + O(1) decode.
[arXiv:2405.21060]

Discrete SSD recurrence per head h (state S ∈ R^{N x P}):
    a_t = exp(dt_t * A_h)                               (scalar decay)
    S_t = a_t * S_{t-1} + dt_t * (B_t ⊗ x_t)
    y_t = C_t · S_t + D_h * x_t

The port of the reference's `repro.models.ssm`, function by function.
The chunked prefill computes the intra-chunk term as a masked quadratic
form (the "duality" with attention) and carries the chunk states across
chunks; the state and the conv history are float32 whatever the model
dtype, as there.

Differences from the reference, on purpose:

  * `ssd_chunked` runs chunks of min(chunk, S) tokens and pads the
    ragged tail with steps of x = 0, B = C = 0 and post-softplus
    dt = 0 — log-decay 0, nothing added to any state, and causality
    keeps them out of every real row — where the reference halves its
    chunk until it divides S (a prime S runs S chunks of one token).
    The decay between two positions of a chunk is summed over the steps
    between them (a masked cumulative sum), not taken as a difference of
    two running sums, which loses float32 bits once the sums grow over
    a long chunk. The chunk states are carried by a Python loop of two
    launches a chunk (at most S / chunk of them; `lax.scan` there), and
    every chunk's output reads its starting state in one product. The
    same function, reassociated: held at 1e-4.
  * A prompt shorter than the conv history (S < d_conv - 1) leaves a
    conv cache of d_conv - 1 rows, the missing ones zero (what `_dconv`
    reads before the sequence's start). The reference asserts there.

In a block program (`sharding.in_blocks`) the mixer runs on the rank's
rows and its blocks, the partition GSPMD gives the reference: each
weight gathered over data inside the layer (FSDP), or contracted where
it lies in a decode of rows whole over data (`sharding.matmul_block`);
`in_z`, `in_x`, `in_dt`, the x conv and `A_log` / `dt_bias` / `D` on
the rank's d_inner/M channels and H/M heads (column-parallel), `in_B` /
`in_C` whole on every rank of `model` (their weight's gradient from its
S/M tokens) or, with fewer tokens than d_model, contracted over the
rank's d_model/M columns and psummed (`_proj_bc`), their convs whole;
the scan on its heads with no collective; the gated norm's sum of
squares over d_inner psummed over `model` before the rsqrt
(`_gated_norm`), its scale the rank's slice; `out` row-parallel,
psummed over `model`. A prefill's cache is the rank's rows, heads and
channels; a decode writes every row's new state and conv history into
its param-rule block of the caches (every row), in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.models import module as mod
from repro_torch.models.layers import rmsnorm, rmsnorm_spec
from repro_torch.models.module import Spec
from repro_torch.models.rglru import _conv_tail, _dconv
from repro_torch.parallel import sharding


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.n_groups, s.d_state, s.head_dim


def mamba2_spec(cfg) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H, G, N, P = dims(cfg)
    K = s.d_conv
    return {
        "in_z": Spec((D, d_inner), ("embed", "ssm_inner")),
        "in_x": Spec((D, d_inner), ("embed", "ssm_inner")),
        "in_B": Spec((D, G * N), ("embed", None)),
        "in_C": Spec((D, G * N), ("embed", None)),
        "in_dt": Spec((D, H), ("embed", "ssm_heads")),
        "conv_x": Spec((K, d_inner), ("conv", "ssm_inner")),
        "conv_x_b": Spec((d_inner,), ("ssm_inner",), init="zeros"),
        "conv_B": Spec((K, G * N), ("conv", None)),
        "conv_B_b": Spec((G * N,), (None,), init="zeros"),
        "conv_C": Spec((K, G * N), ("conv", None)),
        "conv_C_b": Spec((G * N,), (None,), init="zeros"),
        "A_log": Spec((H,), ("ssm_heads",), init="a_log", dtype="float32"),
        "dt_bias": Spec((H,), ("ssm_heads",), init="zeros", dtype="float32"),
        "D": Spec((H,), ("ssm_heads",), init="ones", dtype="float32"),
        "norm": rmsnorm_spec(d_inner),
        "out": Spec((d_inner, D), ("ssm_inner", "embed")),
    }


# the projections: `_proj` gathers or reads them where they lie
_PROJS = ("in_z", "in_x", "in_B", "in_C", "in_dt", "out")


def layer_params(params, cfg):
    """One layer's weights as the mixer reads them: in a block program
    each block but the projections' gathered over data (FSDP; `_proj`
    reads those), else `params` as they are."""
    if not sharding.in_blocks():
        return params
    spec = mamba2_spec(cfg)
    return {k: v if k in _PROJS else tree.map(
        lambda s_, a: sharding.gather_param(a, s_.axes, shape=s_.shape),
        spec[k], v, is_leaf=mod.is_spec) for k, v in params.items()}


def _proj(params, x, name, cfg):
    """x times the projection `name` (`sharding.matmul_block`: in a block
    program its block gathered over data, or contracted where it lies)."""
    s_ = mamba2_spec(cfg)[name]
    return sharding.matmul_block(x, params[name], s_.axes, s_.shape)


def _groups(H_l: int, cfg) -> slice:
    """The B/C groups the rank's H_l heads read (every group where the
    heads are whole)."""
    _, H, G, _, _ = dims(cfg)
    if H_l == H:
        return slice(0, G)
    rep = H // G
    if H_l % rep and rep % H_l:
        raise NotImplementedError(f"{H_l} heads a rank over groups of {rep}")
    r = sharding.axis_index("model")
    return slice(r * H_l // rep, ((r + 1) * H_l - 1) // rep + 1)


def _inner_psum(t):
    """The rank's part of a sum over d_inner, summed over `model`."""
    return sharding.psum(t, "model")


def _gated_norm(norm, y, z, cfg, dtype):
    """rmsnorm(y * silu(z)) over d_inner. With the channels split over
    `model` (a block program) the rank's sum of squares is psummed over
    `model` before the rsqrt and the scale is its slice."""
    g = (y * F.silu(z)).to(dtype)
    d_inner = dims(cfg)[0]
    n = g.shape[-1]
    if n == d_inner:
        return rmsnorm(norm, g, cfg.norm_eps)
    r = sharding.axis_index("model")
    gf = g.float()
    var = _inner_psum(gf.square().sum(-1, keepdim=True)) / d_inner
    scale = norm["scale"][r * n:(r + 1) * n]
    return (gf * torch.rsqrt(var + cfg.norm_eps) * scale).to(dtype)


def _out(w, y, cfg):
    """The out-projection; row-parallel where the channels split."""
    out = _proj(w, y, "out", cfg)
    if y.shape[-1] != dims(cfg)[0]:
        out = sharding.psum(out, "model")
    return out


def _proj_inputs(params, x, cfg):
    z = _proj(params, x, "in_z", cfg)
    xc = _proj(params, x, "in_x", cfg)
    Bm, Cm = _proj_bc(params, x, cfg)
    dt = _proj(params, x, "in_dt", cfg).float()
    return z, xc, Bm, Cm, dt


def _proj_bc(params, x, cfg):
    """x's `in_B` and `in_C` projections. In a block program (both whole
    over `model`) GSPMD's partition: where the rank's tokens are fewer
    than d_model (a decode's, a reduced prefill's), each rank of `model`
    contracts its d_model/M columns of x with the weights' rows, the
    partials psummed over `model` in one all-reduce; else every rank of
    `model` contracts the whole (the all-reduce of the (tokens, 2 G N)
    outputs would move more than the weights)."""
    M, D = sharding.mesh_axis_size("model"), x.shape[-1]
    if not sharding.in_blocks() or M == 1 or D % M or \
            sharding.current().in_place:
        return _proj(params, x, "in_B", cfg), _proj(params, x, "in_C", cfg)
    spec = mamba2_spec(cfg)
    params = {k: sharding.gather_param(params[k], spec[k].axes,
                                       shape=spec[k].shape)
              for k in ("in_B", "in_C")}
    GN = params["in_B"].shape[1]
    if x.shape[:-1].numel() >= D:
        w = torch.cat([params["in_B"], params["in_C"]], 1)
        if x.shape[1] % M == 0 and torch.is_grad_enabled() and (
                x.requires_grad or w.requires_grad):
            return _TokenSplitGrad.apply(x, w).split(GN, -1)
        return (x @ w).split(GN, -1)
    n = D // M
    r = sharding.axis_index("model") * n
    w = torch.cat([params["in_B"][r:r + n], params["in_C"][r:r + n]], 1)
    bc = sharding.psum(x[..., r:r + n] @ w, "model")
    return bc.split(GN, -1)


class _TokenSplitGrad(torch.autograd.Function):
    """x @ w on every rank of `model` (x (b, S, D) and w whole over it),
    as GSPMD partitions `in_B` / `in_C` where the tokens outnumber
    d_model: x's gradient whole on every rank (its share, from its
    heads' cotangent), the weight's from this rank's S/M tokens of the
    cotangent summed over `model` (psum-scattered), 1/M of the work;
    the ranks' shares sum to the weight's gradient
    (`sharding.reduce_replicas`)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        ctx.mesh = sharding.current()
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with sharding.use_context(ctx.mesh):
            gs = sharding.psum_scatter(g, "model", 1)
            n = gs.shape[1]
            xs = x[:, sharding.axis_index("model") * n:][:, :n]
        gw = xs.reshape(-1, x.shape[-1]).T @ gs.reshape(-1, gs.shape[-1])
        return g @ w.T, gw.to(w.dtype)


def ssd_chunked(xh, dt, A, Bm, Cm, Dp, chunk: int, h0=None):
    """Chunked SSD scan.

    xh: (B,S,H,P); dt: (B,S,H) f32 (post-softplus); A: (H,) f32
    (negative); Bm/Cm: (B,S,G,N); Dp: (H,) skip; h0: (B,H,N,P) f32 or
    None. Returns (y (B,S,H,P) in xh's dtype, final state (B,H,N,P)
    f32)."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t, *feat):
        t = t.float()
        if pad:         # pad steps: x = B = C = 0 and dt = 0
            t = torch.cat([t, t.new_zeros((B, pad) + tuple(feat))], 1)
        return t.reshape((B, nc, Q) + tuple(feat))

    xf = chunks(xh, H, P)
    dtc = chunks(dt, H)
    Bc = chunks(Bm, G, N)
    Cc = chunks(Cm, G, N)

    l = (dtc * A).movedim(2, 3)                      # (B,nc,H,Q) log decay
    cs = torch.cumsum(l, dim=-1)                     # inclusive
    # seg[..., i, j] = l_{j+1} + ... + l_i for j <= i (-1e30 above the
    # diagonal, masked BEFORE exp), summed over the steps between
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device)
    below = torch.tril(tri, diagonal=-1)
    seg = torch.cumsum(torch.where(below, l[..., :, None], 0.0), dim=-2)
    seg = torch.where(torch.tril(tri), seg, -1e30)   # (B,nc,H,Q,Q)

    # intra-chunk quadratic term (masked "attention" duality)
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)  # (B,nc,G,Q,Q)
    M = CB.repeat_interleave(rep, dim=2) * torch.exp(seg)
    xT = xf.permute(0, 1, 3, 2, 4)                   # (B,nc,H,Q,P)
    dth = dtc.movedim(2, 3)                          # (B,nc,H,Q)
    y = (M * dth[..., None, :]) @ xT                 # (B,nc,H,Q,P)

    # chunk summary states: S_c = sum_j exp(cs_last - cs_j) dt_j B_j x_j^T
    w = torch.exp(seg[..., -1, :]) * dth             # (B,nc,H,Q)
    Bh = Bc.repeat_interleave(rep, dim=3).permute(0, 1, 3, 4, 2)
    states = (Bh * w[..., None, :]) @ xT             # (B,nc,H,N,P)

    # each chunk's starting state, then their contribution in one product
    prev = h0.float() if h0 is not None else \
        torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
    decay = torch.exp(cs[..., -1])                   # (B,nc,H)
    starts = []
    for c in range(nc):
        starts.append(prev)
        prev = decay[:, c, :, None, None] * prev + states[:, c]
    starts = torch.stack(starts, 1)                  # (B,nc,H,N,P)
    Ch = Cc.repeat_interleave(rep, dim=3).permute(0, 1, 3, 2, 4)
    y = y + (Ch * torch.exp(cs)[..., None]) @ starts  # (B,nc,H,Q,P)

    y = y.permute(0, 1, 3, 2, 4).reshape(B, nc * Q, H, P)[:, :S] \
        + Dp[None, None, :, None] * xh.float()
    return y.to(xh.dtype), prev


def mamba2_forward(params, x, cfg, *, return_cache: bool = False,
                   initial_cache=None):
    """Full-sequence mamba2 mixer. x: (B,S,D) -> (B,S,D) [, cache]."""
    s = cfg.ssm
    _, _, G, N, P = dims(cfg)
    B, S, D = x.shape
    if initial_cache is not None:
        raise NotImplementedError("chunk-continuation prefill not needed")
    params = layer_params(params, cfg)
    H = params["A_log"].shape[0]            # the rank's heads
    z, xc, Bm, Cm, dt = _proj_inputs(params, x, cfg)
    xc_raw, Bm_raw, Cm_raw = xc, Bm, Cm

    xc = F.silu(_dconv(xc, params["conv_x"], params["conv_x_b"]))
    Bm = F.silu(_dconv(Bm, params["conv_B"], params["conv_B_b"]))
    Cm = F.silu(_dconv(Cm, params["conv_C"], params["conv_C_b"]))

    dtp = F.softplus(dt + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    g = _groups(H, cfg)
    y, final = ssd_chunked(xc.reshape(B, S, H, P), dtp, A,
                           Bm.reshape(B, S, G, N)[:, :, g],
                           Cm.reshape(B, S, G, N)[:, :, g],
                           params["D"], s.chunk_size)
    y = _gated_norm(params["norm"], y.reshape(B, S, H * P), z, cfg, x.dtype)
    out = _out(params, y, cfg)
    if not return_cache:
        return out
    # conv caches hold the last K-1 *pre-conv* channel values
    K = s.d_conv
    cache = {
        "state": final,                                   # (B,H,N,P) f32
        "conv_x": _conv_tail(xc_raw, K),
        "conv_B": _conv_tail(Bm_raw, K),
        "conv_C": _conv_tail(Cm_raw, K),
    }
    return out, cache


def mamba2_decode(params, x, cache, cfg):
    """Single-token step. x: (B,1,D); cache from mamba2_cache_spec. The
    conv history, its products and the state are float32 (the
    reference's promotion of the float32 cache with the new row). In a
    block program x is the rank's rows and `cache` its param-rule block
    (every row, its heads and channels): the rank's rows step, and every
    row's new state and history are written into `cache` in place."""
    _, _, G, N, P = dims(cfg)
    B = x.shape[0]
    blocks = sharding.in_blocks()
    if blocks:
        every = cache
        cache = {k: sharding.own_rows(c, B) for k, c in cache.items()}
    params = layer_params(params, cfg)
    H = params["A_log"].shape[0]
    z, xc, Bm, Cm, dt = _proj_inputs(params, x, cfg)

    def step_conv(cache_k, new, w, b):
        hist = torch.cat([cache_k.float(), new.float()], dim=1)  # (B,K,F)
        y = torch.einsum("bkf,kf->bf", hist, w.float()) + b.float()
        return F.silu(y)[:, None], hist[:, 1:]

    xc1, conv_x = step_conv(cache["conv_x"], xc, params["conv_x"],
                            params["conv_x_b"])
    Bm1, conv_B = step_conv(cache["conv_B"], Bm, params["conv_B"],
                            params["conv_B_b"])
    Cm1, conv_C = step_conv(cache["conv_C"], Cm, params["conv_C"],
                            params["conv_C_b"])

    dtp = F.softplus(dt[:, 0] + params["dt_bias"])           # (B,H)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dtp * A)                                   # (B,H)
    xh = xc1[:, 0].reshape(B, H, P)
    g = _groups(H, cfg)
    Bg = Bm1[:, 0].reshape(B, G, N)[:, g]
    Cg = Cm1[:, 0].reshape(B, G, N)[:, g]
    rep = H // Bg.shape[1]
    Bh = Bg.repeat_interleave(rep, dim=1)                   # (B,H,N)
    Ch = Cg.repeat_interleave(rep, dim=1)
    state = a[..., None, None] * cache["state"] \
        + (dtp[..., None] * Bh)[..., :, None] * xh[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch, state) \
        + params["D"][None, :, None] * xh
    y = _gated_norm(params["norm"], y.reshape(B, 1, H * P).to(x.dtype), z,
                    cfg, x.dtype)
    out = _out(params, y, cfg)
    new_cache = {"state": state, "conv_x": conv_x, "conv_B": conv_B,
                 "conv_C": conv_C}
    if blocks:
        for k, c in every.items():
            c.copy_(sharding.every_row(new_cache[k], c.shape[0]))
        new_cache = every
    return out, new_cache


def mamba2_cache_spec(cfg, batch: int) -> dict:
    s = cfg.ssm
    d_inner, H, G, N, P = dims(cfg)
    K = s.d_conv
    return {
        "state": Spec((batch, H, N, P), ("batch", "ssm_heads", None, None),
                      init="zeros", dtype="float32"),
        "conv_x": Spec((batch, K - 1, d_inner), ("batch", None, "ssm_inner"),
                       init="zeros", dtype="float32"),
        "conv_B": Spec((batch, K - 1, G * N), ("batch", None, None),
                       init="zeros", dtype="float32"),
        "conv_C": Spec((batch, K - 1, G * N), ("batch", None, None),
                       init="zeros", dtype="float32"),
    }
