"""Dense feed-forward blocks (GLU variants + plain MLP).

The port of the reference's `repro.models.ffn`. `ffn_apply(sp=True)` is
the explicit Megatron-SP variant for an input sequence-sharded over the
`model` mesh axis, and picks the cheaper of two `sharding.shard_map`
bodies as the reference does (`w_bytes < act_bytes`):

  * `_ffn_apply_wg`, weight-gathered: the tokens stay on their rank, the
    (small) weights are all-gathered whole once; no activation moves;
  * `_ffn_apply_sp`, Megatron-SP: the tokens are all-gathered over
    `model`, each rank computes its `mlp` columns' partial output, and
    the partials are reduce-scattered back to the sequence blocks.

Both run the same per-rank piece, `_ffn_core`, on what their
collectives leave on the rank.
"""
from __future__ import annotations

from functools import partial

from repro_torch.models.layers import act_fn, linear, linear_spec
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P


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


def ffn_apply(params, x, act: str, *, sp: bool = False, spec=None):
    """The FFN of x. `spec`, its global `ffn_spec`, is what a block
    program reads (`_ffn_blocks`); with `sp` a block program runs the SP
    body on its blocks (`sharding.shard_map` in a block program: x the
    rank's (B/dp, S/M) block, the weights its param blocks)."""
    if spec is not None and sharding.in_blocks() and not sp:
        return _ffn_blocks(params, x, act, spec)
    if sp:
        return (_ffn_apply_wg(params, x, act)
                if weight_gathered(params, x, spec)
                else _ffn_apply_sp(params, x, act))
    return linear(params["down"], hidden(x, params.get("gate"),
                                         params["up"], act))


def _ffn_blocks(params, x, act: str, spec):
    """A block program's FFN on the rank's rows: each weight block
    gathered over data inside the layer (FSDP), gate and up column-
    parallel over `model` (the hidden (B, S, F/M), the reference's
    `constrain(h, "batch", "seq", "mlp")`), down row-parallel and its
    partial sums psummed over `model`; with `mlp` unsplit, the whole
    FFN on each rank. Where the rows are whole over data
    (`sharding.rows_in_place`) the weights stay where they lie
    (`sharding.matmul_block`)."""
    in_place = sharding.current().in_place
    # every block gathered over data but, with the rows whole over data,
    # the weights: `lin` contracts each where it lies
    w = {n: {k: sharding.gather_param(a, spec[n][k].axes,
                                      shape=spec[n][k].shape)
             for k, a in params[n].items() if not (in_place and k == "w")}
         for n in params}
    if in_place:
        def lin(n, x_):
            s_ = spec[n]["w"]
            return sharding.matmul_block(x_, params[n]["w"], s_.axes,
                                         s_.shape)
        f = act_fn(act)
        up = _biased(lin("up", x), w["up"])
        h = (f(_biased(lin("gate", x), w["gate"])) * up if "gate" in params
             else f(up))
        y = lin("down", h)
    else:
        h = hidden(x, w.get("gate"), w["up"], act)
        y = h @ w["down"]["w"]
    return _row_parallel_out(y, w["down"],
                             h.shape[-1] != spec["up"]["w"].shape[-1])


def _row_parallel_out(y, down, split: bool):
    """The down projection's output y: its partial sums psummed over
    `model` where the `mlp` columns split (`split`), then its bias, if it
    has one, added once (after the psum: a bias added on every rank
    before it would come out M times)."""
    if split:
        y = sharding.psum(y, "model")
    return _biased(y, down)


def _biased(y, p):
    """y plus the bias of the projection `p` ({"b"?}), if it has one."""
    return y + p["b"].to(y.dtype) if "b" in p else y


def hidden(x, gate, up, act: str):
    """The FFN's hidden activations of x through `gate` (None without a
    gate) and `up` ({"w", "b"?} each)."""
    f = act_fn(act)
    if gate is not None:
        return f(linear(gate, x)) * linear(up, x)
    return f(linear(up, x))


def weight_gathered(params, x, spec=None) -> bool:
    """The reference's choice of the cheaper gather: Megatron-SP moves
    the activations (2 x tokens x D bytes on the wire), the ZeRO-style
    variant the weights once (3 x D x F); small-F FFNs (shared experts)
    are far cheaper weight-gathered."""
    B, S, D = x.shape
    bs = sharding.axis_size(sharding.batch_axes_prefix(B))
    F = params["up"]["w"].shape[-1]
    if sharding.in_blocks():    # x: the rank's rows and S/M positions
        bs, S = 1, S * sharding.mesh_axis_size("model")
        F = spec["up"]["w"].shape[-1]
    n_mats = 3 if "gate" in params else 2
    return n_mats * D * F < 2 * (B // bs) * S * D


def _ffn_core(x, wg, wu, wd, act: str):
    """The FFN of x through these weights (whole or a rank's columns;
    wg None without a gate): a partial sum over F where they are
    columns."""
    f = act_fn(act)
    h = f(x @ wg) * (x @ wu) if wg is not None else f(x @ wu)
    return h @ wd


# the reference's names: a weight fully de-sharded inside shard_map
# (the model axis too), and ZeRO-style over every non-model axis
_gather_all = partial(sharding.gather_param, keep_model=False)
_gather_w = sharding.gather_param


def _ffn_sharded(params, x, act: str, gather, x_body):
    """The shared frame of both SP bodies: x sequence-sharded over
    `model`, the weights by their param specs, `gather` de-sharding
    each weight block and `x_body(x_l, y_fn)` moving the activations."""
    B = x.shape[0]
    has_gate = "gate" in params
    b = sharding.batch_axes_prefix(B) or None
    xspec = P(b, "model", None)
    up, down = params["up"]["w"], params["down"]["w"]
    # spec (and gather) by the `up` shape, as the reference does for gate
    gspec = sharding.resolve_spec(("embed", "mlp"), up.shape, "param")
    dspec = sharding.resolve_spec(("mlp", "embed"), down.shape, "param")

    def body(x_l, wg, wu, wd):
        wu = gather(wu, ("embed", "mlp"))
        wd = gather(wd, ("mlp", "embed"))
        wg = gather(wg, ("embed", "mlp")) if has_gate else None
        return x_body(x_l, lambda x_: _ffn_core(x_, wg, wu, wd, act))

    wg = params["gate"]["w"] if has_gate else up
    return sharding.shard_map(body, (xspec, gspec, gspec, dspec),
                              xspec)(x, wg, up, down)


def _ffn_apply_wg(params, x, act: str):
    """Weight-gathered token-local FFN: x stays sequence-sharded; the
    weights are all-gathered once; zero activation collectives."""
    return _ffn_sharded(params, x, act, _gather_all,
                        lambda x_l, y: y(x_l))


def _ffn_apply_sp(params, x, act: str):
    """Megatron-SP: the sequence all-gathered over `model` in, each
    rank's partial over its mlp columns reduce-scattered out."""
    return _ffn_sharded(params, x, act, _gather_w, lambda x_l, y: (
        sharding.psum_scatter(y(sharding.all_gather(x_l, "model", 1)),
                              "model", 1)))
