"""Logical-axis sharding: rules tables, mesh context, constraint helpers.

The port of the reference's `repro.parallel.sharding`. Two rule tables
(they intentionally differ — FSDP shards *parameters* over the data
axis, while *activations* shard their batch over it):

  param rules:  logical param axis -> mesh axis (or None)
  act rules:    logical activation axis -> mesh axis / tuple of axes

Resolution drops mesh axes that are absent from the active mesh and
falls back to replication when the dim size does not divide the mesh
axis size (this is what lets e.g. kv_heads=8 stay replicated on a
model=16 mesh, or an odd vocab stay unsharded, without per-arch special
cases).

A mesh is a `torch.distributed` `DeviceMesh` (`launch.mesh.make_mesh`)
or an `AbstractMesh` (`launch.mesh.abstract_mesh`: axes and sizes with
no ranks, enough to resolve specs). A resolved spec is a
`PartitionSpec`, the port's own tuple of per-dimension entries (a mesh
axis name, a tuple of them, or None), equal as a tuple to the
reference's `jax.sharding.PartitionSpec`. `placements(spec)` turns it
into what a DTensor takes: per mesh dimension `Shard(d)` for the tensor
dim d it shards, else `Replicate()`. A tensor dim sharded over two mesh
axes is split by DTensor in mesh-dim order, where JAX splits it with the
spec's first axis major: the same local shapes, other blocks.

The reference reads its branches from `perf.FLAGS` (`ep_over_data`,
`moe_impl`, `capacity_factor`, `seq_parallel`, `decode_layout`); the
port has no `perf` module and takes each as an argument of `use_mesh`,
kept on `MeshContext` (`ep_over_data` also of `make_param_rules`),
since they matter only with a mesh. `abstract_with_shardings` gives
the dry-run (`launch.dryrun`) its stand-ins: fake tensors, metadata
only, at this rank's block shapes (`block_shape`) or whole.

The `shard_map` counterpart. The port keeps plain tensors and the
reference's global view at every function boundary: each rank of a
`DeviceMesh` holds every activation and parameter whole. A sharded
region is `shard_map(body, in_specs, out_specs)(*args)`: each input is
cut to the block this rank's mesh coordinates own under its
`PartitionSpec`, `body` runs on the blocks, and each output's global
value is rebuilt from its out-spec by all-gathers. Inside `body` the
reference's `lax` collectives are the functions below, over the
process group of the named mesh axis or tuple of axes:

    lax.all_gather(tiled)        all_gather     (all_gather)
    lax.psum_scatter(tiled)      psum_scatter   (reduce_scatter)
    lax.all_to_all(tiled)        all_to_all     (all_to_all_single)
    lax.psum / lax.pmax          psum / pmax    (all_reduce)
    lax.ppermute                 ppermute       (batch_isend_irecv)
    lax.axis_index               axis_index

A tuple of axes, such as EP over ("model", "data") or the batch over
("pod", "data"), is one line of ranks ordered as JAX orders it, the
first axis major (`_line`); `torch.distributed` orders a group's ranks
by global rank, so the collectives permute blocks to JAX's order.

Why not DTensor with `local_map`: it would push DTensors through every
model function, while a plain body is what one process can also run
rank by rank on the card (`chip_smoke.py` phases 13-16, `parallel.
turns`), with the collectives done as stacked tensor ops. The cost of
the global view is memory and work: every rank holds the whole
activations and computes on them, which the reference shards.
`constrain` resolves its spec and returns its tensor as it is.

The block program. A model of `BLOCK_FAMILIES` (the dense, MoE, SSM and
RG-LRU hybrid decoders and the encoder-decoder: every family) runs each
rank's own program under a `DeviceMesh` instead
(`runs_blocks`, `program`): its inputs are this
rank's blocks (the parameters under their param specs, the batch's
rows, `rows`), its outputs stay blocks, and a tensor changes layout only
where the reference has a `constrain`, by an explicit, differentiable
`relayout`. Inside it (`in_blocks`) the layers read their blocks: the
weights gathered over data inside each layer (FSDP, `gather_param`),
the branches of `parallel.collectives` on the rank's q/k/v. Its
gradients are the collectives' transposes with every rank seeding the
one loss by 1 / (the mesh's ranks), so a collective's transpose sums
the ranks' shares; a parameter's gradient comes out as its block,
psum-scattered over data by the FSDP gather's transpose, and is summed
over the ranks that hold the same block (`reduce_replicas`).

Gradients. The collectives but `pmax` are autograd Functions whose
backward is JAX's transpose: `psum` -> `psum`, `all_gather` <->
`psum_scatter`, `all_to_all` -> the inverse `all_to_all`,
`ppermute(shift)` -> `ppermute(-shift)`, each on the same line in JAX's
order. `shard_map` differentiates as the reference's `shard_map(...,
check_vma=False)` does (`jax/_src/shard_map.py`
`_shard_map_transpose`), on the global view: an output's whole
cotangent, the same on every rank, is cut to this rank's block and
divided by the ranks of the mesh axes its out-spec does not name; the
body's autograd runs; an input's block cotangent is psummed over the
axes its in-spec does not name and all-gathered over those it names.
Every rank ends with the same whole gradient. `pmax` (the decode
merge's, on no training path) records none and refuses an input that
requires one under grad mode. A body must take every
tensor it differentiates as an argument: one it closes over would get
only this rank's share of its gradient.

`shard_tree` / `unshard_tree` cut a tree of whole tensors to this
rank's blocks under their param specs and gather them back: the
sharded train step's state between steps (`train.train_loop`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.models import module as mod


class PartitionSpec(tuple):
    """Per-dimension mesh-axis entries: a name, a tuple of names, None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def make_param_rules(fsdp: bool = True, *, ep_over_data: bool = False) -> dict:
    ep = ("model", "data") if ep_over_data else "model"
    return {
        "layers": None,
        "vocab": "model",
        "embed": "data" if fsdp else None,   # ZeRO-3 style: shard params on data
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "expert": ep,                        # EP (optionally over both axes)
        "expert_mlp": ("data" if fsdp and not ep_over_data else None),
        "q_lora": None,
        "kv_lora": None,
        "rnn": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "state": None,
        "conv": None,
        None: None,
    }


ACT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": "model",      # decode-time KV cache sequence sharding
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "rnn": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "state": None,
    "window": None,
    None: None,
}


MOE_IMPLS = ("a2a", "replicated")
DECODE_LAYOUTS = ("seq", "heads")


@dataclasses.dataclass
class MeshContext:
    mesh: object            # a DeviceMesh or an AbstractMesh
    param_rules: dict
    act_rules: dict
    # the reference's perf.FLAGS branches that matter only on a mesh
    moe_impl: str = "a2a"           # 'a2a' (direct) | 'replicated' (staged)
    capacity_factor: Optional[float] = None   # overrides MoEConfig's
    seq_parallel: bool = False      # Megatron-SP residual stream
    decode_layout: str = "seq"      # 'seq' | 'heads' (KV cache sharding)
    blocks: bool = False            # inside a block program
    in_place: bool = False          # rows whole over data: `rows_in_place`
    row_axes: Optional[tuple] = None    # the axes splitting the rows: `batch_rows`


_CTX: contextvars.ContextVar[Optional[MeshContext]] = contextvars.ContextVar(
    "repro_torch_mesh_ctx", default=None)


@contextlib.contextmanager
def use_mesh(mesh, *, fsdp: bool = True, ep_over_data: bool = False,
             param_rules: dict | None = None, act_rules: dict | None = None,
             moe_impl: str = "a2a", capacity_factor: float | None = None,
             seq_parallel: bool = False, decode_layout: str = "seq"):
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl {moe_impl!r} is not one of {MOE_IMPLS}")
    if decode_layout not in DECODE_LAYOUTS:
        raise ValueError(f"decode_layout {decode_layout!r} is not one of "
                         f"{DECODE_LAYOUTS}")
    ctx = MeshContext(mesh, param_rules or make_param_rules(
        fsdp, ep_over_data=ep_over_data), act_rules or dict(ACT_RULES),
        moe_impl=moe_impl, capacity_factor=capacity_factor,
        seq_parallel=seq_parallel, decode_layout=decode_layout)
    with use_context(ctx):
        yield ctx


@contextlib.contextmanager
def use_context(ctx: Optional[MeshContext]):
    """Make `ctx` (a `use_mesh` context, or None) the current one: what
    a backward, which runs outside its forward's `with`, re-enters."""
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def current() -> Optional[MeshContext]:
    return _CTX.get()


def ranks_in_use() -> bool:
    """A `DeviceMesh` (ranks to communicate with) is in use, not an
    abstract mesh or none."""
    ctx = current()
    return (ctx is not None
            and getattr(ctx.mesh, "mesh_dim_names", None) is not None)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or an AbstractMesh, in order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def mesh_axis_size(name: str) -> int:
    ctx = current()
    if ctx is None:
        return 1
    return axis_sizes(ctx.mesh).get(name, 1)


def _device_mesh(name: str):
    if not ranks_in_use():
        raise RuntimeError(f"axis {name!r}: no DeviceMesh in use (an "
                           "abstract mesh has no ranks to communicate)")
    return current().mesh


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(axis) -> int:
    """The ranks of mesh axis `axis`, or of a tuple of axes (1 without
    a mesh; an absent axis counts 1)."""
    return math.prod(mesh_axis_size(a) for a in _axes(axis))


@dataclasses.dataclass(frozen=True)
class _Line:
    group: object           # the process group of the line's ranks
    ranks: tuple            # global ranks in JAX's order (first axis major)
    order: tuple            # order[j]: group rank of JAX index j
    index: int              # this rank's JAX index on the line
    turns: object = None    # the `turns.Turns` running a LocalMesh's ranks


def _line(axis) -> _Line:
    """This rank's line of ranks along `axis` (a name or a tuple of
    names). A tuple's groups are made once per mesh, every line of them
    by every rank (`new_subgroups_by_enumeration`), so all ranks must
    reach the first use of a tuple together, as SPMD code does."""
    axes = _axes(axis)
    mesh = _device_mesh(axes[0])
    cache = mesh.__dict__.setdefault("_repro_lines", {})
    if axes not in cache:
        # the mesh's rank grid is a real tensor, read outside any
        # dispatch mode (a dry-run traces under FakeTensorMode)
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            cache[axes] = _make_line(mesh, axes)
    return cache[axes]


def _make_line(mesh, axes) -> _Line:
    """The `_Line` of this rank along `axes` of `mesh`."""
    import torch.distributed as dist
    names = list(mesh.mesh_dim_names)
    for a in axes:
        if a not in names:
            raise RuntimeError(f"axis {a!r} is not on the mesh {names}")
    grid = mesh.mesh.permute(
        [names.index(a) for a in names if a not in axes]
        + [names.index(a) for a in axes])
    lines = [tuple(int(r) for r in row)
             for row in grid.reshape(-1, math.prod(
                 grid.shape[len(names) - len(axes):]))]
    turns = getattr(mesh, "turns", None)
    if turns is not None:           # every rank in this process, in turns
        line = next(line for line in lines if mesh.rank in line)
        return _Line(None, line, tuple(range(len(line))),
                     line.index(mesh.rank), turns)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        group, _ = dist.new_subgroups_by_enumeration(
            [sorted(line) for line in lines])
    me = dist.get_rank()
    line = next(line for line in lines if me in line)
    srt = sorted(line)
    return _Line(group, line, tuple(srt.index(r) for r in line),
                 line.index(me))


def axis_index(axis) -> int:
    """This rank's coordinate on mesh axis `axis`; on a tuple of axes,
    its index with the first axis major (lax.axis_index)."""
    return _line(axis).index


def axis_group(axis):
    """The process group of this rank's line along `axis`."""
    return _line(axis).group


# --------------------------------------------------------------------------
# The collectives of a shard_map body (tiled, as the reference calls them)
# --------------------------------------------------------------------------
def _to_group_order(blocks, ln: _Line) -> list:
    """Blocks listed by JAX index -> listed by group rank."""
    inv = {g: j for j, g in enumerate(ln.order)}
    return [blocks[inv[g]] for g in range(len(blocks))]


def _in_turns(ln, op, x, *args):
    return ln.turns.exchange(ln.ranks[ln.index], ln, op, x, *args)


def _all_gather(x, axis, dim: int):
    import torch.distributed as dist
    ln = _line(axis)
    if ln.turns is not None:
        return _in_turns(ln, "all_gather", x, dim)
    parts = [torch.empty_like(x) for _ in ln.ranks]
    dist.all_gather(parts, x.contiguous(), group=ln.group)
    return torch.cat([parts[g] for g in ln.order], dim)


def _psum_scatter(x, axis, dim: int):
    import torch.distributed as dist
    ln = _line(axis)
    if ln.turns is not None:
        return _in_turns(ln, "psum_scatter", x, dim)
    n = len(ln.ranks)
    blocks = [b.contiguous() for b in
              _to_group_order(list(x.chunk(n, dim)), ln)]
    out = torch.empty_like(blocks[0])
    dist.reduce_scatter(out, blocks, group=ln.group)
    return out


def _all_to_all(x, axis, split_dim: int, concat_dim: int):
    import torch.distributed as dist
    ln = _line(axis)
    if ln.turns is not None:
        return _in_turns(ln, "all_to_all", x, split_dim, concat_dim)
    n = len(ln.ranks)
    send = torch.stack(_to_group_order(list(x.chunk(n, split_dim)), ln))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ln.group)
    return torch.cat([recv[g] for g in ln.order], concat_dim)


def _all_reduce(x, axis, op):
    import torch.distributed as dist
    ln = _line(axis)
    if ln.turns is not None:
        return _in_turns(ln, op, x)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=getattr(dist.ReduceOp, op), group=ln.group)
    return out


def _ppermute(x, axis, shift: int):
    import torch.distributed as dist
    ln = _line(axis)
    n = len(ln.ranks)
    if shift % n == 0:
        return x.clone()
    if ln.turns is not None:
        raise NotImplementedError("ppermute in turns")
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ln.ranks[(ln.index + shift) % n],
                      group=ln.group),
           dist.P2POp(dist.irecv, out, ln.ranks[(ln.index - shift) % n],
                      group=ln.group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


class _Collective(torch.autograd.Function):
    """A collective `fwd(x, *args)` whose backward is the collective
    `bwd(g, *bwd_args)`: its transpose."""

    @staticmethod
    def forward(ctx, x, fwd, args, bwd, bwd_args):
        ctx.mesh, ctx.bwd, ctx.bwd_args = current(), bwd, bwd_args
        return fwd(x, *args)

    @staticmethod
    def backward(ctx, g):
        with use_context(ctx.mesh):
            return ctx.bwd(g, *ctx.bwd_args), None, None, None, None


def _apply(x, fwd, args, bwd, bwd_args):
    if torch.is_grad_enabled() and x.requires_grad:
        return _Collective.apply(x, fwd, args, bwd, bwd_args)
    return fwd(x, *args)


def all_gather(x, axis, dim: int):
    """lax.all_gather(x, axis, axis=dim, tiled=True); transpose:
    psum_scatter."""
    return _apply(x, _all_gather, (axis, dim), _psum_scatter, (axis, dim))


def psum_scatter(x, axis, dim: int):
    """lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True);
    transpose: all_gather."""
    return _apply(x, _psum_scatter, (axis, dim), _all_gather, (axis, dim))


def all_to_all(x, axis, split_dim: int, concat_dim: int):
    """lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True): block
    j of `x` on split_dim goes to index j; the blocks received are
    concatenated on concat_dim by their sender's index. Transpose: the
    all_to_all with the two dims swapped."""
    return _apply(x, _all_to_all, (axis, split_dim, concat_dim),
                  _all_to_all, (axis, concat_dim, split_dim))


def psum(x, axis):
    """lax.psum(x, axis); transpose: psum."""
    return _apply(x, _all_reduce, (axis, "SUM"), _all_reduce, (axis, "SUM"))


def pmax(x, axis):
    """lax.pmax(x, axis), with no gradient: only the sharded decode's
    merge, on no training path, takes it, so an input that requires grad
    under grad mode is refused."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "pmax: an input requires grad, and pmax carries no gradient "
            "(only the sharded decode's merge takes it)")
    return _all_reduce(x, axis, "MAX")


def ppermute(x, axis, shift: int):
    """lax.ppermute(x, axis, [(i, (i + shift) % n)]): this rank's block
    goes `shift` places on along the line; the one `shift` places back
    arrives. Transpose: ppermute(-shift)."""
    return _apply(x, _ppermute, (axis, shift), _ppermute, (axis, -shift))


# --------------------------------------------------------------------------
# shard_map
# --------------------------------------------------------------------------
def _block(x, spec):
    """This rank's block of the global `x` under `spec`."""
    for d, ent in enumerate(spec):
        if ent is None:
            continue
        n = axis_size(ent)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {ent} ({n} ranks)")
        b = x.shape[d] // n
        x = x.narrow(d, axis_index(ent) * b, b)
    return x


def unblock(x, spec):
    """The global value of blocks laid out by `spec` (all-gathers; the
    inverse of `_block`)."""
    for d, ent in enumerate(spec):
        if ent is not None:
            x = all_gather(x, ent, d)
    return x


def unnamed_axes(spec) -> tuple:
    """The mesh axes `spec` does not name, in mesh order: a block's
    replicas lie along them."""
    named = {a for ent in spec if ent is not None for a in _axes(ent)}
    return tuple(a for a in axis_sizes(current().mesh) if a not in named)


class _Enter(torch.autograd.Function):
    """A whole input -> this rank's block; backward: the block's
    cotangent psummed over the axes `spec` does not name, then gathered
    over those it names, back to the whole input's."""

    @staticmethod
    def forward(ctx, x, spec):
        ctx.mesh, ctx.spec, ctx.unnamed = current(), spec, unnamed_axes(spec)
        if ctx.unnamed:
            _line(ctx.unnamed)      # every rank makes the group now
        return _block(x, spec).clone()

    @staticmethod
    def backward(ctx, g):
        with use_context(ctx.mesh):
            if ctx.unnamed:
                g = _all_reduce(g, ctx.unnamed, "SUM")
            return unblock(g, ctx.spec), None


class _Exit(torch.autograd.Function):
    """This rank's output block -> the whole output (all-gathers);
    backward: this rank's block of the whole cotangent over the ranks of
    the axes `spec` does not name."""

    @staticmethod
    def forward(ctx, y, spec):
        ctx.mesh, ctx.spec = current(), spec
        ctx.n = axis_size(unnamed_axes(spec))
        out = unblock(y, spec)
        return y.clone() if out is y else out

    @staticmethod
    def backward(ctx, g):
        with use_context(ctx.mesh):
            g = _block(g, ctx.spec)
        return (g / ctx.n if ctx.n != 1 else g), None


def _enter(x, spec):
    if torch.is_grad_enabled() and x.requires_grad:
        return _Enter.apply(x, spec)
    return _block(x, spec)


def _exit(y, spec):
    if torch.is_grad_enabled() and y.requires_grad:
        return _Exit.apply(y, spec)
    return unblock(y, spec)


def gather_param(w, axes, *, keep_model: bool = True, skip=(), shape=None):
    """De-shard a parameter's block inside a shard_map body: all-gather
    it over every mesh axis its param spec names, or every one but
    `model` (the reference's `_gather_w` / `degather`, and with
    keep_model=False its `_gather_all`). The spec is resolved on the
    block's shape, as the reference's are, or on `shape`; the dims of
    the logical axes in `skip` stay sharded (MoE's `_gather_fsdp`
    keeps the expert dim). Its gradient is `all_gather`'s."""
    spec = resolve_spec(axes, w.shape if shape is None else shape, "param")
    for d, ent in enumerate(spec):
        if axes[d] in skip:
            continue
        for ax in _axes(ent) if ent is not None else ():
            if not (keep_model and ax == "model"):
                w = all_gather(w, ax, d)
    return w


def shard_map(body, in_specs, out_specs):
    """The counterpart of the reference's `shard_map(body, mesh,
    in_specs, out_specs, check_vma=False)` on plain tensors held whole
    by every rank: each argument is cut to this rank's block under its
    spec (None: not a tensor, passed as it is), `body` runs on the
    blocks, and each output's global value is rebuilt from its out-spec.
    `out_specs` is one spec (one output) or a tuple of them. Its
    gradient is the reference's transpose (the module docstring). In a
    block program the arguments are this rank's blocks under
    `in_specs` already and the outputs stay its blocks: `body` alone."""
    single = isinstance(out_specs, PartitionSpec)

    def run(*args):
        if in_blocks():         # the arguments are this rank's blocks
            return body(*args)
        blocks = [a if s is None else _enter(a, s)
                  for a, s in zip(args, in_specs, strict=True)]
        out = body(*blocks)
        if single:
            return _exit(out, out_specs)
        return tuple(o if s is None else _exit(o, s)
                     for o, s in zip(out, out_specs, strict=True))
    return run


# --------------------------------------------------------------------------
# The block program
# --------------------------------------------------------------------------
# The model families whose model runs each rank's own program on its
# blocks under a DeviceMesh: the dense decoders ("dense", "vlm"), the MoE
# decoders ("moe": the router, the experts, MLA and the MTP head), the
# SSM ("ssm": mamba2's heads over model), the RG-LRU hybrid ("hybrid":
# the lru width over model, windowed attention) and the encoder-decoder
# ("encdec": the encoder, the decoder, the cross-attention and its frame
# caches). Every family of the registry is one.
BLOCK_FAMILIES = frozenset({"dense", "vlm", "moe", "ssm", "hybrid",
                            "encdec"})


def runs_blocks(cfg) -> bool:
    """`cfg`'s model runs the block program: a DeviceMesh is in use and
    its family is one of `BLOCK_FAMILIES`."""
    return ranks_in_use() and cfg.family in BLOCK_FAMILIES


def program(cfg):
    """The context a step of `cfg`'s model runs in: `block_program()`
    where it runs one (`runs_blocks`: a DeviceMesh and a family of
    `BLOCK_FAMILIES`), else none. In a block program every input is this
    rank's block: the parameters under their param specs, the batch's
    rows (`rows`), a decode's caches under the param rules (every row;
    written in place); and every output stays one: the logits (B/dp, S,
    V/M) where the vocab splits over `model`, a prefill's caches (B/dp,
    S/M, KVH, hd)."""
    return block_program() if runs_blocks(cfg) else contextlib.nullcontext()


@contextlib.contextmanager
def block_program():
    """Mark the current mesh context as running a block program (what
    `shard_map`, `constrain` and the model's layers read)."""
    with use_context(dataclasses.replace(current(), blocks=True)) as ctx:
        yield ctx


def in_blocks() -> bool:
    ctx = current()
    return ctx is not None and ctx.blocks


@contextlib.contextmanager
def rows_in_place(batch: int):
    """Within, a block program whose `batch` rows do not split over data
    (each rank of data holds the same rows) keeps its weights in place:
    `matmul_block` contracts each weight's data block where it lies,
    as GSPMD partitions such a step (a decode of one row), instead of
    gathering it (FSDP)."""
    ctx = current()
    on = (mesh_axis_size("data") > 1
          and "data" not in batch_axes_prefix(batch))
    with use_context(dataclasses.replace(ctx, in_place=on)):
        yield


@contextlib.contextmanager
def batch_rows(batch: int):
    """Within, a block program's rows are its share of a batch of `batch`
    global rows, split over the batch axes that `rows` splits it over
    (`batch_axes_prefix`; whole on the ranks of the others, which then
    hold the same rows): what `row_axes` reads."""
    with use_context(dataclasses.replace(
            current(), row_axes=batch_axes_prefix(batch))):
        yield


def row_axes() -> tuple:
    """The mesh axes that split a block program's rows: those of
    `batch_rows` where a caller named the global batch, else every axis
    of the batch's rule (`batch_axes`)."""
    ctx = current()
    if ctx is not None and ctx.row_axes is not None:
        return ctx.row_axes
    return batch_axes()


def matmul_block(x, w, axes, shape, *, contract: int = 1):
    """x's last dims (the first `contract` dims of w, flattened) times a
    layer's weight block `w` (global `shape`, logical `axes`), the output
    unflattened to w's other dims. In a block program the block is
    gathered over data first (FSDP), its `model` dims kept; where the
    rows are whole over data (`rows_in_place`) a dim split over data
    stays in place instead: a contracted one against x's matching
    columns, the partial products psummed over data; an output one
    giving the rank's columns, all-gathered over data. Outside a block
    program, the product."""
    def mm(x_, w_):
        k = math.prod(w_.shape[:contract])
        y = x_.flatten(-contract) if contract > 1 else x_
        return (y @ w_.reshape(k, -1)).unflatten(-1, w_.shape[contract:])
    if not in_blocks():
        return mm(x, w)
    spec = resolve_spec(axes, shape, "param")
    data = [d for d, e in enumerate(spec) if e == "data"]
    if not current().in_place or not data:
        return mm(x, gather_param(w, axes, shape=shape))
    d = data[0]
    if d >= contract:
        return all_gather(mm(x, w), "data", x.ndim - 2 * contract + d)
    if contract != 1:
        raise NotImplementedError(f"in place over a contracted dim of {axes}")
    n = w.shape[0]
    c0 = axis_index("data") * n
    return psum(mm(x[..., c0:c0 + n], w), "data")


def batch_axes() -> tuple:
    """The mesh axes of the batch's activation rule on the mesh, in the
    rule's order: a block program's loss sums over them (a batch that
    does not split over some holds the same rows on their ranks, which
    its mean counts alike)."""
    ctx = current()
    want = ctx.act_rules.get("batch") if ctx is not None else None
    sizes = axis_sizes(ctx.mesh) if ctx is not None else {}
    return tuple(a for a in _axes(want) if a in sizes) if want else ()


def rows(x, microbatches: int = 1):
    """This rank's rows (dim 0) of a whole batch tensor, or of every leaf
    of a dict of them, split as the batch's activation spec resolves on
    its size (`batch_axes_prefix`; JAX's order, the first axis major).
    With `microbatches` m, the batch is the reference's m microbatches
    (microbatch i the rows [i B/m, (i + 1) B/m)), each split as the spec
    resolves on B/m rows, and the rank's rows of each are concatenated
    in order: a microbatch too small to split over every batch axis
    stays whole on the ranks that cannot split it, as GSPMD lays it
    out."""
    if isinstance(x, dict):
        return {k: rows(v, microbatches) for k, v in x.items()}
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         "microbatches")
    n = B // microbatches
    ax = batch_axes_prefix(n)
    if not ax:
        return x
    if microbatches == 1:
        return _block(x, P(ax))
    return torch.cat([_block(c, P(ax)) for c in x.split(n)])


def every_row(x, batch: int):
    """A block program's rows of `x` (dim 0: its share of a global
    batch of `batch` rows) all-gathered over the batch axes that split
    it: every row, what a decode writes into its caches (the param
    rules' block: every row)."""
    ax = batch_axes_prefix(batch)
    return all_gather(x, ax, 0) if ax else x


def own_rows(x, rows: int):
    """This rank's `rows` rows of `x`, a tensor of every row of the
    batch (dim 0; a decode's caches under the param rules)."""
    ax = batch_axes_prefix(x.shape[0])
    return x.narrow(0, axis_index(ax) * rows, rows) if ax else x


def relayout(x, src, dst):
    """`x`, this rank's block under `src`, as its block under `dst` (two
    specs of one tensor, single-axis entries): per mesh axis that moves,
    an all-to-all (sharded on another dim), an all-gather (sharded no
    more) or a cut (newly sharded; a tensor of its own, so that the
    whole it was cut from is freed: a view would keep it). Differentiable:
    each step's gradient is its transpose."""
    def dims(spec):
        out = {}
        for d, ent in enumerate(spec):
            if ent is not None:
                if not isinstance(ent, str):
                    raise NotImplementedError(f"relayout of {spec}")
                out[ent] = d
        return out
    have, want = dims(src), dims(dst)
    for a in axis_sizes(current().mesh):
        i, j = have.get(a), want.get(a)
        if i == j:
            continue
        if i is not None and j is not None:
            x = all_to_all(x, a, j, i)
        elif i is not None:
            x = all_gather(x, a, i)
        else:
            n = x.shape[j] // axis_size(a)
            x = x.narrow(j, axis_index(a) * n, n).clone(
                memory_format=torch.contiguous_format)
    return x


def reduce_replicas(grads, pspecs):
    """Each leaf's gradient block summed over the axes its param spec
    does not name (no graph): a block program's gradient of a block on
    one rank holds that rank's share of it (the batch rows it saw, the
    model rank's part of a replicated computation); the sum is the
    block's gradient, the same on every replica."""
    def red(g, spec):
        ax = unnamed_axes(spec)
        return _all_reduce(g, ax, "SUM") if ax else g
    with torch.no_grad():
        return tree.map(red, grads, pspecs)


def leaf_specs(tree_, pspecs) -> list:
    """`pspecs`' PartitionSpecs (a tree like `tree_`'s) in the order of
    `tree.leaves(tree_)`."""
    out = []
    tree.map(lambda _, s: out.append(s), tree_, pspecs)
    return out


def param_pspecs(specs):
    """A spec tree's resolved param PartitionSpecs (the active mesh's)."""
    return mod.tree_map_specs(
        lambda s: resolve_spec(s.axes, s.shape, "param"), specs)


# --------------------------------------------------------------------------
# A tree of parameters (or moments) by their param specs
# --------------------------------------------------------------------------
def shard_tree(whole, specs, *, copy: bool = True):
    """This rank's block of every leaf of `whole` under its param spec
    in `specs` (a tree of module Specs), no collective: contiguous
    copies (a donated update of the blocks leaves `whole` as it is), or
    with `copy=False` views of `whole` (one process holding every
    rank's blocks beside the whole tree: `parallel.turns`)."""
    def cut(s, a):
        b = _block(a, resolve_spec(s.axes, s.shape, "param"))
        return b.clone(memory_format=torch.contiguous_format) if copy else b
    return tree.map(cut, specs, whole, is_leaf=mod.is_spec)


def unshard_tree(blocks, specs):
    """Every leaf of `blocks` gathered whole (all-gathers, no graph): the
    inverse of `shard_tree`. A leaf no spec entry cuts comes back as
    itself."""
    with torch.no_grad():
        return tree.map(lambda s, a: unblock(a, resolve_spec(
            s.axes, s.shape, "param")), specs, blocks, is_leaf=mod.is_spec)


# --------------------------------------------------------------------------
# Resolution
# --------------------------------------------------------------------------
def _resolve_dim(logical, dim_size: int, rules: dict, mesh):
    """logical axis name -> mesh axis entry for a PartitionSpec, or None."""
    want = rules.get(logical, None)
    if want is None:
        return None
    if isinstance(want, str):
        want = (want,)
    sizes = axis_sizes(mesh)
    # keep the maximal prefix of available axes whose product divides dim
    kept = []
    prod = 1
    for ax in want:
        if ax not in sizes:
            continue
        n = sizes[ax]
        if dim_size % (prod * n) != 0:
            break
        kept.append(ax)
        prod *= n
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def resolve_spec(axes, shape, table: str = "param") -> PartitionSpec:
    ctx = current()
    if ctx is None:
        return P()
    rules = ctx.param_rules if table == "param" else ctx.act_rules
    used: set[str] = set()
    entries = []
    for logical, dim in zip(axes, shape):
        ent = _resolve_dim(logical, dim, rules, ctx.mesh)
        # a mesh axis may appear at most once in a PartitionSpec
        if ent is not None:
            flat = (ent,) if isinstance(ent, str) else ent
            if any(a in used for a in flat):
                ent = None
            else:
                used.update(flat)
        entries.append(ent)
    return P(*entries)


def placements(spec, mesh) -> list:
    """The DTensor placements a spec means on `mesh`: per mesh dimension,
    `Shard(d)` for the tensor dim d whose entry names it, else
    `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, ent in enumerate(spec):
        for ax in ((ent,) if isinstance(ent, str) else ent or ()):
            dim_of[ax] = d
    return [Shard(dim_of[ax]) if ax in dim_of else Replicate()
            for ax in axis_sizes(mesh)]


def constrain(x, *axes):
    """The reference's with_sharding_constraint by logical activation
    axes: the spec is resolved, and `x` comes back as it is (the port
    keeps activations replicated; no-op without a mesh)."""
    if current() is not None:
        resolve_spec(axes, x.shape, table="act")
    return x


def act_sharding(axes, shape) -> Optional[list]:
    """The placements of an activation of `shape` by logical `axes`, or
    None without a mesh."""
    ctx = current()
    if ctx is None:
        return None
    return placements(resolve_spec(axes, shape, table="act"), ctx.mesh)


def param_shardings(specs):
    """Spec tree -> placements tree (None tree if no active mesh)."""
    ctx = current()
    if ctx is None:
        return tree.map(lambda s: None, specs, is_leaf=mod.is_spec)
    return mod.tree_map_specs(
        lambda s: placements(resolve_spec(s.axes, s.shape, "param"),
                             ctx.mesh), specs)


def block_shape(shape, spec) -> tuple:
    """This rank's block of a global `shape` under `spec`: each dim
    divided by the ranks of the axes its entry names (the active
    mesh's)."""
    return tuple(n // (axis_size(e) if e is not None else 1)
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def fake_mode():
    """The active `FakeTensorMode`, else a new one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) or FakeTensorMode()


def abstract_with_shardings(specs, default_dtype: str, *, whole=False,
                            device=None):
    """(tree of fake tensors, tree of PartitionSpecs) for a spec tree:
    the reference's ShapeDtypeStruct stand-ins with their shardings,
    allocating nothing. Each tensor is this rank's block under its
    resolved param spec (`block_shape`; the whole leaf without a mesh),
    or with `whole` the global leaf, on `device` (None: the package
    default, unchecked: a fake tensor needs no card). They belong to the
    active `FakeTensorMode`, or to a new one."""
    from repro_torch import device as tdevice
    dev = torch.device(device if device is not None
                       else tdevice.get_default())
    pspecs = param_pspecs(specs)

    def leaf(s, spec):
        shape = s.shape if whole else block_shape(s.shape, spec)
        return torch.empty(shape, device=dev, dtype=mod.torch_dtype(
            s.dtype or default_dtype))
    with fake_mode():
        out = tree.map(leaf, specs, pspecs, is_leaf=mod.is_spec)
    return out, pspecs


def batch_axes_prefix(dim_size: int) -> tuple[str, ...]:
    """Mesh axes the batch actually shards over."""
    ctx = current()
    if ctx is None:
        return ()
    ent = _resolve_dim("batch", dim_size, ctx.act_rules, ctx.mesh)
    if ent is None:
        return ()
    return (ent,) if isinstance(ent, str) else tuple(ent)
