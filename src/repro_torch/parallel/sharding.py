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

The reference reads `perf.FLAGS.ep_over_data` in `make_param_rules`;
the port has no `perf` module and takes it as an argument (of
`make_param_rules` and `use_mesh`). `constrain` resolves its spec and
returns its tensor as it is: the port's collectives keep the
reference's global view on replicated tensors (`parallel.collectives`),
so a layout constraint changes no value. `abstract_with_shardings`
exists for lowering and comes with the dry-run tooling.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

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


@dataclasses.dataclass
class MeshContext:
    mesh: object            # a DeviceMesh or an AbstractMesh
    param_rules: dict
    act_rules: dict


_CTX: contextvars.ContextVar[Optional[MeshContext]] = contextvars.ContextVar(
    "repro_torch_mesh_ctx", default=None)


@contextlib.contextmanager
def use_mesh(mesh, *, fsdp: bool = True, ep_over_data: bool = False,
             param_rules: dict | None = None, act_rules: dict | None = None):
    ctx = MeshContext(mesh, param_rules or make_param_rules(
        fsdp, ep_over_data=ep_over_data), act_rules or dict(ACT_RULES))
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def current() -> Optional[MeshContext]:
    return _CTX.get()


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
    ctx = current()
    mesh = None if ctx is None else ctx.mesh
    if mesh is None or getattr(mesh, "mesh_dim_names", None) is None:
        raise RuntimeError(f"axis {name!r}: no DeviceMesh in use (an "
                           "abstract mesh has no ranks to communicate)")
    return mesh


def axis_index(name: str) -> int:
    """This rank's coordinate on mesh axis `name` (lax.axis_index)."""
    return _device_mesh(name).get_local_rank(name)


def axis_group(name: str):
    """The process group of this rank's line along mesh axis `name`."""
    return _device_mesh(name).get_group(name)


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


def batch_axes_prefix(dim_size: int) -> tuple[str, ...]:
    """Mesh axes the batch actually shards over."""
    ctx = current()
    if ctx is None:
        return ()
    ent = _resolve_dim("batch", dim_size, ctx.act_rules, ctx.mesh)
    if ent is None:
        return ()
    return (ent,) if isinstance(ent, str) else tuple(ent)
