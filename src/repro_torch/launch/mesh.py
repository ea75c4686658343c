"""Meshes: the production meshes, any named mesh, and the verbs fabric's
device grid. Functions, never module-level constants, so importing this
module touches no device or process-group state.

`make_mesh(shape, axes)` and `make_production_mesh(*, multi_pod)` are
the counterparts of the reference's `repro.launch.mesh.make_mesh` and
`make_production_mesh` over `torch.distributed.device_mesh.
init_device_mesh` with `mesh_dim_names`: a `DeviceMesh` of prod(shape)
ranks, one a process. Nothing tells a program of its cluster, so the
caller initialises the default process group first (its address, world
size and rank; the gloo backend on the CPU, NCCL on cards) and the
mesh's device type is the package default's (`repro_torch.device`).
`abstract_mesh(shape, axes)` is the same axes and sizes with no ranks
behind them (the reference's `jax.sharding.AbstractMesh`): what the
sharding rules resolve against where no collective runs.

`fake_production_mesh(*, multi_pod)` is the dry-run's mesh: the
default process group on torch's `fake` backend (`FakeStore`, a world
of 256 or 512 ranks in this one process, collectives that move nothing)
and the production `DeviceMesh` over it; the reference's counterpart is
its 512 fake XLA host devices (`XLA_FLAGS` at the top of
`repro/launch/dryrun.py`), which the port sets up only when called.

`make_fabric_mesh(pods, devices_per_pod)` is the counterpart of
`make_fabric_mesh` over ``jax.devices()``: a ``(pods,
devices_per_pod)`` grid of CUDA `torch.device`s when the machine has
exactly that many cards, else ``None`` — the logical-routing rig (one
card, or the CPU), where fabric addressing is identical and only the
device hop differs.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass

import torch

from repro_torch import device as tdevice


@dataclass(frozen=True)
class AbstractMesh:
    """Mesh axes and sizes without ranks: `axis_names` and `shape`
    (name -> size), as a `jax.sharding.AbstractMesh` reads."""
    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.sizes))


def abstract_mesh(shape: tuple, axes: tuple) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    return AbstractMesh(tuple(int(n) for n in shape), tuple(axes))


def make_mesh(shape: tuple, axes: tuple, *, device_type: str | None = None):
    """A `DeviceMesh` of `shape` named `axes` over the default process
    group, which must hold prod(shape) ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"a mesh of {tuple(shape)} needs the default process group "
            f"initialised with {n} ranks (init_process_group with an "
            "address, world size and rank)")
    return init_device_mesh(device_type or tdevice.device_type(),
                            tuple(shape), mesh_dim_names=tuple(axes))


def production_shape(*, multi_pod: bool = False) -> tuple:
    """(shape, axes) of the production mesh: (16, 16) over (data,
    model), or (2, 16, 16) over (pod, data, model)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    return make_mesh(*production_shape(multi_pod=multi_pod),
                     device_type=device_type)


def fake_production_mesh(*, multi_pod: bool = False):
    """The production `DeviceMesh` seen from rank 0 of a `fake` world:
    the default process group is (re)initialised on the `fake` backend
    with the mesh's 256 or 512 ranks unless it already is one of that
    size. Nothing is sent: a collective returns at once, so a program
    traced on fake tensors over it issues every collective it would on
    the cluster."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = production_shape(multi_pod=multi_pod)
    n = math.prod(shape)
    if dist.is_initialized():
        if (dist.get_backend() == "fake" and dist.get_world_size() == n
                and dist.get_rank() == 0):
            return make_mesh(shape, axes)
        if dist.get_backend() != "fake":
            raise RuntimeError("a process group that is not torch's fake "
                               "backend is initialised")
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    return make_mesh(shape, axes)


def make_fabric_mesh(pods: int, devices_per_pod: int = 1):
    """A ``(pods, devices_per_pod)`` nested list of CUDA devices when
    ``torch.cuda.device_count()`` equals their product, else None."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if pods * devices_per_pod != n:
        return None
    return [[torch.device("cuda", p * devices_per_pod + d)
             for d in range(devices_per_pod)] for p in range(pods)]
