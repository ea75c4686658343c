"""Minimal functional module system: spec trees.

Each layer contributes a *spec tree* (nested dicts with `Spec` leaves)
describing shape, logical axes and initializer, as in the reference's
`repro.models.module`; parameters and caches are nested dicts of tensors
built from it. Trees flatten in `jax.tree` order (`repro_torch.tree`:
dict keys sorted), so a leaf list of the port and one of the reference
compare 1:1.

This slice carries the spec layer and the constant initializers
(``zeros`` / ``ones``, enough for decode caches). The random
initializers (``normal`` with an explicit `torch.Generator`, and the
ssm/rglru ones) come with the serving model (ROADMAP slice 4).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones
    scale: Optional[float] = None   # stddev; None => 1/sqrt(fan_in)
    dtype: Optional[str] = None     # None => model default dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def tree_map_specs(fn, specs):
    return tree.map(fn, specs, is_leaf=is_spec)


def stack_specs(specs, n: int):
    """Prepend a stacked 'layers' dimension to every leaf."""
    return tree_map_specs(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape,
                                      axes=("layers",) + s.axes),
        specs)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config names (``"bfloat16"``, ``"float32"``)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _init_leaf(spec: Spec, default_dtype: str, device: torch.device):
    dt = torch_dtype(spec.dtype or default_dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    raise NotImplementedError(
        f"init {spec.init!r} comes with the serving model (ROADMAP "
        "slice 4); this slice builds zeros/ones trees only")


def init_params(specs, default_dtype: str = "float32", *, device=None):
    """Tensors for a spec tree of constant initializers, on `device`
    (None: the package default, the card)."""
    dev = resolve(device)
    return tree_map_specs(lambda s: _init_leaf(s, default_dtype, dev), specs)
