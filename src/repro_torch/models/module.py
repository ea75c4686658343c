"""Minimal functional module system: spec trees.

Each layer contributes a *spec tree* (nested dicts with `Spec` leaves)
describing shape, logical axes and initializer, as in the reference's
`repro.models.module`; parameters and caches are nested dicts of tensors
built from it. Trees flatten in `jax.tree` order (`repro_torch.tree`:
dict keys sorted), so a leaf list of the port and one of the reference
compare 1:1.

Initializers: ``zeros``, ``ones``, ``normal`` (std = the spec's
scale, else 1/sqrt(shape[-2]), drawn in float32 and cast), ``rglru_a``
(Griffin's Λ, the logit of a uniform draw in [0.9^(1/8),
0.999^(1/8)]) and ``a_log`` (mamba2's A_log, log U[1, 16]), the random
ones from an explicit `torch.Generator` that the caller passes: leaves
draw in tree order from that one generator, so a seed fixes the whole tree. The same seed
does not give the reference's numbers, and nothing tries to: tests
carry parameters across as numpy (`convert.params_from_numpy`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones | rglru_a | a_log
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


def _fan_in(shape: tuple[int, ...]) -> int:
    if len(shape) == 1:
        return shape[0]
    # weight layout convention: (..., in, out) or (in, heads, head_dim);
    # the reference takes shape[-2] and callers set scale where it matters
    return shape[-2]


def _init_leaf(spec: Spec, default_dtype: str, device: torch.device,
               generator: torch.Generator | None):
    dt = torch_dtype(spec.dtype or default_dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "normal":
        if generator is None:
            raise ValueError("the normal initializer needs a torch.Generator")
        std = spec.scale if spec.scale is not None else \
            1.0 / math.sqrt(max(1, _fan_in(spec.shape)))
        v = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return v.mul_(std).to(dt)
    if spec.init == "rglru_a":
        # griffin Λ: a = sigmoid(Λ) with a^c roughly in [0.9, 0.999], c = 8
        if generator is None:
            raise ValueError("the rglru_a initializer needs a "
                             "torch.Generator")
        lo, hi = 0.9 ** (1 / 8), 0.999 ** (1 / 8)
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(hi - lo).add_(lo)
        return torch.log(u / (1.0 - u)).to(dt)
    if spec.init == "a_log":
        # mamba2 A_log: log(U[1, 16])
        if generator is None:
            raise ValueError("the a_log initializer needs a torch.Generator")
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(15.0).add_(1.0)
        return torch.log(u).to(dt)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(specs, default_dtype: str = "float32", *, device=None,
                generator: torch.Generator | None = None):
    """Tensors for a spec tree on `device` (None: the package default,
    the card). Random leaves draw from `generator`, which must live on
    that device."""
    dev = resolve(device)
    return tree_map_specs(
        lambda s: _init_leaf(s, default_dtype, dev, generator), specs)


def count_params(specs, predicate=None) -> int:
    total = 0
    for leaf in tree.leaves(specs, is_leaf=is_spec):
        if predicate is None or predicate(leaf):
            total += int(np.prod(leaf.shape))
    return total
