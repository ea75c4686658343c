"""Data crossing into the port: the reference's dtype demotion, and MR
state carried over from the reference.

The reference registers memory through `jnp.asarray` with 64-bit types
off, so float64 becomes float32 and int64 becomes int32 at `reg_mr`, at
`register_dma_region` and wherever a payload is turned into records.
`demote` applies exactly that rule, at exactly those points, so MR
contents compare bit for bit. A float64 payload headed for an integer
region goes float64 -> float32 -> region dtype, as in the reference
(a direct float64 -> int cast can round differently).

`regions_from_numpy` seeds a port `ProtectionDomain` with the MR
contents the reference holds (handed over as numpy): with
`ProtectionDomain._next_key` pinned to the same value in both packages,
the same registration order mints the same lkey/rkey, so WRs built for
one side replay on the other.

`tree_from_numpy` carries a tree of arrays (the reference's caches,
taken out with `np.asarray`) into the port as the same structure of
tensors. bf16 crosses as its uint16 bit pattern: numpy has no bf16 of
its own, and the card machine has no `ml_dtypes`. `params_from_numpy`
does the same for a model's parameters and, given the port's model,
holds the tree to its parameter specs, so both packages run one set of
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve
from repro_torch.models.module import is_spec, torch_dtype

_NP_DEMOTE = {np.dtype(np.float64): np.dtype(np.float32),
              np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.uint64): np.dtype(np.uint32),
              np.dtype(np.complex128): np.dtype(np.complex64)}
_TORCH_DEMOTE = {torch.float64: torch.float32, torch.int64: torch.int32,
                 torch.complex128: torch.complex64}


def demote(x):
    """`x` with the reference's 64->32-bit demotion applied: a tensor
    stays a tensor, anything else becomes a numpy array."""
    if isinstance(x, torch.Tensor):
        dt = _TORCH_DEMOTE.get(x.dtype)
        return x if dt is None else x.to(dt)
    a = np.asarray(x)
    dt = _NP_DEMOTE.get(a.dtype)
    return a if dt is None else a.astype(dt)


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """Demoted `x` as a tensor on `device`, then cast to `dtype` when
    given. A numpy bf16 array (`ml_dtypes.bfloat16`, what the reference
    holds) crosses as its bits. May alias `x` when no copy or cast is
    needed: callers that keep the result copy it themselves."""
    t = demote(x)
    if not isinstance(t, torch.Tensor):
        shape = t.shape                 # ascontiguousarray makes 0-d 1-d
        t = np.ascontiguousarray(t)
        if not t.flags.writeable:       # read-only views (broadcasts)
            t = t.copy()
        if t.dtype.name == "bfloat16":  # torch cannot read numpy bf16
            t = torch.from_numpy(t.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(t)
        t = t.reshape(shape)
    return t.to(device=device, dtype=dtype)


def to_host(x) -> np.ndarray:
    """`x` as a numpy array. For a tensor this is an explicit
    device->host copy — on the card a synchronising transfer, which is
    why the datapath calls it only where the reference converts to
    host memory itself."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def regions_from_numpy(pd, regions: dict, device=None) -> dict:
    """Register each numpy array of `regions` on the port's `pd`, in the
    dict's order, with the reference's demotion; returns {name: MR}.
    The regions live on the pd's device; `device`, when given, must be
    that device."""
    if device is not None and resolve(device) != pd.engine.device:
        raise ValueError(f"pd lives on {pd.engine.device}, not {device}")
    return {name: pd.reg_mr(name, arr) for name, arr in regions.items()}


def tree_from_numpy(arrays, device=None, *, bf16_bits: bool = False):
    """The nested dict/list/tuple `arrays` of numpy arrays as the same
    structure of tensors on `device` (None: the package default), with
    the reference's demotion. A bf16 leaf crosses as its bits: either an
    `ml_dtypes.bfloat16` array, or — with ``bf16_bits=True`` — a uint16
    array of bit patterns (``np.asarray(x).view(np.uint16)`` on the
    reference side); both arrive as `torch.bfloat16` with equal bits."""
    dev = resolve(device)

    def one(a):
        a = np.asarray(a)
        if bf16_bits:
            if a.dtype != np.uint16:
                raise TypeError(f"bf16_bits needs uint16 leaves, not "
                                f"{a.dtype}")
            a = np.ascontiguousarray(a)
            if not a.flags.writeable:
                a = a.copy()
            t = torch.from_numpy(a).view(torch.bfloat16)
        else:
            t = to_tensor(a, "cpu")
        # the tensor must not alias the caller's numpy memory
        return t.clone() if dev.type == "cpu" else t.to(dev)
    return tree.map(one, arrays)


def params_from_numpy(arrays, device=None, *, model=None,
                      bf16_bits: bool = False):
    """The reference's parameter tree (its leaves as numpy arrays, bf16
    as `ml_dtypes.bfloat16` or, with ``bf16_bits=True``, as uint16
    bits) as the port's tree of tensors on `device` (None: the package
    default). With `model`, the leaves must match its `param_specs` in
    order and shape, and a leaf whose spec names a dtype must have it
    (the norms' scales, the MoE router's weights and bias and the
    RG-LRU's Λ stay float32 in a bf16 model)."""
    params = tree_from_numpy(arrays, device, bf16_bits=bf16_bits)
    if model is None:
        return params
    specs = tree.leaves(model.param_specs(), is_leaf=is_spec)
    leaves = tree.leaves(params)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} parameter leaves for "
                         f"{len(specs)} specs")
    for i, (spec, leaf) in enumerate(zip(specs, leaves)):
        if tuple(leaf.shape) != tuple(spec.shape) or (
                spec.dtype and leaf.dtype != torch_dtype(spec.dtype)):
            raise ValueError(f"parameter leaf {i}: {tuple(leaf.shape)} "
                             f"{leaf.dtype} does not match its spec "
                             f"{spec.shape} {spec.dtype}")
    return params
