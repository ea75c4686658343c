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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve

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
    given. May alias `x` when no copy or cast is needed: callers that
    keep the result copy it themselves."""
    t = demote(x)
    if not isinstance(t, torch.Tensor):
        t = np.ascontiguousarray(t)
        if not t.flags.writeable:       # read-only views (broadcasts)
            t = t.copy()
        t = torch.from_numpy(t)
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
