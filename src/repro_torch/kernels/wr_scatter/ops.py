"""Fused-launch ops for the T4 flush: ONE kernel launch per run.

A coalesced flush lands its WRITE run through `scatter_records` and its
READ run through `gather_records`. On a CUDA tensor each is one launch
of a hand-written kernel (`csrc/wr_rows.cu`, one row-copy kernel with
a scatter and a gather entry point); on a CPU tensor it is the plain
version in `ref.py`; any other device raises. Every call is counted in
the `fused/launches` registry counter, exactly where the reference
counts it (the launches-per-flush contract); `_build.LAUNCHES` counts
only the kernels really launched on the card (an empty run launches
nothing).

Differences from the reference, on purpose:

  * In place — the region tensor is written where it lies and returned
    (the reference donates the buffer and its callers rebind the
    result; they still do, to the same tensor). Anything holding the
    region tensor sees the write, which is why nothing may cache
    `pd.mr_array()` across a flush.
  * No power-of-two padding — the reference pads run lengths only to
    keep its jit cache warm; here exactly m rows move, and
    `gather_records` returns exactly n rows.
  * int64 offsets and 64-bit addressing — the reference's int32
    offsets and gather index overflow past 2^31 elements. Out-of-range
    offsets raise IndexError here, before any launch (the reference
    drops or fills them); the layers above never send one
    (`QPContext.submit_dma` refuses it, the transport completes such a
    WR with an error status).

Only the batch-wise flush (`coalesce_writes=True`) calls these: the
element-at-a-time oracle never touches the kernels.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.convert import to_host, to_tensor
from repro_torch.kernels import _build
from repro_torch.kernels.wr_scatter import ref
from repro_torch.obs import metrics

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIG = {"scatter_rows": [_P, _P, _P, _I64, _I64, _P],
        "gather_rows": [_P, _P, _P, _I64, _I64, _P]}


def _count():
    metrics.get_registry().scope("fused").counter("launches").inc()


def records_in(offs: np.ndarray, n: int) -> bool:
    """Whether every record offset in `offs` lies in [0, n)."""
    if offs.size == 1:                  # the per-WR case, without reductions
        return 0 <= offs.item() < n
    return offs.size == 0 or bool(offs.min() >= 0 and offs.max() < n)


def _offsets(offs, hi: int) -> np.ndarray:
    """Record offsets as a 1-D int64 host array, each in [0, hi)."""
    o = np.asarray(to_host(offs), np.int64).ravel()
    if not records_in(o, hi):
        raise IndexError(f"record offsets must lie in [0, {hi}); got "
                         f"[{o.min()}, {o.max()}]")
    return o


def _check_region(region):
    if not isinstance(region, torch.Tensor):
        raise TypeError(f"region must be a torch.Tensor, not {type(region)}")
    if region.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for {region.device}")
    if not region.is_contiguous():
        raise ValueError("region must be contiguous")


def scatter_records(region, offs, vals):
    """ONE fused scatter, in place: region[offs[i]] <- vals[i] rows.
    offs is 1-D with vals row-aligned (`dedupe_last_wins` upstream);
    vals is cast to the region's dtype after the reference's demotion —
    for host vals this is the flush's one host->device copy."""
    _check_region(region)
    rec = tuple(region.shape[1:])
    offs = _offsets(offs, region.shape[0])
    m = offs.size
    row = math.prod(rec)
    vals = to_tensor(vals, region.device, region.dtype)
    if vals.numel() != m * row:
        raise ValueError(f"vals {tuple(vals.shape)} do not hold {m} records "
                         f"of shape {rec}")
    vals = vals.reshape((m,) + rec).contiguous()
    offs_t = torch.from_numpy(offs).to(region.device)
    _count()
    if region.device.type == "cpu":
        return ref.scatter(region, offs_t, vals)
    if m == 0 or row == 0:
        return region
    lib = _build.load("wr_rows", _SIG)
    rc = lib.scatter_rows(region.data_ptr(), vals.data_ptr(),
                          offs_t.data_ptr(), m,
                          row * region.element_size(),
                          _build.stream_ptr(region.device))
    _build.check(lib, rc, "scatter_rows")
    _build.count("scatter_rows")
    return region


def scatter_one(region, offsets, buf):
    """One DmaOp's scatter. Well-formed record writes (1-D offsets,
    row-aligned buf) ride `scatter_records`; the general broadcasting
    form keeps `at[].set` semantics verbatim (offsets shape included)
    as one plain `index_put_` — the reference does not run it through
    its Pallas kernel either."""
    _check_region(region)
    offsets = np.asarray(to_host(offsets), np.int64)
    if offsets.ndim == 1 and getattr(buf, "ndim", 0) >= 1 \
            and buf.shape[0] == offsets.size:
        return scatter_records(region, offsets, buf)
    _count()
    region[torch.from_numpy(offsets).to(region.device)] = \
        to_tensor(buf, region.device, region.dtype)
    return region


def gather_records(region, offs, length: int) -> torch.Tensor:
    """ONE fused gather of `length`-element records at record offsets
    `offs` of the flattened region: returns an (n, length) block."""
    _check_region(region)
    length = int(length)
    offs = _offsets(offs, region.numel() // length if length else 0)
    n = offs.size
    offs_t = torch.from_numpy(offs).to(region.device)
    _count()
    if region.device.type == "cpu":
        return ref.gather(region, offs_t, length)
    out = torch.empty((n, length), dtype=region.dtype, device=region.device)
    if n == 0 or length == 0:
        return out
    lib = _build.load("wr_rows", _SIG)
    rc = lib.gather_rows(out.data_ptr(), region.data_ptr(), offs_t.data_ptr(),
                         n, length * region.element_size(),
                         _build.stream_ptr(region.device))
    _build.check(lib, rc, "gather_rows")
    _build.count("gather_rows")
    return out
