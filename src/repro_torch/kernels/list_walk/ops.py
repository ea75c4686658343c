"""The server-side linked-list walk (paper §5.6): ONE launch per request.

`list_traverse` chases `next` pointers through a region of
``[key, next, value...]`` float32 records on the device, as the
reference's `install_list_traversal` does with one `jax.lax.while_loop`
(counted there as one DMA launch). An eager torch loop would cost a
host round trip per hop: the N round trips the opcode exists to
remove. On a CUDA tensor it is one launch of the hand-written kernel
`csrc/list_walk.cu` (entry `list_traverse`); on a CPU tensor it is the
plain version in `ref.py`; any other device raises. Index semantics are
the reference's (a key compared as float32, `next` truncated toward
zero, a negative pointer ends the walk and wraps to the record at
pointer + n, a miss stops after `max_hops`), with one difference on
purpose: a `head` or a `next` outside ``[-n, n)`` raises IndexError
(the reference clamps it into the region) — `head` before the launch,
a `next` when the kernel reports it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.list_walk import ref

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIG = {"list_traverse": [_P, _P, _P, _I64, _I64, _I64, ctypes.c_float,
                          _I64, _I64, _P]}


def list_traverse(records: torch.Tensor, key, head,
                  max_hops: int) -> tuple[torch.Tensor, int, int]:
    """Walk `records` ((n, 2 + V) float32, contiguous) from `head` to the
    record whose key equals `key` (compared as float32). Returns (the
    (V,) value words of the record the walk rests on, on the records'
    device; the hops taken; that record's index)."""
    if not isinstance(records, torch.Tensor):
        raise TypeError(f"records must be a torch.Tensor, not "
                        f"{type(records)}")
    if records.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for {records.device}")
    if records.dtype != torch.float32 or records.ndim != 2 \
            or records.shape[1] < 2 or not records.is_contiguous():
        raise ValueError("records must be a contiguous (n, 2 + V) float32 "
                         "tensor")
    n, rec = records.shape
    key = float(np.float32(key))
    head, max_hops = int(head), int(max_hops)
    if not -n <= head < n:
        raise IndexError(f"head {head} outside [-{n}, {n})")
    if records.device.type == "cpu":
        return ref.walk(records, key, head, max_hops)
    out = torch.empty((rec - 2,), dtype=torch.float32, device=records.device)
    meta = torch.empty((3,), dtype=torch.int64, device=records.device)
    lib = _build.load("list_walk", _SIG)
    rc = lib.list_traverse(out.data_ptr(), meta.data_ptr(),
                           records.data_ptr(), n, rec, rec - 2, key, head,
                           max_hops, _build.stream_ptr(records.device))
    _build.check(lib, rc, "list_traverse")
    _build.count("list_traverse")
    ptr, hops, status = meta.tolist()
    if status:
        raise IndexError(f"record {ptr}: next outside [-{n}, {n})")
    return out, hops, ptr
