"""Collective traffic of a traced program (the dry-run's 'profile').

The port of the reference's `repro.utils.hlo_analysis`. The reference
parses compiled HLO text; torch has none, so `collective_stats` works
over the records of a traced program instead: one (op, out_bytes,
group size) record per collective the program dispatched, which
`hlo_cost.CollectiveRecorder` takes from every `c10d` and
`_c10d_functional` op. `out_bytes` is the op's result, as the reference
reads the result shape of each HLO collective, and the per-device wire
bytes follow the same ring-algorithm factors:

    all-gather          out * (N-1)/N
    all-reduce          2 * out * (N-1)/N          (RS + AG)
    reduce-scatter      out * (N-1)                (operand = out * N)
    all-to-all          out * (N-1)/N
    collective-permute  out

N is the size of the op's process group.
"""
from __future__ import annotations

from collections import defaultdict

import torch

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int16: 2, torch.uint16: 2, torch.float16: 2, torch.bfloat16: 2,
    torch.int32: 4, torch.uint32: 4, torch.float32: 4,
    torch.int64: 8, torch.uint64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}

COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")


def tensor_bytes(t) -> int:
    return t.numel() * DTYPE_BYTES.get(t.dtype, 4)


def wire_bytes(op: str, out: float, n: int) -> float:
    """Per-device wire bytes of one collective whose result is `out`
    bytes over a group of `n` ranks."""
    if op == "all-gather":
        return out * (n - 1) / n
    if op == "all-reduce":
        return 2 * out * (n - 1) / n
    if op == "reduce-scatter":
        return out * (n - 1)
    if op == "all-to-all":
        return out * (n - 1) / n
    if op == "collective-permute":
        return out
    raise ValueError(f"no wire model for {op!r}")


def collective_stats(records) -> dict:
    """Returns {'wire_bytes': per-device bytes, 'per_op_bytes': {...},
    'counts': {...}} over (op, out_bytes, n, ...) records."""
    per_op_bytes: dict[str, float] = defaultdict(float)
    per_op_count: dict[str, int] = defaultdict(int)
    for op, out, n, *_ in records:
        if out == 0:
            continue
        per_op_bytes[op] += wire_bytes(op, out, n)
        per_op_count[op] += 1
    return {
        "wire_bytes": float(sum(per_op_bytes.values())),
        "per_op_bytes": dict(per_op_bytes),
        "counts": dict(per_op_count),
    }
