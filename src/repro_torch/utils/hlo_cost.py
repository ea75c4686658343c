"""Exact cost extraction from a traced step: FLOPs, collective wire bytes
and live memory, per rank.

The port of the reference's `repro.utils.hlo_cost`. The reference
parses compiled HLO text and propagates `known_trip_count` multipliers
through while bodies, because XLA's `cost_analysis()` counts a loop body
once. The port runs the step eagerly (on fake tensors in the dry-run,
`launch.dryrun`, or on the card), so every op and every collective is
dispatched as often as it runs: there is no while-body-once blind spot
and no trip count to recover. Under `Trace`:

  * FLOPs: `torch.utils.flop_counter.FlopCounterMode`, 2 * M * N * K a
    product, as the reference counts a dot (the flash kernel's custom
    op brings its own formula, `kernels/flash_attention/ops.py`);
  * collective wire bytes: `CollectiveRecorder`, a dispatch mode that
    sees every `c10d` and `_c10d_functional` op whoever issues it (the
    shard_map collectives of `parallel/sharding.py`, the int8 reduction
    of `parallel/compress.py`, `train_loop.check_replicated`'s
    all-reduces), with the ring factors of `hlo_analysis`;
  * live memory: `LiveBytes`, the bytes of every tensor storage alive,
    its peak and what the step's arguments hold (the counterpart of
    the compiled executable's `memory_analysis()`).

Values are per rank: the traced program is one rank's.
"""
from __future__ import annotations

import math
import os
import re
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.utils.hlo_analysis import (collective_stats, tensor_bytes,
                                            wire_bytes)

# c10d op -> (the reference's collective, the argument holding the result)
_C10D = {
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_coalesced_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    # a permute counts once, at its receive
    "recv_": ("collective-permute", 0),
    "recv_any_source_": ("collective-permute", 0),
}
# functional collectives: the result is what the op returns
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# ops that move no payload a collective term should count
_IGNORED = {"send", "barrier", "monitored_barrier_", "wait_tensor"}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = (os.path.join(_PKG, "parallel", "sharding.py"),
         os.path.join(_PKG, "utils"))


def _group_size(func, args) -> int:
    import torch.distributed as dist
    if func.namespace == "_c10d_functional":
        from torch.distributed.distributed_c10d import _resolve_process_group
        name = next(a for a in reversed(args) if isinstance(a, str))
        return _resolve_process_group(name).size()
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:        # a ReduceOp
                continue
    raise ValueError(f"{func}: no process group among its arguments")


def source() -> str:
    """The port function that issued the collective running now: the
    innermost frame of the package outside `parallel/sharding.py` (whose
    collectives serve every caller) and this module, as
    "<module>.<qualname>" with digits as N (the reference's op_name
    normalisation); else the innermost package frame; else "?"."""
    f, inner = sys._getframe(1), None
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG):
            name = (os.path.splitext(os.path.basename(path))[0] + "."
                    + f.f_code.co_qualname)
            if not path.startswith(_SKIP):
                return re.sub(r"\d+", "N", name)
            if inner is None and not path.startswith(_SKIP[1]):
                inner = name
        f = f.f_back
    return re.sub(r"\d+", "N", inner) if inner else "?"


class CollectiveRecorder(TorchDispatchMode):
    """Records (op, out_bytes, group size, source) for every collective
    dispatched while it is active; `stats()` is `collective_stats` of
    them."""

    def __init__(self):
        super().__init__()
        self.records: list[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns, name = func.namespace, func._opname
        if ns == "c10d" and name in _C10D:
            op, i = _C10D[name]
            nbytes = sum(tensor_bytes(t) for t in tree_leaves(args[i])
                         if isinstance(t, torch.Tensor))
        elif ns == "_c10d_functional" and name in _FUNCTIONAL:
            op = _FUNCTIONAL[name]
            nbytes = sum(tensor_bytes(t) for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor))
        elif ns in ("c10d", "_c10d_functional") and name not in _IGNORED:
            raise NotImplementedError(f"no wire model for {func}")
        else:
            return out
        self.records.append((op, nbytes, _group_size(func, args), source()))
        return out

    def stats(self) -> dict:
        return collective_stats(self.records)


class LiveBytes(TorchDispatchMode):
    """The bytes of every tensor storage alive: the arguments registered
    by `track`, and each storage an op creates while the mode is active,
    until it is freed. Two tallies: `current` / `peak` count each
    storage's bytes (what the reference's `memory_analysis` counts of
    its buffers), `alloc` / `alloc_peak` as the CUDA caching allocator
    rounds it (a multiple of 512 bytes), so on the card `alloc_peak`
    less what was allocated before reads against
    `torch.cuda.max_memory_allocated`."""

    ROUND = 512

    def __init__(self):
        super().__init__()
        self.current = self.peak = 0
        self.alloc = self.alloc_peak = 0
        self._live: dict[int, tuple[int, int]] = {}

    @classmethod
    def size(cls, nbytes: int) -> int:
        return cls.ROUND * math.ceil(nbytes / cls.ROUND)

    def _add(self, t) -> tuple[int, int]:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return 0, 0
        n = st.nbytes()
        self._live[key] = (n, self.size(n))
        self.current += n
        self.alloc += self.size(n)
        self.peak = max(self.peak, self.current)
        self.alloc_peak = max(self.alloc_peak, self.alloc)
        weakref.finalize(st, self._free, key)
        return self._live[key]

    def _free(self, key):
        n, a = self._live.pop(key, (0, 0))
        self.current -= n
        self.alloc -= a

    def track(self, tree) -> tuple[int, int]:
        """Register the tensors of `tree` (the arguments); returns the
        (bytes, allocator bytes) they add."""
        added = [self._add(t) for t in tree_leaves(tree)
                 if isinstance(t, torch.Tensor)]
        return sum(a for a, _ in added), sum(b for _, b in added)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


class FlashInBackward(TorchDispatchMode):
    """The FLOPs of the flash operator's calls made inside a backward
    pass (`flops`: the forwards a checkpointed layer recomputes), and
    whether any operator ran in one (`backward`)."""

    def __init__(self):
        super().__init__()
        self.flops, self.backward = 0, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if torch._C._current_graph_task_id() != -1:
            # the import registers the operator
            from repro_torch.kernels.flash_attention import ops
            self.backward = True
            if func is torch.ops.repro_torch.flash_attention.default:
                q, k, v = args[:3]
                self.flops += ops.flops(q.shape, k.shape, v.shape)
        return func(*args, **(kwargs or {}))


class Trace:
    """FLOPs, collectives and, with `memory`, live bytes of what runs
    inside the `with`; `result()` is the reference's `analyze` dict."""

    def __init__(self, memory: bool = False):
        from torch.utils.flop_counter import FlopCounterMode
        self.flops = FlopCounterMode(display=False)
        self.coll = CollectiveRecorder()
        self.mem = LiveBytes() if memory else None

    def __enter__(self):
        if self.mem is not None:
            self.mem.__enter__()
        self.coll.__enter__()
        self.flops.__enter__()
        return self

    def __exit__(self, *exc):
        self.flops.__exit__(*exc)
        self.coll.__exit__(*exc)
        if self.mem is not None:
            self.mem.__exit__(*exc)
        return False

    def result(self) -> dict:
        return {"flops": float(self.flops.get_total_flops()),
                "collective": self.coll.stats()}


def analyze(fn, *args, **kwargs) -> dict:
    """{'flops', 'collective': {'wire_bytes', 'per_op_bytes', 'counts'}}
    of one call of `fn(*args, **kwargs)`, per rank."""
    with Trace() as t:
        fn(*args, **kwargs)
    return t.result()


def attribute_collectives(records, top: int = 12) -> list[tuple]:
    """Wire bytes per (collective op, source) — the dry-run's 'profiler
    view': (bytes, op, source) rows, largest first. (The reference's
    sums each collective's result bytes; these are its wire bytes, as
    both docstrings say.)"""
    agg: dict[tuple[str, str], float] = defaultdict(float)
    for op, out, n, src in records:
        agg[(op, src)] += wire_bytes(op, out, n)
    rows = sorted(((b, op, src) for (op, src), b in agg.items()),
                  reverse=True)
    return rows[:top]
