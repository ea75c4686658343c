"""The device CQ ring's designs that the package does not keep, for
timing against the one it does, on a card.

    python3 tools/desc_ring/probe.py       # from the repo root, on a card

* `V1`: the port's first ring (`ring_v1.cu`, one block of 1024 threads)
  behind its first host boundary: a pageable copy of the batch to the
  card, an allocation of limit + 1 rows, a pageable read-back of all of
  them, `_build.load` on every call. It has the package ops' signatures,
  so a `core.notification.Ring` runs on it after `use_v1(ring)`.
  `chip_smoke.py` times it beside the package's design in phase 2
  (`ring_rounds`) and in phase 7's host-vs-device crossover.
* `Variant`: the package's kernel behind the two host boundaries that
  were measured against the package's and not kept: the rows and k
  words written to card memory and brought back by one
  `cudaMemcpyAsync` into pinned memory (the package's kernel writes
  them through a mapped pointer); a batch past the parameters read by
  the kernel through the staging buffer's mapped pointer (the package
  copies it to card memory first).

`main` prints the card's `nvidia-smi` line, runs phase 2's ring part
(`chip_smoke.phase_ring_kernels`: three mixed laps and the plan's edge
cases against the plain version, then both designs timed at the
main-path shapes: kernel, wrapper, plain, host ring, empty launch), then
times the package's wrapper against `Variant` at the same shapes, in
interleaved rounds (`chip_smoke.Timer.rounds`, host clock), and prints
one JSON object of the numbers.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
SOURCE = Path(__file__).resolve().parent / "ring_v1.cu"

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
V1_SIG = {
    "ring_produce": [_P, _P, _I64, _INT, _P, _I64, _I64, _P],
    "ring_consume": [_P, _P, _I64, _INT, _I64, _I64, _P, _P],
    "ring_produce_consume": [_P, _P, _I64, _INT, _P, _I64, _I64, _I64, _I64,
                             _P, _P],
}


def v1_lib():
    from repro_torch.kernels import _build
    return _build.load(SOURCE, V1_SIG)


class V1:
    """The first wrapper around `ring_v1.cu`, as it was: one launch a
    call, the batch and the rows pageable. Counts nothing (its launches
    are comparisons, not the package's)."""

    @staticmethod
    def _launch(fn, *args):
        from repro_torch.kernels import _build
        lib = v1_lib()
        _build.check(lib, getattr(lib, fn)(*args), fn)

    @staticmethod
    def _batch(slots, batch):
        import numpy as np
        import torch
        b = np.ascontiguousarray(batch, np.int64)
        return torch.from_numpy(b).to(slots.device)

    @staticmethod
    def _rows(out):
        host = out.cpu().numpy()
        return host[1:1 + int(host[0, 0])]

    @classmethod
    def produce(cls, slots, flags, head, batch, via=None):
        from repro_torch.kernels import _build
        cap, width = slots.shape
        b = cls._batch(slots, batch)
        cls._launch("ring_produce", slots.data_ptr(), flags.data_ptr(), cap,
                    width, b.data_ptr(), b.shape[0], head % (2 * cap),
                    _build.stream_ptr(slots.device))

    @classmethod
    def consume(cls, slots, flags, tail, limit, via=None):
        import torch
        from repro_torch.kernels import _build
        cap, width = slots.shape
        limit = min(max(0, limit), cap)
        out = torch.empty((limit + 1, width), dtype=torch.int64,
                          device=slots.device)
        cls._launch("ring_consume", slots.data_ptr(), flags.data_ptr(), cap,
                    width, tail % (2 * cap), limit, out.data_ptr(),
                    _build.stream_ptr(slots.device))
        return cls._rows(out)

    @classmethod
    def produce_consume(cls, slots, flags, head, tail, batch, limit,
                        via=None):
        import torch
        from repro_torch.kernels import _build
        cap, width = slots.shape
        b = cls._batch(slots, batch)
        limit = min(max(0, limit), cap)
        out = torch.empty((limit + 1, width), dtype=torch.int64,
                          device=slots.device)
        cls._launch("ring_produce_consume", slots.data_ptr(),
                    flags.data_ptr(), cap, width, b.data_ptr(), b.shape[0],
                    head % (2 * cap), tail % (2 * cap), limit,
                    out.data_ptr(), _build.stream_ptr(slots.device))
        return cls._rows(out)


def use_v1(ring):
    """Run a device `Ring` on the one-block design from here on."""
    ring._ring_ops, ring._via = V1, None
    return ring


class Variant:
    """The package's kernel (`ops.plan`, the same entries) behind the host
    boundaries measured against the package's and not kept: the rows and
    k words written to card memory and brought back by one
    `cudaMemcpyAsync` into the pinned buffer (`readback="copy"`; the
    package's kernel writes them through its mapped pointer), and a
    batch past the parameters copied from the pinned staging buffer to
    card memory by one `cudaMemcpyAsync` before the launch
    (`staging="copy"`; the package's kernel reads it through the mapped
    pointer)."""

    def __init__(self, cap, device, readback="mapped", staging="mapped"):
        import numpy as np
        import torch
        from repro_torch.kernels.desc_ring import ops
        sys.path.insert(0, str(ROOT))
        import chip_smoke
        self.dma = chip_smoke.tool("latency").lib().dma_copy
        self.bd = ops.Boundary(cap, device)
        self.readback, self.staging = readback, staging
        words = ops.MAX_CTAS + cap * 8
        self.rb_card = torch.empty(words, dtype=torch.int64, device=device)
        self.st_card = torch.empty((cap, 8), dtype=torch.int64,
                                   device=device)
        self.bd._stage_batch(np.zeros((1, 8), np.int64))   # the buffers

    def step(self, entry, slots, flags, head, tail, b, limit):
        from repro_torch.kernels import _build
        from repro_torch.kernels.desc_ring import ops
        bd, cap = self.bd, self.bd.cap
        n = 0 if b is None else b.shape[0]
        produce, consume = entry != "ring_consume", entry != "ring_produce"
        pl = ops.plan(cap, head, tail, n, limit, produce=produce,
                      consume=consume)
        stream = bd.stream()
        batch = None
        if n and pl.tier:
            batch = b.ctypes.data
        elif n:
            batch = bd._stage_batch(b)
            if self.staging == "copy":
                _build.check(bd.lib, self.dma(
                    self.st_card.data_ptr(), bd._stage[0].ctypes.data,
                    b.nbytes, stream), "dma_copy")
                batch = self.st_card.data_ptr()
        kw_ptr = self.rb_card.data_ptr() if self.readback == "copy" \
            else bd._rb_dev
        rows_ptr = kw_ptr + 8 * ops.MAX_CTAS
        sched = pl[2:7]
        common = (slots.data_ptr(), flags.data_ptr(), cap, 8)
        if entry == "ring_produce":
            args = (*common, batch, n, head, *sched, pl.tier)
        elif entry == "ring_consume":
            args = (*common, tail, limit, rows_ptr, kw_ptr, *sched)
        else:
            args = (*common, batch, n, head, tail, limit, rows_ptr, kw_ptr,
                    *sched, pl.tier)
        _build.check(bd.lib, bd.fns[entry](*args, stream), entry)
        if n and not pl.tier:
            _build.check(bd.lib, bd.lib.ring_event_record(
                bd._stage[2], stream), "ring_event_record")
            bd._staged = True
        if not consume:
            return None
        if self.readback == "copy":
            _build.check(bd.lib, self.dma(
                bd.readback.ctypes.data, kw_ptr,
                8 * (ops.MAX_CTAS + limit * 8), stream), "dma_copy")
        _build.check(bd.lib, bd._sync(stream), "ring_sync")
        k = int(bd.kwords[:pl.grid].min())
        return bd.rows[:k].copy()


def breakdown(torch, np, dev, cap: int) -> dict:
    """What one package wrapper call spends: warm host microseconds of
    each of its pieces (timeit, 2000 calls each, no eviction), and, on
    the card's clock (`Timer.rounds`, cold), the ways to move a
    `cap`-row batch to the card."""
    import timeit
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.desc_ring import ops
    elib = cs.tool("latency").lib()
    slots, flags = ops.alloc(cap, 8, dev)
    bd = ops.Boundary(cap, dev, slots, flags)
    one = np.ones((1, 8), np.int64)
    eight = np.ones((8, 8), np.int64)
    full = np.ones((cap, 8), np.int64)
    bd._stage_batch(full[:1])
    view, mapped, ev = bd._stage
    sp = bd.stream()
    parts = {
        "check": lambda: ops._check(slots, flags),
        "batch": lambda: ops._batch(slots, one),
        "count": ops._count,
        "plan": lambda: ops.plan(cap, 5, 3, 1, 0, produce=True,
                                 consume=False),
        "shape_class": lambda: ops.shape_class(8, 8),
        "raw stream": bd.stream,
        "torch current_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "empty launch (ctypes)": lambda: elib.empty_launch(sp),
        "launch produce n1 (no wait)": lambda: bd.launch(
            "ring_produce", slots, flags, 0, 0, one, 0, sp),
        "sync after nothing": lambda: bd._sync(sp),
        "produce n1 wrapper": lambda: ops.produce(slots, flags, 0, one,
                                                  via=bd),
        "consume limit1 wrapper": lambda: ops.consume(slots, flags, 0, 1,
                                                      via=bd),
        "produce_consume n8 limit8 wrapper": lambda: ops.produce_consume(
            slots, flags, 0, 0, eight, 8, via=bd),
        "numpy copy of the rows into pinned staging":
            lambda: view.__setitem__(slice(0, cap), full),
        "event record": lambda: bd.lib.ring_event_record(ev, sp),
        f"launch produce n{cap} (no wait)": lambda: bd.launch(
            "ring_produce", slots, flags, 0, 0, full, 0, sp),
        f"produce n{cap} wrapper": lambda: ops.produce(slots, flags, 0, full,
                                                       via=bd),
        "pageable .to(card) of the rows": lambda: torch.from_numpy(
            full).to(dev),
    }
    out = {}
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        out[name] = timeit.timeit(fn, number=2000) / 2000 * 1e6
        torch.cuda.synchronize()
    card = torch.empty((cap, 8), dtype=torch.int64, device=dev)
    sched = ops.plan(cap, 0, 0, cap, 0, produce=True, consume=False)[2:7]
    t = cs.Timer(torch).rounds({
        "dma pinned->card": lambda: elib.dma_copy(
            card.data_ptr(), view.ctypes.data, cap * 64, sp),
        "kernel produce from mapped": lambda: bd.fns["ring_produce"](
            slots.data_ptr(), flags.data_ptr(), cap, 8, mapped, cap, 0,
            *sched, 0, sp),
        "kernel produce from card": lambda: bd.fns["ring_produce"](
            slots.data_ptr(), flags.data_ptr(), cap, 8, card.data_ptr(),
            cap, 0, *sched, 0, sp),
        "pageable .to(card)": lambda: card.copy_(torch.from_numpy(full)),
    })
    for k, v in t.items():
        out[f"{k} n{cap} (card clock, cold)"] = v["ms"] * 1e3
    _build.reset_launches()
    print("wrapper breakdown (us): " + "  ".join(
        f"{k} {v:.2f}" for k, v in out.items()), flush=True)
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.desc_ring import ops

    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda")
    T = cs.Timer(torch)
    rng = np.random.default_rng(0)
    cap = cs.FULL.ring
    out = {"breakdown": breakdown(torch, np, dev, cap),
           "rows": cs.phase_ring_kernels(torch, np, dev, cap, rng, T)}
    slots, flags = ops.alloc(cap, 8, dev)
    full = rng.integers(-2**62, 2**62, (cap, 8), dtype=np.int64)
    ops.produce(slots, flags, 0, full)
    variants = {"package": None,
                "copy readback": Variant(cap, dev, readback="copy"),
                "copy staging": Variant(cap, dev, staging="copy")}
    res = {}
    for entry, n, limit in cs.RING_SHAPES:
        b = full[:n] if entry != "ring_consume" else None
        fns = {}
        for name, v in variants.items():
            v = v or ops._boundary(slots, None)
            fns[name] = (lambda v=v, b=b: v.step(entry, slots, flags, 0, 0,
                                                 b, limit), "read", "host")
        want = fns["package"][0]()
        for name, (fn, _, _) in fns.items():
            got = fn()
            cs.check(want is None and got is None
                     or np.array_equal(got, want),
                     f"{entry} n={n} limit={limit}: {name} != package")
        t = T.rounds(fns)
        key = f"{entry} n={n} limit={limit}"
        res[key] = {k: dict(ms=v["ms"], lo=v["lo"], hi=v["hi"])
                    for k, v in t.items()}
        print(f"boundary {key}: " + "  ".join(
            f"{k} {v['ms']:.4f} ({v['lo']:.4f}-{v['hi']:.4f})"
            for k, v in t.items()) + " ms (host clock)", flush=True)
    out["boundary"] = res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
