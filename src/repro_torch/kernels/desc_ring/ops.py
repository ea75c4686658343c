"""Host boundary of the device-resident descriptor ring.

Each call is ONE launch of `csrc/desc_ring.cu` on a CUDA ring (the plain
version in `ref.py` on a CPU ring), counted as `fused/ring_launches` in
the registry exactly where the reference counts it — separate from the
per-flush `fused/launches` contract. `_build.LAUNCHES` counts the launches
made on the card, and `_build.BY_SHAPE` the same by `shape_class`.

Slots are (capacity, width) int64 and flags (capacity,) uint8, updated
in place. `consume` and `produce_consume` return the drained rows as
host int64 descriptors, bit-equal to the reference's.

On the card nothing pageable crosses per call. `plan` sizes the grid to
the slots the call touches; a batch of up to PARAM_MAX descriptors rides
in the launch's parameters, a larger one in the ring's pinned staging
buffer. The kernel writes each CTA's k word and the rows straight into
the ring's pinned read-back buffer through its mapped pointer; the
wrapper synchronises the stream once, takes k as the least of those
words and returns a copy of rows[:k]. A `Boundary` owns those buffers
and the resolved C functions: each `Ring` keeps one bound to its slots
and flags (checked once), and direct callers share one per (device,
capacity). Pinning memory that fails raises.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.descriptors import DESCRIPTOR_WIDTH
from repro_torch.kernels import _build
from repro_torch.kernels.desc_ring import ref
from repro_torch.obs import metrics

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_PLAN = [_I64, _I64, _INT, _I64, _INT]      # base, span, grid, per, threads
_SIG = {
    "ring_produce": [_P, _P, _I64, _INT, _P, _I64, _I64, *_PLAN, _INT, _P],
    "ring_consume": [_P, _P, _I64, _INT, _I64, _I64, _P, _P, *_PLAN, _P],
    "ring_produce_consume": [_P, _P, _I64, _INT, _P, _I64, _I64, _I64, _I64,
                             _P, _P, *_PLAN, _INT, _P],
    "ring_host_alloc": [_I64, ctypes.POINTER(_P), ctypes.POINTER(_P)],
    "ring_host_free": [_P],
    "ring_sync": [_P],
    "ring_event_create": [ctypes.POINTER(_P)],
    "ring_event_record": [_P, _P],
    "ring_event_sync": [_P],
    "ring_event_destroy": [_P],
}

SLOTS_PER_CTA = 32          # one 16-byte chunk per thread: 128 threads
MAX_CTAS = 1024             # header words in the read-back buffer
# descriptors each parameter struct of the kernel carries (the largest is
# desc_ring.cu's kParamMax: 32,764 bytes of parameters, less the rest)
PARAM_TIERS = (8, 64, 510)
PARAM_MAX = PARAM_TIERS[-1]


def _count():
    metrics.get_registry().scope("fused").counter("ring_launches").inc()


def _pow2(x: int) -> int:
    return 0 if x <= 0 else 1 << (x - 1).bit_length()


def shape_class(n: int, limit: int) -> str:
    """The class `_build.BY_SHAPE` counts a launch under: the batch
    size `n` and the scan `limit`, each rounded up to a power of two."""
    return f"n{_pow2(n)} limit{_pow2(limit)}"


class Plan(NamedTuple):
    """One launch's schedule: CTA c owns the window slots
    (base + j) % cap for j in [c * per, min((c + 1) * per, span));
    `tier` is the parameter struct that carries the batch (0: the
    staging buffer, or no batch)."""
    produce: bool
    consume: bool
    base: int
    span: int
    grid: int
    per: int
    threads: int
    tier: int


def plan(cap: int, head: int, tail: int, n: int, limit: int, *,
         produce: bool, consume: bool,
         per_cta: int = SLOTS_PER_CTA) -> Plan:
    """The grid for a call that produces `n` rows at `head` and/or scans
    `limit` positions from `tail`: the window of slots it touches —
    from the tail's slot when it consumes (wide enough for the produced
    rows too), else from the head's — cut into CTAs of at most
    `per_cta` slots (more only past MAX_CTAS CTAs)."""
    hs, ts = head % cap, tail % cap
    if consume:
        base = ts
        reach = (hs - ts) % cap + n if produce and n else 0
        span = min(cap, max(limit, reach))
    else:
        base, span = hs, n
    grid = max(1, min(MAX_CTAS, -(-span // per_cta)))
    per = -(-span // grid)
    threads = max(32, min(4 * per_cta, -(-4 * per // 32) * 32))
    tier = 0
    if produce and 0 < n <= PARAM_MAX:
        small, mid, _ = PARAM_TIERS
        tier = small if n <= small else mid if n <= mid else PARAM_MAX
    return Plan(produce, consume, base, span, grid, per, threads, tier)


def alloc(capacity: int, width: int, device: torch.device):
    """Device slot memory + valid flags, all zero (every slot invalid).
    The kernel moves 64-byte descriptors: a device ring is
    DESCRIPTOR_WIDTH (8) int64 words wide."""
    if not 0 < capacity < 2 ** 31:
        raise ValueError(f"ring capacity {capacity} out of range")
    if width != DESCRIPTOR_WIDTH:
        raise ValueError(f"a device ring is {DESCRIPTOR_WIDTH} words wide, "
                         f"not {width}")
    return (torch.zeros((capacity, width), dtype=torch.int64, device=device),
            torch.zeros((capacity,), dtype=torch.uint8, device=device))


def _pin(lib, words: int):
    """`words` int64 of pinned host memory mapped for the device: a numpy
    view of it, the pointer a kernel uses, and the host pointer that
    `ring_host_free` takes."""
    host, dev = _P(), _P()
    _build.check(lib, lib.ring_host_alloc(8 * words, ctypes.byref(host),
                                          ctypes.byref(dev)),
                 "ring_host_alloc")
    view = np.ctypeslib.as_array((ctypes.c_int64 * words).from_address(
        host.value))
    return view, dev.value, host.value


class Boundary:
    """What a device ring of `cap` slots keeps at its host boundary: the
    C entry points, resolved once; the pinned read-back buffer (MAX_CTAS
    k words, then up to `cap` rows) the kernel writes through its mapped
    pointer; the pinned staging buffer for a batch past PARAM_MAX,
    made at first need; and the event after a staged launch (a `produce`
    does not synchronise) that the next write of that buffer waits on.
    Bound to a ring's `slots` and `flags` (as a `Ring` binds its own),
    it checks them once, here, instead of on every call."""

    def __init__(self, cap: int, device: torch.device, slots=None,
                 flags=None):
        if slots is not None:
            _check(slots, flags)
        self.slots, self.flags = slots, flags
        device = torch.device(device)
        if device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        lib = _build.load("desc_ring", _SIG)
        self.lib, self.cap, self.device = lib, cap, device
        self.fns = {fn: getattr(lib, fn) for fn in
                    ("ring_produce", "ring_consume", "ring_produce_consume")}
        self._sync = lib.ring_sync
        words = MAX_CTAS + cap * DESCRIPTOR_WIDTH
        self.readback, self._rb_dev, host = _pin(lib, words)
        weakref.finalize(self, lib.ring_host_free, host)
        self.kwords = self.readback[:MAX_CTAS]
        self.rows = self.readback[MAX_CTAS:].reshape(cap, DESCRIPTOR_WIDTH)
        self._rows_dev = self._rb_dev + 8 * MAX_CTAS
        self._stage = None          # (pinned rows, mapped pointer, event)
        self._staged = False        # the event follows a staged launch

    def owns(self, slots, flags) -> bool:
        return slots is self.slots and flags is self.flags

    def stream(self) -> int:
        """PyTorch's current stream on the ring's card, as a raw handle
        (the raw query: `torch.cuda.current_stream` costs ~6 us a call,
        more than the rest of the host side)."""
        return torch._C._cuda_getCurrentRawStream(self.device.index)

    def _stage_batch(self, b: np.ndarray) -> int:
        """The batch in the pinned staging buffer, once the last kernel
        that read it is done: the mapped pointer the kernel reads."""
        lib = self.lib
        if self._stage is None:
            view, mapped, host = _pin(lib, self.cap * DESCRIPTOR_WIDTH)
            weakref.finalize(self, lib.ring_host_free, host)
            ev = _P()
            _build.check(lib, lib.ring_event_create(ctypes.byref(ev)),
                         "ring_event_create")
            weakref.finalize(self, lib.ring_event_destroy, ev.value)
            self._stage = (view.reshape(self.cap, DESCRIPTOR_WIDTH), mapped,
                           ev.value)
        view, mapped, ev = self._stage
        if self._staged:
            _build.check(lib, lib.ring_event_sync(ev), "ring_event_sync")
            self._staged = False
        view[:b.shape[0]] = b
        return mapped

    def launch(self, entry: str, slots, flags, head: int, tail: int,
               b: np.ndarray | None, limit: int, stream: int) -> Plan:
        """ONE launch of `entry` on `stream`, counted; its plan."""
        cap = self.cap
        n = 0 if b is None else b.shape[0]
        pl = plan(cap, head, tail, n, limit,
                  produce=entry != "ring_consume",
                  consume=entry != "ring_produce")
        batch = None
        if n:
            batch = b.__array_interface__["data"][0] if pl.tier \
                else self._stage_batch(b)
        sched = pl[2:7]             # base, span, grid, per, threads
        sp, fp = slots.data_ptr(), flags.data_ptr()
        if entry == "ring_produce":
            rc = self.fns[entry](sp, fp, cap, DESCRIPTOR_WIDTH, batch, n,
                                 head, *sched, pl.tier, stream)
        elif entry == "ring_consume":
            rc = self.fns[entry](sp, fp, cap, DESCRIPTOR_WIDTH, tail, limit,
                                 self._rows_dev, self._rb_dev, *sched,
                                 stream)
        else:
            rc = self.fns[entry](sp, fp, cap, DESCRIPTOR_WIDTH, batch, n,
                                 head, tail, limit, self._rows_dev,
                                 self._rb_dev, *sched, pl.tier, stream)
        _build.check(self.lib, rc, entry)
        _build.count(entry, shape_class(n, limit))
        if n and not pl.tier:       # the next write of the buffer waits
            _build.check(self.lib, self.lib.ring_event_record(
                self._stage[2], stream), "ring_event_record")
            self._staged = True
        return pl

    def step(self, entry: str, slots, flags, head: int, tail: int,
             b: np.ndarray | None, limit: int):
        """`launch`, then, when it consumes, the drained rows."""
        stream = self.stream()
        pl = self.launch(entry, slots, flags, head, tail, b, limit, stream)
        if not pl.consume:
            return None
        # the ONE wait: the k words and the rows have landed
        _build.check(self.lib, self._sync(stream), "ring_sync")
        k = int(self.kwords[:pl.grid].min())
        return self.rows[:k].copy()


_SHARED: dict = {}


def _boundary(slots, via: Boundary | None) -> Boundary:
    if via is not None:
        return via
    key = (slots.device, slots.shape[0])
    b = _SHARED.get(key)
    if b is None:
        b = _SHARED[key] = Boundary(slots.shape[0], slots.device)
    return b


def _checked(slots, flags, via: Boundary | None):
    if via is None or not via.owns(slots, flags):
        _check(slots, flags)


def _check(slots, flags):
    if slots.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for {slots.device}")
    if slots.dtype != torch.int64 or flags.dtype != torch.uint8 \
            or slots.ndim != 2 or slots.shape[1] != DESCRIPTOR_WIDTH \
            or flags.shape != slots.shape[:1] \
            or flags.device != slots.device \
            or not (slots.is_contiguous() and flags.is_contiguous()):
        raise ValueError("ring needs contiguous (cap, 8) int64 slots and "
                         "(cap,) uint8 flags on one device")


def _batch(slots, batch: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(batch, np.int64)
    if b.ndim != 2 or b.shape[1] != slots.shape[1] \
            or b.shape[0] > slots.shape[0]:
        raise ValueError(f"batch {b.shape} does not fit ring "
                         f"{tuple(slots.shape)}")
    return b


def produce(slots, flags, head: int, batch: np.ndarray, *,
            via: Boundary | None = None):
    """ONE launch publishing the host int64 batch block at head.."""
    _checked(slots, flags, via)
    cap = slots.shape[0]
    b = _batch(slots, batch)
    _count()
    if slots.device.type == "cpu":
        ref.produce(slots, flags, head % (2 * cap), torch.from_numpy(b))
        return
    _boundary(slots, via).step("ring_produce", slots, flags,
                               head % (2 * cap), 0, b, 0)


def consume(slots, flags, tail: int, limit: int, *,
            via: Boundary | None = None) -> np.ndarray:
    """One launch scanning the valid prefix from tail; returns up to
    `limit` rows as host int64 descriptors."""
    _checked(slots, flags, via)
    cap = slots.shape[0]
    limit = min(max(0, limit), cap)
    _count()
    if slots.device.type == "cpu":
        rows, k = ref.consume(slots, flags, tail % (2 * cap), limit)
        return rows[:k].numpy().copy()
    return _boundary(slots, via).step("ring_consume", slots, flags, 0,
                                      tail % (2 * cap), None, limit)


def produce_consume(slots, flags, head: int, tail: int, batch: np.ndarray,
                    limit: int, *, via: Boundary | None = None
                    ) -> np.ndarray:
    """Fused publish+poll: ONE launch producing the host int64 batch AND
    scanning the valid prefix from tail — exactly `produce` then
    `consume`, for half the launches (the one-launch poll). Returns up
    to `limit` host int64 rows."""
    _checked(slots, flags, via)
    cap = slots.shape[0]
    b = _batch(slots, batch)
    limit = min(max(0, limit), cap)
    _count()
    if slots.device.type == "cpu":
        ref.produce(slots, flags, head % (2 * cap), torch.from_numpy(b))
        rows, k = ref.consume(slots, flags, tail % (2 * cap), limit)
        return rows[:k].numpy().copy()
    return _boundary(slots, via).step("ring_produce_consume", slots, flags,
                                      head % (2 * cap), tail % (2 * cap), b,
                                      limit)
