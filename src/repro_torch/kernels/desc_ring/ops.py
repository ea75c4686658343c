"""Host boundary of the device-resident descriptor ring.

Each call is ONE launch of `csrc/desc_ring.cu` on a CUDA ring (the plain
version in `ref.py` on a CPU ring), counted as `fused/ring_launches` in
the registry exactly where the reference counts it — separate from the
per-flush `fused/launches` contract. `_build.LAUNCHES` counts the launches
made on the card.

Slots are (capacity, width) int64 and flags (capacity,) uint8, updated
in place. `consume` and `produce_consume` return the drained rows as
host int64 descriptors, bit-equal to the reference's: on the card the
kernel writes k and the rows into one block, and the wrapper reads it
back in ONE synchronising copy.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.descriptors import DESCRIPTOR_WIDTH
from repro_torch.kernels import _build
from repro_torch.kernels.desc_ring import ref
from repro_torch.obs import metrics

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIG = {
    "ring_produce": [_P, _P, _I64, _INT, _P, _I64, _I64, _P],
    "ring_consume": [_P, _P, _I64, _INT, _I64, _I64, _P, _P],
    "ring_produce_consume": [_P, _P, _I64, _INT, _P, _I64, _I64, _I64, _I64,
                             _P, _P],
}


def _count():
    metrics.get_registry().scope("fused").counter("ring_launches").inc()


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


def _batch(slots, batch: np.ndarray) -> torch.Tensor:
    b = np.ascontiguousarray(batch, np.int64)
    if b.ndim != 2 or b.shape[1] != slots.shape[1] \
            or b.shape[0] > slots.shape[0]:
        raise ValueError(f"batch {b.shape} does not fit ring "
                         f"{tuple(slots.shape)}")
    return torch.from_numpy(b).to(slots.device)


def _launch(fn: str, *args):
    lib = _build.load("desc_ring", _SIG)
    _build.check(lib, getattr(lib, fn)(*args), fn)
    _build.count(fn)


def _rows(out: torch.Tensor) -> np.ndarray:
    host = out.cpu().numpy()        # the ONE synchronising read-back
    k = int(host[0, 0])
    return host[1:1 + k]


def produce(slots, flags, head: int, batch: np.ndarray):
    """ONE launch publishing the host int64 batch block at head.."""
    _check(slots, flags)
    cap, width = slots.shape
    b = _batch(slots, batch)
    _count()
    if slots.device.type == "cpu":
        ref.produce(slots, flags, head % (2 * cap), b)
        return
    _launch("ring_produce", slots.data_ptr(), flags.data_ptr(), cap, width,
            b.data_ptr(), b.shape[0], head % (2 * cap),
            _build.stream_ptr(slots.device))


def consume(slots, flags, tail: int, limit: int) -> np.ndarray:
    """One launch scanning the valid prefix from tail; returns up to
    `limit` rows as host int64 descriptors."""
    _check(slots, flags)
    cap, width = slots.shape
    limit = min(max(0, limit), cap)
    _count()
    if slots.device.type == "cpu":
        rows, k = ref.consume(slots, flags, tail % (2 * cap), limit)
        return rows[:k].numpy().copy()
    out = torch.empty((limit + 1, width), dtype=torch.int64,
                      device=slots.device)
    _launch("ring_consume", slots.data_ptr(), flags.data_ptr(), cap, width,
            tail % (2 * cap), limit, out.data_ptr(),
            _build.stream_ptr(slots.device))
    return _rows(out)


def produce_consume(slots, flags, head: int, tail: int, batch: np.ndarray,
                    limit: int) -> np.ndarray:
    """Fused publish+poll: ONE launch producing the host int64 batch AND
    scanning the valid prefix from tail — exactly `produce` then
    `consume`, for half the launches (the one-launch poll). Returns up
    to `limit` host int64 rows."""
    _check(slots, flags)
    cap, width = slots.shape
    b = _batch(slots, batch)
    limit = min(max(0, limit), cap)
    _count()
    if slots.device.type == "cpu":
        ref.produce(slots, flags, head % (2 * cap), b)
        rows, k = ref.consume(slots, flags, tail % (2 * cap), limit)
        return rows[:k].numpy().copy()
    out = torch.empty((limit + 1, width), dtype=torch.int64,
                      device=slots.device)
    _launch("ring_produce_consume", slots.data_ptr(), flags.data_ptr(), cap,
            width, b.data_ptr(), b.shape[0], head % (2 * cap),
            tail % (2 * cap), limit, out.data_ptr(),
            _build.stream_ptr(slots.device))
    return _rows(out)
