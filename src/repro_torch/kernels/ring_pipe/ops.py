"""The T3 notification pipe's device half: ONE launch per drained batch.

The host-side `core.notification.Ring` is the paper's SPSC descriptor
pipe; `ring_consume` is its consumer on the device: given the slot
index of each drained descriptor and the payload slot buffer, it
gathers each descriptor's payload slot into a dense batch in
descriptor order. On a CUDA tensor it is one launch of the
hand-written row-copy kernel (`csrc/wr_rows.cu`, entry
`ring_pipe_consume`, counted apart from the datapath's gathers, through
`kernels.wr_scatter.ops.launch_rows`); on a CPU tensor it is the plain
version in `ref.py`; any other device raises.

Difference from the reference's `kernels/ring_pipe`, on purpose: a slot
index outside ``[0, n_slots)`` raises IndexError before any launch
(the reference's plain `jnp.take` fills such a row and its Pallas
BlockSpec clamps the index). Repeated indices are legal: it is a
gather.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ring_pipe import ref
from repro_torch.kernels.wr_scatter.ops import _offsets, launch_rows


def ring_consume(slots: torch.Tensor, src_idx) -> torch.Tensor:
    """slots: (n_slots, W), any dtype; src_idx: (n,) slot index per
    descriptor, host or device. Returns the (n, W) payloads in
    descriptor order, on the slots' device."""
    if not isinstance(slots, torch.Tensor):
        raise TypeError(f"slots must be a torch.Tensor, not {type(slots)}")
    if slots.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for {slots.device}")
    if slots.ndim != 2 or not slots.is_contiguous():
        raise ValueError("slots must be a contiguous (n_slots, W) tensor")
    idx = _offsets(src_idx, slots.shape[0])
    idx_t = torch.from_numpy(idx).to(slots.device)
    if slots.device.type == "cpu":
        return ref.consume(slots, idx_t)
    n, W = idx.size, slots.shape[1]
    out = torch.empty((n, W), dtype=slots.dtype, device=slots.device)
    slot_bytes = W * slots.element_size()
    if n == 0 or slot_bytes == 0:
        return out
    launch_rows("ring_pipe_consume", out, slots, idx_t, n, slot_bytes)
    return out
