"""Transfer descriptors: the "header" half of the header/payload split (T1).

A descriptor is deliberately tiny and fixed-width (the paper's WQE is one
cacheline). Descriptors are built on the control path (python / scalar
land) and never ride the payload collectives; `DESCRIPTOR_WIDTH` int64
words is the wire format used by the notification ring and the ring_pipe
kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DESCRIPTOR_WIDTH = 8          # int64 words per descriptor ("64B WQE")

# word layout
W_OPCODE = 0
W_SRC = 1                     # source shard / logical page id
W_DST = 2                     # destination shard / slot
W_OFFSET = 3
W_LENGTH = 4
W_TAG = 5
W_FLAGS = 6
W_SEQ = 7

OP_NOOP = 0
OP_KV_WRITE = 1               # payload -> paged KV cache slot
OP_KV_READ = 2
OP_KV_ACTIVATE = 3            # migrated pages -> live decode slot
OP_BATCH_READ = 0x1234        # paper Listing 1 example opcode
OP_LIST_TRAVERSAL = 0x1235
OP_BLOCK_READ_4K = 0x1240     # Solar block-storage analogue


def make_descriptor(opcode: int, *, src: int = 0, dst: int = 0,
                    offset: int = 0, length: int = 0, tag: int = 0,
                    flags: int = 0, seq: int = 0) -> np.ndarray:
    d = np.zeros((DESCRIPTOR_WIDTH,), np.int64)
    d[W_OPCODE], d[W_SRC], d[W_DST] = opcode, src, dst
    d[W_OFFSET], d[W_LENGTH], d[W_TAG] = offset, length, tag
    d[W_FLAGS], d[W_SEQ] = flags, seq
    return d


@dataclass(frozen=True)
class TransferPlan:
    """Header-only TX plan: computed once on the control path.

    axis:   mesh axis the payload crosses (e.g. 'pod')
    shift:  ppermute distance along that axis
    stripe: stripe the payload over these extra axes so every ICI link
            carries 1/prod(stripe) of the bytes (packet spraying, §5.7)
    quantize_bits: 0 (off) or 8 — compress payload on the wire
    """
    axis: str = "pod"
    shift: int = 1
    stripe: tuple[str, ...] = ("data", "model")
    quantize_bits: int = 0

    def descriptors(self, n_chunks: int, nbytes: int) -> np.ndarray:
        """The header stream for this plan (for the notification pipe)."""
        out = np.zeros((n_chunks, DESCRIPTOR_WIDTH), np.int64)
        for i in range(n_chunks):
            out[i] = make_descriptor(OP_KV_WRITE, src=i, dst=i,
                                     length=nbytes // max(1, n_chunks),
                                     seq=i)
        return out
