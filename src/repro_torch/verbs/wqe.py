"""WQE/CQE wire format for the software verbs layer.

Work-queue elements ride the exact 64B cacheline descriptor of
`core/descriptors.py` (DESCRIPTOR_WIDTH int64 words) — the same format the
T3 notification ring and the ring_pipe kernel speak, so a send queue, a
completion queue and the notification pipe are all the *same* header
stream (paper §3.4: one DMA-only pipe for every control message).

Word layout for a verbs WQE/CQE (reusing the core word names):

  W_OPCODE  verbs opcode (IBV_WR_*) or a raw custom opcode (Table 2)
  W_SRC     wr_id
  W_DST     remote key (rkey) for one-sided ops / dest QP number for SEND
  W_OFFSET  remote record offset (RDMA) / first record offset
  W_LENGTH  payload length: bytes when inline, records otherwise
  W_TAG     local key (lkey), 0 when the payload is by-value
  W_FLAGS   bit0 inline, bit1 signaled, bit2 custom-resp expected,
            bits 8..11 inline payload dtype code
  W_SEQ     CQ sequence number (stamped at publication)

Inline SENDs (≤ INLINE_MAX_BYTES) pack the payload into ONE companion
descriptor row: header + data are both 64B cachelines on the header path
— the paper's header/payload split taken literally.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.descriptors import (DESCRIPTOR_WIDTH, W_DST, W_FLAGS,
                                    W_LENGTH, W_OFFSET, W_OPCODE, W_SEQ,
                                    W_SRC, W_TAG)

# -- verbs opcodes (chosen clear of the core OP_* and Table-2 custom space)
IBV_WR_SEND = 0x10
IBV_WR_RDMA_WRITE = 0x11
IBV_WR_RDMA_READ = 0x12
IBV_WC_RECV = 0x18            # completion-side opcode for a landed SEND

_VERB_OPCODES = {IBV_WR_SEND, IBV_WR_RDMA_WRITE, IBV_WR_RDMA_READ,
                 IBV_WC_RECV}

# -- completion status
IBV_WC_SUCCESS = 0
IBV_WC_RNR_ERR = 1            # receiver not ready (no posted recv WR)
IBV_WC_ACCESS_ERR = 2         # bad lkey/rkey
IBV_WC_WR_FLUSH_ERR = 3       # WR flushed by QP teardown / ERR transition
IBV_WC_RETRY_EXC_ERR = 4      # transport retries exhausted (lossy link)

# -- flags
WQE_F_INLINE = 1 << 0
WQE_F_SIGNALED = 1 << 1
WQE_F_CUSTOM = 1 << 2

INLINE_MAX_BYTES = DESCRIPTOR_WIDTH * 8      # one 64B companion cacheline

_DTYPE_CODES = {np.dtype(np.float32): 1, np.dtype(np.int32): 2,
                np.dtype(np.int64): 3, np.dtype(np.uint8): 4,
                np.dtype(np.float64): 5}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


def is_custom(opcode: int) -> bool:
    """Anything outside the IBV_WR_* set dispatches to the offload engine."""
    return opcode not in _VERB_OPCODES


def encode_wqe(opcode: int, *, wr_id: int = 0, rkey: int = 0, lkey: int = 0,
               remote_offset: int = 0, length: int = 0,
               flags: int = WQE_F_SIGNALED, dtype_code: int = 0) -> np.ndarray:
    d = np.zeros((DESCRIPTOR_WIDTH,), np.int64)
    d[W_OPCODE], d[W_SRC], d[W_DST] = opcode, wr_id, rkey
    d[W_OFFSET], d[W_LENGTH], d[W_TAG] = remote_offset, length, lkey
    d[W_FLAGS] = flags | (dtype_code << 8)
    return d


def pack_inline(payload) -> tuple[np.ndarray, int, int]:
    """Pack a small array into one descriptor row.

    Returns (row, nbytes, dtype_code). Raises ValueError above the
    inline budget — callers fall back to the payload path.
    """
    arr = np.ascontiguousarray(np.asarray(payload))
    if arr.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {arr.dtype} not inlinable")
    if arr.nbytes > INLINE_MAX_BYTES:
        raise ValueError(f"{arr.nbytes}B exceeds inline budget "
                         f"{INLINE_MAX_BYTES}B")
    raw = np.zeros((INLINE_MAX_BYTES,), np.uint8)
    raw[:arr.nbytes] = np.frombuffer(arr.tobytes(), np.uint8)
    return raw.view(np.int64).copy(), arr.nbytes, _DTYPE_CODES[arr.dtype]


def unpack_inline(row: np.ndarray, nbytes: int, dtype_code: int) -> np.ndarray:
    dtype = _CODE_DTYPES[dtype_code]
    raw = np.ascontiguousarray(row, np.int64).view(np.uint8)[:nbytes]
    return np.frombuffer(raw.tobytes(), dtype).copy()


def pack_inline_batch(payloads) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched `pack_inline`: one (n, DESCRIPTOR_WIDTH) block of inline
    companion rows for n payloads, with row i bit-identical to
    pack_inline(payloads[i]).

    A homogeneous run (same dtype and shape — every chain the benches and
    serve paths build) packs with ONE stack + ONE byte-view copy instead of
    n tobytes/frombuffer roundtrips; ragged or mixed runs fall back to the
    per-element pack (and raise exactly where it would).

    Returns (rows, nbytes, dtype_codes) with the latter two as n-vectors.
    """
    n = len(payloads)
    arrs = [p if isinstance(p, np.ndarray) else np.asarray(p)
            for p in payloads]
    a0 = arrs[0]
    if n > 1 and all(a is a0 for a in arrs):
        # one payload OBJECT posted n times (RPC fan-out, the send
        # benches): pack once, hand out a zero-copy broadcast view —
        # rows are read-only but delivery never writes them
        row, nb, dc = pack_inline(a0)
        return (np.broadcast_to(row, (n, DESCRIPTOR_WIDTH)),
                np.full(n, nb, np.int64), np.full(n, dc, np.int64))
    d0, s0 = a0.dtype, a0.shape
    if (d0 in _DTYPE_CODES and a0.nbytes <= INLINE_MAX_BYTES
            and all(a.dtype == d0 and a.shape == s0 for a in arrs[1:])):
        block = np.ascontiguousarray(np.stack(arrs)).reshape(n, -1)
        raw = np.zeros((n, INLINE_MAX_BYTES), np.uint8)
        raw[:, :a0.nbytes] = block.view(np.uint8)
        return (raw.view(np.int64),
                np.full(n, a0.nbytes, np.int64),
                np.full(n, _DTYPE_CODES[d0], np.int64))
    rows = np.empty((n, DESCRIPTOR_WIDTH), np.int64)
    nbytes = np.empty(n, np.int64)
    dcodes = np.empty(n, np.int64)
    for i, a in enumerate(arrs):
        rows[i], nbytes[i], dcodes[i] = pack_inline(a)
    return rows, nbytes, dcodes


def unpack_inline_batch(rows: np.ndarray, nbytes: int,
                        dtype_code: int) -> np.ndarray:
    """Batched `unpack_inline` for a homogeneous inline run: (k, W) rows →
    one (k, nbytes/itemsize) payload block in a single byte-view pass.
    Row i is bit-identical to unpack_inline(rows[i], nbytes, dtype_code);
    delivery hands out the block's rows as zero-copy views."""
    dtype = _CODE_DTYPES[dtype_code]
    raw = np.ascontiguousarray(rows, np.int64).view(np.uint8)[:, :nbytes]
    return np.ascontiguousarray(raw).view(dtype)


def encode_wqe_batch(opcodes, *, wr_ids=0, rkeys=0, lkeys=0,
                     remote_offsets=0, lengths=0, flags=WQE_F_SIGNALED,
                     dtype_codes=0):
    """Vectorized `encode_wqe`: every argument is a scalar or an
    n-vector; returns an (n, DESCRIPTOR_WIDTH) chain built in one shot.
    Row i is bit-identical to encode_wqe(field_i, ...) — the N-WR chain
    costs one array pass instead of N descriptor constructions: one
    zeroed block + broadcasting column stores."""
    opcodes = np.asarray(opcodes, np.int64).ravel()
    out = np.zeros((opcodes.shape[0], DESCRIPTOR_WIDTH), np.int64)
    out[:, W_OPCODE] = opcodes
    out[:, W_SRC] = wr_ids
    out[:, W_DST] = rkeys
    out[:, W_OFFSET] = remote_offsets
    out[:, W_LENGTH] = lengths
    out[:, W_TAG] = lkeys
    out[:, W_FLAGS] = np.asarray(flags, np.int64) \
        | (np.asarray(dtype_codes, np.int64) << 8)
    return out


def encode_cqe_batch(opcodes, wr_ids, statuses, lengths, flags=0,
                     dtype_codes=0):
    """Vectorized `encode_cqe`: one (n, DESCRIPTOR_WIDTH) CQE block per
    completion batch (the transport publishes per-CQ in ONE encode+push)."""
    opcodes = np.asarray(opcodes, np.int64).ravel()
    out = np.zeros((opcodes.shape[0], DESCRIPTOR_WIDTH), np.int64)
    out[:, W_OPCODE] = opcodes
    out[:, W_SRC] = wr_ids
    out[:, W_DST] = statuses
    out[:, W_LENGTH] = lengths
    out[:, W_FLAGS] = np.asarray(flags, np.int64) \
        | (np.asarray(dtype_codes, np.int64) << 8)
    return out


def decode_cqe_batch(descs) -> dict:
    """Vectorized `cqe_fields`: decode a (k, DESCRIPTOR_WIDTH) block into
    column vectors in one pass (poll_cq's array-at-a-time consumer)."""
    descs = np.atleast_2d(np.asarray(descs, np.int64))
    flags = descs[:, W_FLAGS]
    return dict(opcode=descs[:, W_OPCODE], wr_id=descs[:, W_SRC],
                status=descs[:, W_DST], length=descs[:, W_LENGTH],
                flags=flags & 0xFF, dtype_code=(flags >> 8) & 0xF,
                seq=descs[:, W_SEQ])


def cqe_fields(desc: np.ndarray) -> dict:
    """Decode one CQ descriptor back into WorkCompletion fields."""
    flags = int(desc[W_FLAGS])
    return dict(opcode=int(desc[W_OPCODE]), wr_id=int(desc[W_SRC]),
                status=int(desc[W_DST]), length=int(desc[W_LENGTH]),
                flags=flags & 0xFF, dtype_code=(flags >> 8) & 0xF,
                seq=int(desc[W_SEQ]))


def encode_cqe(opcode: int, wr_id: int, status: int, length: int,
               flags: int = 0, dtype_code: int = 0) -> np.ndarray:
    d = np.zeros((DESCRIPTOR_WIDTH,), np.int64)
    d[W_OPCODE], d[W_SRC], d[W_DST] = opcode, wr_id, status
    d[W_LENGTH] = length
    d[W_FLAGS] = flags | (dtype_code << 8)
    return d
