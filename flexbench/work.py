"""The work each request needs, in bytes, and the H100's published peaks.

The yardstick of every roofline share the benchmark reports. A share
counts the bytes that the *request* needs, not the bytes one kernel
moves, and divides by the device time of every operation the request
path ran, so it reads the same work whatever implements it: a later
change that fuses, splits or removes a kernel cannot make its own
share look better by moving bytes out of the count.

Peak: NVIDIA H100 SXM5 80 GB data sheet, at the card's full power
limit of 700 W (no cell runs a model step, so no FLOP peak is used). A
card set below that limit runs slower under load; write its limit
beside every number.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # HBM3 bandwidth, H100 SXM5 80 GB
POWER_LIMIT_W = 700.0           # the power limit the peak assumes

BLOCK_BYTES = 4096              # one Solar block: 1024 float32 words
CHECKSUM_BYTES = 4              # one float32 checksum a block
LBA_BYTES = 8                   # one int64 LBA, as the handler copies it


def block_read_bytes(n_lbas: int) -> int:
    """Bytes one aggregated block read of `n_lbas` LBAs needs: every
    block read once from the store and written once to the response,
    one checksum written a block, and the LBAs copied to the device."""
    n = int(n_lbas)
    return n * (2 * BLOCK_BYTES + CHECKSUM_BYTES + LBA_BYTES)


def roofline_pct(need_bytes: float, device_s: float,
                 peak: float = HBM_BYTES_PER_S) -> float | None:
    """The least time the bytes need at `peak`, as a percentage of the
    device time the work took; None when no device time was seen (a
    share is never reported as 0 for want of a reading)."""
    if device_s <= 0 or need_bytes <= 0:
        return None
    return 100.0 * need_bytes / peak / device_s
