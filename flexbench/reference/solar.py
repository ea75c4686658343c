"""Plain reference of a Solar block read: NumPy only.

The store's blocks are drawn again from the seed by a frozen copy of
the draw the deployment states (`numpy.random.default_rng(seed)`
standard normals in float64, rows of 1024 words in order, each cast to
float32), keeping only the rows a check needs. The checksum of a block
is the float64 sum of its float32 words.
"""
from __future__ import annotations

import numpy as np

BLOCK_WORDS = 1024
DRAW_ROWS = 8192                # rows a chunk of the draw (64 MiB)


def draw_rows(n_blocks: int, seed: int, rows) -> tuple[np.ndarray, np.ndarray]:
    """The blocks at `rows` of an `n_blocks` store drawn from `seed`:
    (sorted unique rows, their (k, 1024) float32 blocks). The whole
    stream is drawn, in chunks, since a row's words depend on every
    draw before it."""
    rows = np.unique(np.asarray(rows, np.int64).ravel())
    if rows.size and (rows[0] < 0 or rows[-1] >= n_blocks):
        raise IndexError(f"rows outside a store of {n_blocks} blocks")
    out = np.empty((rows.size, BLOCK_WORDS), np.float32)
    rng = np.random.default_rng(seed)
    buf = np.empty((DRAW_ROWS, BLOCK_WORDS), np.float64)
    last = int(rows[-1]) + 1 if rows.size else 0
    for start in range(0, last, DRAW_ROWS):
        m = min(DRAW_ROWS, n_blocks - start)
        rng.standard_normal(out=buf[:m])
        lo, hi = np.searchsorted(rows, [start, start + m])
        out[lo:hi] = buf[rows[lo:hi] - start]
    return rows, out


def checksums(blocks: np.ndarray) -> np.ndarray:
    return blocks.astype(np.float64).sum(axis=-1)


def compare(samples, rows: np.ndarray, blocks: np.ndarray) -> dict:
    """Judge sampled responses against the reference blocks.

    `samples` are (lbas, data, crc) on the host: the request's LBAs and
    what it returned. Returns the numbers the check compares:
    ``words_differing`` (32-bit words of returned blocks that are not
    the reference's bit for bit; a response of the wrong shape counts
    every word it should have held) and ``crc_gap`` (the largest
    |returned checksum - float64 sum of the reference block|; inf where
    a checksum is missing or not finite)."""
    words, gap = 0, 0.0
    for lbas, data, crc in samples:
        want = blocks[np.searchsorted(rows, np.asarray(lbas, np.int64))]
        data = np.asarray(data)
        if data.shape != want.shape or data.dtype != np.float32:
            words += want.size
        else:
            words += int(np.count_nonzero(
                data.view(np.uint32) != want.view(np.uint32)))
        crc = np.asarray(crc, np.float64)
        if crc.shape != (want.shape[0],) or not np.isfinite(crc).all():
            gap = float("inf")
            continue
        gap = max(gap, float(np.abs(crc - checksums(want)).max(initial=0.0)))
    return {"words_differing": words, "crc_gap": gap}
