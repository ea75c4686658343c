"""Disaggregated block storage over the offload engine (paper §5.7 Fig. 17,
Alibaba Solar transport / 4KB READ IOPS).

The storage server's blocks live in an MR registered on a verbs
protection domain; the storage agent is a verbs client QP. Reads are
issued as ONE custom-opcode SEND carrying N LBAs (the Table-2 escape
hatch dispatches it into the offload engine); the server coalesces them
into one fused gather — one launch of the `gather_rows` row-copy kernel
on the card — and a fused checksum ("CRC offload": one float32 sum per
block), the paper's FlexiNS bar. `read_cpu` is the per-request loop
baseline with a host-side checksum.

The blocks are the reference's: `np.random.default_rng(seed)` standard
normals cast to float32, drawn in chunks of rows (the same stream as one
draw, without its float64 copy of the whole store). An LBA outside the
store raises IndexError before anything is posted (the reference's
`blocks[lbas]` clamps it).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import verbs
from repro_torch.core.descriptors import OP_BLOCK_READ_4K
from repro_torch.core.offload_engine import QPContext
from repro_torch.kernels.kv_ingest.ops import gather_pages
from repro_torch.kernels.wr_scatter.ops import records_in

BLOCK_WORDS = 1024          # 4 KiB of f32
_DRAW_ROWS = 1 << 16        # blocks per chunk of the seeded draw


def draw_blocks(n_blocks: int, seed: int) -> np.ndarray:
    """The store's (n_blocks, BLOCK_WORDS) float32 blocks, as the
    reference draws them."""
    rng = np.random.default_rng(seed)
    blocks = np.empty((n_blocks, BLOCK_WORDS), np.float32)
    for i in range(0, n_blocks, _DRAW_ROWS):
        rows = min(_DRAW_ROWS, n_blocks - i)
        blocks[i:i + rows] = rng.standard_normal((rows, BLOCK_WORDS))
    return blocks


class SolarBlockStore:
    def __init__(self, n_blocks: int, seed: int = 0, *, device=None):
        blocks = draw_blocks(n_blocks, seed)
        self.n_blocks = n_blocks
        self.pd = verbs.ProtectionDomain(device=device)
        self.engine = self.pd.engine
        self.device = self.engine.device
        self.mr = self.pd.reg_mr("blocks", blocks)
        self._install()
        # the agent <-> server RC connection (loopback on the test rig)
        self.pair = verbs.VerbsPair(pd=self.pd)
        self._host_blocks = blocks          # for the CPU baseline

    def _install(self):
        def handle(packet, ctx: QPContext):
            # production handler: ONE gather launch + one fused checksum
            data = gather_pages(self.engine.regions["blocks"],
                                np.asarray(packet, np.int64))
            crc = torch.sum(data, dim=-1, dtype=torch.float32)
            ctx.dma_launches += 1
            ctx.submit_resp((data, crc))

        self.engine.register_opcode(OP_BLOCK_READ_4K, 0, handle)

    def _lbas(self, lbas) -> np.ndarray:
        lbas = np.asarray(lbas, np.int64).ravel()
        if not records_in(lbas, self.n_blocks):
            raise IndexError(f"LBAs must lie in [0, {self.n_blocks})")
        return lbas

    # -- FlexiNS path -------------------------------------------------------
    def read_flexins(self, lbas):
        """One aggregated verbs request: custom-opcode SEND -> coalesced
        device gather + fused crc, response in the completion. Returns
        (data (n, BLOCK_WORDS), crc (n,)) on the store's device."""
        wc = self.pair.rpc(OP_BLOCK_READ_4K, self._lbas(lbas))
        assert wc.ok, f"BLOCK_READ_4K completion status {wc.status}"
        return wc.data

    # -- one-sided path ---------------------------------------------------
    def read_rdma(self, lbas):
        """The same blocks via raw RDMA_READ verbs (no CRC offload): each
        flush-sized chunk of reads coalesces into one gather server-side."""
        lbas = self._lbas(lbas)
        parts = []
        chunk = self.pair.client.max_send_wr
        for base in range(0, len(lbas), chunk):
            for i, lba in enumerate(lbas[base:base + chunk]):
                self.pair.client.post_send(verbs.SendWR(
                    wr_id=int(base + i), opcode=verbs.IBV_WR_RDMA_READ,
                    remote_key=self.mr.rkey, remote_offsets=[int(lba)]))
            self.pair.client.flush()
            parts.extend(w.data.reshape(-1, BLOCK_WORDS)
                         for w in self.pair.client_cq.poll())
        if not parts:
            return torch.empty((0, BLOCK_WORDS), dtype=torch.float32,
                               device=self.device)
        return torch.cat(parts)

    # -- CPU baseline ---------------------------------------------------
    def read_cpu(self, lbas):
        out = np.empty((len(lbas), BLOCK_WORDS), np.float32)
        crc = np.empty((len(lbas),), np.float32)
        for i, lba in enumerate(lbas):                  # per-block memcpy
            out[i] = self._host_blocks[lba]
            crc[i] = out[i].sum(dtype=np.float32)       # host "CRC"
        return out, crc
