"""Solar block storage: a `SolarBlockStore` read through `read_flexins`.

The deployment is the configuration's store of `n_blocks` 4 KiB blocks
of float32, drawn by the program from the run's seed and registered on
the card. A request is one aggregated read of the traffic's clients x
iodepth LBAs: one custom-opcode SEND through the verbs pair, one gather
and one fused float32 checksum on the card. It completes when an event
recorded after `read_flexins` returns has been synchronised.

The check compares a seeded sample of the window's responses, every
block and checksum of each, with `flexbench.reference.solar`.
"""
from __future__ import annotations

import numpy as np

from flexbench import traffic
from flexbench.reference import solar as ref

SAMPLE_BLOCKS = 1 << 16         # blocks the check compares (256 MiB)


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from repro_torch.core.solar import SolarBlockStore

        if mix["kind"] != "block_read":
            raise ValueError(f"the solar driver serves block_read, "
                             f"not {mix['kind']}")
        self.seed = int(seed)
        self.n_blocks = int(cfg["n_blocks"])
        self.store = SolarBlockStore(self.n_blocks, seed=self.seed,
                                     device=device)
        self.gen = traffic.BlockReads(mix, self.n_blocks, self.seed)
        self.sample_size = max(8, SAMPLE_BLOCKS // self.gen.n)
        self._ctx = self.store.pair.server.ctx   # the handler's QPContext
        self.lbas = 0                           # LBAs read so far

    # -- the timed path ----------------------------------------------------
    def issue(self, i: int):
        out = self.store.read_flexins(self.gen.lbas(i))
        self.lbas += self.gen.n
        return out

    # -- what the readers and the check are given --------------------------
    def counters(self) -> dict:
        from repro_torch.kernels import _build
        return {"lbas": self.lbas,
                "launches": sum(_build.LAUNCHES.values()),
                "dma_launches": self._ctx.dma_launches,
                "doorbell_writes": self.store.pair.client.doorbell_writes}

    def end_to_end(self, counters: dict, window_s: float) -> dict:
        return {"kiops": counters["lbas"] / window_s / 1e3}

    def host(self, handle):
        data, crc = handle
        return data.cpu().numpy(), crc.cpu().numpy()

    def release(self):
        self.store = None
        self._ctx = None

    def check(self, samples) -> dict:
        """`samples`: (request index, host response) pairs."""
        lbas = [self.gen.lbas(i) for i, _ in samples]
        rows, blocks = ref.draw_rows(
            self.n_blocks, self.seed,
            np.concatenate(lbas) if lbas else np.zeros(0, np.int64))
        return ref.compare([(l, d, c) for l, (_, (d, c))
                            in zip(lbas, samples)], rows, blocks)
