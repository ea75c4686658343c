"""The control: the plain reference put in the program's place, one
precision below what the configuration states, judged by the same check.

    python3 -m flexbench.control --workload <cell> --seeds 1,2,3 --seconds 5

Each seed sets up the reference's own deployment on the card, drives the
cell's traffic in a closed loop for `--seconds` through the control's
path, and judges a sample as large as a run's with the cell's check. It
prints one JSON line a seed with the numbers the check compares beside
the configuration's limits; a sound check reads the control as not
correct. The benchmark's own runs never run this.

Solar (float32 blocks and checksums): the control is bfloat16, the next
precision below float32 -- the reference's blocks held in bf16 on the
card, gathered, and summed with a bf16 result.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from flexbench import run as harness


class SolarControl:
    """The reference's read of a Solar store, in bfloat16."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        import numpy as np
        import torch

        from flexbench import traffic
        from flexbench.reference import solar as ref

        self.n_blocks = int(cfg["n_blocks"])
        self.seed = int(seed)
        self.rows, host = ref.draw_rows(self.n_blocks, self.seed,
                                        np.arange(self.n_blocks))
        self.host = host
        self.blocks = torch.from_numpy(host).to(device, torch.bfloat16)
        self.gen = traffic.BlockReads(mix, self.n_blocks, self.seed)
        self.sample_size = max(8, (1 << 16) // self.gen.n)
        self.device = device

    def issue(self, i: int):
        import torch
        idx = torch.from_numpy(self.gen.lbas(i)).to(self.device)
        data = self.blocks.index_select(0, idx)
        crc = torch.sum(data, dim=-1, dtype=torch.bfloat16)
        return data.float(), crc.float()

    def check(self, samples) -> dict:
        from flexbench.reference import solar as ref
        return ref.compare([(self.gen.lbas(i), d.cpu().numpy(),
                             c.cpu().numpy()) for i, (d, c) in samples],
                           self.rows, self.host)


CONTROLS = {"solar": SolarControl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m flexbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import torch

    from flexbench import cells
    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available():
        harness.log("flexbench.control: no CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    control = CONTROLS[cell.config["driver"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = control(cell.config, cell.mix, seed, dev)
        sync = harness._sync_fn(torch, dev)
        first, _ = harness.warm_up(drv, sync)
        w = harness.drive(drv, args.seconds, first, sync,
                          time.perf_counter_ns,
                          harness.Reservoir(drv.sample_size, seed), False)
        numbers = drv.check(w.samples)
        limits = cell.config["limits"]
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control": "bfloat16",
            "requests": w.requests, "sampled": len(w.samples),
            "seconds": time.perf_counter() - t0,
            "numbers": {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits},
            "correct": all(numbers[k] <= limits[k] for k in limits)}),
            flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
