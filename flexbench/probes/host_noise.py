"""Probe: how steady the host that drives the card is.

    python3 -m flexbench.probes.host_noise [--lbas 32] [--pin] [--freeze]

Times a pure-Python loop (iterations a second over 0.5 s) before and
after, and between them four 2 s slices of closed-loop Solar reads of
`--lbas` LBAs on a small store (2^16 blocks: the host path is the same,
the set-up short). A host whose calibration loop and slices swing
between processes and within one is the floor of any host-bound
metric's spread. `--pin` runs on one core, `--freeze` moves the
set-up's objects out of the collector's reach and uses one intra-op
thread; neither steadied the slices on a shared H100 machine's host.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from flexbench import run as harness


def calibrate(seconds: float = 0.5) -> float:
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        sum(range(2000))
        n += 1
    return n / seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lbas", type=int, default=32)
    ap.add_argument("--pin", action="store_true")
    ap.add_argument("--freeze", action="store_true")
    args = ap.parse_args(argv)
    harness.prepare_environment()
    if args.pin:
        os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
    import numpy as np
    import torch

    from repro_torch.core.solar import SolarBlockStore
    if args.freeze:
        torch.set_num_threads(1)
    c0 = calibrate()
    store = SolarBlockStore(1 << 16, seed=1, device="cuda")
    lbas = np.random.default_rng(0).integers(0, 1 << 16, (1024, args.lbas))
    sync = harness._sync_fn(torch, torch.device("cuda"))

    def one(k):
        store.read_flexins(lbas[k % 1024])
        sync()
    for k in range(2000):
        one(k)
    if args.freeze:
        gc.collect()
        gc.freeze()
    rates, k = [], 0
    for _ in range(4):
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < 2.0:
            one(k)
            k += 1
            n += 1
        rates.append(n / (time.perf_counter() - t0))
    print(json.dumps({"lbas": args.lbas, "pin": args.pin,
                      "freeze": args.freeze, "calibration": [c0, calibrate()],
                      "slices_per_s": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
