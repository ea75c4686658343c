#!/usr/bin/env python3
"""Run `chip_smoke.py`'s phase 15 alone on the card (the dry-run against
the card's own steps: gemma-2b's train step, prefill and decode step,
real FLOPs against traced, the card's peak against the trace's, each
step's time against its H100 roofline), and with `--direction` phase
11's one-step direction check of gemma-2b on seeds 0-3. Card only:

    python3 tools/dryrun/probe.py [--direction]
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tools/dryrun/probe.py: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as c
    from repro_torch import device
    from repro_torch.kernels import _build
    device.set_default("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.log(c.smi_line())
    _build.build(("flash_attention",))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    out = {"phase15": c.phase_dryrun(torch, np, dev, c.DRYRUN,
                                     c.Timer(torch))}
    c.log(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    c.free_device_memory(torch)
    if "--direction" in sys.argv[1:]:
        setup = c.learning_setup(torch, "gemma-2b", c.TRAIN, dev)
        for seed in c.DIRECTION_SEEDS["gemma-2b"]:
            r = c.learning_check(torch, setup, dev, seed, 1)
            out[f"direction_seed{seed}"] = r
            c.log(f"gemma-2b seed {seed}: one step gap {r['gap']:+.4%} "
                  f"(margin {c.DIRECTION_MARGIN:.2%}), fall {r['fall']:+.4%}")
    c.log(json.dumps(out, default=str))
    c.log(c.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
