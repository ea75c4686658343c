#!/usr/bin/env python3
"""Run `chip_smoke.py`'s phase 13 alone on the card (sequence and expert
parallelism, one rank at a time): build the flash kernel, run
`chip_smoke.phase_sp` at the card's sizes (`chip_smoke.SP`), print the
card's line, the phase's log and its launches, and with `--out PATH`
write the phase's whole result there as JSON. Card only (~2 min):

    python3 tools/sp/probe.py [--out PATH]
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
        print("tools/sp/probe.py: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as c
    from repro_torch import device
    from repro_torch.kernels import _build
    device.set_default("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.log(c.smi_line())
    t0 = time.perf_counter()
    _build.build(("flash_attention",))
    c.log(f"built flash_attention in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = c.phase_sp(torch, np, torch.device("cuda"), c.SP,
                     np.random.default_rng(0), c.Timer(torch))
    c.log(f"phase 13 took {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if "--out" in sys.argv[1:]:
        path = Path(sys.argv[sys.argv.index("--out") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1, default=str))
    c.log(json.dumps({"launches": out["launches"],
                      "flash_by_shape": out["flash_by_shape"]}))
    c.log(c.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
