#!/usr/bin/env python3
"""Run phase 11's learning check (`chip_smoke.learning_setup` and
`learning_check`, as the phase runs them) on the card for other seeds,
parameter dtypes, rates and step counts than the phase's:
for each run, the held-out loss of the conditioned copy of the CLI's
initial parameters (drawn with the run's seed) before training, after `steps`
donated AdamW steps at `lr`, and after the same steps at `-lr` (the
control), their fall and gap over the starting loss. The arch's
dtype is the config's unless the run names float32 (the parameters,
moments and products all in float32). Card only:

    python3 tools/train/learning_probe.py            # the runs below
    python3 tools/train/learning_probe.py --out PATH  # and their JSON

The runs (RUNS) are gemma-2b's seeds 0-3 in bf16 at the CLI's rate,
seed 1 in float32, at lr 1e-4 and 3e-5, and after 1 and 3 steps
(whisper-base's and internvl2-2b's seed 1 are held by the phase).
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# (arch, seed, dtype, lr, steps)
RUNS = (("gemma-2b", 0, "bfloat16", 3e-4, 10),
        ("gemma-2b", 1, "bfloat16", 3e-4, 10),
        ("gemma-2b", 2, "bfloat16", 3e-4, 10),
        ("gemma-2b", 3, "bfloat16", 3e-4, 10),
        ("gemma-2b", 1, "float32", 3e-4, 10),
        ("gemma-2b", 1, "bfloat16", 1e-4, 10),
        ("gemma-2b", 1, "bfloat16", 3e-5, 10),
        ("gemma-2b", 1, "bfloat16", 3e-4, 1),
        ("gemma-2b", 1, "bfloat16", 3e-4, 3))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tools/train/learning_probe.py: no CUDA card", file=sys.stderr)
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
    out = []
    for arch, seed, dtype, lr, steps in RUNS:
        t0 = time.perf_counter()
        L = c.learning_check(torch, c.learning_setup(
            torch, arch, c.TRAIN, dev, dtype=dtype, lr=lr), dev, seed, steps)
        out.append(dict(arch=arch, seed=seed, dtype=dtype, lr=lr,
                        steps=steps, **L))
        c.log(f"{arch} seed {seed} {dtype} lr {lr:g} {steps} steps: "
              f"before {L['before']:.6f}, descent {L['descent']:.6f}, "
              f"ascent {L['ascent']:.6f}, fall {L['fall']:.6f}, gap "
              f"{L['gap']:.6f} (margin {c.LEARN_MARGIN}); "
              f"{time.perf_counter() - t0:.1f} s")
        c.free_device_memory(torch)
    if "--out" in sys.argv[1:]:
        path = Path(sys.argv[sys.argv.index("--out") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    c.log(c.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
