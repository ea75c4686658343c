#!/usr/bin/env python3
"""Why phase 16 holds whisper-base on its values at fan-in. CPU only:

    PYTHONPATH=src python3 tools/blocks/conditioning.py [--seq 256]

whisper-base at full width with one encoder and one decoder layer (its
vocab cut to 1001), 2 x SEQ tokens over 1500 seeded frames, in float32,
on `chip_smoke.conditioned`'s copy of seeded parameters and on the same
copy with `chip_smoke.values_at_fan_in`. For each copy it prints:

  * the encoder output's mean over the frames against their spread (the
    norm of the mean, the mean norm of each frame's deviation from it);
  * the unsharded train step's float32 rounding: its gradient at
    microbatches=2 (one row each) against microbatches=1, the same mean
    gradient summed in another order, over each leaf's scale;
  * phase 16's hold (`chip_smoke.phase_blocks`, its ranks in turns on a
    (data 2, model 16) grid): the block program's gradient against the
    unsharded step's.

Each the five largest leaves. ~3 minutes with 8 CPUs.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def worst(errs: dict, n: int = 5) -> str:
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{k} {v:.3g}" for k, v in top)


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as c
    from repro_torch import device, tree
    from repro_torch.train import train_loop
    device.set_default("cpu")
    seq = int(sys.argv[sys.argv.index("--seq") + 1]) if "--seq" in \
        sys.argv[1:] else 256
    dev = torch.device("cpu")
    kw = (("enc_layers", 1), ("vocab_size", 1001))
    Z = c.BlockSizes(archs=(("whisper-base", kw),), reduce=False, layers=1,
                     data=2, model=16, batch=2, seq=seq, reps=1)
    cfg = c.blocks_cfg("whisper-base", kw, Z, "float32")
    fan_in = c.values_at_fan_in
    for name, fix in (("conditioned", lambda p: p),
                      ("values at fan-in", fan_in)):
        # phase 16's inputs, its values at fan-in or not
        c.values_at_fan_in = fix
        model, whole, batch, _ = c.blocks_inputs(torch, cfg, Z, dev)
        with torch.no_grad():
            e = model._encode(whole, batch["embeddings"])[0]
        mean = e.mean(0)
        print(f"{name}: the encoder output's mean over the frames "
              f"{float(mean.norm()):.4g}, their spread "
              f"{float((e - mean).norm(dim=-1).mean()):.4g}")
        one, two = (train_loop.make_grads_fn(model, cfg, microbatches=m)(
            whole, batch)[1] for m in (1, 2))
        errs = {k: float((b.float() - a.float()).abs().max()
                         / a.float().abs().max().clamp(min=1e-30))
                for (k, a), b in zip(tree.flatten_with_keys(one),
                                     tree.leaves(two))}
        print(f"{name}: the unsharded step, 2 microbatches against 1: "
              f"{worst(errs)}")
        hold = c.phase_blocks(torch, np, dev, Z, c._Clock())[
            "archs"]["whisper-base"]["hold"]
        print(f"{name}: phase 16's hold {hold['rel_max']:.3g}: "
              f"{worst(hold['errs'])}")
    c.values_at_fan_in = fan_in
    return 0


if __name__ == "__main__":
    sys.exit(main())
