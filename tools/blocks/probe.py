#!/usr/bin/env python3
"""Run `chip_smoke.py`'s phase 16 alone on the card (the dense decoders'
block program rank by rank on a (data 2, model 16) grid: gemma-2b and
codeqwen1.5-7b at full width, depth 2; float32 holds against the
unsharded steps, each rank's bf16 device ms). Card only:

    python3 tools/blocks/probe.py
    python3 tools/blocks/probe.py --rounding

`--rounding` runs only gemma-2b's float32 train step, at 2 x 1024 and
2 x 4096 tokens, and prints each gradient leaf's difference over its
scale from the unsharded step's three times: the block program's; the
unsharded step's with the batch's rows swapped; and its two
microbatches' (one row each, their gradients summed: the split of the
batch over data 2). The last two are the same mean gradient with its
sums over the tokens taken in another order: float32's rounding alone.
Beside each, the leaf's scaling: a in got = (1 + a) want, fitted by
least squares (a leaf scaled wrong reads its error in a; rounding,
uncorrelated with the values, leaves a far under the difference).
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def rel(got, want) -> float:
    """The largest difference over the scale of `want`."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def scaling(got, want) -> float:
    """a of the least-squares fit got = (1 + a) want."""
    g, w = got.double().flatten(), want.double().flatten()
    return float((g - w).dot(w) / w.dot(w).clamp(min=1e-300))


def rounding(torch, c, dev) -> dict:
    """gemma-2b's float32 gradient, leaf by leaf: the block program, the
    unsharded step with its rows swapped and in two microbatches, each
    against the unsharded step, at two token counts."""
    from repro_torch import tree
    from repro_torch.parallel.turns import Turns
    from repro_torch.train import train_loop
    out = {}
    for seq in (1024, 4096):
        Z = dataclasses.replace(c.BLOCKS, archs=(("gemma-2b", ()),), seq=seq)
        cfg = c.blocks_cfg("gemma-2b", (), Z, "float32")
        model, whole, batch, tokens = c.blocks_inputs(torch, cfg, Z, dev)
        one = dict(params=whole, rows=batch, tokens=tokens)
        want = c.blocks_step(torch, model, cfg, one, Z, "train")["grads"]
        swapped = dict(one, rows={k: v.flip(0) for k, v in batch.items()})
        alt = c.blocks_step(torch, model, cfg, swapped, Z, "train")["grads"]
        halves = train_loop.make_grads_fn(model, cfg, microbatches=2)(
            whole, batch)[1]
        preps = Turns((Z.data, Z.model), c.BLOCK_AXES).run(
            lambda r: c.blocks_prep(torch, model, whole, batch, tokens, Z))
        ranks = Turns((Z.data, Z.model), c.BLOCK_AXES).run(
            lambda r: c.blocks_step(torch, model, cfg, preps[r], Z,
                                    "train")["grads"])
        spec, shape = c.blocks_specs(model, cfg, Z)["grads"]
        keys = [k for k, _ in tree.flatten_with_keys(want)]
        res = {}
        for k, sp, sh, outs, w, a, h in zip(
                keys, c._leaf_list(spec, want), c._leaf_list(shape, want),
                zip(*[tree.leaves(r) for r in ranks]), tree.leaves(want),
                tree.leaves(alt), tree.leaves(halves)):
            got, _ = c.blocks_assemble(torch, list(outs), sp, tuple(sh), Z)
            res[k] = {n: (rel(x, w), scaling(x, w)) for n, x in (
                ("blocks", got), ("swapped_rows", a),
                ("two_microbatches", h))}
            c.log(f"rounding: {Z.batch} x {seq} {k}: " + ", ".join(
                f"{n} {d:.4g} of scale (a {f:.3g})"
                for n, (d, f) in res[k].items()))
        out[f"{Z.batch}x{seq}"] = res
        del model, whole, batch, tokens, one, want, alt, halves, preps
        del ranks
        c.free_device_memory(torch)
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tools/blocks/probe.py: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as c
    from repro_torch import device
    from repro_torch.kernels import _build
    device.set_default("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.log(c.smi_line())
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    if "--rounding" in sys.argv[1:]:
        out = rounding(torch, c, dev)
    else:
        _build.build(("flash_attention",))
        out = c.phase_blocks(torch, np, dev, c.BLOCKS, c.Timer(torch))
    c.log(f"took {time.perf_counter() - t0:.1f} s")
    c.log(json.dumps(out, default=str))
    c.log(c.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
