#!/usr/bin/env python3
"""Run `chip_smoke.py`'s phase 16 alone on the card (the block program
rank by rank on a (data 2, model 16) grid: gemma-2b, codeqwen1.5-7b,
granite-moe-1b-a400m, deepseek-v3-671b, mamba2-780m, recurrentgemma-2b
and whisper-base at full width; float32 holds against the unsharded
steps, each rank's bf16 device ms). Card only:

    python3 tools/blocks/probe.py [--arch granite-moe-1b-a400m,...]
    python3 tools/blocks/probe.py --rounding [--arch mamba2-780m]
    python3 tools/blocks/probe.py --routing
    python3 tools/blocks/probe.py --memory --arch deepseek-v3-671b

`--arch` runs only the named archs of `chip_smoke.BLOCKS` (with
`--rounding`, each of them; gemma-2b by default).

`--memory` runs phase 16 (for the archs of `--arch`) with the card's
allocated GiB printed before and after each collective of more than a
GiB in all (the largest of each kind and shape) and, at the first
all-to-all, the live allocations counted by size.

`--routing` runs only the MoE archs' float32 prefill unsharded, on three
copies of their parameters: the conditioned copy, the same with the
input embedding table at its drawn scale (`chip_smoke.routed`'s table
alone), and `chip_smoke.routed`. For each MoE layer it prints the
router logits' spread across tokens (each expert's standard deviation
over the tokens, their mean) beside the spread across experts of the
mean logit, the mean cosine between two router inputs of one rank's
block of tokens (a row's S/M positions), the most assignments one such
block sends one expert and the float32 hold's capacity factor
(`chip_smoke.blocks_hold_cf`).

`--rounding` runs only an arch's float32 train step, at 2 x 1024 and
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


def rounding(torch, c, dev, arch: str = "gemma-2b") -> dict:
    """`arch`'s float32 gradient (phase 16's config of it), leaf by leaf:
    the block program, the unsharded step with its rows swapped and in
    two microbatches, each against the unsharded step, at two token
    counts."""
    from repro_torch import tree
    from repro_torch.parallel.turns import Turns
    from repro_torch.train import train_loop
    kw = dict(c.BLOCKS.archs)[arch]
    out = {}
    for seq in (1024, 4096):
        Z = dataclasses.replace(c.BLOCKS, archs=((arch, kw),), seq=seq)
        cfg = c.blocks_cfg(arch, kw, Z, "float32")
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


def routing(torch, c, dev) -> dict:
    """The MoE archs' routing on three copies of their parameters."""
    import math

    from repro_torch import tree
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    Z = c.BLOCKS
    n = Z.seq // Z.model                    # a rank's block of a row
    seen, route = [], moe.route

    def watched(p, x, cfg, **kw):
        out = route(p, x, cfg, **kw)
        seen.append((x[0, -n:].float(), x.float() @ p["router"]["w"],
                     out[1]))
        return out
    out = {}
    for arch, kw in Z.archs:
        cfg = c.blocks_cfg(arch, kw, Z, "float32")
        if cfg.moe is None:
            continue
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        cond = c.conditioned(model.init(gen, device=dev), cfg)
        batch = launch_train.make_batch_fn(cfg, Z.batch, Z.seq,
                                           device=dev)(0)
        D = cfg.d_model
        res = {}
        for name in ("conditioned", "embedding_at_1", "routed"):
            params = cond if name == "conditioned" else \
                c.routed(cond, cfg) if name == "routed" else \
                tree.unflatten(cond, [
                    a * math.sqrt(D) if k == "embed/table" else
                    a / math.sqrt(D) if (k == "final_norm/scale"
                                         and cfg.tie_embeddings) else a
                    for k, a in tree.flatten_with_keys(cond)])
            moe.route = watched
            try:
                with torch.no_grad():
                    model.prefill(params, batch["tokens"])
            finally:
                moe.route = route
            del params
            layers = []
            for blk, lg, idx in seen:
                lg = lg.reshape(-1, cfg.moe.n_experts)
                u = blk / blk.norm(dim=-1, keepdim=True)
                layers.append(dict(
                    logit_spread_tokens=float(lg.std(0).mean()),
                    logit_spread_experts_of_mean=float(lg.mean(0).std()),
                    block_cosine=float(u.mean(0).norm() ** 2),
                    most_to_one_expert=int(max(
                        torch.bincount(idx[b, j:j + n].reshape(-1).long(),
                                       minlength=cfg.moe.n_experts).max()
                        for b in range(idx.shape[0])
                        for j in range(0, Z.seq, n))),
                    hold_cf=c.blocks_hold_cf(torch, cfg, [idx], Z)))
                c.log(f"routing: {arch} {name} moe layer {len(layers) - 1}"
                      f" ({n} tokens a block, {cfg.moe.top_k} of "
                      f"{cfg.moe.n_experts} experts): " + ", ".join(
                          f"{k} {v:.4g}" for k, v in layers[-1].items()))
            seen.clear()
            res[name] = layers
        out[arch] = res
        del model, cond, batch
        c.free_device_memory(torch)
    return out


def memory(torch, np, c, dev, Z) -> dict:
    """Phase 16 with the card's allocations read at its big
    collectives."""
    import collections

    from repro_torch.parallel import turns
    stacked, seen, snap = turns._stacked, {}, []

    def watched(op, xs, args):
        big = sum(x.numel() * x.element_size() for x in xs) > 2**30
        before = torch.cuda.memory_allocated() / 2**30
        if big and op == "all_to_all" and not snap:
            sizes = collections.Counter(
                b["size"] for seg in torch.cuda.memory_snapshot()
                for b in seg["blocks"] if b["state"] == "active_allocated")
            snap.append(sorted(((n * sz, sz, n) for sz, n in sizes.items()),
                               reverse=True)[:16])
            c.log("memory: live at the first all-to-all: " + ", ".join(
                f"{n} x {sz / 2**20:.2f} MiB" for _, sz, n in snap[0]))
        out = stacked(op, xs, args)
        if big:
            k = f"{op} {tuple(xs[0].shape)}"
            a, b, n = seen.get(k, (0.0, 0.0, 0))
            seen[k] = (max(a, before), max(b, torch.cuda.memory_allocated()
                                           / 2**30), n + 1)
        return out
    turns._stacked = watched
    try:
        out = c.phase_blocks(torch, np, dev, Z, c.Timer(torch))
    finally:
        turns._stacked = stacked
        for k, (a, b, n) in seen.items():
            c.log(f"memory: {k}: {a:.2f} GiB before, {b:.2f} after "
                  f"(largest of {n})")
    return dict(out, collectives_gib=seen)


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
    want = (sys.argv[sys.argv.index("--arch") + 1].split(",")
            if "--arch" in sys.argv[1:] else None)
    if "--rounding" in sys.argv[1:]:
        out = {a: rounding(torch, c, dev, a) for a in want or ["gemma-2b"]}
    elif "--routing" in sys.argv[1:]:
        out = routing(torch, c, dev)
    else:
        _build.build(("flash_attention",))
        Z = c.BLOCKS
        if want:
            Z = dataclasses.replace(Z, archs=tuple(
                a for a in Z.archs if a[0] in want))
        if "--memory" in sys.argv[1:]:
            out = memory(torch, np, c, dev, Z)
        else:
            out = c.phase_blocks(torch, np, dev, Z, c.Timer(torch))
    c.log(f"took {time.perf_counter() - t0:.1f} s")
    c.log(json.dumps(out, default=str))
    c.log(c.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
