"""Training CLI of the torch port: AdamW steps on the synthetic stream,
with checkpoint/restart through `TrainController`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --reduced --device cpu --steps 20      # on the CPU, at smoke size
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --steps 10                             # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \\
        --steps 12 --ckpt-dir ckpt --checkpoint-every 4 --fail-at 9

The reference's flags (`--arch --steps --batch --seq --lr --microbatches
--reduced --mesh --ckpt-dir --checkpoint-every --fail-at --log-every`)
and `--device` (default: the card). Parameters are drawn from a
`torch.Generator` seeded with 0 on the run's device; the step donates
them and the optimizer state (`jit_train_step`: updated in place).
`--mesh` raises: the sharded step comes with ROADMAP slice 8e.

A frontend config gets seeded embeddings of (batch, n_tokens, d_input)
in every batch, a pure function of the step as the tokens are: whisper-
base's 1500 audio frames (the stubbed conv frontend's output, which its
encoder reads), internvl2-2b's 256 patch embeddings (spliced over the
first 256 token rows, so `--seq` must be at least 256). The reference's
CLI feeds none, so its whisper run fails; feeding them here is a
launcher convenience, not a model feature.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as tdevice
from repro_torch import tree
from repro_torch.configs.base import get_config, reduced as reduce_cfg
from repro_torch.models.module import torch_dtype
from repro_torch.models.registry import build_model
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as optim
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault import TrainController
from repro_torch.train.train_loop import jit_train_step


def make_batch_fn(cfg, batch: int, seq: int, *, device=None, seed: int = 0):
    """step -> the synthetic batch of that step on `device`, with the
    config's frontend embeddings (standard normal, numpy's generator
    seeded with (seed, step, 1)) where it has a frontend."""
    F = cfg.frontend
    if F.kind == "vision" and seq < F.n_tokens:
        raise ValueError(f"{cfg.name} splices {F.n_tokens} patch "
                         f"embeddings over the first token rows: --seq "
                         f"must be at least {F.n_tokens}, not {seq}")
    dev = tdevice.resolve(device)

    def batch_fn(step: int) -> dict:
        out = data_lib.synthetic_batch(step, batch, seq, cfg.vocab_size,
                                       seed=seed, device=dev)
        if F.kind != "none":
            e = np.random.default_rng((seed, step, 1)).standard_normal(
                (batch, F.n_tokens, F.d_input), dtype=np.float32)
            out["embeddings"] = torch.from_numpy(e).to(
                device=dev, dtype=torch_dtype(cfg.dtype))
        return out
    return batch_fn


def main(argv=None):
    """Returns (final state {"params", "opt"}, history [(step,
    metrics)])."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="gemma-2b")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--mesh", default="", help="e.g. 2x2x2 -> pod,data,model")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--fail-at", type=int, default=None)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: the sharded train step comes with training on a "
            "mesh (ROADMAP slice 8e)")

    dev = tdevice.resolve(args.device)
    tdevice.set_default(dev)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    batch_fn = make_batch_fn(cfg, args.batch, args.seq, device=dev)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_cfg = optim.OptConfig(lr=args.lr,
                              warmup_steps=min(100, args.steps // 10 + 1))
    opt_state = optim.init_opt_state(params, opt_cfg)
    step_fn = jit_train_step(model, cfg, opt_cfg,
                             microbatches=args.microbatches)
    n_params = sum(x.numel() for x in tree.leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch}x{args.seq} on {dev}")

    def controller_step(state, batch):
        p, o, m = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    def line(s, m):
        return (f"step {s}: loss={float(m['loss']):.4f} "
                f"gnorm={float(m['grad_norm']):.3f}")

    state = {"params": params, "opt": opt_state}
    if args.ckpt_dir:
        ck = Checkpointer(args.ckpt_dir)
        try:
            start = ck.latest_step() or 0
            if start:
                _, state = ck.restore(state)
                print(f"resumed from step {start}")
            ctrl = TrainController(controller_step, batch_fn, ck,
                                   checkpoint_every=args.checkpoint_every)
            t0 = time.monotonic()
            state, last, hist = ctrl.run(state, start, args.steps,
                                         fail_at=args.fail_at)
        finally:
            ck.close()
        for s, m in hist[::args.log_every]:
            print(line(s, m))
        print(f"done at step {last}; "
              f"{(time.monotonic()-t0)/max(1, len(hist)):.3f} s/step; "
              f"restarts {ctrl.restarts}; stragglers flagged: "
              f"{len(ctrl.monitor.flagged)}")
        return state, hist
    t0 = time.monotonic()
    hist = []
    for i in range(args.steps):
        state, m = controller_step(state, batch_fn(i))
        hist.append((i, m))
        if i % args.log_every == 0:
            print(line(i, m))
    print(f"done; {(time.monotonic()-t0)/max(1, args.steps):.3f} s/step")
    return state, hist


if __name__ == "__main__":
    main()
