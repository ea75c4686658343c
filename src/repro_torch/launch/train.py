"""Training CLI of the torch port: AdamW steps on the synthetic stream,
with checkpoint/restart through `TrainController`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --reduced --device cpu --steps 20      # on the CPU, at smoke size
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --steps 10                             # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \\
        --steps 12 --ckpt-dir ckpt --checkpoint-every 4 --fail-at 9
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch gemma-2b --reduced --mesh 2x2x2 --device cpu  # 8 CPU ranks
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch gemma-2b --mesh 2x2x2                         # on 8 cards

The reference's flags (`--arch --steps --batch --seq --lr --microbatches
--reduced --mesh --ckpt-dir --checkpoint-every --fail-at --log-every`)
and `--device` (default: the card). Parameters are drawn from a
`torch.Generator` seeded with 0 on the run's device; the step donates
them and the optimizer state (`jit_train_step`: updated in place).

`--mesh 2x2x2` names (pod, data, model), its last axes for fewer dims,
as the reference's. Every rank runs this program: the default process
group is the caller's where one is initialised, else it is made from
the `torchrun` environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`,
`MASTER_PORT`; gloo on the CPU, NCCL on cards, each rank on card
`LOCAL_RANK`; more ranks than cards raise). Under
`use_mesh(make_mesh(...))` each rank holds its blocks of the parameters
and moments (`train_loop.shard_train_state`), takes the sharded step,
and checkpoints and restarts through the spec tree (`TrainController(
spec_tree=)`: rank 0 writes the whole tree; a restore cuts the blocks of
the mesh in use). A model that runs the block program (`sharding.
runs_blocks`: the dense, MoE, SSM and hybrid decoders) reads its (pod,
data) rows of each microbatch of each step's seeded batch, the same
whole batch the reference's step sees. On a mesh `main` returns this
rank's blocks, and only rank 0 prints.

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
import contextlib
import os
import time

import numpy as np
import torch

from repro_torch import device as tdevice
from repro_torch import tree
from repro_torch.configs.base import get_config, reduced as reduce_cfg
from repro_torch.models.module import torch_dtype
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import build_model
from repro_torch.parallel import sharding
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as optim
from repro_torch.train import train_loop
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault import TrainController


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


def mesh_dims(text: str) -> tuple:
    """"2x2x2" -> ((2, 2, 2), ("pod", "data", "model")): the last axes
    of (pod, data, model) for fewer dims, as the reference names them."""
    dims = tuple(int(d) for d in text.split("x"))
    if not 1 <= len(dims) <= 3:
        raise ValueError(f"--mesh {text!r}: one to three dims")
    return dims, ("pod", "data", "model")[-len(dims):]


def join_ranks(world: int, device: str) -> tuple:
    """(this rank's device, whether this call made the default process
    group): the caller's group where one is initialised, else one made
    from the `torchrun` environment, gloo on the CPU and NCCL on cards,
    each rank on card LOCAL_RANK."""
    import torch.distributed as dist
    dev = tdevice.resolve(device)
    made = not dist.is_initialized()
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if world > n:
            raise RuntimeError(f"a mesh of {world} ranks needs {world} "
                               f"cards; this machine has {n}")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if made:
        if "RANK" not in os.environ:
            raise RuntimeError(
                "--mesh: no process group, and no torchrun environment "
                "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) to make one")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    if dist.get_world_size() != world:
        raise RuntimeError(f"--mesh needs {world} ranks; the process "
                           f"group has {dist.get_world_size()}")
    return dev, made


def main(argv=None):
    """Returns (final state {"params", "opt"}, history [(step,
    metrics)]); on a mesh the state is this rank's blocks."""
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

    made = False
    if args.mesh:
        dims, axes = mesh_dims(args.mesh)
        dev, made = join_ranks(int(np.prod(dims)), args.device)
    else:
        dev = tdevice.resolve(args.device)
    tdevice.set_default(dev)
    try:
        with (sharding.use_mesh(make_mesh(dims, axes)) if args.mesh
              else contextlib.nullcontext()):
            return _run(args, dev)
    finally:
        if made:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, dev):
    """The training run of `main`, inside its mesh, if any."""
    import torch.distributed as dist
    lead = not args.mesh or dist.get_rank() == 0
    say = print if lead else (lambda *a, **kw: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    batch_fn = make_batch_fn(cfg, args.batch, args.seq, device=dev)
    if sharding.runs_blocks(cfg):
        whole_fn = batch_fn

        def batch_fn(step: int) -> dict:
            """This rank's rows of each microbatch of the step's whole
            batch."""
            return sharding.rows(whole_fn(step), args.microbatches)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_cfg = optim.OptConfig(lr=args.lr,
                              warmup_steps=min(100, args.steps // 10 + 1))
    opt_state = optim.init_opt_state(params, opt_cfg)
    n_params = sum(x.numel() for x in tree.leaves(params))
    specs = None
    if args.mesh:
        specs = train_loop.state_specs(model, opt_cfg)
        params, opt_state = train_loop.shard_train_state(model, opt_cfg,
                                                         params, opt_state)
    step_fn = train_loop.jit_train_step(model, cfg, opt_cfg,
                                        microbatches=args.microbatches,
                                        batch=args.batch)
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M "
        f"batch={args.batch}x{args.seq} on {dev}"
        + (f" mesh={args.mesh} ({dist.get_world_size()} ranks)"
           if args.mesh else ""))

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
                _, state = ck.restore(state, spec_tree=specs)
                say(f"resumed from step {start}")
            ctrl = TrainController(controller_step, batch_fn, ck,
                                   checkpoint_every=args.checkpoint_every,
                                   spec_tree=specs)
            t0 = time.monotonic()
            state, last, hist = ctrl.run(state, start, args.steps,
                                         fail_at=args.fail_at)
        finally:
            ck.close()
        for s, m in hist[::args.log_every]:
            say(line(s, m))
        say(f"done at step {last}; "
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
            say(line(i, m))
    say(f"done; {(time.monotonic()-t0)/max(1, args.steps):.3f} s/step")
    return state, hist


if __name__ == "__main__":
    main()
