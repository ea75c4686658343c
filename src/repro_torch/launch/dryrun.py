"""Multi-pod dry-run of the port: trace every (arch x shape x mesh) cell
on fake tensors (no allocation) as rank 0 of a fake 256- or 512-rank
process group, count FLOPs, collective wire bytes and live memory,
derive the H100 roofline terms, and persist one JSON per cell under
experiments/dryrun_torch/<tag>.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both

The port of the reference's `repro.launch.dryrun`, which lowers and
compiles each cell with `ShapeDtypeStruct` stand-ins on 512 fake XLA
devices. Here:

  * the mesh is `launch.mesh.fake_production_mesh`: torch's `fake`
    process-group backend, whose collectives return at once;
  * the stand-ins are fake tensors (`FakeTensorMode`;
    `sharding.abstract_with_shardings`, `registry.input_specs`), and the
    step runs eagerly on them: the port's own program, op by op, with
    the flash kernel's operator giving its output's shape alone;
  * the counts come from `utils.hlo_cost.Trace`: FLOPs by
    `FlopCounterMode`, wire bytes by a dispatch mode over every c10d
    op, memory by the live fake storages (`LiveBytes`: their bytes, and
    beside them each storage rounded as the CUDA caching allocator
    rounds it, what the card's `max_memory_allocated` reads).

What a cell traces is what the port runs, and its record says which
program (`"view"`). A model of `sharding.BLOCK_FAMILIES` (every family
of the registry: the dense, MoE, SSM and hybrid decoders and the
encoder-decoder) runs the block program (`"blocks"`): a
train cell is the sharded step (`train_loop.jit_train_step` under the
mesh) on this rank's blocks of the parameters and moments and its rows
of the batch (its share of each microbatch; `"chunks"` records the
microbatches the step ran), each layer's weights gathered over data
inside it; prefill and decode cells
call `model.prefill` / `model.decode_step` on the parameter blocks, the
rank's rows and (decode) its block of the caches under the param rules,
as the reference resolves them (a decode of one row, long_500k's,
keeps each weight in place: `sharding.rows_in_place`). So
`argument_bytes`, `flops_dev` and `temp_bytes` compare with the
reference's per device. A family outside `BLOCK_FAMILIES` would keep
the global view (`"global"`; no registered config reaches it): its
train step gathers the parameters whole, every activation is whole on
every rank, and its prefill and decode take the parameters, the batch
and the caches whole.

Keys are the reference's (`repro/launch/dryrun.py`). Values with no
torch counterpart are null: `raw_cost_analysis.bytes` (XLA's bytes
accessed; torch counts no bytes, so the memory term is `costmodel`'s in
both packages) and the generated code size (eager PyTorch compiles
nothing). `raw_cost_analysis.flops` equals `flops_dev`: an eager trace
has no while-body-once blind spot. `compile_s` is the trace's wall time.

The fake tensors live on `cuda` where torch was built with CUDA, else
on `cpu` (a CPU-only build's autograd engine asks for a CUDA device
guard on a fake CUDA tensor and aborts). Neither allocates, and the
model's code takes no branch on the device.

`--set` takes the reference's `perf.FLAGS` names: `moe_impl`,
`capacity_factor`, `seq_parallel`, `decode_layout`, `fsdp` and
`ep_over_data` go to `sharding.use_mesh`, `remat_policy` to
`build_model`, `microbatches` to the train step; `q_chunk`, `kv_chunk`
and `block_skip` are accepted and change nothing (the flash kernel's
tiles are its own); any other name raises.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import (SHAPES, cell_supported, get_config,
                                      list_archs)
from repro_torch.launch.mesh import fake_production_mesh
from repro_torch.models.registry import (build_model, count_params_analytic,
                                         input_specs)
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as optim
from repro_torch.train.train_loop import jit_train_step
from repro_torch.utils import costmodel, hlo_cost, roofline

# the reference's perf.FLAGS, with its defaults
FLAGS = dict(q_chunk=512, kv_chunk=1024, block_skip=False, moe_impl="a2a",
             capacity_factor=None, fsdp=True, remat_policy="nothing",
             decode_layout="seq", microbatches=1, seq_parallel=False,
             ep_over_data=False)
MESH_FLAGS = ("moe_impl", "capacity_factor", "seq_parallel",
              "decode_layout", "fsdp", "ep_over_data")


def parse_set(items) -> dict:
    """The flags with `--set name=value` overrides, each value typed as
    the reference's `dryrun.main` types it; an unknown name raises."""
    flags = dict(FLAGS)
    for kv in items:
        k, v = kv.split("=", 1)
        if k not in FLAGS:
            raise KeyError(f"unknown flag {k!r}; known: {sorted(FLAGS)}")
        cur = FLAGS[k]
        if isinstance(cur, bool):
            flags[k] = v.lower() in ("1", "true", "yes")
        elif cur is None:
            try:
                flags[k] = float(v)
            except ValueError:
                flags[k] = v
        else:
            flags[k] = type(cur)(v)
    return flags


def default_device() -> str:
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def trace(step, args) -> dict:
    """One call of `step(*args)` on fake tensors (under their mode, or
    on real ones) under `hlo_cost.Trace`: the reference's analyze dict
    with the collective records and the memory: argument bytes (the
    distinct storages of `args`), output bytes (those of the result),
    temp bytes (the peak less the arguments) and the peak; and
    "allocator", the argument, temp and peak bytes rounded as the CUDA
    caching allocator rounds each storage. "flash_flops" are the flash
    operator's forward FLOPs and "flash_recompute_flops" what its
    backwards recompute (one forward each, a plain recompute the
    reference's differentiated attention does not make): every forward
    call but those a checkpointed layer's backward makes again, whose
    graph alone is differentiated."""
    with hlo_cost.Trace(memory=True) as t, hlo_cost.FlashInBackward() as fb:
        arg_bytes, arg_alloc = t.mem.track(args)
        out = step(*args)
        out_bytes, _ = hlo_cost.LiveBytes().track(out)
    # a train step's metrics say how many microbatches it ran
    chunks = (out[2].get("chunks") if isinstance(out, tuple) and len(out) == 3
              and isinstance(out[2], dict) else None)
    del out
    res = t.result()
    res["records"] = t.coll.records
    res["chunks"] = chunks
    # the flash operator's forward FLOPs: its backward recomputes one
    res["flash_flops"] = float(t.flops.get_flop_counts()["Global"].get(
        torch.ops.repro_torch.flash_attention, 0))
    res["flash_recompute_flops"] = (
        res["flash_flops"] - fb.flops if fb.backward else 0.0)
    res["memory"] = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                     "temp_bytes": t.mem.peak - arg_bytes,
                     "peak_bytes": t.mem.peak}
    res["allocator"] = {"argument_bytes": arg_alloc,
                        "temp_bytes": t.mem.alloc_peak - arg_alloc,
                        "peak_bytes": t.mem.alloc_peak}
    return res


def cell_step(cfg, shape, flags, device):
    """(model, step, args) of a cell under the active mesh, inside the
    active FakeTensorMode: the sharded train step on this rank's blocks,
    or prefill / decode on blocks (the block program) or whole tensors
    (the global view; the module docstring)."""
    model = build_model(cfg, remat_policy=flags["remat_policy"])
    specs = model.param_specs()
    ins, _ = input_specs(cfg, shape, device=device, microbatches=(
        flags["microbatches"] if shape.kind == "train" else 1))
    if shape.kind == "train":
        moment_dtype = ("bfloat16" if count_params_analytic(cfg) > 5e10
                        else "float32")
        opt_cfg = optim.OptConfig(moment_dtype=moment_dtype)
        params, _ = sharding.abstract_with_shardings(specs, cfg.dtype,
                                                     device=device)
        opt, _ = sharding.abstract_with_shardings(
            optim.opt_state_specs(specs, opt_cfg), "float32", device=device)
        step = jit_train_step(model, cfg, opt_cfg,
                              microbatches=flags["microbatches"],
                              batch=shape.global_batch)
        return model, step, (params, opt, dict(ins))
    params, _ = sharding.abstract_with_shardings(
        specs, cfg.dtype, whole=not sharding.runs_blocks(cfg), device=device)
    # the reference's jit prunes the arguments a step does not read
    # (keep_unused=False): serving reads no MTP head, a decode step no
    # encoder and no cross-attention K/V projection (the frames' keys and
    # values are cached)
    params.pop("mtp", None)
    if shape.kind == "decode" and cfg.family == "encdec":
        del params["enc"], params["enc_ln"]
        del params["dec"]["xattn"]["wk"], params["dec"]["xattn"]["wv"]
    if shape.kind == "prefill":
        def prefill(params, batch):
            return model.prefill(params, batch["tokens"],
                                 embeddings=batch.get("embeddings"))
        return model, prefill, (params, ins)
    return model, model.decode_step, (params, ins["tokens"], ins["cache"],
                                       ins["pos"])


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               flags: dict | None = None, *,
               records: list | None = None) -> dict:
    """One cell's record (the reference's keys); `records`, if given,
    receives the collective records (`attribute`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    flags = dict(FLAGS) if flags is None else flags
    device = default_device()
    mesh_name = "multi" if multi_pod else "single"
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}

    mesh = fake_production_mesh(multi_pod=multi_pod)
    chips = int(mesh.size())
    t0 = time.monotonic()
    with sharding.use_mesh(mesh, **{k: flags[k] for k in MESH_FLAGS}), \
            FakeTensorMode(allow_non_fake_inputs=True):
        model, step, args = cell_step(cfg, shape, flags, device)
        res = trace(step, args)
        view = "blocks" if sharding.runs_blocks(cfg) else "global"
        del args
    coll = res["collective"]
    if records is not None:
        records.extend(res["records"])
    n_params = count_params_analytic(cfg)
    n_active = count_params_analytic(cfg, active_only=True)
    moment_bytes = 2 if n_params > 5e10 else 4
    bytes_dev = costmodel.hbm_bytes_per_device(
        cfg, shape, chips, model, n_params, n_active,
        moment_bytes=moment_bytes)
    dt = time.monotonic() - t0
    flops_dev = float(res["flops"])
    mem = res["memory"]
    print(f"--- {arch} x {shape_name} x {mesh_name} ---")
    print(f"memory: args={mem['argument_bytes']/1e9:.3f}GB "
          f"out={mem['output_bytes']/1e9:.3f}GB "
          f"temp={mem['temp_bytes']/1e9:.3f}GB "
          f"peak={mem['peak_bytes']/1e9:.3f}GB")
    print(f"counts: flops/dev={flops_dev:.3e} "
          f"wire/dev={coll['wire_bytes']:.3e} counts={coll['counts']}")
    rl = roofline.roofline_terms(flops_dev, bytes_dev, coll["wire_bytes"])
    mflops = roofline.model_flops(cfg, shape, n_active)
    useful = mflops / max(1.0, flops_dev * chips)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "status": "ok", "view": view,
        "chunks": res["chunks"],
        "compile_s": round(dt, 2),
        "flops_dev": flops_dev, "flash_flops": res["flash_flops"],
        "flash_recompute_flops": res["flash_recompute_flops"],
        "bytes_dev": bytes_dev,
        "raw_cost_analysis": {"flops": flops_dev, "bytes": None},
        "collectives": coll,
        "memory": mem,
        "roofline": rl.asdict(),
        "model_flops_total": mflops,
        "useful_flop_ratio": useful,
        "mfu_bound": roofline.mfu(mflops, rl.step_s, chips)
        if rl.step_s > 0 else 0.0,
        "params_total": n_params,
        "params_active": n_active,
        "perf_flags": flags,
    }
    print(f"roofline: compute={rl.compute_s*1e3:.3f}ms "
          f"memory={rl.memory_s*1e3:.3f}ms "
          f"collective={rl.collective_s*1e3:.3f}ms -> {rl.dominant}; "
          f"useful-flop ratio={useful:.3f} mfu_bound={rec['mfu_bound']:.3f} "
          f"(trace {dt:.1f}s)")
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--set", action="append", default=[],
                   help="perf flag override, e.g. --set moe_impl=replicated")
    p.add_argument("--tag", default="baseline")
    p.add_argument("--force", action="store_true")
    p.add_argument("--out", default="experiments/dryrun_torch")
    args = p.parse_args(argv)
    flags = parse_set(args.set)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    outdir = os.path.join(args.out, args.tag)
    os.makedirs(outdir, exist_ok=True)
    failures = []
    t0 = time.monotonic()
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                name = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
                path = os.path.join(outdir, name + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"skip (exists): {name}")
                    continue
                try:
                    rec = lower_cell(arch, shape_name, multi, flags)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi else "single",
                           "status": "error", "error": f"{type(e).__name__}: {e}"}
                    failures.append(name)
                gc.collect()
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    _teardown()
    print(f"\ndry-run wall time {time.monotonic() - t0:.1f}s")
    if failures:
        print(f"\nFAILED cells ({len(failures)}): {failures}")
        raise SystemExit(1)
    print("\nall requested cells traced OK")


def _teardown():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
