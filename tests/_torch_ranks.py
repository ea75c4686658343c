"""Multi-rank runs of the port on the CPU, for the parallelism tests
(`test_torch_sharding.py`, `test_torch_context_parallel.py`).

`run(jobs, world, workdir, payload)` spawns `world` processes with
`torch.multiprocessing.spawn`; each joins one gloo process group through
a `FileStore` in `workdir` (no TCP port, so concurrent test workers
cannot collide), pins one thread, selects the CPU as the package
default, runs every named job of `JOBS` on the numpy `payload` in turn
and saves what it returns. A module spawns its ranks once, for all its
cases. Returns one {name: array} per rank.

This module imports torch and the port only: the ranks import it, and
they never import JAX.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def run(jobs, world: int, workdir, payload: dict) -> list[dict]:
    import torch.multiprocessing as mp
    workdir = str(workdir)
    mp.spawn(_rank, args=(world, workdir, tuple(jobs), payload),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _rank(rank, world, workdir, jobs, payload):
    import torch.distributed as dist
    from repro_torch import device
    torch.set_num_threads(1)
    device.set_default("cpu")
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world)
    try:
        res = {}
        for job in jobs:
            res.update(JOBS[job](rank, payload))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.detach().float().numpy()


# -- slice 8a ------------------------------------------------------------------
def shard_shapes(rank, payload):
    """The local shape DTensor gives this rank for each parameter leaf of
    reduced gemma-2b under `param_shardings` on a (2, 4) (data, model)
    mesh, with and without FSDP."""
    from torch.distributed.tensor import Placement, distribute_tensor

    from repro_torch import tree
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding

    mesh = make_mesh((2, 4), ("data", "model"))
    specs = build_model(reduced(get_config("gemma-2b"))).param_specs()
    out = {}
    for fsdp in (True, False):
        with sharding.use_mesh(mesh, fsdp=fsdp):
            pl = sharding.param_shardings(specs)
        for (key, spec), p in zip(
                tree.flatten_with_keys(specs),
                tree.leaves(pl, is_leaf=lambda x: isinstance(x, list) and all(
                    isinstance(e, Placement) for e in x))):
            d = distribute_tensor(torch.zeros(spec.shape), mesh, p)
            out[f"shape/{int(fsdp)}/{key}"] = np.asarray(
                d.to_local().shape, np.int64)
    return out


def compress(rank, payload):
    """`compressed_psum_mean` of row `rank` of payload["x"] over an (8,)
    mesh axis, with its residual; and without the residual."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding
    from repro_torch.parallel.compress import compressed_psum_mean

    mesh = make_mesh((8,), ("d",))
    with sharding.use_mesh(mesh):
        group = sharding.axis_group("d")
    x = _t(payload["x"][rank])
    out, res = compressed_psum_mean(x, group, return_residual=True)
    bare = compressed_psum_mean(x, group)
    return {"compress/out": _n(out), "compress/residual": _n(res),
            "compress/bare": _n(bare)}


# -- slice 8b ------------------------------------------------------------------
def _counting(names):
    """Wrap `collectives.<name>` to count its calls; returns the counts."""
    from repro_torch.parallel import collectives
    counts = {n: 0 for n in names}
    for n in names:
        fn = getattr(collectives, n)

        def wrapped(*a, _fn=fn, _n=n, **kw):
            counts[_n] += 1
            return _fn(*a, **kw)
        setattr(collectives, n, wrapped)
    return counts


def context_parallel(rank, payload):
    """On a (2, 4) (data, model) mesh: `attend` at the reference test's
    shapes (H = 3 over model = 4: context parallelism), then the sharded
    decode with and without MLA's `v_dims`."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives, sharding

    counts = _counting(("_context_parallel_attention", "_sharded_decode"))
    mesh = make_mesh((2, 4), ("data", "model"))
    p = {k: _t(v) for k, v in payload.items() if k.startswith("cp/")}
    out = {}
    with sharding.use_mesh(mesh):
        out["cp/got"] = _n(collectives.attend(p["cp/q"], p["cp/k"],
                                              p["cp/v"], causal=True))
        args = [p[f"cp/{n}"] for n in ("dq", "kc", "vc", "kn", "vn", "pos")]
        o, kc, vc = collectives.seqparallel_decode_attention(*args)
        out.update({"cp/dec": _n(o), "cp/dec_k": _n(kc), "cp/dec_v": _n(vc)})
        o, kc, vc = collectives.seqparallel_decode_attention(
            *args, v_dims=int(payload["cp/v_dims"]))
        out.update({"cp/mla": _n(o), "cp/mla_k": _n(kc)})
        assert vc is None
    out["cp/counts"] = np.asarray([counts["_context_parallel_attention"],
                                   counts["_sharded_decode"]])
    return out


def model_on_mesh(rank, payload):
    """Reduced gemma-2b on a (1, 8) (data, model) mesh, on the
    reference's parameters: `forward`, then `prefill` and decode steps
    on caches padded to payload max_seq (H 4 and KVH 1 over model = 8:
    context parallelism and the sharded decode)."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding
    from repro_torch.serve.kvcache import pad_caches

    counts = _counting(("_context_parallel_attention", "_sharded_decode"))
    model = build_model(reduced(get_config("gemma-2b")))
    specs = model.param_specs()
    params = params_from_numpy(tree.unflatten(specs, [
        payload[f"param/{k}"] for k, _ in tree.flatten_with_keys(specs)]),
        "cpu", model=model)
    toks, steps = _t(payload["model/toks"]), _t(payload["model/steps"])
    S, max_seq = toks.shape[1], int(payload["model/max_seq"])
    mesh = make_mesh((1, 8), ("data", "model"))
    out = {}
    with sharding.use_mesh(mesh):
        logits, _ = model.forward(params, toks)
        out["model/forward"] = _n(logits)
        logits, caches = model.prefill(params, toks)
        out["model/prefill"] = _n(logits)
        caches = pad_caches(caches, S, max_seq,
                            model.cache_specs(toks.shape[0], max_seq))
        for i in range(steps.shape[0]):
            pos = torch.full((toks.shape[0],), S + i, dtype=torch.int32)
            logits, caches = model.decode_step(params, steps[i], caches, pos)
            out[f"model/decode{i}"] = _n(logits)
    out["model/counts"] = np.asarray([counts["_context_parallel_attention"],
                                      counts["_sharded_decode"]])
    return out


JOBS = {"shard_shapes": shard_shapes, "compress": compress,
        "context_parallel": context_parallel,
        "model_on_mesh": model_on_mesh}
