"""Multi-rank runs of the port on the CPU, for the parallelism tests
(`test_torch_sharding.py`, `test_torch_context_parallel.py`,
`test_torch_expert_parallel.py`, `test_torch_seq_parallel.py`,
`test_torch_wire.py`, `test_torch_mesh_grads.py`,
`test_torch_mesh_train.py`, `test_torch_dryrun_mesh.py`).

`run(jobs, world, workdir, payload)` spawns `world` processes with
`torch.multiprocessing.spawn`; each joins one gloo process group through
a `FileStore` in `workdir` (no TCP port, so concurrent test workers
cannot collide) with a timeout on every collective, pins one thread,
selects the CPU as the package
default, runs every named job of `JOBS` on the numpy `payload` in turn
and saves what it returns. A module spawns its ranks once, for all its
cases. Returns one {name: array} per rank.

This module imports torch and the port only: the ranks import it, and
they never import JAX.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch

COLLECTIVE_TIMEOUT_S = 240


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
    # a collective that waits this long is a hang (ranks issuing their
    # collectives in other orders): it raises, and the test fails
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
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
    """A numpy copy (a later in-place update of `t` leaves it as it is)."""
    return t.detach().float().numpy().copy()


def _whole_logits(lg, vocab: int, B: int):
    """A block program's logits (B/dp, S, V/M or V) of a batch of B rows
    gathered whole."""
    from repro_torch.parallel import sharding
    if lg.shape[-1] != vocab:
        lg = sharding.all_gather(lg, "model", lg.ndim - 1)
    ax = sharding.batch_axes_prefix(B)
    return sharding.all_gather(lg, ax, 0) if ax else lg


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


def _count_block_decodes(counts):
    """Wrap `collectives.blocks_decode` to count its calls into `counts`:
    "blocks_decode/seq" where the cache's positions split over `model`
    (its M > 1), else "blocks_decode/heads"; returns the counts."""
    from repro_torch.parallel import collectives
    fn = collectives.blocks_decode
    counts.update({"blocks_decode/seq": 0, "blocks_decode/heads": 0})

    def wrapped(*a, **kw):
        counts["blocks_decode/seq" if a[6] > 1 else "blocks_decode/heads"] += 1
        return fn(*a, **kw)
    collectives.blocks_decode = wrapped
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
    out.update(_decode_gathers(mesh, args))
    return out


def _decode_gathers(mesh, args):
    """The bytes a rank's all-gathers send in one sequence-sharded
    decode (on `args`) and in one heads-layout decode (KVH 4 over
    model = 4, seeded), each beside its output's bytes; and the heads
    layout's output and caches."""
    from repro_torch.parallel import collectives, sharding
    g = torch.Generator().manual_seed(0)
    B, S, D = 4, 32, 16
    hargs = [torch.randn(sh, generator=g) for sh in (
        (B, 4, 2, D), (B, S, 4, D), (B, S, 4, D), (B, 4, D), (B, 4, D))]
    hargs.append(args[-1])
    sent, gather = [], sharding.all_gather

    def counting(x, axis, dim):
        sent.append(x.numel() * x.element_size())
        return gather(x, axis, dim)
    sharding.all_gather = counting
    try:
        with sharding.use_mesh(mesh):
            o = collectives.seqparallel_decode_attention(*args)[0]
            seq_sent = sum(sent)
            sent.clear()
            h, hk, hv = collectives.seqparallel_decode_attention(
                *hargs, force_local=True)
    finally:
        sharding.all_gather = gather
    return {"cp/gathered": np.asarray([seq_sent, o.numel() * o.element_size(),
                                       sum(sent), h.numel() * h.element_size()]),
            "cp/heads": _n(h), "cp/heads_k": _n(hk), "cp/heads_v": _n(hv),
            **{f"cp/heads_in{i}": _n(t) for i, t in enumerate(hargs)}}


def model_on_mesh(rank, payload):
    """Reduced gemma-2b on a (1, 8) (data, model) mesh, on the
    reference's parameters: `forward`, then `prefill` and decode steps
    on caches padded to payload max_seq (H 4 and KVH 1 over model = 8:
    context parallelism and the sharded decode), each on this rank's
    blocks (the block program), its outputs gathered whole."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding

    counts = _count_block_decodes(_counting(("cp_block_attention",)))
    model = build_model(reduced(get_config("gemma-2b")))
    specs = model.param_specs()
    params = params_from_numpy(tree.unflatten(specs, [
        payload[f"param/{k}"] for k, _ in tree.flatten_with_keys(specs)]),
        "cpu", model=model)
    toks, steps = _t(payload["model/toks"]), _t(payload["model/steps"])
    S, max_seq = toks.shape[1], int(payload["model/max_seq"])
    mesh = make_mesh((1, 8), ("data", "model"))
    out = {}
    V, B = model.cfg.vocab_size, toks.shape[0]
    with sharding.use_mesh(mesh):
        # the block program: this rank's blocks in, its blocks out
        params = sharding.shard_tree(params, specs)
        rows = sharding.rows(toks)
        logits, _ = model.forward(params, rows)
        out["model/forward"] = _n(_whole_logits(logits, V, B))
        logits, caches = model.prefill(params, rows)
        out["model/prefill"] = _n(_whole_logits(logits, V, B))
        caches = model.decode_caches(caches, B, S, max_seq)
        for i in range(steps.shape[0]):
            pos = torch.full((rows.shape[0],), S + i, dtype=torch.int32)
            logits, caches = model.decode_step(
                params, sharding.rows(steps[i]), caches, pos)
            out[f"model/decode{i}"] = _n(_whole_logits(logits, V, B))
    out["model/counts"] = np.asarray([counts["cp_block_attention"],
                                      counts["blocks_decode/seq"]])
    return out


# -- slice 8c / 8d -------------------------------------------------------------
def _tree(payload, prefix, specs):
    """The tree of `specs`' structure whose leaves are payload's
    f"{prefix}{key}" arrays, as CPU tensors."""
    from repro_torch import tree
    from repro_torch.convert import tree_from_numpy
    return tree_from_numpy(tree.unflatten(specs, [
        payload[prefix + k] for k, _ in tree.flatten_with_keys(specs)]),
        "cpu")


def _count_calls(module, names, counts=None):
    """Wrap `module.<name>` to count its calls into `counts` (a new dict
    by default); returns the counts."""
    counts = {} if counts is None else counts
    for n in names:
        counts[n] = 0
        fn = getattr(module, n)

        def wrapped(*a, _fn=fn, _n=n, **kw):
            counts[_n] += 1
            return _fn(*a, **kw)
        setattr(module, n, wrapped)
    return counts


def _record_drops(moe):
    """Wrap `moe._dispatch_indices` to list each call's dropped real
    assignments (ids below the dummy expert, past capacity)."""
    drops = []
    fn = moe._dispatch_indices

    def wrapped(idx, w, E, C):
        slot, keep = fn(idx, w, E, C)
        drops.append(int((~keep & (idx < E - 1)).sum()))
        return slot, keep
    moe._dispatch_indices = wrapped
    return drops


def expert_parallel(rank, payload):
    """Reduced granite-moe's MoE layer on the reference's parameters:
    `_moe_a2a` and `_moe_replicated` on a (2, 4) (data, model) mesh at a
    capacity factor of 8 (no drops), without and with FSDP weights; both
    at a factor that drops, with each rank's drops; and EP over (model,
    data) on (2, 2) — two (2, 2) meshes side by side on a (2, 2, 2)
    ("rep", data, model) mesh, `rep` named by no rule."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.parallel import sharding

    cfg = reduced(get_config("granite-moe-1b-a400m"))
    params = _tree(payload, "ep/param/", moe.moe_spec(cfg))
    x, xd = _t(payload["ep/x"]), _t(payload["ep/x_drop"])
    counts = _count_calls(moe, ("_moe_a2a", "_moe_replicated"))
    drops = _record_drops(moe)
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for name, kw in (("a2a", dict(fsdp=False)),
                     ("rep", dict(fsdp=False, moe_impl="replicated")),
                     ("fsdp", dict(fsdp=True))):
        with sharding.use_mesh(mesh, capacity_factor=8.0, **kw):
            out[f"ep/{name}"] = _n(moe.moe_apply(params, x, cfg)[0])
    assert not any(drops), drops
    for cf in payload["ep/drop_cfs"].tolist():
        for impl in ("a2a", "replicated"):
            del drops[:]
            with sharding.use_mesh(mesh, fsdp=False, moe_impl=impl,
                                   capacity_factor=cf):
                out[f"ep/drop/{cf}/{impl}"] = _n(
                    moe.moe_apply(params, xd, cfg)[0])
            out[f"ep/drop/{cf}/{impl}/drops"] = np.asarray(drops)
    mesh2 = make_mesh((2, 2, 2), ("rep", "data", "model"))
    for impl in ("a2a", "replicated"):
        with sharding.use_mesh(mesh2, fsdp=False, ep_over_data=True,
                               moe_impl=impl, capacity_factor=8.0):
            out[f"ep/epd/{impl}"] = _n(moe.moe_apply(params, x, cfg)[0])
    out["ep/counts"] = np.asarray([counts["_moe_a2a"],
                                   counts["_moe_replicated"]])
    return out


def _model(arch):
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.registry import build_model
    return build_model(reduced(get_config(arch)))


def seq_parallel(rank, payload):
    """Megatron-SP on the reference's parameters: reduced granite-moe's
    and deepseek-v3's `forward` with `seq_parallel` on a (2, 4) mesh (the
    block program: the rank's blocks and rows, the logits gathered);
    stablelm-12b's attention block through `attn_apply_sp` on (2, 4)
    (its 2 kv heads sliced) and (4, 2) (kv heads sharded); a dense
    FFN's two SP bodies, with and without FSDP; head-TP `attend` (kv
    heads grouped and repeated); and stablelm's prefill and decode steps
    with the "heads" cache layout on (4, 2)."""
    from repro_torch import tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ffn, mla, transformer
    from repro_torch.parallel import collectives, sharding

    counts = _count_calls(transformer, ("attn_apply_sp",))
    _count_calls(mla, ("mla_forward_sp",), counts)
    _count_calls(ffn, ("_ffn_apply_wg", "_ffn_apply_sp"), counts)
    _count_calls(collectives, ("_head_tp_attention",
                               "head_tp_block_attention"), counts)
    _count_block_decodes(counts)
    m24 = make_mesh((2, 4), ("data", "model"))
    m42 = make_mesh((4, 2), ("data", "model"))
    out = {}

    def snap(key):
        out[f"sp/counts/{key}"] = np.asarray([counts[n] for n in sorted(
            counts)])
    for arch in ("granite-moe-1b-a400m", "deepseek-v3-671b"):
        model = _model(arch)
        specs = model.param_specs()
        params = _tree(payload, f"sp/{arch}/param/", specs)
        toks = _t(payload["sp/tokens"])
        V, B = model.cfg.vocab_size, toks.shape[0]
        with sharding.use_mesh(m24, fsdp=False, seq_parallel=True,
                               capacity_factor=8.0):
            # the block program: this rank's blocks in, its blocks out
            logits, extras = model.forward(sharding.shard_tree(params, specs),
                                           sharding.rows(toks))
            out[f"sp/{arch}/forward"] = _n(_whole_logits(logits, V, B))
            if "mtp_logits" in extras:
                out[f"sp/{arch}/mtp"] = _n(_whole_logits(
                    extras["mtp_logits"], V, B))
        snap(arch)
    model = _model("stablelm-12b")
    cfg = model.cfg
    params = _tree(payload, "sp/stablelm-12b/param/", model.param_specs())
    attn = tree.map(lambda a: a[0], params["groups"][0]["b0"]["attn"])
    x, positions = _t(payload["sp/attn_x"]), _t(payload["sp/attn_pos"])
    for name, mesh in (("m24", m24), ("m42", m42)):
        with sharding.use_mesh(mesh, seq_parallel=True):
            y, _ = transformer.attn_apply(attn, x, positions, cfg)
        out[f"sp/attn/{name}"] = _n(y)
        snap(f"attn/{name}")
    fp = _tree(payload, "sp/ffn/param/", ffn.ffn_spec(64, 128, "swiglu"))
    for fsdp in (False, True):
        for xs in ("long", "short"):
            with sharding.use_mesh(m24, fsdp=fsdp):
                y = ffn.ffn_apply(fp, _t(payload[f"sp/ffn_x/{xs}"]),
                                  "swiglu", sp=True)
            out[f"sp/ffn/{int(fsdp)}/{xs}"] = _n(y)
            snap(f"ffn/{int(fsdp)}/{xs}")
    for lay in ("grouped", "repeated"):
        q, k, v = (_t(payload[f"sp/tp/{lay}/{n}"]) for n in "qkv")
        with sharding.use_mesh(m24):
            out[f"sp/tp/{lay}"] = _n(collectives.attend(q, k, v))
        snap(f"tp/{lay}")
    toks, steps = _t(payload["sp/dec/toks"]), _t(payload["sp/dec/steps"])
    S, max_seq = toks.shape[1], int(payload["sp/dec/max_seq"])
    V, B = cfg.vocab_size, toks.shape[0]
    with sharding.use_mesh(m42, decode_layout="heads"):
        # the block program: this rank's blocks in, its blocks out
        blocks = sharding.shard_tree(params, model.param_specs())
        rows = sharding.rows(toks)
        logits, caches = model.prefill(blocks, rows)
        out["sp/dec/prefill"] = _n(_whole_logits(logits, V, B))
        caches = model.decode_caches(caches, B, S, max_seq)
        for i in range(steps.shape[0]):
            pos = torch.full((rows.shape[0],), S + i, dtype=torch.int32)
            logits, caches = model.decode_step(
                blocks, sharding.rows(steps[i]), caches, pos)
            out[f"sp/dec/decode{i}"] = _n(_whole_logits(logits, V, B))
    snap("dec")
    out["sp/count_names"] = np.asarray(sorted(counts))
    return out


def wire(rank, payload):
    """`tx_engine.transmit` (direct, int8) and `transmit_staged` of the
    reference test's (2, 8, 16) tensor and a cache tree, and
    `KVTransferEngine.make_transfer_step` both ways, on a (2, 2, 2)
    (pod, data, model) mesh; the bytes each rank's permutes moved."""
    from repro_torch import tree
    from repro_torch.core import kvtransfer, tx_engine
    from repro_torch.core.descriptors import TransferPlan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.module import Spec
    from repro_torch.parallel import sharding

    moved = {"n": 0}
    permute = tx_engine._permute_leaf

    def counted(x, spec, axis, shift):
        moved["n"] += sharding._block(x, spec).nbytes
        return permute(x, spec, axis, shift)
    tx_engine._permute_leaf = counted
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    x = _t(payload["wire/x"])
    spec = {"k": Spec(tuple(x.shape), ("batch", "kv_seq", None))}
    plan = TransferPlan(axis="pod", shift=1)
    plan8 = TransferPlan(axis="pod", shift=1, quantize_bits=8)
    out = {}
    with sharding.use_mesh(mesh):
        for name, fn, pl in (("direct", tx_engine.transmit, plan),
                             ("staged", tx_engine.transmit_staged, plan),
                             ("int8", tx_engine.transmit, plan8)):
            moved["n"] = 0
            out[f"wire/{name}"] = _n(fn({"k": x}, spec, pl)["k"])
            out[f"wire/{name}/bytes"] = np.asarray(moved["n"])
        eng = kvtransfer.KVTransferEngine(_model("gemma-2b"), 2, 16, plan)
        try:
            caches = _tree(payload, "wire/cache/", eng.spec_tree)
            for staged in (False, True):
                got = eng.make_transfer_step(staged=staged)(caches)
                for k, a in tree.flatten_with_keys(got):
                    out[f"wire/step/{int(staged)}/{k}"] = _n(a)
        finally:
            eng.close()
    return out


# -- slice 8e -----------------------------------------------------------------
def _grad_case(fn, inputs: dict, params, ct, aux=None):
    """The output of `fn(inputs..., params)` and the gradients of
    sum(out * ct) (+ the aux term fn returns second, where `aux`) with
    respect to every input and parameter leaf, keyed "in/<name>" and
    "param/<keypath>"."""
    from repro_torch import tree
    xs = {k: v.clone().requires_grad_(v.is_floating_point())
          for k, v in inputs.items()}
    ps = tree.map(lambda a: a.clone().requires_grad_(True), params)
    with torch.enable_grad():
        y = fn(xs, ps)
        loss = (y[0] * ct).sum() + y[1] if aux else (y * ct).sum()
        want = [(f"in/{k}", v) for k, v in xs.items() if v.requires_grad]
        want += [(f"param/{k}", v) for k, v in tree.flatten_with_keys(ps)]
        got = torch.autograd.grad(loss, [v for _, v in want])
    out = {"out": _n(y[0] if aux else y)}
    out.update({k: _n(g) for (k, _), g in zip(want, got)})
    return out


def mesh_grads(rank, payload):
    """Each sharded branch that training runs, differentiated on the
    reference's inputs, cotangent and parameters (`MG_CASES` of
    `test_torch_mesh_grads.py`: their meshes and flags): the output, the
    gradient of every input and parameter, the branches called and the
    MoE's dropped assignments on this rank."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ffn, mla, moe, transformer
    from repro_torch.parallel import collectives, sharding

    counts = _count_calls(collectives, ("_head_tp_attention",
                                        "_context_parallel_attention"))
    _count_calls(ffn, ("_ffn_apply_wg", "_ffn_apply_sp"), counts)
    _count_calls(moe, ("_moe_a2a", "_moe_replicated"), counts)
    _count_calls(mla, ("mla_forward_sp",), counts)
    _count_calls(transformer, ("attn_apply_sp",), counts)
    drops = _record_drops(moe)
    meshes = {"m24": make_mesh((2, 4), ("data", "model")),
              "m222": make_mesh((2, 2, 2), ("rep", "data", "model"))}
    cfgs = {a: reduced(get_config(a)) for a in (
        "granite-moe-1b-a400m", "deepseek-v3-671b", "stablelm-12b")}
    fns = {
        "attend": lambda x, p: collectives.attend(x["q"], x["k"], x["v"]),
        "ffn": lambda x, p: ffn.ffn_apply(p, x["x"], "swiglu", sp=True),
        "moe": lambda x, p: moe.moe_apply(
            p, x["x"], cfgs["granite-moe-1b-a400m"]),
        "mla": lambda x, p: mla.mla_forward_sp(
            p, x["x"], x["pos"], cfgs["deepseek-v3-671b"]),
        "attn": lambda x, p: transformer.attn_apply(
            p, x["x"], x["pos"], cfgs["stablelm-12b"])[0],
    }
    out = {}
    for case in payload["mg/cases"].tolist():
        pre = f"mg/{case}/"
        kind, mesh = str(payload[pre + "kind"]), str(payload[pre + "mesh"])
        flags = {k: v.item() for k, v in (
            (k[len(pre) + 5:], payload[k]) for k in payload
            if k.startswith(pre + "flag/"))}
        inputs = {k[len(pre) + 3:]: _t(v) for k, v in payload.items()
                  if k.startswith(pre + "in/")}
        pkeys = sorted(k for k in payload if k.startswith(pre + "param/"))
        params = {}
        for k in pkeys:                 # the nested dicts of the keypaths
            d = params
            *path, leaf = k[len(pre) + 6:].split("/")
            for part in path:
                d = d.setdefault(part, {})
            d[leaf] = _t(payload[k])
        before = dict(counts)
        del drops[:]
        with sharding.use_mesh(meshes[mesh], **flags):
            got = _grad_case(fns[kind], inputs, params, _t(payload[pre + "ct"]),
                             aux=kind == "moe")
        out.update({pre + k: v for k, v in got.items()})
        out[pre + "calls"] = np.asarray(sorted(
            n for n in counts if counts[n] > before[n]))
        out[pre + "drops"] = np.asarray(sum(drops))
    return out


def mesh_train(rank, payload):
    """The sharded train step on a (2, 2, 2) (pod, data, model) mesh, on
    the conditioned copies of the reference's parameters and its
    batches, for each arch of payload["mt/archs"] (remat on for those of
    payload["mt/remat"]): the whole gradient of the first batch, two
    steps' losses and grad norms and the parameters after each; for
    granite-moe the loss, aux loss and whole gradient on (2, 4, 1) (a
    model axis of 1); for gemma-2b the whole gradient at microbatches=2 on (2, 2, 2) (each
    microbatch split over pod alone) and the same and a step on (1, 2, 4)
    (split over data), and its
    state after the two steps checkpointed on (2, 2, 2), restored on
    (1, 2, 4) and stepped once there and on (2, 2, 2) (the second
    moments after that step too)."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding
    from repro_torch.train import optimizer as optim
    from repro_torch.train import train_loop
    from repro_torch.train.checkpoint import Checkpointer

    m222 = make_mesh((2, 2, 2), ("pod", "data", "model"))
    m124 = make_mesh((1, 2, 4), ("pod", "data", "model"))
    m241 = make_mesh((2, 4, 1), ("pod", "data", "model"))
    opt_cfg = optim.OptConfig(**{k: payload[f"mt/opt/{k}"].item() for k in (
        "lr", "warmup_steps", "weight_decay")})
    remat = set(payload["mt/remat"].tolist())
    out = {}

    def put(prefix, t):
        out.update({prefix + k: _n(a) for k, a in tree.flatten_with_keys(t)})

    for arch in payload["mt/archs"].tolist():
        cfg = reduced(get_config(arch))
        if arch in remat:
            cfg = dataclasses.replace(cfg, remat=True)
        model = build_model(cfg)
        pre = f"mt/{arch}/"

        def params():
            return _tree(payload, pre + "param/", model.param_specs())
        batches = [{k: _t(payload[f"{pre}batch{i}/{k}"]) for k in (
            "tokens", "labels", "embeddings")
            if f"{pre}batch{i}/{k}" in payload} for i in range(3)]
        pspecs = model.param_specs()
        with sharding.use_mesh(m222):
            # the block program takes this rank's blocks and rows and
            # gives its gradient blocks, gathered whole here
            blocks = sharding.runs_blocks(cfg)

            def cut(p):
                return sharding.shard_tree(p, pspecs) if blocks else p

            def rows(b, microbatches=1):
                return sharding.rows(b, microbatches) if blocks else b

            def gathered(g):
                return sharding.unshard_tree(g, pspecs) if blocks else g
            (loss, _), grads = train_loop.make_grads_fn(model, cfg)(
                cut(params()), rows(batches[0]))
            put(pre + "grad/", gathered(grads))
            out[pre + "loss0"] = _n(loss)
            p0 = params()
            state = train_loop.shard_train_state(
                model, opt_cfg, p0, optim.init_opt_state(p0, opt_cfg))
            out[pre + "block_shapes"] = np.asarray(
                [list(a.shape) + [0] * (4 - a.ndim)
                 for a in tree.leaves(state[0])])
            step = train_loop.jit_train_step(model, cfg, opt_cfg)
            losses, norms = [], []
            for i in range(2):
                *state, m = step(*state, rows(batches[i]))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                whole = train_loop.unshard_train_state(model, opt_cfg,
                                                       *state)
                put(pre + f"step{i + 1}/", whole[0])
            out[pre + "losses"] = np.asarray(losses)
            out[pre + "gnorms"] = np.asarray(norms)
            if arch == "granite-moe-1b-a400m":
                # a model axis of 1: `_moe_local` on the rank's rows
                with sharding.use_mesh(m241):
                    (loss, mets), grads = train_loop.make_grads_fn(
                        model, cfg)(cut(params()), rows(batches[0]))
                    put(pre + "m1grad/", gathered(grads))
                out[pre + "m1/loss"] = _n(loss)
                out[pre + "m1/moe_aux"] = _n(mets["moe_aux"])
            if arch != "gemma-2b":
                continue
            p0 = params()
            # on (2, 2, 2): a microbatch of two rows splits over pod alone
            # and stays whole over data, as GSPMD lays it out
            (_, mets), grads = train_loop.make_grads_fn(
                model, cfg, microbatches=2)(cut(p0), rows(batches[0], 2))
            put(pre + "mb2grad222/", gathered(grads))
            out[pre + "mb2chunks"] = np.asarray(mets["chunks"])
            # on (1, 2, 4): each microbatch's two rows split over data
            with sharding.use_mesh(m124):
                _, grads = train_loop.make_grads_fn(
                    model, cfg, microbatches=2)(cut(p0), rows(batches[0], 2))
                put(pre + "mb2grad/", gathered(grads))
                mb = train_loop.jit_train_step(model, cfg, opt_cfg,
                                               microbatches=2)
                mstate = train_loop.shard_train_state(
                    model, opt_cfg, p0, optim.init_opt_state(p0, opt_cfg))
                *mstate, m = mb(*mstate, rows(batches[0], 2))
                out[pre + "mb2/loss"] = _n(m["loss"])
                put(pre + "mb2/", train_loop.unshard_train_state(
                    model, opt_cfg, *mstate)[0])
            specs = train_loop.state_specs(model, opt_cfg)
            ck = Checkpointer(str(payload["mt/ckpt_dir"]))
            ck.save(2, {"params": state[0], "opt": state[1]},
                    spec_tree=specs)
            ck.close()
            *state, m = step(*state, rows(batches[2]))
            out[pre + "step3/loss"] = _n(m["loss"])
            p3, o3 = train_loop.unshard_train_state(model, opt_cfg, *state)
            put(pre + "step3/", p3)
            put(pre + "v3/", o3["v"])
        # the checkpoint of (2, 2, 2) resumed on (1, 2, 4)
        with sharding.use_mesh(m124):
            template = train_loop.shard_train_state(model, opt_cfg, *whole)
            _, got = Checkpointer(str(payload["mt/ckpt_dir"])).restore(
                {"params": template[0], "opt": template[1]},
                spec_tree=specs)
            put(pre + "m124/restored/", train_loop.unshard_train_state(
                model, opt_cfg, got["params"], got["opt"])[0])
            step = train_loop.jit_train_step(model, cfg, opt_cfg)
            *state, m = step(got["params"], got["opt"],
                             sharding.rows(batches[2]) if blocks
                             else batches[2])
            out[pre + "m124/loss"] = _n(m["loss"])
            put(pre + "m124/step3/", train_loop.unshard_train_state(
                model, opt_cfg, *state)[0])
    return out


def mesh_cli(rank, payload):
    """`launch.train.main` with `--mesh 2x2x2` on the CPU, as `torchrun`
    would start it on each rank (the process group already made): a run
    checkpointing every payload["cli/every"] steps, and the same run
    failing at payload["cli/fail_at"] and restarting from its latest
    checkpoint; each run's losses and its final parameters."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding
    from repro_torch.train import optimizer as optim
    from repro_torch.train import train_loop

    argv = [str(a) for a in payload["cli/argv"].tolist()]
    out = {}
    for name, extra in (("whole", []),
                        ("failed", ["--fail-at", str(payload["cli/fail_at"])])):
        state, hist = launch_train.main(
            argv + ["--ckpt-dir", f"{payload['cli/dir']}/{name}"] + extra)
        out[f"cli/{name}/steps"] = np.asarray([s for s, _ in hist])
        out[f"cli/{name}/losses"] = np.asarray([float(m["loss"])
                                                for _, m in hist])
        # the blocks gathered whole on the run's mesh
        model = build_model(reduced(get_config(argv[argv.index("--arch")
                                                     + 1])))
        opt_cfg = optim.OptConfig()
        with sharding.use_mesh(make_mesh((2, 2, 2), ("pod", "data",
                                                      "model"))):
            whole = train_loop.unshard_train_state(
                model, opt_cfg, state["params"], state["opt"])
        out.update({f"cli/{name}/param/{k}": _n(a)
                    for k, a in tree.flatten_with_keys(whole[0])})
        out[f"cli/{name}/step"] = _n(whole[1]["step"])
    return out


# -- the dry-run ---------------------------------------------------------------
def dryrun_cell(rank, payload):
    """The dry-run's sharded cells run for real: the sharded train step
    of each reduced arch of payload["dr/archs"] on a (2, 2, 2) (pod,
    data, model) mesh, on a seeded batch of payload["dr/batch"] x
    payload["dr/seq"] tokens (and a frontend's seeded embeddings),
    under `hlo_cost.Trace`: the collectives
    this rank issued (their wire bytes and counts by op) and the step's
    FLOPs, under "dr/<arch>/"."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding
    from repro_torch.train import optimizer as optim
    from repro_torch.train import train_loop
    from repro_torch.utils import hlo_cost

    out = {}
    for arch in payload["dr/archs"].tolist():
        cfg = reduced(get_config(arch))
        model = build_model(cfg)
        opt_cfg = optim.OptConfig()
        params = model.init(torch.Generator().manual_seed(0))
        B, S = int(payload["dr/batch"]), int(payload["dr/seq"])
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                 (B, S + 1))
        batch = {"tokens": _t(toks[:, :-1].astype(np.int32)),
                 "labels": _t(toks[:, 1:].astype(np.int32))}
        if cfg.frontend.kind != "none":
            batch["embeddings"] = _t(np.random.default_rng(1).standard_normal(
                (B, cfg.frontend.n_tokens, cfg.frontend.d_input)).astype(
                    np.float32))
        with sharding.use_mesh(make_mesh((2, 2, 2), ("pod", "data",
                                                      "model"))):
            state = train_loop.shard_train_state(
                model, opt_cfg, params, optim.init_opt_state(params,
                                                             opt_cfg))
            step = train_loop.jit_train_step(model, cfg, opt_cfg)
            with hlo_cost.Trace() as t:
                step(*state, sharding.rows(batch))   # the block program
        res = t.result()
        coll = res["collective"]
        ops = sorted(coll["counts"])
        pre = f"dr/{arch}/"
        out.update({pre + "ops": np.asarray(ops),
                    pre + "counts": np.asarray([coll["counts"][o]
                                                for o in ops]),
                    pre + "per_op_bytes": np.asarray(
                        [coll["per_op_bytes"][o] for o in ops]),
                    pre + "wire_bytes": np.asarray(coll["wire_bytes"]),
                    pre + "flops": np.asarray(res["flops"])})
    return out


# -- slice 15: the block program ---------------------------------------------
def block_cfg(arch: str, kw_json: str):
    """A reduced config with the fields of `kw_json` replaced (an entry
    that is a dict, such as "moe" or "frontend", the fields of that
    nested config)."""
    import dataclasses
    import json

    from repro_torch.configs.base import get_config, reduced
    cfg = reduced(get_config(arch))
    kw = {k: dataclasses.replace(getattr(cfg, k), **v)
          if isinstance(v, dict) else v
          for k, v in json.loads(kw_json).items()}
    return dataclasses.replace(cfg, **kw)


def _record_assignments(moe):
    """Wrap `moe._dispatch_indices` to list, while `on` holds a list,
    each call's expert ids and whether each assignment kept its slot;
    returns (the switch, the original function)."""
    on = [None]
    fn = moe._dispatch_indices

    def wrapped(idx, w, E, C):
        slot, keep = fn(idx, w, E, C)
        if on[0] is not None:
            on[0].append([idx.tolist(), keep.tolist()])
        return slot, keep
    moe._dispatch_indices = wrapped
    return on, fn


def blocks(rank, payload):
    """The block program on a (2, 2, 2) (pod, data, model) mesh, for each
    case of payload["bl/cases"] (a reduced config with fields replaced,
    on the conditioned copy of the reference's parameters): the first
    batch's loss (and an MoE's aux loss and MTP loss) and this rank's
    gradient blocks (and the gradient gathered whole), two
    `jit_train_step`s (the parameters after each, gathered whole), the
    prefill's last logits and caches and one decode step's logits
    (gathered whole); and the shapes a rank's step holds: the residual
    stream entering each layer, the FFN hidden and the logits; with
    Megatron-SP (a case's fourth field "1") the SP bodies its steps
    called. An MoE case also gives one forward's MTP logits (gathered
    whole) and its assignments (each dispatch's expert ids and kept
    slots, as JSON); with a fifth field "1", the loss, aux loss,
    gradient (gathered whole) and assignments of `make_grads_fn(
    microbatches=2)` on the rank's share of each microbatch. The shapes
    also list the mixers' inner activations (mamba2's scan input, the
    RG-LRU scan's) and, for the encoder-decoder, the residual stream
    entering every encoder and decoder layer; "in_place" counts the
    logits contracted in place (`layers._unembed_in_place`),
    "rows_in_place" the projections that kept their weights in place
    (`sharding.matmul_block` under `rows_in_place`). A sixth field
    plants a fault: "1" mamba2's gated norm without the psum of its sum
    of squares over `model`, "bias" the FFN's down bias added on every
    rank of `model` before the psum. A seventh, a JSON dict, goes to
    `sharding.use_mesh` (`ep_over_data`, `moe_impl`)."""
    import json

    from repro_torch import tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import (encdec, ffn, mla, moe, rglru, ssm,
                                    transformer)
    from repro_torch.models import module as mod
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding
    from repro_torch.train import optimizer as optim
    from repro_torch.train import train_loop

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    opt_cfg = optim.OptConfig(**{k: payload[f"bl/opt/{k}"].item() for k in (
        "lr", "warmup_steps", "weight_decay")})
    from repro_torch.models import layers
    seen = {"residual": set(), "hidden": set(), "inner": set()}
    in_place_fn, in_place = layers._unembed_in_place, [0, 0]
    matmul_fn = sharding.matmul_block

    def unembed_in_place(*a, **kw):
        in_place[0] += 1
        return in_place_fn(*a, **kw)

    def matmul_block(*a, **kw):
        in_place[1] += getattr(sharding.current(), "in_place", False)
        return matmul_fn(*a, **kw)
    layers._unembed_in_place = unembed_in_place
    sharding.matmul_block = matmul_block
    block_fn, hidden_fn = transformer.superblock_apply, ffn.hidden
    scan_fns = {ssm: ssm.ssd_chunked, rglru: rglru.rglru_scan}
    inner_psum = ssm._inner_psum

    def inner(mod, name):
        def call(x, *a, **kw):
            seen["inner"].add(tuple(x.shape))
            return scan_fns[mod](x, *a, **kw)
        setattr(mod, name, call)
    inner(ssm, "ssd_chunked")
    inner(rglru, "rglru_scan")
    sp_names = ("attn_apply_sp", "_ffn_apply_sp", "_ffn_apply_wg",
                "mla_forward_sp")
    sp_mods = {"attn_apply_sp": transformer, "mla_forward_sp": mla}
    sp_fns = {n: getattr(sp_mods.get(n, ffn), n) for n in sp_names}
    sp_calls = []

    def sp_counted(name):
        def call(*a, **kw):
            if name not in sp_calls:
                sp_calls.append(name)
            return sp_fns[name](*a, **kw)
        return call
    for n in sp_names:
        setattr(sp_mods.get(n, ffn), n, sp_counted(n))

    def residual(params, x, *a, **kw):
        seen["residual"].add(tuple(x.shape))
        return block_fn(params, x, *a, **kw)
    layer_fns = {"_enc_layer": encdec._enc_layer,
                 "_dec_layer": encdec._dec_layer}

    def enc_dec_residual(name):
        def call(p, x, *a, **kw):
            seen["residual"].add(tuple(x.shape))
            return layer_fns[name](p, x, *a, **kw)
        return call
    for n in layer_fns:
        setattr(encdec, n, enc_dec_residual(n))
    row_out = ffn._row_parallel_out

    def bias_before_psum(y, down, split: bool):
        y = ffn._biased(y, down)
        return sharding.psum(y, "model") if split else y

    def hidden(*a, **kw):
        h = hidden_fn(*a, **kw)
        seen["hidden"].add(tuple(h.shape))
        return h
    transformer.superblock_apply, ffn.hidden = residual, hidden
    assignments, dispatch_fn = _record_assignments(moe)
    out = {}

    def put(prefix, t):
        out.update({prefix + k: _n(a) for k, a in tree.flatten_with_keys(t)})
    try:
        for case, arch, kw, sp, mb, *rest in payload["bl/cases"].tolist():
            fault = rest[0] if rest else "0"
            mesh_kw = json.loads(rest[1]) if len(rest) > 1 else {}
            cfg = block_cfg(arch, kw)
            sp_calls.clear()
            ssm._inner_psum = (lambda t: t) if fault == "1" else inner_psum
            ffn._row_parallel_out = (bias_before_psum if fault == "bias"
                                     else row_out)
            in_place[:] = [0, 0]
            model = build_model(cfg)
            specs = model.param_specs()
            pre = f"bl/{case}/"
            whole = _tree(payload, pre + "param/", specs)
            batches = [{k: _t(payload[f"{pre}batch{i}/{k}"]) for k in (
                "tokens", "labels", "embeddings")
                if f"{pre}batch{i}/{k}" in payload} for i in range(2)]
            B, S = batches[0]["tokens"].shape
            V = cfg.vocab_size
            with sharding.use_mesh(mesh, seq_parallel=sp == "1", **mesh_kw):
                assert sharding.runs_blocks(cfg)
                params = sharding.shard_tree(whole, specs)
                rows = [sharding.rows(b) for b in batches]
                for v in seen.values():
                    v.clear()
                (loss, mets), grads = train_loop.make_grads_fn(model, cfg)(
                    params, rows[0])
                out[pre + "loss0"] = _n(loss)
                for k in ("moe_aux", "mtp_ce"):
                    if k in mets:
                        out[pre + k + "0"] = _n(mets[k])
                put(pre + "gblock/", grads)
                put(pre + "grad/", sharding.unshard_tree(grads, specs))
                out[pre + "shapes/residual"] = np.asarray(
                    sorted(seen["residual"]))
                out[pre + "shapes/hidden"] = np.asarray(
                    sorted(seen["hidden"]))
                out[pre + "shapes/inner"] = np.asarray(
                    sorted(seen["inner"]) or [[0]])
                assignments[0] = [] if cfg.moe is not None else None
                logits, extras = model.forward(params, rows[0]["tokens"],
                                               embeddings=rows[0].get(
                                                   "embeddings"))
                out[pre + "shapes/logits"] = np.asarray(logits.shape)
                if cfg.moe is not None:
                    out[pre + "assignments"] = np.asarray(json.dumps(
                        sorted(assignments[0])))
                    assignments[0] = None
                if "mtp_logits" in extras:
                    out[pre + "mtp"] = _n(_whole_logits(
                        extras["mtp_logits"], V, B))
                if mb == "1":
                    assignments[0] = []
                    (loss, mets), grads = train_loop.make_grads_fn(
                        model, cfg, microbatches=2, batch=B)(
                            params, sharding.rows(batches[0], 2))
                    out[pre + "mb2/assignments"] = np.asarray(json.dumps(
                        sorted(assignments[0])))
                    assignments[0] = None
                    out[pre + "mb2/loss"] = _n(loss)
                    out[pre + "mb2/moe_aux"] = _n(mets["moe_aux"])
                    out[pre + "mb2/chunks"] = np.asarray(mets["chunks"])
                    put(pre + "mb2grad/", sharding.unshard_tree(grads,
                                                                specs))
                state = train_loop.shard_train_state(
                    model, opt_cfg, whole, optim.init_opt_state(whole,
                                                                opt_cfg))
                step = train_loop.jit_train_step(model, cfg, opt_cfg)
                losses, norms = [], []
                for i in range(2):
                    *state, m = step(*state, rows[i])
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                    put(pre + f"step{i + 1}/", train_loop.unshard_train_state(
                        model, opt_cfg, *state)[0])
                out[pre + "losses"] = np.asarray(losses)
                out[pre + "gnorms"] = np.asarray(norms)
                logits, caches = model.prefill(
                    params, rows[0]["tokens"],
                    embeddings=rows[0].get("embeddings"))
                out[pre + "prefill"] = _n(_whole_logits(logits, V, B))
                max_seq = int(payload["bl/max_seq"])
                dec = model.decode_caches(caches, B, S, max_seq)
                # each leaf cut back to its prefill-length spec's shape
                put(pre + "cache/", tree.map(
                    lambda s_, a: a[tuple(slice(0, n) for n in s_.shape)],
                    model.cache_specs(B, S), sharding.unshard_tree(
                        dec, model.cache_specs(B, max_seq)),
                    is_leaf=mod.is_spec))
                tok = sharding.rows(_t(payload[pre + "step_tokens"]))
                pos = torch.full((tok.shape[0],), S, dtype=torch.int32)
                logits, _ = model.decode_step(params, tok, dec, pos)
                out[pre + "decode"] = _n(_whole_logits(logits, V, B))
            out[pre + "sp_calls"] = np.asarray(sp_calls or [""])
            out[pre + "in_place"] = np.asarray(in_place[0])
            out[pre + "rows_in_place"] = np.asarray(in_place[1])
    finally:
        moe._dispatch_indices = dispatch_fn
        transformer.superblock_apply, ffn.hidden = block_fn, hidden_fn
        ssm.ssd_chunked, rglru.rglru_scan = scan_fns[ssm], scan_fns[rglru]
        ssm._inner_psum = inner_psum
        ffn._row_parallel_out = row_out
        for n, fn in layer_fns.items():
            setattr(encdec, n, fn)
        layers._unembed_in_place = in_place_fn
        sharding.matmul_block = matmul_fn
        for n in sp_names:
            setattr(sp_mods.get(n, ffn), n, sp_fns[n])
    return out


def phase16(rank, payload):
    """`chip_smoke.py`'s phase 16 at CPU size (`BLOCKS_CPU`) on real
    ranks: each arch's inputs (`blocks_inputs`, float32) through
    `blocks_prep` and `blocks_steps` on a (data 2, model 4) mesh of the 8
    gloo ranks; this rank's outputs (its blocks)."""
    import sys
    from pathlib import Path

    from repro_torch import tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    Z = cs.BLOCKS_CPU
    dev = torch.device("cpu")
    out = {}
    for arch, kw in Z.archs:
        cfg = cs.blocks_cfg(arch, kw, Z, "float32")
        model, whole, batch, tokens = cs.blocks_inputs(torch, cfg, Z, dev)
        with sharding.use_mesh(make_mesh((Z.data, Z.model), cs.BLOCK_AXES)):
            prep = cs.blocks_prep(torch, model, whole, batch, tokens, Z,
                                  decode=True)
            got = cs.blocks_steps(torch, model, cfg, prep, Z)
        out.update({f"p16/{arch}/{k}": _n(a)
                    for k, a in tree.flatten_with_keys(got)})
    return out


JOBS = {"shard_shapes": shard_shapes, "compress": compress,
        "context_parallel": context_parallel,
        "model_on_mesh": model_on_mesh, "expert_parallel": expert_parallel,
        "seq_parallel": seq_parallel, "wire": wire,
        "mesh_grads": mesh_grads, "mesh_train": mesh_train,
        "mesh_cli": mesh_cli, "dryrun_cell": dryrun_cell,
        "blocks": blocks, "phase16": phase16}
