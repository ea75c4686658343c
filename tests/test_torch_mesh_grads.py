"""Gradients through the port's sharded branches on 8 gloo ranks, held
against `jax.grad` through the JAX package's `shard_map` regions, and
the "dots" remat policy against "nothing" and the reference's.

The ranks run once for the module (`_torch_ranks.run`, job
`mesh_grads`): every branch a training forward takes on a mesh, each
differentiated on the reference's inputs, parameters and a seeded
cotangent of its output — head-TP and context-parallel `attend`, the
weight-gathered and Megatron-SP FFN (FSDP weights), the MoE through
`_moe_a2a` and `_moe_replicated` (FSDP expert weights) and `_moe_a2a`
with EP over (model, data), `mla_forward_sp` and `attn_apply_sp`. The
reference's outputs and gradients come from one subprocess with 8 fake
XLA devices (`jax.grad` of sum(output x cotangent), plus the MoE's aux
loss). The cases sit on both sides of the transpose's divide: head-TP
`attend` takes a batch of 3, which does not split over data, so its
input and output are replicated over data (the output's cotangent is
divided by 2 and the input's psummed); the others shard their batch
over data; the staged MoE's output is a psum, replicated over model.
`moe_a2a_drops` runs at a capacity factor of 0.5, where assignments
overflow into the spill row: their gradient is zero, as the
reference's.

Tolerances: every gradient leaf and the output within `GRAD_REL` (1e-4)
of the reference leaf's largest |value|, as `_train_parity` holds a
train step's; every rank's bit-equal to rank 0's. "dots" against
"nothing" bit for bit (the same products, saved or recomputed), and
against the reference's `remat_policy="dots"` at `GRAD_REL` on the
conditioned copy."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
import _train_parity as tp_
from repro import perf
from repro.models.registry import build_model as jbuild
from repro.train.train_loop import make_loss_fn as jloss
from repro_torch import tree
from repro_torch.configs.base import get_config, reduced
from repro_torch.models.registry import build_model
from repro_torch.train import train_loop as tloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8

# case -> (what it differentiates, the port's mesh, its use_mesh flags,
# the branch it must take)
MG_CASES = {
    "attend_tp": ("attend", "m24", {}, "_head_tp_attention"),
    "attend_cp": ("attend", "m24", {}, "_context_parallel_attention"),
    "ffn_wg": ("ffn", "m24", {"fsdp": True}, "_ffn_apply_wg"),
    "ffn_sp": ("ffn", "m24", {"fsdp": True}, "_ffn_apply_sp"),
    "moe_a2a": ("moe", "m24", {"capacity_factor": 8.0}, "_moe_a2a"),
    "moe_a2a_drops": ("moe", "m24", {"capacity_factor": 0.5}, "_moe_a2a"),
    "moe_replicated": ("moe", "m24", {"capacity_factor": 8.0,
                                      "moe_impl": "replicated"},
                       "_moe_replicated"),
    "moe_a2a_ep_data": ("moe", "m222", {"capacity_factor": 8.0,
                                        "fsdp": False,
                                        "ep_over_data": True}, "_moe_a2a"),
    "mla_sp": ("mla", "m24", {"seq_parallel": True, "fsdp": False},
               "mla_forward_sp"),
    "attn_sp": ("attn", "m24", {"seq_parallel": True}, "attn_apply_sp"),
}

REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
import repro.perf as perf
from repro.configs.base import get_config, reduced
from repro.launch.mesh import make_mesh
from repro.models import ffn, mla, moe, transformer
from repro.models.module import init_params
from repro.parallel import collectives, sharding

cases = json.loads(sys.argv[2])
cfgs = {a: reduced(get_config(a)) for a in (
    "granite-moe-1b-a400m", "deepseek-v3-671b", "stablelm-12b")}
# the (2, 2, 2) ("rep", data, model) mesh of the port is two (2, 2)
# meshes side by side: one (2, 2) mesh here
meshes = {"m24": make_mesh((2, 4), ("data", "model")),
          "m222": make_mesh((2, 2), ("data", "model"))}
out = {}
keys = iter(jax.random.split(jax.random.PRNGKey(7), 64))


def normal(shape, scale=1.0):
    return scale * jax.random.normal(next(keys), shape)


def put(prefix, t):
    for k, a in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                              for p in k)] = np.asarray(a)


def inputs(name):
    D = {"moe": cfgs["granite-moe-1b-a400m"].d_model,
         "mla": cfgs["deepseek-v3-671b"].d_model,
         "attn": cfgs["stablelm-12b"].d_model, "ffn": 64}
    kind = cases[name][0]
    if name == "attend_tp":        # KVH 1, G 4 over model 4; B 3 over data 2
        return ({"q": normal((3, 16, 1, 4, 16)), "k": normal((3, 16, 1, 16)),
                 "v": normal((3, 16, 1, 16))}, {}, {})
    if name == "attend_cp":        # H 3 over model 4: context parallelism
        return ({"q": normal((4, 32, 1, 3, 16)), "k": normal((4, 32, 1, 16)),
                 "v": normal((4, 32, 1, 16))}, {}, {})
    S = 128 if name == "ffn_wg" else 16
    x = {"x": normal((4, S, D[kind]), 0.5)}
    pos = {"pos": jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (4, S))}
    spec = {"ffn": lambda: ffn.ffn_spec(64, 128, "swiglu"),
            "moe": lambda: moe.moe_spec(cfgs["granite-moe-1b-a400m"]),
            "mla": lambda: mla.mla_spec(cfgs["deepseek-v3-671b"]),
            "attn": lambda: transformer.attn_spec(cfgs["stablelm-12b"])}[kind]()
    return x, init_params(spec, next(keys), "float32"), \\
        pos if kind in ("mla", "attn") else {}


fns = {
    "attend": lambda x, p, c: collectives.attend(x["q"], x["k"], x["v"]),
    "ffn": lambda x, p, c: ffn.ffn_apply(p, x["x"], "swiglu", sp=True),
    "moe": lambda x, p, c: moe.moe_apply(p, x["x"],
                                         cfgs["granite-moe-1b-a400m"]),
    "mla": lambda x, p, c: mla.mla_forward_sp(p, x["x"], c["pos"],
                                              cfgs["deepseek-v3-671b"]),
    "attn": lambda x, p, c: transformer.attn_apply(
        p, x["x"], c["pos"], cfgs["stablelm-12b"])[0],
}
for name, (kind, mesh, flags) in cases.items():
    xs, ps, const = inputs(name)
    fn = fns[kind]
    # the output's shape is the queries' (Dv = Dk) or the activations'
    ct = normal(xs["q" if kind == "attend" else "x"].shape)
    pflags = {k: v for k, v in flags.items() if k != "fsdp"}

    def loss(xs, ps):
        y = fn(xs, ps, const)
        return jnp.sum(y[0] * ct) + y[1] if kind == "moe" else jnp.sum(y * ct)

    def both(xs, ps):
        y = fn(xs, ps, const)
        return (y[0] if kind == "moe" else y), jax.grad(
            loss, argnums=(0, 1))(xs, ps)
    perf.set_flags(**pflags)
    try:
        with sharding.use_mesh(meshes[mesh], fsdp=flags.get("fsdp", True)):
            # a fresh jit each case: the flags are read while tracing
            y, (gx, gp) = jax.jit(both)(xs, ps)
    finally:
        perf.reset_flags()
    pre = name + "/"
    out[pre + "ct"] = np.asarray(ct)
    out[pre + "out"] = np.asarray(y)
    put(pre + "in/", xs)
    put(pre + "in/", const)
    put(pre + "param/", ps)
    put(pre + "grad/in/", gx)
    put(pre + "grad/param/", gp)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the reference's results, each of the 8 ranks' results)."""
    import json
    d = tmp_path_factory.mktemp("mg")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cases = {k: (v[0], v[1], v[2]) for k, v in MG_CASES.items()}
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "ref.npz"),
                        json.dumps(cases)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr
    with np.load(d / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    payload = {f"mg/{k}": v for k, v in ref.items() if "/grad/" not in k
               and not k.endswith("/out")}
    payload["mg/cases"] = np.asarray(list(MG_CASES))
    for name, (kind, mesh, flags, _) in MG_CASES.items():
        payload[f"mg/{name}/kind"] = np.asarray(kind)
        payload[f"mg/{name}/mesh"] = np.asarray(mesh)
        payload.update({f"mg/{name}/flag/{k}": np.asarray(v)
                        for k, v in flags.items()})
    got = _torch_ranks.run(("mesh_grads",), WORLD, d, payload)
    return ref, got


@pytest.mark.parametrize("case", list(MG_CASES))
def test_branch_gradients_match_the_reference(ranks, case):
    """The branch's output and the gradient of every input and parameter
    (sum(output x cotangent), plus the MoE's aux loss) within GRAD_REL of
    the reference's `jax.grad` through its `shard_map` region, the same
    on every rank, through the branch named in MG_CASES."""
    ref, got = ranks
    pre = f"{case}/"
    want = {k[len(pre) + 5:]: v for k, v in ref.items()
            if k.startswith(pre + "grad/")}
    want["out"] = ref[pre + "out"]
    have = {k: got[0][f"mg/{pre}{k}"] for k in want}
    worst = {k: float(np.abs(have[k] - w).max() / max(np.abs(w).max(),
                                                       1e-30))
             for k, w in want.items()}
    assert max(worst.values()) <= tp_.GRAD_REL, worst
    assert len(want) > 2
    for r, g in enumerate(got):
        for k in want:
            np.testing.assert_array_equal(g[f"mg/{pre}{k}"], have[k],
                                          err_msg=f"{case} {k}, rank {r}")
    assert MG_CASES[case][3] in got[0][f"mg/{pre}calls"].tolist()
    if case.startswith("moe"):
        dropped = sum(int(g[f"mg/{pre}drops"]) for g in got)
        assert (dropped > 0) == (case == "moe_a2a_drops"), dropped


def test_pmax_refuses_an_input_that_requires_grad():
    """`pmax` (the sharded decode's merge, on no training path) has no
    transpose: an input that requires grad under grad mode raises before
    any collective; under no_grad it goes on to the collective (here on
    an abstract mesh: no ranks)."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.parallel import sharding
    x = torch.ones(4, requires_grad=True)
    with sharding.use_mesh(tmesh.abstract_mesh((2, 4), ("data", "model"))):
        with pytest.raises(NotImplementedError, match="pmax"):
            sharding.pmax(x, "model")
        with torch.no_grad():
            with pytest.raises(RuntimeError, match="DeviceMesh"):
                sharding.pmax(x, "model")


# -- the "dots" remat policy ----------------------------------------------------
DOTS_ARCHS = ("gemma-2b", "granite-moe-1b-a400m", "deepseek-v3-671b")


def _remat_pair(arch: str, policy: str):
    """`tp_.conditioned_pair(arch)` with remat on in both packages, the
    port's model under `policy`."""
    jm, jp, tm, tp = tp_.conditioned_pair(arch)
    jcfg = dataclasses.replace(jm.cfg, remat=True)
    cfg = dataclasses.replace(tm.cfg, remat=True)
    return jbuild(jcfg), jp, build_model(cfg, remat_policy=policy), tp


def _port_grads(tm, tp, nb):
    (loss, _), g = tloop.value_and_grad(tloop.make_loss_fn(tm, tm.cfg), tp,
                                        tree.map(lambda a: torch.tensor(a), nb))
    return float(loss), tree.leaves(g)


@pytest.mark.parametrize("arch", DOTS_ARCHS)
def test_dots_equals_nothing_and_the_reference(arch):
    """One train step's gradients with every layer recomputed under
    "dots" (the products without batch dims saved) bit-equal to
    "nothing" and to no remat, and within GRAD_REL of the reference's
    `jax.value_and_grad` under `remat_policy="dots"` (remat on in both
    packages, the conditioned copy)."""
    nb = tp_.batch(tp_.pair(arch)[2].cfg)
    got = {}
    for policy in ("nothing", "dots"):
        jm, jp, tm, tp = _remat_pair(arch, policy)
        got[policy] = _port_grads(tm, tp, nb)
    got["off"] = _port_grads(tp_.pair(arch)[2], tp, nb)
    for a, b, c in zip(got["dots"][1], got["nothing"][1], got["off"][1]):
        assert torch.equal(a, b) and torch.equal(a, c)
    perf.set_flags(remat_policy="dots")
    try:
        (jl, _), jg = jax.jit(jax.value_and_grad(
            jloss(jm, jm.cfg), has_aux=True))(jp, jax.tree.map(jnp.asarray,
                                                               nb))
    finally:
        perf.reset_flags()
    np.testing.assert_allclose(got["dots"][0], float(jl), rtol=tp_.LOSS_REL)
    for a, j in zip(got["dots"][1], jax.tree.leaves(jg)):
        j = np.asarray(j)
        assert np.abs(a.numpy() - j).max() <= tp_.GRAD_REL * max(
            np.abs(j).max(), 1e-30)


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops that run under it."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-1b-a400m"])
def test_dots_recomputes_no_matrix_product(arch):
    """The backward's aten ops counted by a dispatch mode: under "dots"
    as many `aten.mm` as with no remat (none recomputed: the forward's
    were saved), while the batched products run again (`aten.bmm`: the
    experts'; and the attention, one `repro_torch::flash_attention`
    operator a call, whose scores the dispatch mode does not see inside
    it); under "nothing" both run again."""
    nb = tree.map(torch.tensor, tp_.batch(tp_.pair(arch)[2].cfg))
    counts = {}
    for name, remat, policy in (("off", False, "nothing"),
                                ("nothing", True, "nothing"),
                                ("dots", True, "dots")):
        _, _, tm, tp = tp_.pair(arch)
        m = build_model(dataclasses.replace(tm.cfg, remat=remat),
                        remat_policy=policy)
        p = tree.map(lambda a: a.detach().requires_grad_(True), tp)
        with torch.enable_grad():
            loss, _ = tloop.make_loss_fn(m, m.cfg)(p, nb)
            with _CountOps() as c:
                torch.autograd.grad(loss, tree.leaves(p), allow_unused=True)
        counts[name] = (c.n.get(torch.ops.aten.mm.default, 0),
                        c.n.get(torch.ops.aten.bmm.default, 0)
                        + c.n.get(torch.ops.repro_torch.flash_attention.default,
                                  0))
    assert counts["dots"][0] == counts["off"][0] < counts["nothing"][0]
    assert counts["dots"][1] == counts["nothing"][1] > counts["off"][1]


def test_an_unknown_remat_policy_is_refused():
    """`build_model` takes "nothing" and "dots" only, for every family."""
    for arch in ("gemma-2b", "whisper-base"):
        with pytest.raises(ValueError, match="remat_policy"):
            build_model(reduced(get_config(arch)), remat_policy="everything")


def test_chip_smoke_phase14_at_cpu_size():
    """`chip_smoke.py`'s phase 14 at a toy size on the CPU: each piece
    rank by rank, forward and backward with the transposed exchanges,
    its assembled float32 gradients within SP_HOLD of the unsharded
    block's (gemma's context parallelism over 8 ranks, where its 4
    reduced heads land there; the others over 4), and (b)'s "dots"
    gradients within MB_TOL of "nothing"'s."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from repro_torch import device as tdevice

    Z = chip_smoke.MeshTrainSizes(reduce=True, seq=64, model=4, hold_cf=8.0,
                                  remat_batch=2, remat_seq=16,
                                  pieces=chip_smoke.MT_PIECES[1:])
    prev = tdevice.set_default("cpu")
    try:
        outs = [chip_smoke.phase_mesh_train(
            torch, np, torch.device("cpu"), z, np.random.default_rng(0),
            chip_smoke._Clock())
            for z in (dataclasses.replace(Z, model=8,
                                          pieces=chip_smoke.MT_PIECES[:1]),
                      Z)]
    finally:
        tdevice.set_default(prev)
    pieces = {k: v for o in outs for k, v in o["pieces"].items()}
    assert sorted(pieces) == sorted(f"{a}/{p}"
                                    for a, p in chip_smoke.MT_PIECES)
    for o in outs:
        assert o["launches"] == {} and o["flash_by_shape"] == {}
        assert o["remat"]["grad_rel_max"] <= chip_smoke.MB_TOL
    for name, r in pieces.items():
        assert r["finite"], name
        assert r["grad_rel_max"] <= chip_smoke.SP_HOLD, name
        assert r["out_rel"] <= chip_smoke.SP_HOLD, name
        assert len(r["rank_ms"]) == (8 if "attend_cp" in name else 4)
    assert pieces["stablelm-12b/ffn_sp"]["branch"] == "megatron-sp"
    # the pieces' assembly rules: attn_sp's kv projections are whole on
    # every rank (2 kv heads over 4) and psummed; the rest concatenated
    assert len(pieces["stablelm-12b/attn_sp"]["grad_errs"]) == 5


def test_mt_transpose_is_jax_transposes():
    """The stacked exchanges' transposes are JAX's: all_gather <->
    psum_scatter on the same dim, all_to_all with its dims swapped,
    psum and none themselves; and each transpose is an adjoint:
    <exchange(x), y> = <x, transpose(y)> over the ranks."""
    sys.path.insert(0, REPO)
    import chip_smoke
    M = 4
    g = torch.Generator().manual_seed(0)
    for how, shape in ((("gather", 1), (2, 3, 5)), (("scatter", 1), (2, 8, 5)),
                       (("a2a", 0, 1), (8, 3, 2)), (("psum",), (3, 2)),
                       (("none",), (3, 2))):
        t = chip_smoke._mt_transpose(how)
        assert chip_smoke._mt_transpose(t) == how
        xs = [torch.randn(shape, generator=g, dtype=torch.float64)
              for _ in range(M)]
        ys_shape = chip_smoke._sp_exchange(torch, how, M)(xs)
        ys = [torch.randn(y.shape, generator=g, dtype=torch.float64)
              for y in ys_shape]
        lhs = sum((a * b).sum() for a, b in zip(ys_shape, ys))
        rhs = sum((a * b).sum() for a, b in zip(
            xs, chip_smoke._sp_exchange(torch, t, M)(ys)))
        assert torch.allclose(lhs, rhs), how
