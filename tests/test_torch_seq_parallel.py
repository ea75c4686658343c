"""Sequence parallelism of the port (Megatron-SP: `transformer.
attn_apply_sp`, `mla.mla_forward_sp`, `ffn._ffn_apply_wg` /
`_ffn_apply_sp`, the SP MoE), head-TP `attend` and the "heads" decode
layout, on 8 gloo ranks, held against the JAX package's sharded results.

The ranks run once for the module (`_torch_ranks.run`, job
`seq_parallel`), on the reference's float32 parameters:

  * reduced granite-moe-1b-a400m's and deepseek-v3's `forward` of a
    (4, 16) batch with `seq_parallel` on a (2, 4) (data, model) mesh,
    `fsdp=False`, capacity factor 8 (`tests/test_sharded.py::
    test_seq_parallel_forward_matches_local`), in the block program
    (each rank its blocks and rows, the stream its S/M positions):
    attention through `attn_apply_sp`, deepseek's MLA through
    `mla_forward_sp`, its shared expert and first dense FFN through the
    SP FFN, the MoE through `_moe_a2a`, and deepseek's MTP head;
  * reduced stablelm-12b's attention block (H 4 on 2 kv heads) through
    `attn_apply_sp` on (2, 4) (the kv heads sliced by rank) and (4, 2)
    (the kv heads sharded), FSDP weights gathered over data;
  * a swiglu FFN (D 64, F 128) through `ffn_apply(sp=True)` at a long
    sequence (weight-gathered) and a short one (Megatron-SP), with and
    without FSDP;
  * head-TP `attend` on (2, 4): 4 kv heads grouped, and 1 kv head of G
    4 repeated to the heads;
  * reduced stablelm-12b's prefill of 16 tokens and three decode steps
    with the "heads" cache layout on (4, 2).

The reference's sharded numbers (and its local ones) come from one
subprocess with 8 fake XLA devices. Tolerances are the reference test's
for a forward, 2e-3 absolute and relative; 1e-5 for attention (its CP
test's). Also here: `use_sp` and `decode_heads_layout` against the
reference's for every config on both production meshes, and phase 13
of `chip_smoke.py` at CPU size. The gradients of these branches are
held in `test_torch_mesh_grads.py`."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import _torch_ranks
from repro import perf
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_archs
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtransformer
from repro.parallel import sharding as jsharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-3
ATOL = 1e-5
WORLD = 8

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
import repro.perf as perf
from repro.configs.base import get_config, reduced
from repro.launch.mesh import make_mesh
from repro.models import ffn, transformer
from repro.models.module import init_params
from repro.models.registry import build_model
from repro.parallel import collectives, sharding
from repro.serve.kvcache import pad_caches

out = {}


def put_tree(prefix, t):
    for k, a in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                              for p in k)] = a


def jit(fn, *a):
    # a fresh jit each call: the flags are read while tracing
    return jax.jit(fn)(*a)


m24 = make_mesh((2, 4), ("data", "model"))
m42 = make_mesh((4, 2), ("data", "model"))
tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 256)
out["tokens"] = tokens
for arch in ("granite-moe-1b-a400m", "deepseek-v3-671b"):
    model = build_model(reduced(get_config(arch)))
    params = model.init(jax.random.PRNGKey(0))
    put_tree(f"{arch}/param/", params)
    out[f"{arch}/local"] = jit(lambda p, t: model.forward(p, t)[0], params,
                               tokens)
    perf.set_flags(seq_parallel=True, capacity_factor=8.0)
    with sharding.use_mesh(m24, fsdp=False):
        logits, extras = jit(lambda p, t: model.forward(p, t), params,
                             tokens)
    perf.reset_flags()
    out[f"{arch}/forward"] = logits
    if "mtp_logits" in extras:
        out[f"{arch}/mtp"] = extras["mtp_logits"]

model = build_model(reduced(get_config("stablelm-12b")))
cfg = model.cfg
params = model.init(jax.random.PRNGKey(0))
put_tree("stablelm-12b/param/", params)
attn = jax.tree.map(lambda a: a[0], params["groups"][0]["b0"]["attn"])
x = jax.random.normal(jax.random.PRNGKey(2), (4, 16, cfg.d_model))
positions = jnp.broadcast_to(jnp.arange(16, dtype=jnp.int32), (4, 16))
out.update(attn_x=x, attn_pos=positions,
           attn_local=transformer.attn_apply(attn, x, positions, cfg)[0])
perf.set_flags(seq_parallel=True)
for name, mesh in (("m24", m24), ("m42", m42)):
    with sharding.use_mesh(mesh):
        out[f"attn/{name}"] = jit(lambda a, x, p: transformer.attn_apply(
            a, x, p, cfg)[0], attn, x, positions)
perf.reset_flags()

fp = init_params(ffn.ffn_spec(64, 128, "swiglu"), jax.random.PRNGKey(3),
                 "float32")
put_tree("ffn/param/", fp)
for xs, S in (("long", 128), ("short", 16)):
    xf = jax.random.normal(jax.random.PRNGKey(4), (4, S, 64))
    out[f"ffn_x/{xs}"] = xf
    out[f"ffn_local/{xs}"] = ffn.ffn_apply(fp, xf, "swiglu")
    for fsdp in (False, True):
        with sharding.use_mesh(m24, fsdp=fsdp):
            out[f"ffn/{int(fsdp)}/{xs}"] = jit(lambda p, x: ffn.ffn_apply(
                p, x, "swiglu", sp=True), fp, xf)

for lay, KVH, G in (("grouped", 4, 1), ("repeated", 1, 4)):
    ks = jax.random.split(jax.random.PRNGKey(5), 3)
    q = jax.random.normal(ks[0], (2, 32, KVH, G, 16))
    k = jax.random.normal(ks[1], (2, 32, KVH, 16))
    v = jax.random.normal(ks[2], (2, 32, KVH, 16))
    out.update({f"tp/{lay}/q": q, f"tp/{lay}/k": k, f"tp/{lay}/v": v})
    with sharding.use_mesh(m24):
        out[f"tp/{lay}"] = jit(lambda q, k, v: collectives.attend(
            q, k, v, causal=True, q_chunk=16, kv_chunk=16), q, k, v)

rng = np.random.default_rng(5)
toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
steps = rng.integers(0, 256, (3, 2, 1)).astype(np.int32)
out.update({"dec/toks": toks, "dec/steps": steps,
            "dec/max_seq": np.asarray(24)})
perf.set_flags(decode_layout="heads")
with sharding.use_mesh(m42):
    logits, caches = jit(lambda p, t: model.prefill(p, t), params,
                         jnp.asarray(toks))
    out["dec/prefill"] = logits
    caches = pad_caches(caches, 16, 24)
    step = jax.jit(model.decode_step)      # one trace: the flags stay
    for i in range(3):
        pos = jnp.full((2,), 16 + i, jnp.int32)
        logits, caches = step(params, jnp.asarray(steps[i]), caches, pos)
        out[f"dec/decode{i}"] = logits
perf.reset_flags()
np.savez(sys.argv[1], **{k: np.asarray(a) for k, a in out.items()})
"""

# the port's calls on each run: sorted counter names
COUNTS = ("_ffn_apply_sp", "_ffn_apply_wg", "_head_tp_attention",
          "attn_apply_sp", "blocks_decode/heads", "blocks_decode/seq",
          "head_tp_block_attention", "mla_forward_sp")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the reference's results, each of the 8 ranks' results)."""
    d = tmp_path_factory.mktemp("sp")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "ref.npz")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr
    with np.load(d / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    payload = {f"sp/{k}": v for k, v in ref.items()}
    got = _torch_ranks.run(("seq_parallel",), WORLD, d, payload)
    for g in got:
        assert tuple(g["sp/count_names"]) == COUNTS
    return ref, got


def _counts(g, key):
    return dict(zip(COUNTS, g[f"sp/counts/{key}"].tolist()))


def _held(got, key, want, tol, what):
    for r, g in enumerate(got):
        np.testing.assert_allclose(g[key], want, atol=tol, rtol=tol,
                                   err_msg=f"{what}, rank {r}")
        np.testing.assert_array_equal(g[key], got[0][key])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v3-671b"])
def test_seq_parallel_forward_matches_the_reference(ranks, arch):
    """The reduced forward with `seq_parallel` on (2, 4): within 2e-3
    of the reference's sharded forward and of its local one; every
    attention layer through `attn_apply_sp` (granite) or
    `mla_forward_sp` (deepseek; the MTP head's block sees S - 1 = 15
    tokens, which do not split over 4, and runs unsharded, as the
    reference's does)."""
    ref, got = ranks
    layers = jreduced(jget_config(arch)).n_layers
    for name in ("forward", "mtp"):
        if f"{arch}/{name}" in ref:
            _held(got, f"sp/{arch}/{name}", ref[f"{arch}/{name}"], TOL,
                  f"{arch} {name}")
    _held(got, f"sp/{arch}/forward", ref[f"{arch}/local"], TOL, arch)
    c = _counts(got[0], arch)
    if arch == "granite-moe-1b-a400m":
        assert c["attn_apply_sp"] == layers and c["mla_forward_sp"] == 0
        assert c["_ffn_apply_sp"] + c["_ffn_apply_wg"] == 0
    else:
        assert c["mla_forward_sp"] == layers
        # the first dense FFN, and every MoE layer's shared expert
        assert c["_ffn_apply_sp"] + c["_ffn_apply_wg"] == layers


@pytest.mark.parametrize("mesh", ["m24", "m42"])
def test_attn_apply_sp_matches_the_reference(ranks, mesh):
    """stablelm's attention block through `attn_apply_sp`: on (2, 4) each
    rank slices the one kv head its query head groups into; on (4, 2)
    the kv heads are sharded. Within 2e-3 of the reference's sharded
    block and of its local one."""
    ref, got = ranks
    _held(got, f"sp/attn/{mesh}", ref[f"attn/{mesh}"], TOL, mesh)
    _held(got, f"sp/attn/{mesh}", ref["attn_local"], TOL, mesh)
    before = "deepseek-v3-671b" if mesh == "m24" else "attn/m24"
    assert (_counts(got[0], f"attn/{mesh}")["attn_apply_sp"]
            - _counts(got[0], before)["attn_apply_sp"]) == 1


@pytest.mark.parametrize("fsdp", [0, 1])
@pytest.mark.parametrize("xs,body", [("long", "_ffn_apply_wg"),
                                     ("short", "_ffn_apply_sp")])
def test_ffn_sp_branches_match_the_reference(ranks, xs, body, fsdp):
    """`ffn_apply(sp=True)` takes the weight-gathered body at 128 tokens
    a row (3 D F < 2 tokens D) and Megatron-SP at 16, as the
    reference's does; each within 2e-3 of the reference's sharded
    output and of its local one."""
    ref, got = ranks
    key = f"ffn/{fsdp}/{xs}"
    _held(got, f"sp/{key}", ref[key], TOL, key)
    _held(got, f"sp/{key}", ref[f"ffn_local/{xs}"], TOL, key)
    order = ["attn/m42"] + [f"ffn/{f}/{x}" for f in (0, 1)
                            for x in ("long", "short")]
    prev = order[order.index(key) - 1]
    diff = {n: _counts(got[0], key)[n] - _counts(got[0], prev)[n]
            for n in ("_ffn_apply_wg", "_ffn_apply_sp")}
    assert diff == {n: int(n == body) for n in diff}


@pytest.mark.parametrize("lay", ["grouped", "repeated"])
def test_head_tp_attend_matches_the_reference(ranks, lay):
    """Head-TP `attend` on (2, 4): 4 kv heads, one a rank, grouped; or
    one kv head of 4 queries repeated to 4 heads, one a rank. Within
    1e-5 of the reference's sharded `attend`."""
    ref, got = ranks
    _held(got, f"sp/tp/{lay}", ref[f"tp/{lay}"], ATOL, lay)
    prev = "ffn/1/short" if lay == "grouped" else "tp/grouped"
    assert (_counts(got[0], f"tp/{lay}")["_head_tp_attention"]
            - _counts(got[0], prev)["_head_tp_attention"]) == 1


def test_heads_decode_layout_matches_the_reference(ranks):
    """stablelm's prefill (head-TP, kv heads grouped) and three decode
    steps with the "heads" cache layout on (4, 2), each rank decoding its
    kv heads with no collective: the logits within 2e-3 of the
    reference's under the same layout."""
    ref, got = ranks
    layers = 3
    for name in ("prefill", "decode0", "decode1", "decode2"):
        _held(got, f"sp/dec/{name}", ref[f"dec/{name}"], TOL, name)
    c, prev = _counts(got[0], "dec"), _counts(got[0], "tp/repeated")
    assert (c["blocks_decode/heads"] - prev["blocks_decode/heads"]
            == 3 * layers)
    assert c["blocks_decode/seq"] == prev["blocks_decode/seq"]
    assert (c["head_tp_block_attention"] - prev["head_tp_block_attention"]
            == layers)


def test_use_sp_and_heads_layout_match_the_reference_on_production_meshes():
    """`transformer.use_sp` at 4096 and 4095 tokens and
    `decode_heads_layout` equal the reference's for every config on the
    (16, 16) and (2, 16, 16) meshes, flags on and off."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import transformer
    from repro_torch.parallel import sharding
    n = 0
    for multi_pod in (False, True):
        shape, axes = tmesh.production_shape(multi_pod=multi_pod)
        for sp, layout in ((True, "heads"), (False, "seq")):
            perf.set_flags(seq_parallel=sp, decode_layout=layout)
            try:
                for arch in list_archs():
                    jcfg, cfg = jget_config(arch), get_config(arch)
                    with jsharding.use_mesh(AbstractMesh(shape, axes)):
                        want = ([jtransformer.use_sp(jcfg, s)
                                 for s in (4096, 4095)],
                                jtransformer.decode_heads_layout(jcfg))
                    with sharding.use_mesh(
                            tmesh.abstract_mesh(shape, axes),
                            seq_parallel=sp, decode_layout=layout):
                        have = ([transformer.use_sp(cfg, s)
                                 for s in (4096, 4095)],
                                transformer.decode_heads_layout(cfg))
                    assert have == want, (arch, multi_pod, sp)
                    n += any(want[0]) + want[1]
            finally:
                perf.reset_flags()
    assert n > 0
    assert not transformer.use_sp(get_config("gemma-2b"), 4096)


def test_chip_smoke_phase13_at_cpu_size():
    """`chip_smoke.py`'s phase 13 at a toy size on the CPU: the reduced
    configs' bodies rank by rank over a model axis of 4 (codeqwen's over
    2, where its 2 kv heads split) on a 64-token prompt, each assembled
    float32 output within `SP_HOLD` of the unsharded block, the branch
    the port's gates take, and the MoE's drop share."""
    import dataclasses

    import torch
    sys.path.insert(0, REPO)
    import chip_smoke
    from repro_torch import device as tdevice

    Z = chip_smoke.SpSizes(archs=("granite-moe-1b-a400m", "deepseek-v3-671b",
                                  "stablelm-12b"), reduce=True, seq=64,
                           model=4, decode_seq=64, decode_pos=50,
                           hold_cf=8.0)
    prev = tdevice.set_default("cpu")
    try:
        outs = [chip_smoke.phase_sp(torch, np, torch.device("cpu"), z,
                                    np.random.default_rng(0),
                                    chip_smoke._Clock())
                for z in (Z, dataclasses.replace(
                    Z, archs=("codeqwen1.5-7b",), model=2))]
    finally:
        tdevice.set_default(prev)
    bodies = {k: v for o in outs for k, v in o["bodies"].items()}
    assert sorted(bodies) == sorted(f"{a}/{b}" for a, bs in
                                    chip_smoke.SP_BODIES.items() for b in bs)
    for o in outs:
        assert o["launches"] == {} and o["by_shape"] == {}
    for name, r in bodies.items():
        assert r["finite"], name
        assert r["hold_max_abs_err"] <= r["hold_bound"], name
        assert r["hold_bound"] == chip_smoke.SP_HOLD * r["hold_scale"] > 0
        assert len(r["rank_ms"]) == (2 if name.startswith("codeqwen") else 4)
    assert bodies["deepseek-v3-671b/ffn_shared"]["branch"] == \
        "weight-gathered"
    assert bodies["deepseek-v3-671b/ffn_dense"]["branch"] == "megatron-sp"
    assert bodies["stablelm-12b/attend_tp"]["layout"] == "repeated"
    assert bodies["codeqwen1.5-7b/attend_tp"]["layout"] == "grouped"
    for name in ("granite-moe-1b-a400m/moe_a2a",
                 "granite-moe-1b-a400m/moe_replicated",
                 "deepseek-v3-671b/moe_a2a"):
        assert 0.0 <= bodies[name]["drop_share"] < 1.0, name
