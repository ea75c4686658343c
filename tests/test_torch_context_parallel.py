"""Context parallelism and the sequence-sharded decode of the port
(`parallel.collectives`), on 8 gloo ranks, held against the JAX package.

The ranks run once for the module (`_torch_ranks.run`): `attend` at the
reference test's shapes (`tests/test_sharded.py::
test_context_parallel_attention_matches_local`: B 2, S 64, KVH 1, G 3,
Dk 16 on a (2, 4) (data, model) mesh, so H = 3 over model = 4 takes
context parallelism: each rank attends its 16 query rows through the
flash kernel's plain version at q_offset = 16 x its coordinate, against
the K/V it holds whole), the sharded decode (`::test_seqparallel_decode_matches_
local`: B 4, S 32, KVH 2, G 2, Dk 16, positions 31, 7, 16, 0), and the
same with MLA's `v_dims`; then reduced gemma-2b (H 4 on KVH 1) on a
(1, 8) mesh, `forward`, `prefill` of 16 tokens and three decode steps on
a cache of 24, on the reference's parameters. The reference's sharded
results come from one subprocess with 8 fake XLA devices.

Tolerances: the reference test's 1e-5 for attention and decode (against
the reference's `chunked_attention` and its local and sharded decode);
caches exact; the model at `test_torch_model.py`'s MODEL_REL (1e-3 of
the logits' scale) against the reference's unsharded model. Every rank
returns the same global result."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.attention import chunked_attention as jattention
from repro.models.registry import build_model as jbuild
from repro.serve.kvcache import pad_caches as jpad
from repro_torch import tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
MODEL_REL = 1e-3
WORLD = 8
V_DIMS = 8

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.parallel import collectives, sharding

out = {}
B, S, KVH, G, Dk = 2, 64, 1, 3, 16
ks = jax.random.split(jax.random.PRNGKey(0), 3)
q = jax.random.normal(ks[0], (B, S, KVH, G, Dk))
k = jax.random.normal(ks[1], (B, S, KVH, Dk))
v = jax.random.normal(ks[2], (B, S, KVH, Dk))
mesh = make_mesh((2, 4), ("data", "model"))
with sharding.use_mesh(mesh):
    got = jax.jit(lambda q, k, v: collectives.attend(
        q, k, v, causal=True, q_chunk=16, kv_chunk=16))(q, k, v)
out.update(q=q, k=k, v=v, cp=got)

B, S, KVH, G, Dk = 4, 32, 2, 2, 16
ks = jax.random.split(jax.random.PRNGKey(0), 5)
dq = jax.random.normal(ks[0], (B, KVH, G, Dk))
kc = jax.random.normal(ks[1], (B, S, KVH, Dk))
vc = jax.random.normal(ks[2], (B, S, KVH, Dk))
kn = jax.random.normal(ks[3], (B, KVH, Dk))
vn = jax.random.normal(ks[4], (B, KVH, Dk))
pos = jnp.array([31, 7, 16, 0], jnp.int32)
args = (dq, kc, vc, kn, vn, pos)
out.update(dq=dq, kc=kc, vc=vc, kn=kn, vn=vn, pos=pos)
for name, kw in (("dec", {}), ("mla", {"v_dims": int(sys.argv[2])})):
    lo, lk, lv = collectives.seqparallel_decode_attention(*args, **kw)
    with sharding.use_mesh(mesh):
        so, sk, sv = jax.jit(lambda *a: collectives.
                             seqparallel_decode_attention(*a, **kw))(*args)
    out.update({f"{name}_local": lo, f"{name}_local_k": lk,
                f"{name}_sharded": so, f"{name}_sharded_k": sk})
    if lv is not None:
        out.update({f"{name}_local_v": lv, f"{name}_sharded_v": sv})
np.savez(sys.argv[1], **{k: np.asarray(a) for k, a in out.items()})
"""


def _model_reference():
    """Reduced gemma-2b's reference parameters and its unsharded
    forward, prefill and decode logits on seeded tokens."""
    jm = jbuild(jreduced(jget_config("gemma-2b")))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    steps = rng.integers(0, 256, (3, 2, 1)).astype(np.int32)
    max_seq = 24
    want = {"forward": np.asarray(jm.forward(jp, jnp.asarray(toks))[0])}
    logits, caches = jm.prefill(jp, jnp.asarray(toks))
    want["prefill"] = np.asarray(logits)
    caches = jpad(caches, 16, max_seq)
    for i in range(steps.shape[0]):
        pos = jnp.full((2,), 16 + i, jnp.int32)
        logits, caches = jm.decode_step(jp, jnp.asarray(steps[i]), caches,
                                        pos)
        want[f"decode{i}"] = np.asarray(logits)
    payload = {f"param/{k}": np.asarray(a) for k, a in
               tree.flatten_with_keys(jax.tree.map(np.asarray, jp))}
    payload.update({"model/toks": toks, "model/steps": steps,
                    "model/max_seq": np.asarray(max_seq)})
    return payload, want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the reference's results, the model's unsharded logits, each of
    the 8 ranks' results)."""
    d = tmp_path_factory.mktemp("cp")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "ref.npz"),
                        str(V_DIMS)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stderr
    with np.load(d / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    payload, want = _model_reference()
    payload.update({f"cp/{n}": ref[n] for n in
                    ("q", "k", "v", "dq", "kc", "vc", "kn", "vn", "pos")})
    payload["cp/v_dims"] = np.asarray(V_DIMS)
    got = _torch_ranks.run(("context_parallel", "model_on_mesh"), WORLD, d,
                           payload)
    return ref, want, got


def test_context_parallel_attention_matches_the_reference(ranks):
    """Every rank's `attend` equals the reference's unsharded
    `chunked_attention` and its sharded `attend` within 1e-5, through
    the context-parallel branch."""
    ref, _, got = ranks
    exp = np.asarray(jattention(*(jnp.asarray(ref[n]) for n in "qkv"),
                                causal=True, q_chunk=16, kv_chunk=16))
    for r, g in enumerate(got):
        assert g["cp/counts"][0] == 1, r
        np.testing.assert_allclose(g["cp/got"], exp, atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(g["cp/got"], ref["cp"], atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("name", ["dec", "mla"])
def test_sharded_decode_matches_the_reference(ranks, name):
    """The sequence-sharded decode (each of the four ranks writes the
    new entry into its rows at p - s0 and its partials over them are
    merged over `model`; the whole caches written locally), without and
    with MLA's `v_dims`: every rank's output within 1e-5 of the
    reference's local and sharded decode, its caches equal."""
    ref, _, got = ranks
    port = {"dec": "cp/dec", "mla": "cp/mla"}[name]
    for r, g in enumerate(got):
        assert g["cp/counts"][1] == 2, r
        for side in ("local", "sharded"):
            np.testing.assert_allclose(g[port], ref[f"{name}_{side}"],
                                       atol=ATOL, rtol=ATOL)
            np.testing.assert_array_equal(g[f"{port}_k"],
                                          ref[f"{name}_{side}_k"])
        if name == "dec":
            np.testing.assert_array_equal(g["cp/dec_v"], ref["dec_local_v"])


def test_sharded_decodes_gather_their_output_and_no_cache(ranks):
    """Every rank holds the whole caches, so neither the sequence-sharded
    decode nor the heads layout gathers a cache: a rank's all-gathers
    send at most its output's bytes (a cache block is larger). The heads
    layout (KVH 4 over model = 4) equals the decode with no mesh within
    1e-5, its caches exactly."""
    import torch
    from repro_torch.parallel import collectives
    _, _, got = ranks
    for r, g in enumerate(got):
        seq_sent, seq_out, heads_sent, heads_out = g["cp/gathered"]
        assert 0 < seq_sent <= seq_out and 0 < heads_sent <= heads_out, r
        args = [torch.from_numpy(g[f"cp/heads_in{i}"]) for i in range(6)]
        o, k, v = collectives.seqparallel_decode_attention(*args)
        np.testing.assert_allclose(g["cp/heads"], o.numpy(), atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_array_equal(g["cp/heads_k"], k.numpy())
        np.testing.assert_array_equal(g["cp/heads_v"], v.numpy())


def test_reduced_gemma_on_a_model_mesh_matches_the_unsharded_reference(
        ranks):
    """reduced gemma-2b on a (1, 8) mesh — every attention layer's
    prefill through context parallelism, every decode step through the
    sharded decode — against the reference's model with no mesh, at
    MODEL_REL of the logits' scale, the same on every rank."""
    _, want, got = ranks
    layers = jreduced(jget_config("gemma-2b")).n_layers
    for r, g in enumerate(got):
        # forward and prefill: one CP call a layer each; 3 decode steps
        assert list(g["model/counts"]) == [2 * layers, 3 * layers], r
        for name, w in want.items():
            np.testing.assert_allclose(
                g[f"model/{name}"], w, rtol=MODEL_REL,
                atol=MODEL_REL * np.abs(w).max(), err_msg=f"{r} {name}")
            np.testing.assert_array_equal(g[f"model/{name}"],
                                          got[0][f"model/{name}"])


def test_chip_smoke_phase12_at_cpu_size():
    """`chip_smoke.py`'s phase 12 at a toy size on the CPU: reduced
    gemma-2b, phi4-mini-3.8b, recurrentgemma-2b (window 8) and
    whisper-base (its self-attention and its cross-attention against 8
    frames, no mask), a 64-token prompt cut into 16 query shards of 4 —
    each shard held against the plain version at its offset, the shards'
    concatenation equal to the unsharded call — and the sharded decode's
    merge over 16 shards of a 64-row cache against the whole-cache
    decode."""
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke
    from repro_torch import device as tdevice

    prev = tdevice.set_default("cpu")
    try:
        C = chip_smoke.CpSizes(archs=chip_smoke.CP.archs, reduce=True,
                               batch=2, seq=64, model=16,
                               decode_arch="gemma-2b", decode_seq=64,
                               decode_pos=50, dtype="float32",
                               cross=chip_smoke.CP.cross)
        out = chip_smoke.phase_cp(torch, np, torch.device("cpu"), C,
                                  np.random.default_rng(0),
                                  chip_smoke._Clock())
    finally:
        tdevice.set_default(prev)
    assert out["launches"] == {} and out["by_shape"] == {}
    assert C.cross == ("whisper-base",)
    assert sorted(out["archs"]) == sorted(
        C.archs + tuple(a + "/cross" for a in C.cross))
    for arch, r in out["archs"].items():
        assert r["shards"] == 16 and r["rows"] == 4
        assert r["max_abs_err"] == 0.0, arch
        assert r["concat_vs_unsharded"] == 0.0, arch
    d = out["decode"]
    assert d["shards"] == 16 and d["max_abs_err"] <= 1e-5 * d["scale"]


def test_chip_smoke_phase12_decode_in_bf16():
    """Phase 12's sharded decode with bf16 caches on the CPU: the merge
    within 1e-5 of the whole-cache decode's scale, and the bf16 output
    within one bf16 ulp of `seqparallel_decode_attention`'s."""
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke
    from repro_torch.models.attention import (decode_partials,
                                              finalize_partials)
    from repro_torch.parallel import collectives

    C = chip_smoke.CpSizes(archs=(), reduce=True, batch=1, seq=64, model=16,
                           decode_arch="gemma-2b", decode_seq=256,
                           decode_pos=200, dtype="bfloat16")
    gen = torch.Generator().manual_seed(3)
    d = chip_smoke._cp_decode(torch, torch.device("cpu"), C, gen,
                              torch.bfloat16, collectives, decode_partials,
                              finalize_partials, chip_smoke._Clock())
    assert d["shards"] == 16 and d["max_abs_err"] <= 1e-5 * d["scale"]
    assert d["out_ulps_bound"] == 1.0 and d["out_max_ulps"] <= 1.0
