"""The port's dry-run (`repro_torch.launch.dryrun`, `launch.attribute`,
`utils.hlo_cost`, `utils.hlo_analysis`, `sharding.abstract_with_shardings`,
`registry.input_specs`, the flash operator under `FakeTensorMode`) held
against the reference's.

* Stand-ins: every arch x shape on both production meshes (abstract
  meshes in both packages) gives the reference's global shapes, dtypes
  and resolved specs, and each block is the global shape divided by its
  spec (the reference's `shard_shape`).
* Counter calibration on the reference's own programs: the matmul chain
  of `test_system.py::test_hlo_cost_parser_calibration` reads exactly
  2 B D D L in both packages; the psum in a 5-trip loop over 4 ranks of
  `test_hlo_cost_collectives_in_scan` reads exactly L 2 N 4 3/4 (the
  reference's parser reads it within its own 0.8-1.3 band); and
  `compressed_psum_mean` over 8 ranks under 0.55 of a float32
  all-reduce, as `test_compress.py` holds the reference.
* Flash under fake mode: the reference's count for its interpret-mode
  kernel at 1 x 2 x 512 x 64, causal and not, exactly; no launch, no
  raise and no (Sq, Sk) scores on fake CUDA tensors.
* The CLIs on the CPU: the reference's JSON keys, an unknown `--set`
  refused.

Whatever makes a process group (torch's `fake` backend) runs in a
subprocess, as `tests/test_sharded.py::run_sharded` does, so that no
test worker keeps a group."""
import ast
import json
import os
import subprocess
import sys
import textwrap
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jflash
from repro.models.registry import build_model as jbuild
from repro.models.registry import input_specs as jinput_specs
from repro.parallel import sharding as jsharding
from repro.utils import hlo_cost as jhlo_cost
from repro_torch import tree
from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import mesh as tmesh
from repro_torch.models.module import is_spec
from repro_torch.models.registry import build_model, input_specs
from repro_torch.parallel import sharding
from repro_torch.utils import hlo_analysis, hlo_cost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_archs()
FLASH_REF_FLOPS = 134_217_728      # the reference's count, 1 x 2 x 512 x 64


def _run(prog: str, timeout=300) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(prog)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=REPO)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


# -- stand-ins -------------------------------------------------------------------
def _jleaves(t):
    return jax.tree.leaves(t)


def _check_leaf(got, spec, want, what):
    """A port stand-in (fake tensor at block or global shape) against
    the reference's ShapeDtypeStruct."""
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what
    wspec = tuple(want.sharding.spec) if want.sharding is not None else ()
    assert tuple(spec) == wspec + (None,) * (len(spec) - len(wspec)), what


@pytest.mark.parametrize("arch", ARCHS)
def test_stand_ins_are_the_reference_s_on_both_production_meshes(arch):
    """Parameters (`abstract_with_shardings`: blocks, and whole) and the
    inputs of every shape (`input_specs`: global) on the (16, 16) and
    (2, 16, 16) meshes: the reference's global shapes, dtypes and
    specs; each block the global shape divided by its spec, equal to
    the reference's `shard_shape`."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    specs = build_model(cfg).param_specs()
    jspecs = jbuild(jcfg).param_specs()
    for multi in (False, True):
        shape, axes = tmesh.production_shape(multi_pod=multi)
        with sharding.use_mesh(tmesh.abstract_mesh(shape, axes)):
            blocks, pspecs = sharding.abstract_with_shardings(
                specs, cfg.dtype, device="cpu")
            whole, _ = sharding.abstract_with_shardings(
                specs, cfg.dtype, whole=True, device="cpu")
            ins = {k: input_specs(cfg, s, device="cpu")
                   for k, s in SHAPES.items()}
        with jsharding.use_mesh(AbstractMesh(shape, axes)):
            jparams = jsharding.abstract_with_shardings(jspecs, jcfg.dtype)
            jins = {k: jinput_specs(jcfg, s) for k, s in JSHAPES.items()}
        leaves = tree.leaves(specs, is_leaf=is_spec)
        for s, b, w, sp, j in zip(leaves, tree.leaves(blocks),
                                  tree.leaves(whole), tree.leaves(
                                      pspecs, is_leaf=lambda x: isinstance(
                                          x, sharding.PartitionSpec)),
                                  _jleaves(jparams), strict=True):
            _check_leaf(b, sp, j, (arch, multi, s))
            assert tuple(w.shape) == j.shape == s.shape
            assert tuple(b.shape) == j.sharding.shard_shape(j.shape)
        for k, (got, gspecs) in ins.items():
            want = jins[k]
            assert sorted(got) == sorted(want), (arch, k)
            for name in got:
                g, w = tree.leaves(got[name]), _jleaves(want[name])
                sp = tree.leaves(gspecs[name], is_leaf=lambda x: isinstance(
                    x, sharding.PartitionSpec))
                for a, p, b in zip(g, sp, w, strict=True):
                    assert tuple(a.shape) == b.shape, (arch, k, name)
                    _check_leaf(a, p, b, (arch, k, name))
                    if b.sharding is not None:
                        with sharding.use_mesh(
                                tmesh.abstract_mesh(shape, axes)):
                            blk = sharding.block_shape(a.shape, p)
                        assert blk == b.sharding.shard_shape(b.shape)


def test_stand_ins_allocate_nothing_and_raise_nowhere_without_a_card():
    """The stand-ins are fake tensors on the package default (`cuda`)
    with no card: metadata only. A real tensor on the card still needs
    one (`repro_torch.device.resolve` raises)."""
    from repro_torch import device as tdevice
    from torch._subclasses.fake_tensor import is_fake
    prev = tdevice.set_default("cuda")
    try:
        p, _ = sharding.abstract_with_shardings(
            build_model(get_config("deepseek-v3-671b")).param_specs(),
            "bfloat16")
        leaves = tree.leaves(p)
        assert all(is_fake(t) and t.device.type == "cuda" for t in leaves)
        assert sum(t.numel() for t in leaves) > 6e11
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                tdevice.resolve()
    finally:
        tdevice.set_default(prev)


# -- counters ---------------------------------------------------------------------
def test_matmul_chain_reads_exactly_its_flops_in_both_packages():
    """`test_system.py::test_hlo_cost_parser_calibration`'s scanned chain
    (B 8, D 64, L 7): 2 B D D L, exactly, from the port's counter on the
    unrolled loop and from the reference's parser on the scan."""
    D, L, B = 64, 7, 8
    expected = 2 * B * D * D * L

    def f(x, w):
        def body(x, wl):
            return x @ wl, None
        y, _ = jax.lax.scan(body, x, w)
        return y.sum()
    w, x = jnp.zeros((L, D, D)), jnp.zeros((B, D))
    jres = jhlo_cost.analyze(jax.jit(f).lower(x, w).compile().as_text())
    with FakeTensorMode():
        tw, tx = torch.empty(L, D, D), torch.empty(B, D)

        def chain(x, w):
            for layer in range(L):
                x = x @ w[layer]
            return x.sum()
        res = hlo_cost.analyze(chain, tx, tw)
    assert res["flops"] == jres["flops"] == expected
    assert res["collective"] == {"wire_bytes": 0.0, "per_op_bytes": {},
                                 "counts": {}}


CALIBRATION = """
    import json
    import torch, torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch import device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding
    from repro_torch.parallel.compress import compressed_psum_mean
    from repro_torch.utils import hlo_cost
    device.set_default("cpu")
    out = {}
    # test_hlo_cost_collectives_in_scan: a psum in a 5-trip loop, 4 ranks
    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    mesh = make_mesh((4,), ("x",))
    L, N = 5, 1024
    P = sharding.P
    sm = sharding.shard_map(lambda c: sharding.psum(c, "x"), (P(),), P())
    with sharding.use_mesh(mesh), FakeTensorMode():
        x = torch.ones(N)
        def f(x):
            for _ in range(L):
                x = sm(x)
            return x.sum()
        out["scan"] = hlo_cost.analyze(f, x)["collective"]
    dist.destroy_process_group()
    # test_compress.py: compressed_psum_mean over 8 ranks
    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    mesh = make_mesh((8,), ("d",))
    with sharding.use_mesh(mesh), FakeTensorMode():
        group = sharding.axis_group("d")
        x = torch.empty(4096)
        out["compress"] = hlo_cost.analyze(
            compressed_psum_mean, x, group)["collective"]
        out["exact"] = hlo_cost.analyze(
            lambda x: dist.all_reduce(x.clone(), group=group), x)["collective"]
    dist.destroy_process_group()
    print(json.dumps(out))
"""


def test_collectives_read_the_reference_s_wire_bytes():
    """The psum in a loop reads L 2 N 4 3/4 exactly (five all-reduces of
    4096 bytes over 4 ranks); the int8 reduction's all-to-alls and
    all-gathers under 0.55 of a float32 all-reduce of the same vector,
    which reads 2 F 4 7/8."""
    out = json.loads(_run(CALIBRATION).strip().splitlines()[-1])
    L, N, F = 5, 1024, 4096
    assert out["scan"] == {"wire_bytes": L * 2 * N * 4 * 3 / 4,
                           "per_op_bytes": {"all-reduce": L * 2 * N * 4 * 3 / 4},
                           "counts": {"all-reduce": L}}
    f32_ar = 2 * F * 4 * 7 / 8
    assert out["exact"]["wire_bytes"] == f32_ar
    assert out["compress"]["wire_bytes"] < 0.55 * f32_ar
    assert out["compress"]["counts"] == {"all-to-all": 2, "all-gather": 2}


def test_wire_model_is_the_reference_s_ring_factors():
    recs = [(op, 1024, 8, "s") for op in hlo_analysis.COLL_OPS]
    got = hlo_analysis.collective_stats(recs)
    assert got["per_op_bytes"] == {
        "all-reduce": 2 * 1024 * 7 / 8, "all-gather": 1024 * 7 / 8,
        "reduce-scatter": 1024 * 7, "all-to-all": 1024 * 7 / 8,
        "collective-permute": 1024}
    assert got["counts"] == {op: 1 for op in hlo_analysis.COLL_OPS}
    rows = hlo_cost.attribute_collectives(recs + [("all-gather", 1024, 8,
                                                   "s")], top=2)
    assert rows == [(1024 * 7.0, "reduce-scatter", "s"),
                    (2 * 1024 * 7 / 8, "all-reduce", "s")]
    with pytest.raises(ValueError):
        hlo_analysis.wire_bytes("broadcast", 1, 2)


# -- flash -------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
def test_flash_counts_the_reference_s_flops(causal):
    """At 1 x 2 x 512 x 64: the flash operator's formula, on fake and on
    CPU tensors, equals the reference's `hlo_cost.analyze` of its
    interpret-mode kernel, causal or not."""
    shape = (1, 2, 512, 64)
    z = jnp.zeros(shape, jnp.float32)
    jres = jhlo_cost.analyze(jax.jit(partial(
        jflash, causal=causal, interpret=True)).lower(z, z, z).compile()
        .as_text())
    assert jres["flops"] == FLASH_REF_FLOPS
    with FakeTensorMode():
        q = torch.empty(shape)
        fake = hlo_cost.analyze(fa_ops.attention, q, q, q, causal=causal)
    q = torch.zeros(shape)
    real = hlo_cost.analyze(fa_ops.attention, q, q, q, causal=causal)
    assert fake["flops"] == real["flops"] == FLASH_REF_FLOPS


def test_flash_formula_at_mla_head_dims():
    """Dk 192 / Dv 128, GQA, Sq != Sk: 2 B H Sq Sk (Dk + Dv)."""
    B, H, KVH, Sq, Sk = 2, 4, 2, 48, 80
    with FakeTensorMode():
        q = torch.empty(B, H, Sq, 192)
        k = torch.empty(B, KVH, Sk, 192)
        v = torch.empty(B, KVH, Sk, 128)
        res = hlo_cost.analyze(fa_ops.attention, q, k, v, causal=False)
    assert res["flops"] == 2 * B * H * Sq * Sk * (192 + 128)


def test_flash_on_fake_cuda_tensors_launches_nothing_and_holds_no_scores():
    """A fake CUDA call neither launches nor raises (no card, no build),
    returns the kernel's (B, H, Sq, Dv) view of a (B, Sq, H, Dv) tensor,
    and the live bytes grow by its output alone, not by the (Sq, Sk)
    scores the plain version would hold."""
    before = dict(_build.LAUNCHES)
    with FakeTensorMode():
        q = torch.empty(1, 8, 4096, 256, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(1, 1, 4096, 256, device="cuda", dtype=torch.bfloat16)
        with hlo_cost.Trace(memory=True) as t:
            args, alloc = t.mem.track((q, k))
            out = fa_ops.attention(q, k, k, causal=True)
    assert out.device.type == "cuda" and out.shape == (1, 8, 4096, 256)
    assert out.transpose(1, 2).is_contiguous()
    assert t.mem.peak - args == 8 * 4096 * 256 * 2
    assert t.mem.alloc_peak - alloc == hlo_cost.LiveBytes.size(
        8 * 4096 * 256 * 2)
    assert t.result()["flops"] == 2 * 8 * 4096 * 4096 * 512
    assert _build.LAUNCHES == before


# -- the CLIs ------------------------------------------------------------------------
def _reference_keys() -> tuple[set, set]:
    """The keys of the reference's cell record and of its "memory", from
    the dict literal in `repro/launch/dryrun.py::lower_cell`."""
    src = open(os.path.join(REPO, "src", "repro", "launch", "dryrun.py"))
    for node in ast.walk(ast.parse(src.read())):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "rec" and isinstance(
                    node.value, ast.Dict) and len(node.value.keys) > 5:
            keys = {k.value for k in node.value.keys}
            mem = next(v for k, v in zip(node.value.keys, node.value.values)
                       if k.value == "memory")
            return keys, {k.value for k in mem.keys}
    raise AssertionError("no record literal in the reference's dryrun.py")


CLI = """
    import json, os, sys
    from repro_torch.launch import attribute, dryrun
    out = sys.argv[1]
    dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k,long_500k",
                 "--mesh", "single", "--out", out])
    rows = attribute.main(["--arch", "gemma-2b", "--shape", "decode_32k"])
    try:
        dryrun.main(["--arch", "gemma-2b", "--set", "no_such_flag=1",
                     "--out", out])
        refused = False
    except KeyError:
        refused = True
    print(json.dumps({"rows": rows, "refused": refused,
                      "flags": dryrun.parse_set(["moe_impl=replicated",
                                                 "capacity_factor=1.5",
                                                 "fsdp=false",
                                                 "microbatches=2"])}))
"""


def test_cli_writes_the_reference_s_keys_and_attributes(tmp_path):
    """`launch.dryrun` on gemma-2b x decode_32k x single and the skipped
    long_500k cell, `launch.attribute` on the same cell; an unknown flag
    raises; `--set` types values as the reference does. A record has the
    reference's keys and four of the port's: the program it traced
    ("view": gemma-2b's block program), flash's FLOPs, what its
    backwards recompute (0 in a decode cell) and the microbatches a
    train step ran ("chunks", None in a decode cell)."""
    out = _run(CLI.replace("sys.argv[1]", repr(str(tmp_path))))
    got = json.loads(out.strip().splitlines()[-1])
    assert got["refused"]
    assert got["flags"]["moe_impl"] == "replicated"
    assert got["flags"]["capacity_factor"] == 1.5
    assert got["flags"]["fsdp"] is False and got["flags"]["microbatches"] == 2
    d = tmp_path / "baseline"
    rec = json.loads((d / "gemma-2b__decode_32k__single.json").read_text())
    keys, mem = _reference_keys()
    # the reference's keys, and the program traced, flash's FLOPs, its
    # recompute and the microbatches a train step ran (none in a decode
    # cell)
    assert set(rec) == keys | {"view", "flash_flops",
                               "flash_recompute_flops", "chunks"}
    assert set(rec["memory"]) == mem
    assert rec["view"] == "blocks" and rec["flash_flops"] == 0
    assert rec["flash_recompute_flops"] == 0
    assert rec["chunks"] is None
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["raw_cost_analysis"]["bytes"] is None
    assert rec["flops_dev"] > 0 and rec["memory"]["peak_bytes"] > \
        rec["memory"]["argument_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    skip = json.loads((d / "gemma-2b__long_500k__single.json").read_text())
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]
    # the decode cell's collectives: the sharded decode's
    assert rec["collectives"]["wire_bytes"] == pytest.approx(
        sum(r[0] for r in got["rows"]), rel=1e-12)
    assert any("collectives." in r[2] for r in got["rows"])


# -- chip_smoke phase 15 ----------------------------------------------------------------
def test_chip_smoke_phase15_at_cpu_size():
    """Phase 15 at CPU size (`chip_smoke.DRYRUN_CPU`, reduced gemma-2b):
    the train step, the prefill and the decode step each run for real
    under the counters and traced on fake copies of their arguments, the
    FLOPs equal; nothing launches; the trace holds temporaries."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from repro_torch import device as tdevice
    prev = tdevice.set_default("cpu")
    try:
        r = chip_smoke.phase_dryrun(torch, np, torch.device("cpu"),
                                    chip_smoke.DRYRUN_CPU, chip_smoke._Clock())
    finally:
        tdevice.set_default(prev)
    for name in ("train", "prefill", "decode"):
        got = r[name]
        assert got["flops_real"] == got["flops_traced"] > 0, name
        assert got["traced_launches"] == 0 and got["real_flash_launches"] == 0
        assert got["memory"]["temp_bytes"] > 0
        assert got["allocator"]["temp_bytes"] >= got["memory"]["temp_bytes"]
        assert got["roofline"]["dominant"] in ("compute", "memory")
    assert r["launches"] == {} and r["flash_by_shape"] == {}
