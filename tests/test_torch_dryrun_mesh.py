"""The dry-run of a sharded cell against the reference's and against the
same step run for real.

Reduced gemma-2b's train step at 4 x 32 tokens on a (2, 2, 2) (pod,
data, model) mesh, three ways at once:

  * traced by `launch.dryrun` as rank 0 of a fake 8-rank process group
    (a subprocess: the `fake` world is process-global);
  * lowered by the reference on 8 fake XLA devices (a subprocess, as
    `tests/test_sharded.py` runs it), whose
    `memory_analysis().argument_size_in_bytes` is the per-device
    arguments;
  * run on 8 gloo ranks (`_torch_ranks.dryrun_cell`) under the same
    counters.

The trace's `argument_bytes` (this rank's blocks of the parameters and
moments, and its rows of the batch: gemma-2b runs the block program) is
within 1 % of the reference's; its collectives (wire bytes, and counts
and bytes by op) and FLOPs are equal to what rank 0 of the gloo run
dispatched, and every gloo rank dispatched the same: the fake trace
counts what the real program does (so too for reduced mamba2-780m's and
recurrentgemma-2b's and whisper-base's train steps). The train,
prefill (4 x 32) and decode (4 slots of 32) cells of gemma-2b, of
reduced deepseek-v3 (the MoE family: MLA, MoE, the MTP head), of
reduced mamba2-780m (the SSM), of reduced recurrentgemma-2b (the RG-LRU
hybrid, windowed attention) and of reduced whisper-base (the
encoder-decoder: its 8 frames, the cross-attention, the frame caches)
each cost what the reference's compiled cell does per device: FLOPs within 5 % (less the flash recompute in train), arguments
within 1 %, temp bytes within 2× in train and prefill. internvl2-2b at
vocab 1025 (its two tables whole over model, large enough to be most of
what a reduced decode would move gathering them, as at full size)
decodes moving at most WIRE_X of the reference's wire bytes a rank: the
tables contracted in place, not gathered over data. The SSM's and the
hybrid's decode of one row (long_500k's batch: whole on every rank of
data) keeps every weight in place as the reference's partition does,
and costs what the reference's cell does."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
B, S = 4, 32
ARG_REL = 0.01
FLOP_REL = 0.05
TEMP_X = 2.0
WIRE_X = 1.25
# the dense decoder, the MoE (MLA, a dense_big layer, MoE layers, the
# MTP head), the SSM, the RG-LRU hybrid and the encoder-decoder of the
# block program
ARCHS = ("gemma-2b", "deepseek-v3-671b", "mamba2-780m", "recurrentgemma-2b",
         "whisper-base")
# the families whose train step is also run on the gloo ranks
RUN = ("gemma-2b", "mamba2-780m", "recurrentgemma-2b", "whisper-base")
# the families whose decode of one row (long_500k's batch) is traced
ONE_ROW = ("mamba2-780m", "recurrentgemma-2b")
# the cells traced and compiled: (name, arch, fields replaced, kinds,
# batch)
CELLS = [(a, a, {}, ("train", "prefill", "decode"), B) for a in ARCHS] + [
    ("internvl2-2b@v1025", "internvl2-2b", {"vocab_size": 1025},
     ("decode",), B)] + [(a + "@b1", a, {}, ("decode",), 1) for a in ONE_ROW]

FAKE = f"""
import dataclasses
import json
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import device
from repro_torch.configs.base import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import sharding
device.set_default("cpu")
dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {{}}
for name, arch, kw, kinds, rows in {CELLS!r}:
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    for kind in kinds:
        with sharding.use_mesh(mesh), \
                FakeTensorMode(allow_non_fake_inputs=True):
            _, step, args = dryrun.cell_step(
                cfg, ShapeConfig("t", {S}, rows, kind), dict(dryrun.FLAGS),
                "cpu")
            res = dryrun.trace(step, args)
        out.setdefault(name, {{}})[kind] = {{
            k: res[k] for k in ("flops", "flash_flops", "collective",
                                "memory")}}
dist.destroy_process_group()
print(json.dumps(out))
"""

REFERENCE = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses
import json
import jax
from repro.configs.base import ShapeConfig, get_config, reduced
from repro.launch.mesh import make_mesh
from repro.models.registry import build_model, input_specs
from repro.parallel import sharding
from repro.train import optimizer as optim
from repro.train.train_loop import make_train_step
from repro.utils import hlo_cost
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {{}}
for name, arch, kw, kinds, rows in {CELLS!r}:
  cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
  out[name] = {{}}
  with sharding.use_mesh(mesh):
    model = build_model(cfg)
    specs = model.param_specs()
    params = sharding.abstract_with_shardings(specs, cfg.dtype)
    for kind in kinds:
        ins = input_specs(cfg, ShapeConfig("t", {S}, rows, kind))
        if kind == "train":
            opt_cfg = optim.OptConfig()
            opt = sharding.abstract_with_shardings(
                optim.opt_state_specs(specs, opt_cfg), "float32")
            step = make_train_step(model, cfg, opt_cfg)
            compiled = jax.jit(step, donate_argnums=(0, 1)).lower(
                params, opt, dict(ins)).compile()
        elif kind == "prefill":
            compiled = jax.jit(lambda p, b: model.prefill(
                p, b["tokens"], **({{"embeddings": b["embeddings"]}}
                                   if "embeddings" in b else {{}}))).lower(
                params, ins).compile()
        else:
            compiled = jax.jit(model.decode_step, donate_argnums=(2,)).lower(
                params, ins["tokens"], ins["cache"], ins["pos"]).compile()
        mem = compiled.memory_analysis()
        res = hlo_cost.analyze(compiled.as_text())
        out[name][kind] = {{
            "argument_bytes": mem.argument_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "flops": res["flops"],
            "wire_bytes": res["collective"]["wire_bytes"]}}
print(json.dumps(out))
"""


def _start(prog):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(prog)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)


def _finish(proc, timeout=600) -> dict:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the fake trace, the reference's arguments, the gloo ranks)."""
    procs = [_start(FAKE), _start(REFERENCE)]
    try:
        ranks = _torch_ranks.run(["dryrun_cell"], WORLD,
                                 tmp_path_factory.mktemp("ranks"),
                                 {"dr/batch": np.asarray(B),
                                  "dr/seq": np.asarray(S),
                                  "dr/archs": np.asarray(RUN)})
        fake, ref = (_finish(p) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return fake, ref, ranks


def test_argument_bytes_are_the_reference_s_per_device_arguments(runs):
    fake, ref, _ = runs
    fake, ref = fake["gemma-2b"]["train"], ref["gemma-2b"]["train"]
    got, want = fake["memory"]["argument_bytes"], ref["argument_bytes"]
    print("argument bytes: port", got, "reference", want)
    assert abs(got - want) <= ARG_REL * want
    assert fake["memory"]["peak_bytes"] >= got + fake["memory"]["temp_bytes"] \
        - 1 and fake["memory"]["temp_bytes"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_block_program_cell_costs_the_reference_s_per_device(runs, kind,
                                                             arch):
    """The block program traced (this rank's blocks, its rows; decode
    on its param-rule block of the caches) against the reference's
    compiled cell, reduced gemma-2b, deepseek-v3 (MLA, its MoE and MTP
    head), mamba2-780m, recurrentgemma-2b and whisper-base: `flops_dev`,
    less the
    recompute in the train cell (one flash forward a layer: the port's
    flash backward recomputes it),
    within FLOP_REL; the arguments within ARG_REL; the temp bytes within
    TEMP_X of the reference's in train and prefill (a decode's writes its
    caches in place and is only printed)."""
    fake, ref, _ = runs
    fake, ref = fake[arch][kind], ref[arch][kind]
    flops = fake["flops"] - (fake["flash_flops"] if kind == "train" else 0)
    mem = fake["memory"]
    print(kind, "flops", flops, ref["flops"], "args", mem["argument_bytes"],
          ref["argument_bytes"], "temp", mem["temp_bytes"],
          ref["temp_bytes"])
    assert abs(flops - ref["flops"]) <= FLOP_REL * ref["flops"]
    assert abs(mem["argument_bytes"] - ref["argument_bytes"]) <= \
        ARG_REL * ref["argument_bytes"]
    if kind != "decode":
        assert mem["temp_bytes"] <= TEMP_X * ref["temp_bytes"]


def _trace_is_what_the_ranks_moved(fake, ranks, arch):
    """The fake trace's collectives (ops, counts and bytes by op, wire
    bytes) and FLOPs of `arch`'s train cell equal what every gloo rank
    dispatched in the same step."""
    fake = fake[arch]["train"]
    coll = fake["collective"]
    ops = sorted(coll["counts"])
    assert ops and coll["wire_bytes"] > 0
    pre = f"dr/{arch}/"
    for r in ranks:
        assert r[pre + "ops"].tolist() == ops
        assert r[pre + "counts"].tolist() == [coll["counts"][o] for o in ops]
        assert r[pre + "per_op_bytes"].tolist() == [
            coll["per_op_bytes"][o] for o in ops]
        assert float(r[pre + "wire_bytes"]) == coll["wire_bytes"]
        assert float(r[pre + "flops"]) == fake["flops"]


def test_fake_trace_counts_what_the_gloo_ranks_moved(runs):
    fake, _, ranks = runs
    _trace_is_what_the_ranks_moved(fake, ranks, "gemma-2b")


@pytest.mark.parametrize("arch", RUN[1:])
def test_recurrent_families_trace_what_the_gloo_ranks_moved(runs, arch):
    """mamba2's, recurrentgemma's and whisper-base's train steps on the
    block program: the fake trace counts the collectives and FLOPs their
    gloo ranks dispatched (the gated norm's psum, in_B / in_C's, the
    windowed attention's K/V gathers, the encoder-decoder's frames and
    cross-attention among them)."""
    fake, _, ranks = runs
    _trace_is_what_the_ranks_moved(fake, ranks, arch)


def test_replicated_vocab_decode_moves_the_reference_s_wire(runs):
    """internvl2-2b at vocab 1025 (the embedding and output tables whole
    over model 2, split over data by their embed columns): its decode
    cell contracts both in place (the data line's rows through the
    rank's columns, psum-scattered back) and moves at most WIRE_X of the
    reference's wire bytes a rank, where gathering both tables over data
    moved 1.48x; its FLOPs and arguments within their bounds."""
    fake, ref, _ = runs
    fake, ref = fake["internvl2-2b@v1025"]["decode"], \
        ref["internvl2-2b@v1025"]["decode"]
    wire = fake["collective"]["wire_bytes"]
    print("wire", wire, ref["wire_bytes"], "flops", fake["flops"],
          ref["flops"])
    assert wire <= WIRE_X * ref["wire_bytes"]
    assert abs(fake["flops"] - ref["flops"]) <= FLOP_REL * ref["flops"]
    assert abs(fake["memory"]["argument_bytes"] - ref["argument_bytes"]) \
        <= ARG_REL * ref["argument_bytes"]


@pytest.mark.parametrize("arch", ONE_ROW)
def test_one_row_decode_costs_the_reference_s_per_device(runs, arch):
    """A decode of one row of 32 (the reduced long_500k cell: the row
    whole on every rank of data, `sharding.rows_in_place`): each weight
    block contracted where it lies, its data rows' partial products
    psummed (no FSDP gather), the FLOPs within FLOP_REL and the
    arguments within ARG_REL of the reference's compiled cell, whose
    partition does the same; its wire bytes printed."""
    fake, ref, _ = runs
    fake, ref = fake[arch + "@b1"]["decode"], ref[arch + "@b1"]["decode"]
    print(arch, "flops", fake["flops"], ref["flops"], "wire",
          fake["collective"]["wire_bytes"], ref["wire_bytes"])
    assert abs(fake["flops"] - ref["flops"]) <= FLOP_REL * ref["flops"]
    assert abs(fake["memory"]["argument_bytes"] - ref["argument_bytes"]) \
        <= ARG_REL * ref["argument_bytes"]
