"""Training on a mesh: the port's sharded train step on 8 gloo ranks,
held against the JAX package's sharded step on 8 fake XLA devices.

The six reduced configs of `tests/test_sharded.py::
test_reduced_train_step_lowers_on_mesh` (gemma-2b, granite-moe-1b-a400m,
deepseek-v3-671b, mamba2-780m, recurrentgemma-2b, whisper-base, the last
fed seeded frame embeddings in both packages) on a (2, 2, 2) (pod, data,
model) mesh, on the `conditioned` copy of the reference's parameters
(`tests/_train_parity.py`), gemma-2b and granite with remat on in both
packages (`reduced()` turns it off), so that the collectives run again
inside the backward. Every config, whisper-base's encoder-decoder too,
runs the block program (`sharding.BLOCK_FAMILIES`): the job cuts the
parameters to the rank's blocks and the batch to its rows, and gathers
the gradient blocks whole to compare. The ranks run once for the module
(`_torch_ranks.run`, jobs `mesh_train` and `mesh_cli`); the reference's
numbers come from two subprocesses (three configs each) that run beside
them.

Tolerances. The first batch's loss at `LOSS_REL` (1e-5) and every leaf
of its whole gradient within `GRAD_REL` (1e-4) of the reference leaf's
largest |grad|, as `_train_parity` holds a single-process step; the
whole gradient bit-equal on all 8 ranks (a wrong transpose gives a rank
another share of it: an n-fold gradient or a rank's own). Two steps'
losses at 1e-5 and their clip norms at 1e-4. Each step's update (the
parameters after it less those before, over the step's rate) within
UPD_TOL of the reference's, by `_hold_update`: AdamW moves an element
by its rate times m̂ / (sqrt(v̂) + eps), about 1 where the gradient is
clear of 0, so a missing update or one of the wrong sign misses by ~1;
only where sqrt(v̂) is at most FLIP of the leaf's largest, where the
gradients' error can turn the sign, may the two differ by up to twice
the reference's largest update. Checkpoints and restarts bit for
bit."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import _torch_ranks
import _train_parity as tp_
from repro.train import optimizer as joptim
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro_torch import tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
ARCHS = ("gemma-2b", "granite-moe-1b-a400m", "deepseek-v3-671b",
         "mamba2-780m", "recurrentgemma-2b", "whisper-base")
REMAT = ("gemma-2b", "granite-moe-1b-a400m")
OPT = dict(lr=1e-3, warmup_steps=10, weight_decay=0.1)
CLI = ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps", "6",
       "--batch", "4", "--seq", "16", "--lr", "3e-3", "--log-every", "1",
       "--checkpoint-every", "2"]
CLI_FAIL_AT = 5
# `_hold_update`: where sqrt(v̂) exceeds FLIP of the leaf's largest, a
# gradient error of GRAD_REL of scale moves Adam's m̂ / sqrt(v̂) by about
# GRAD_REL / FLIP, so an update holds there within UPD_TOL of the step's
# rate (float32's rounding of the parameters on top). On the CPU the
# worst is 5.2e-4 (recurrentgemma-2b's second step); 15 % of the
# elements fall under FLIP, most at a gradient of exactly 0.
FLIP = 1e-2
UPD_TOL = tp_.GRAD_REL / FLIP

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config, reduced
from repro.launch.mesh import make_mesh
from repro.models.module import is_spec
from repro.models.registry import build_model
from repro.parallel import sharding
from repro.train import optimizer as optim
from repro.train.train_loop import jit_train_step, make_loss_fn

inp = dict(np.load(sys.argv[1]))
archs, remat = sys.argv[3].split(","), sys.argv[4].split(",")
OPT = optim.OptConfig(lr=float(inp["opt/lr"]),
                      warmup_steps=int(inp["opt/warmup_steps"]),
                      weight_decay=float(inp["opt/weight_decay"]))
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}


def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def params(model, arch):
    # fresh arrays each call: the step donates its inputs
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        model.param_specs(), is_leaf=is_spec)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(inp[f"{arch}/param/{key(k)}"]) for k, _ in flat])


def put(prefix, t):
    for k, a in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[prefix + key(k)] = np.asarray(a)


for arch in archs:
    cfg = reduced(get_config(arch))
    if arch in remat:
        cfg = dataclasses.replace(cfg, remat=True)
    model = build_model(cfg)
    batches = [{k.rsplit("/", 1)[1]: jnp.asarray(v) for k, v in inp.items()
                if k.startswith(f"{arch}/batch{i}/")} for i in range(2)]
    with sharding.use_mesh(mesh):
        shardings = sharding.param_shardings(model.param_specs())
        out[f"{arch}/block_shapes"] = np.asarray([
            list(s.shard_shape(spec.shape)) + [0] * (4 - len(spec.shape))
            for s, spec in zip(jax.tree.leaves(shardings), jax.tree.leaves(
                model.param_specs(), is_leaf=is_spec))])
        vg = jax.jit(jax.value_and_grad(make_loss_fn(model, cfg),
                                        has_aux=True))
        (loss, _), g = vg(params(model, arch), batches[0])
        out[f"{arch}/loss0"] = np.asarray(loss)
        put(f"{arch}/grad/", g)
        step = jit_train_step(model, cfg, OPT)
        p = params(model, arch)
        o = optim.init_opt_state(p, OPT)
        losses, norms = [], []
        for i in range(2):
            p, o, m = step(p, o, batches[i])
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            put(f"{arch}/step{i + 1}/", p)
            put(f"{arch}/v{i + 1}/", o["v"])
        out[f"{arch}/losses"] = np.asarray(losses)
        out[f"{arch}/gnorms"] = np.asarray(norms)
    if arch == "granite-moe-1b-a400m":
        # a model axis of 1: the experts' loop on every device's rows
        with sharding.use_mesh(make_mesh((2, 4, 1),
                                         ("pod", "data", "model"))):
            (loss, mets), g = jax.jit(jax.value_and_grad(
                make_loss_fn(model, cfg), has_aux=True))(
                    params(model, arch), batches[0])
        out[f"{arch}/m1/loss"] = np.asarray(loss)
        out[f"{arch}/m1/moe_aux"] = np.asarray(mets["moe_aux"])
        put(f"{arch}/m1grad/", g)
    with sharding.use_mesh(mesh):
        if arch == "gemma-2b":
            # the scan of make_train_step's microbatches=2: each half's
            # gradient over two, summed in float32
            p = params(model, arch)
            acc = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), p)
            n = batches[0]["tokens"].shape[0] // 2
            for h in range(2):
                _, g = vg(p, {k: v[h * n:(h + 1) * n]
                              for k, v in batches[0].items()})
                acc = jax.tree.map(
                    lambda a, b: a + b.astype(jnp.float32) / 2, acc, g)
            put(f"{arch}/mb2grad/", acc)
            step = jit_train_step(model, cfg, OPT, microbatches=2)
            p, o, m = step(p, optim.init_opt_state(p, OPT), batches[0])
            out[f"{arch}/mb2/loss"] = np.asarray(m["loss"])
            put(f"{arch}/mb2/", p)
            put(f"{arch}/mb2v/", o["v"])
np.savez(sys.argv[2], **out)
"""


def _inputs() -> dict:
    """The conditioned parameters and three batches of every arch, and the
    optimizer's settings, as numpy."""
    out = {f"opt/{k}": np.asarray(v) for k, v in OPT.items()}
    for arch in ARCHS:
        _, _, tm, cp = tp_.conditioned_pair(arch)
        out.update({f"{arch}/param/{k}": a.numpy()
                    for k, a in tree.flatten_with_keys(cp)})
        for i in range(3):
            out.update({f"{arch}/batch{i}/{k}": v for k, v in
                        tp_.batch(tm.cfg, i, B=4, S=16).items()})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the reference's results, each of the 8 ranks' results, the
    checkpoint directory, the CLI runs' directory)."""
    d = tmp_path_factory.mktemp("mt")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "in.npz"),
         str(d / f"ref{i}.npz"), ",".join(part), ",".join(REMAT)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env) for i, part in enumerate((ARCHS[:3], ARCHS[3:]))]
    try:
        payload = {f"mt/{k}": v for k, v in inp.items()}
        payload.update({"mt/archs": np.asarray(ARCHS),
                        "mt/remat": np.asarray(REMAT),
                        "mt/ckpt_dir": np.asarray(str(d / "ckpt")),
                        "cli/argv": np.asarray(CLI + ["--mesh", "2x2x2"]),
                        "cli/fail_at": np.asarray(CLI_FAIL_AT),
                        "cli/dir": np.asarray(str(d / "cli"))})
        got = _torch_ranks.run(("mesh_train", "mesh_cli"), WORLD, d, payload)
        # the starting parameters beside the reference's results
        ref = {k: v for k, v in inp.items() if "/param/" in k}
        for i, r in enumerate(refs):
            _, err = r.communicate(timeout=900)
            assert r.returncode == 0, err
            with np.load(d / f"ref{i}.npz") as z:
                ref.update({k: z[k] for k in z.files})
    finally:
        for r in refs:
            r.kill()
    return ref, got, d / "ckpt", d / "cli"


def _rank_equal(got, key):
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g[key], got[0][key],
                                      err_msg=f"{key}, rank {r}")


def _leaves(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _rate(step: int) -> float:
    """The reference's `_schedule`: the rate of the step-th update."""
    return OPT["lr"] * min(1.0, step / max(1, OPT["warmup_steps"]))


def _hold_update(what, before, after, want_before, want_after, v, step):
    """Hold the update of one AdamW step, (after - before) / rate, against
    the reference's, (want_after - want_before) / rate, leaf by leaf:
    within UPD_TOL plus float32's rounding of the four parameters, except
    where the reference's sqrt(v̂) after the step (the update's
    denominator: the gradients' root mean square) is at most FLIP of the
    leaf's largest: there the gradients' error (up to GRAD_REL of scale)
    can turn the update's sign, and it may differ by up to twice the
    reference's largest update."""
    rate = _rate(step)
    bc2 = 1.0 - joptim.OptConfig(**OPT).b2 ** step
    assert sorted(after) == sorted(want_after) == sorted(v)
    for k, w1 in want_after.items():
        u = (after[k].astype(np.float64) - before[k]) / rate
        w = (w1.astype(np.float64) - want_before[k]) / rate
        rms = np.sqrt(v[k] / bc2)
        clear = rms > FLIP * rms.max()
        ulp = sum(np.spacing(np.abs(a[k]).astype(np.float32))
                  for a in (before, after, want_before, want_after))
        err = np.abs(u - w)
        bad = clear & (err > UPD_TOL + ulp / rate)
        assert not bad.any(), (
            f"{what} step {step} {k}: {int(bad.sum())} of {bad.size} "
            f"updates off by up to {float(err[bad].max()):.4g} of the rate")
        assert float(err.max(initial=0)) <= (
            2 * float(np.abs(w).max(initial=0)) + UPD_TOL
            + float((ulp / rate).max(initial=0))), (what, step, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_gradient_matches_the_reference_on_every_rank(ranks, arch):
    """The first batch's loss and gradient on (2, 2, 2) — the block
    program's gradient blocks, every sharded branch the config takes
    differentiated through its collectives, gathered whole — against
    `jax.value_and_grad` of the reference's loss on its mesh: each leaf
    within GRAD_REL of its scale, and bit-equal on every rank."""
    ref, got, _, _ = ranks
    pre = f"mt/{arch}/"
    np.testing.assert_allclose(got[0][pre + "loss0"], ref[f"{arch}/loss0"],
                               rtol=tp_.LOSS_REL)
    want = _leaves(ref, f"{arch}/grad/")
    have = _leaves(got[0], pre + "grad/")
    assert sorted(have) == sorted(want)
    worst = {k: float(np.abs(have[k] - w).max() / max(np.abs(w).max(),
                                                       1e-30))
             for k, w in want.items()}
    assert max(worst.values()) <= tp_.GRAD_REL, worst
    for k in have:
        _rank_equal(got, pre + "grad/" + k)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_sharded_steps_match_the_reference(ranks, arch):
    """Two `jit_train_step`s on the ranks' blocks (the block program's
    gradient blocks, AdamW on the blocks with the clip norm over them)
    against the reference's sharded `jit_train_step`: the
    losses at 1e-5, the clip norms at 1e-4, each step's update by
    `_hold_update`, and the parameters the same on every rank."""
    ref, got, _, _ = ranks
    pre = f"mt/{arch}/"
    np.testing.assert_allclose(got[0][pre + "losses"], ref[f"{arch}/losses"],
                               rtol=tp_.LOSS_REL)
    np.testing.assert_allclose(got[0][pre + "gnorms"], ref[f"{arch}/gnorms"],
                               rtol=1e-4)
    start = _leaves(ref, f"{arch}/param/")
    have, want = [start], [start]
    for s in (1, 2):
        have.append(_leaves(got[0], pre + f"step{s}/"))
        want.append(_leaves(ref, f"{arch}/step{s}/"))
        _hold_update(arch, have[s - 1], have[s], want[s - 1], want[s],
                     _leaves(ref, f"{arch}/v{s}/"), s)
        for k in have[s]:
            _rank_equal(got, pre + f"step{s}/" + k)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_the_reference_blocks(ranks, arch):
    """Between steps a rank holds, of every parameter, the block shape
    the reference's `param_shardings` gives it on (2, 2, 2)
    (`NamedSharding.shard_shape`; FSDP's embed over data included)."""
    ref, got, _, _ = ranks
    want = ref[f"{arch}/block_shapes"]
    for g in got:
        np.testing.assert_array_equal(g[f"mt/{arch}/block_shapes"], want)
    shapes = [tuple(r) for r in want]
    whole = [tuple(a.shape) + (0,) * (4 - a.ndim) for a in
             tree.leaves(tp_.pair(arch)[3])]
    assert any(s != w for s, w in zip(shapes, whole)), "nothing sharded"


def test_microbatches_on_a_mesh_match_the_reference(ranks):
    """gemma-2b at microbatches=2 on (2, 2, 2), one row a rank, where
    each of the reference's microbatches (rows [0, 2) and [2, 4)) splits
    over pod alone and stays whole over data (`sharding.rows(batch, 2)`,
    as GSPMD lays it out), and on (1, 2, 4), where each splits over
    data: the whole gradient of `make_grads_fn(microbatches=2)` against
    the reference's scan of `jax.value_and_grad` over the two halves
    (each leaf within GRAD_REL of its scale, bit-equal on every rank),
    two chunks run; on (1, 2, 4) the sharded step's loss at 1e-5
    against the reference's `jit_train_step(microbatches=2)` and its
    update by `_hold_update`."""
    ref, got, _, _ = ranks
    want = _leaves(ref, "gemma-2b/mb2grad/")
    for name in ("mb2grad222/", "mb2grad/"):
        have = _leaves(got[0], "mt/gemma-2b/" + name)
        assert sorted(have) == sorted(want)
        worst = {k: float(np.abs(have[k] - w).max()
                          / max(np.abs(w).max(), 1e-30))
                 for k, w in want.items()}
        assert max(worst.values()) <= tp_.GRAD_REL, (name, worst)
        for k in have:
            _rank_equal(got, "mt/gemma-2b/" + name + k)
    assert all(int(g["mt/gemma-2b/mb2chunks"]) == 2 for g in got)
    np.testing.assert_allclose(got[0]["mt/gemma-2b/mb2/loss"],
                               ref["gemma-2b/mb2/loss"], rtol=tp_.LOSS_REL)
    want = _leaves(ref, "gemma-2b/mb2/")
    want.pop("loss")
    have = _leaves(got[0], "mt/gemma-2b/mb2/")
    have.pop("loss")
    start = _leaves(ref, "gemma-2b/param/")
    _hold_update("gemma-2b mb2", start, have, start, want,
                 _leaves(ref, "gemma-2b/mb2v/"), 1)


def test_moe_on_a_mesh_whose_model_axis_is_1_matches_the_reference(ranks):
    """granite-moe on (2, 4, 1), where the model axis has one rank: the
    block program's `_moe_local` on each rank's rows (its four rows split
    over pod alone, whole over data) with the experts gathered whole
    from their FSDP blocks, no capacity, the aux loss global. The loss
    and the aux loss at 1e-5 and the whole gradient within GRAD_REL of
    its scale against the reference's sharded step on the same mesh,
    bit-equal on every rank."""
    ref, got, _, _ = ranks
    pre = "mt/granite-moe-1b-a400m/m1"
    for name in ("loss", "moe_aux"):
        for g in got:
            np.testing.assert_allclose(
                g[f"{pre}/{name}"], ref[f"granite-moe-1b-a400m/m1/{name}"],
                rtol=tp_.LOSS_REL)
    want = _leaves(ref, "granite-moe-1b-a400m/m1grad/")
    have = _leaves(got[0], pre + "grad/")
    assert sorted(have) == sorted(want)
    worst = {k: float(np.abs(have[k] - w).max() / max(np.abs(w).max(), 1e-30))
             for k, w in want.items()}
    assert max(worst.values()) <= tp_.GRAD_REL, worst
    for k in have:
        _rank_equal(got, pre + "grad/" + k)
    assert float(ref["granite-moe-1b-a400m/m1/moe_aux"]) > 0


def test_checkpoint_resumes_on_another_mesh_one_process_and_the_reference(
        ranks):
    """gemma-2b's state after two steps on (2, 2, 2), saved through the
    spec tree (rank 0 writes it whole): restored on (1, 2, 4) (each rank
    cuts its new blocks), in one process and by the reference's
    Checkpointer, bit-equal to the saved parameters everywhere; the
    third step from it on (1, 2, 4) and in one process within 1e-5 of
    the loss of the same step on (2, 2, 2), and its update held against
    that step's by `_hold_update`."""
    import torch

    from repro_torch import device as tdevice
    from repro_torch.train import optimizer as toptim
    from repro_torch.train import train_loop
    from repro_torch.train.checkpoint import Checkpointer

    ref, got, ckpt, _ = ranks
    saved = _leaves(got[0], "mt/gemma-2b/step2/")
    for g in got:
        restored = _leaves(g, "mt/gemma-2b/m124/restored/")
        assert sorted(restored) == sorted(saved)
        for k, a in saved.items():
            np.testing.assert_array_equal(restored[k], a, err_msg=k)
    _, jp, tm, tp = tp_.pair("gemma-2b")
    prev = tdevice.set_default("cpu")
    try:
        ocfg = toptim.OptConfig(**OPT)
        template = {"params": tp, "opt": toptim.init_opt_state(tp, ocfg)}
        step, state = Checkpointer(str(ckpt)).restore(template)
        assert step == 2 and int(state["opt"]["step"]) == 2
        for k, a in tree.flatten_with_keys(state["params"]):
            np.testing.assert_array_equal(a.numpy(), saved[k], err_msg=k)
        batch = {k: torch.from_numpy(np.array(v)) for k, v in
                 tp_.batch(tm.cfg, 2, B=4, S=16).items()}
        p, _, m = train_loop.make_train_step(tm, tm.cfg, ocfg)(
            state["params"], state["opt"], batch)
    finally:
        tdevice.set_default(prev)
    jt = {"params": jp, "opt": joptim.init_opt_state(jp, joptim.OptConfig(
        **OPT))}
    jstep, jstate = JCheckpointer(str(ckpt)).restore(jt)
    assert jstep == 2
    for (k, _), a in zip(tree.flatten_with_keys(tp),
                         jax.tree.leaves(jstate["params"])):
        np.testing.assert_array_equal(np.asarray(a), saved[k], err_msg=k)
    want = float(got[0]["mt/gemma-2b/step3/loss"])
    for loss in (float(got[0]["mt/gemma-2b/m124/loss"]), float(m["loss"])):
        np.testing.assert_allclose(loss, want, rtol=tp_.LOSS_REL)
    s3 = _leaves(got[0], "mt/gemma-2b/step3/")
    s3.pop("loss")
    v3 = _leaves(got[0], "mt/gemma-2b/v3/")
    one = {k: a.numpy() for k, a in tree.flatten_with_keys(p)}
    for name, after in (("one process", one), ("(1, 2, 4)", _leaves(
            got[0], "mt/gemma-2b/m124/step3/"))):
        _hold_update(name, saved, after, saved, s3, v3, 3)


def test_cli_trains_on_a_mesh_and_restarts_bit_equal(ranks, capsys):
    """`launch.train --mesh 2x2x2 --reduced --device cpu` on 8 gloo ranks:
    a run checkpointing every 2 steps and the same run failing at step 5
    and restoring its step-4 checkpoint through the spec tree give the
    same losses step by step and the same final parameters, bit for bit,
    on every rank. Its losses within 1e-5 of one process's: the first,
    those of its step-2 and step-4 checkpoints, and those after each of
    these checkpoints' next update (steps 3 and 5: one process's AdamW
    step at the CLI's rate and schedule from the checkpointed parameters
    and moments). gemma-2b runs the block program, whose sums fall
    otherwise than one process's; Adam's first update (the sign of each
    gradient on this unconditioned model) turns those roundings into
    another trajectory (step 1 reads 1.1e-4 off), so the updates are held
    from checkpoints, where the moments are past it (steps 3 and 5 read
    1.6e-7 and 6.0e-6 off; a rate 10 % off reads 3.6e-3)."""
    import torch

    from repro_torch import device as tdevice
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.registry import build_model
    from repro_torch.train import optimizer as toptim
    from repro_torch.train import train_loop
    from repro_torch.train.checkpoint import Checkpointer

    _, got, _, cli = ranks
    g = got[0]
    assert g["cli/whole/steps"].tolist() == list(range(6))
    resumed = CLI_FAIL_AT // 2 * 2
    assert g["cli/failed/steps"].tolist() == (list(range(CLI_FAIL_AT))
                                             + list(range(resumed, 6)))
    by_step = dict(zip(g["cli/whole/steps"].tolist(),
                       g["cli/whole/losses"].tolist()))
    assert [by_step[s] for s in g["cli/failed/steps"].tolist()] == \
        g["cli/failed/losses"].tolist()
    whole = _leaves(g, "cli/whole/param/")
    for r in got:
        for k, a in whole.items():
            np.testing.assert_array_equal(r[f"cli/failed/param/{k}"], a)
            np.testing.assert_array_equal(r[f"cli/whole/param/{k}"], a)
    assert int(g["cli/whole/step"]) == 6
    assert sorted(os.listdir(cli / "whole")) == [
        f"step_{s:09d}" for s in (2, 4, 6)]
    prev = tdevice.set_default("cpu")
    try:
        cfg = reduced(get_config("gemma-2b"))
        model = build_model(cfg)
        batch_fn = tlaunch.make_batch_fn(cfg, 4, 16, device="cpu")
        loss_fn = train_loop.make_loss_fn(model, cfg)
        # the CLI's optimizer at --lr 3e-3 --steps 6 (warmup 6 // 10 + 1)
        opt_cfg = toptim.OptConfig(lr=3e-3, warmup_steps=1)
        step = train_loop.make_train_step(model, cfg, opt_cfg)
        p0 = model.init(torch.Generator().manual_seed(0), device="cpu")
        template = {"params": p0,
                    "opt": toptim.init_opt_state(p0, opt_cfg)}
        with torch.no_grad():
            want = {0: float(loss_fn(p0, batch_fn(0))[0])}
        for k in (2, 4):
            _, state = Checkpointer(str(cli / "whole")).restore(template, k)
            p, _, m = step(state["params"], state["opt"], batch_fn(k))
            want[k] = float(m["loss"])
            with torch.no_grad():
                want[k + 1] = float(loss_fn(p, batch_fn(k + 1))[0])
    finally:
        tdevice.set_default(prev)
    for k, w in want.items():
        np.testing.assert_allclose(g["cli/whole/losses"][k], w,
                                   rtol=tp_.LOSS_REL, err_msg=f"step {k}")
    capsys.readouterr()
