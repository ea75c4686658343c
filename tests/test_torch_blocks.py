"""The block program on 8 gloo ranks, held against the JAX package's
sharded step on 8 fake XLA devices.

Under a `DeviceMesh` a model of `sharding.BLOCK_FAMILIES` (dense, vlm,
moe) runs each rank's own program on its blocks: the batch split over
(pod, data), each layer's weights gathered over data inside it (FSDP),
q/k/v and the FFN column-parallel and the out-projections row-parallel
over `model`, the embedding and the loss vocab-parallel; an MoE's router
and experts on the rank's tokens (expert parallelism over `model`, the
aux loss global), MLA's heads over `model`, the MTP head on the rank's
rows. The reference gets the same partition from GSPMD. One case a
branch, each a reduced config `dataclasses.replace`d the same way in
both packages, on a (2, 2, 2) (pod, data, model) mesh:

  gemma       reduced gemma-2b (H 4, KVH 1): head-TP, KV repeated
  codeqwen    reduced codeqwen1.5-7b (KVH 2): grouped head-TP
  cp          gemma-2b at H 3 / KVH 1: context parallelism
  vocab257    gemma-2b at vocab 257: the vocab replicated over model
  internvl    reduced internvl2-2b: the frontend splice
  granite     reduced granite-moe (4 experts, top 2), its capacity
              factor 0.5: `_moe_a2a`, drops; also at microbatches=2
  deepseek    reduced deepseek-v3: MLA, a dense_big layer, MoE with a
              shared expert at its factor 1.25 (drops), the MTP head
  deepseek_sp deepseek-v3 with Megatron-SP: `mla_forward_sp`, the SP
              FFNs, the MoE on the rank's S/M positions

on the conditioned copy of the reference's parameters
(`tests/_train_parity.py`). The ranks run once for the module
(`_torch_ranks.run`, job `blocks`); the reference's numbers come from
two subprocesses beside them (the dense cases, the MoE cases).

Held: the first batch's loss at `LOSS_REL` (an MoE's aux loss and MTP
loss too, and its MTP logits and every dispatch's kept assignments, rank
by rank); each rank's gradient block
against the same block of the reference's gradient within `GRAD_REL`
of the leaf's scale, bit-equal on the ranks that hold the same block;
two `jit_train_step`s' losses (1e-5), clip norms (1e-4) and updates
(`_hold_update`); the prefill's last logits, its caches and one decode
step's logits at `MODEL_REL` of their scale. And the structure: inside
a step the residual stream, the FFN hidden and the logits each have
this rank's `block_shape` under their activation spec (the global view
holds them whole). `chip_smoke.py`'s phase 16 runs its ranks in turns in
one process (`parallel.turns`); at CPU size its every rank's outputs
equal the gloo ranks' of the same steps."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_ranks
import _train_parity as tp_
from test_torch_mesh_train import OPT, _hold_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
SHAPE = (2, 2, 2)
AXES = ("pod", "data", "model")
B, S, MAX_SEQ = 4, 16, 24
MODEL_REL = 1e-3
# phase 16's ranks in turns against the gloo ranks: the same per-rank
# arithmetic, the collectives' sums in another order
TURNS_REL = 1e-6
# the same for the SSM and the hybrid, whose recurrences amplify that
# reordering (float32 ulps of a psum over model) in float32: measured at
# most 2.34e-6 of scale (mamba2's A_log gradient) and 8.56e-6
# (recurrentgemma's gate_a gradient; its first layer's outputs bit-equal,
# the next psum's rounding grown through sqrt(1 - a^2) near a = 1)
TURNS_REL_RECURRENT = {"mamba2-780m": 1e-5, "recurrentgemma-2b": 3e-5}
# case -> (arch, the fields replaced in both packages' reduced config)
CASES = {"gemma": ("gemma-2b", {}),
         "codeqwen": ("codeqwen1.5-7b", {}),
         "cp": ("gemma-2b", {"n_heads": 3}),
         "vocab257": ("gemma-2b", {"vocab_size": 257}),
         "internvl": ("internvl2-2b", {}),
         "sp": ("stablelm-12b", {}),
         "sp_cp": ("gemma-2b", {"n_heads": 3}),
         "granite": ("granite-moe-1b-a400m", {"moe": {"capacity_factor": 0.5}}),
         "deepseek": ("deepseek-v3-671b", {}),
         "deepseek_sp": ("deepseek-v3-671b", {})}
BRANCH = {"gemma": "head_tp", "codeqwen": "head_tp", "cp": "cp",
          "vocab257": "head_tp", "internvl": "head_tp", "sp": "head_tp",
          "sp_cp": "cp", "granite": "head_tp", "deepseek": "mla",
          "deepseek_sp": "mla"}
# the MoE cases (family "moe"): reduced granite-moe (4 experts, top 2, GQA
# head-TP, its config's capacity factor set to 0.5 so that assignments
# drop) and reduced deepseek-v3 (MLA, one dense_big layer, then MoE with
# a shared expert, the MTP head; its config's factor 1.25, which drops),
# and deepseek-v3 with Megatron-SP
MOE = ("granite", "deepseek", "deepseek_sp")
# the cases that also run microbatches=2 against the reference's split
MB2 = ("granite",)
# the cases run with Megatron-SP on (both packages' `seq_parallel`), and
# the SP bodies each takes: stablelm's attention through `attn_apply_sp`,
# gemma's at H 3 (which `attn_apply_sp` does not take) on the gathered
# stream; both FFNs by the reference's choice of body; deepseek's MLA
# through `mla_forward_sp` in training, its first dense FFN and shared
# expert by the reference's choice, the MoE on the rank's S/M positions
SP = {"sp": ("attn_apply_sp", "_ffn_apply_sp"), "sp_cp": ("_ffn_apply_sp",),
      "deepseek_sp": ("mla_forward_sp", "_ffn_apply_sp")}

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config, reduced
from repro.launch.mesh import make_mesh
from repro.models.module import is_spec
from repro.models.registry import build_model
from repro.parallel import sharding
from repro.serve.kvcache import pad_caches
from repro.train import optimizer as optim
from repro.train.train_loop import jit_train_step, make_loss_fn
from repro import perf
from repro.models import moe
from jax import lax

inp = dict(np.load(sys.argv[1]))
# each dispatch's expert ids and kept slots, by rank, while RECORD is on
RECORD, assigned = [False], {r: [] for r in range(8)}
_dispatch = moe._dispatch_indices


def _recorded(idx, w, E, C):
    slot, keep = _dispatch(idx, w, E, C)
    if RECORD[0]:
        jax.debug.callback(
            lambda i, k, p, d, m: assigned[4 * int(p) + 2 * int(d)
                                           + int(m)].append(
                [np.asarray(i).tolist(), np.asarray(k).tolist()]),
            idx, keep, lax.axis_index("pod"), lax.axis_index("data"),
            lax.axis_index("model"))
    return slot, keep


moe._dispatch_indices = _recorded


def recorded(fn):
    # a fresh trace with the callback in; every rank's list, then cleared
    RECORD[0] = True
    try:
        res = jax.block_until_ready(fn())
    finally:
        RECORD[0] = False
    got = {r: json.dumps(sorted(a)) for r, a in assigned.items()}
    for a in assigned.values():
        a.clear()
    return res, got
cases = json.loads(sys.argv[3])
OPT = optim.OptConfig(lr=float(inp["opt/lr"]),
                      warmup_steps=int(inp["opt/warmup_steps"]),
                      weight_decay=float(inp["opt/weight_decay"]))
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
S, MAX_SEQ = int(inp["seq"]), int(inp["max_seq"])
out = {}


def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def put(prefix, t):
    for k, a in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[prefix + key(k)] = np.asarray(a)


for case, arch, kw, sp, mb, *flags in cases:
    perf.reset_flags()
    perf.set_flags(seq_parallel=sp == "1",
                   **(json.loads(flags[0]) if flags else {}))
    cfg = reduced(get_config(arch))
    kw = {k: dataclasses.replace(getattr(cfg, k), **v)
          if isinstance(v, dict) else v for k, v in json.loads(kw).items()}
    cfg = dataclasses.replace(cfg, **kw)
    model = build_model(cfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        model.param_specs(), is_leaf=is_spec)

    def params():
        return jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(inp[f"{case}/param/{key(k)}"]) for k, _ in flat])
    batches = [{k.rsplit("/", 1)[1]: jnp.asarray(v) for k, v in inp.items()
                if k.startswith(f"{case}/batch{i}/")} for i in range(2)]
    with sharding.use_mesh(mesh):
        vg = jax.jit(jax.value_and_grad(make_loss_fn(model, cfg),
                                        has_aux=True))
        (loss, mets), g = vg(params(), batches[0])
        out[f"{case}/loss0"] = np.asarray(loss)
        for k in ("moe_aux", "mtp_ce"):
            if k in mets:
                out[f"{case}/{k}0"] = np.asarray(mets[k])
        put(f"{case}/grad/", g)
        if cfg.moe is not None:
            (_, extras), got = recorded(lambda: jax.jit(model.forward)(
                params(), batches[0]["tokens"]))
            out.update({f"{case}/assignments/{r}": np.asarray(a)
                        for r, a in got.items()})
            if "mtp_logits" in extras:
                out[f"{case}/mtp"] = np.asarray(extras["mtp_logits"])
        if mb == "1":
            # make_train_step's scan over microbatches=2: each one's
            # gradient over two, summed in float32
            gf = jax.value_and_grad(make_loss_fn(model, cfg), has_aux=True)

            def mb2(p, b):
                n = b["tokens"].shape[0] // 2
                mbs = {k: v.reshape(2, n, *v.shape[1:]) for k, v in b.items()}

                def body(acc, x):
                    (l, m), g_ = gf(p, x)
                    return jax.tree.map(lambda a, c: a + c.astype(
                        jnp.float32) / 2, acc, g_), (l, m)
                zeros = jax.tree.map(lambda a: jnp.zeros(a.shape,
                                                         jnp.float32), p)
                acc, (ls, ms) = lax.scan(body, zeros, mbs)
                return ls.mean(), jax.tree.map(jnp.mean, ms), acc
            (l, m, g), got = recorded(lambda: jax.jit(mb2)(params(),
                                                           batches[0]))
            out[f"{case}/mb2/loss"] = np.asarray(l)
            out[f"{case}/mb2/moe_aux"] = np.asarray(m["moe_aux"])
            put(f"{case}/mb2grad/", g)
            out.update({f"{case}/mb2/assignments/{r}": np.asarray(a)
                        for r, a in got.items()})
        step = jit_train_step(model, cfg, OPT)
        p = params()
        o = optim.init_opt_state(p, OPT)
        losses, norms = [], []
        for i in range(2):
            p, o, m = step(p, o, batches[i])
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            put(f"{case}/step{i + 1}/", p)
            put(f"{case}/v{i + 1}/", o["v"])
        out[f"{case}/losses"] = np.asarray(losses)
        out[f"{case}/gnorms"] = np.asarray(norms)
        b0 = batches[0]
        logits, caches = jax.jit(lambda p, t, e: model.prefill(
            p, t, embeddings=e))(params(), b0["tokens"], b0.get("embeddings"))
        out[f"{case}/prefill"] = np.asarray(logits)
        put(f"{case}/cache/", caches)
        caches = pad_caches(caches, S, MAX_SEQ)
        logits, _ = jax.jit(model.decode_step)(
            params(), jnp.asarray(inp[f"{case}/step_tokens"]), caches,
            jnp.full((b0["tokens"].shape[0],), S, jnp.int32))
        out[f"{case}/decode"] = np.asarray(logits)
perf.reset_flags()
np.savez(sys.argv[2], **out)
"""


def _replaced(cfg, kw: dict):
    """`cfg` with the fields of `kw` replaced (an entry that is a dict,
    such as "moe" or "frontend", the fields of that nested config), as
    both packages' configs take them."""
    import dataclasses
    kw = {k: dataclasses.replace(getattr(cfg, k), **v)
          if isinstance(v, dict) else v for k, v in kw.items()}
    return dataclasses.replace(cfg, **kw)


def _pair(arch: str, kw: dict):
    """The conditioned copy of the reference's parameters of the case's
    config, as the port's tree, and the port's config."""
    import jax

    from repro.configs.base import get_config as jget_config
    from repro.configs.base import reduced as jreduced
    from repro.models.registry import build_model as jbuild
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.registry import build_model
    jm = jbuild(_replaced(jreduced(jget_config(arch)), kw))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = build_model(_replaced(reduced(get_config(arch)), kw))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    return tp_.conditioned(tp, tm.cfg), tm.cfg


def _inputs() -> dict:
    """Every case's conditioned parameters, two batches and a decode
    step's tokens, and the optimizer's settings, as numpy."""
    from repro_torch import tree
    out = {f"opt/{k}": np.asarray(v) for k, v in OPT.items()}
    out.update({"seq": np.asarray(S), "max_seq": np.asarray(MAX_SEQ)})
    for case, (arch, kw) in CASES.items():
        cp, cfg = _pair(arch, kw)
        out.update({f"{case}/param/{k}": a.numpy()
                    for k, a in tree.flatten_with_keys(cp)})
        for i in range(2):
            out.update({f"{case}/batch{i}/{k}": v for k, v in
                        tp_.batch(cfg, i, B=B, S=S).items()})
        out[f"{case}/step_tokens"] = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, 1)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the reference's results, each of the 8 ranks' results)."""
    d = tmp_path_factory.mktemp("blocks")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    cases = [[c, a, json.dumps(kw), str(int(c in SP)), str(int(c in MB2))]
             for c, (a, kw) in CASES.items()]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "in.npz"),
         str(d / f"ref{i}.npz"), json.dumps(part)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env) for i, part in enumerate((cases[:7], cases[7:]))]
    try:
        payload = {f"bl/{k}": v for k, v in inp.items()}
        payload["bl/cases"] = np.asarray(cases)
        got = _torch_ranks.run(("blocks", "phase16"), WORLD, d, payload)
        ref = {k: v for k, v in inp.items() if "/param/" in k}
        for i, r in enumerate(refs):
            _, err = r.communicate(timeout=900)
            assert r.returncode == 0, err
            with np.load(d / f"ref{i}.npz") as z:
                ref.update({k: z[k] for k in z.files})
    finally:
        for r in refs:
            r.kill()
    return ref, got


def _leaves(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _specs(case):
    """{leaf key: its resolved param spec} on an abstract (2, 2, 2)."""
    from repro_torch import tree
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding
    cfg = _torch_ranks.block_cfg(CASES[case][0], json.dumps(CASES[case][1]))
    specs = build_model(cfg).param_specs()
    with sharding.use_mesh(abstract_mesh(SHAPE, AXES)):
        pspecs = sharding.param_pspecs(specs)
    return dict(zip([k for k, _ in tree.flatten_with_keys(specs)],
                    sharding.leaf_specs(specs, pspecs))), cfg


def _np_block(a, spec, rank: int):
    """Rank `rank`'s block of the whole `a` under `spec` on (2, 2, 2),
    a tuple entry's first axis major (JAX's order)."""
    coord = dict(zip(AXES, np.unravel_index(rank, SHAPE)))
    size = dict(zip(AXES, SHAPE))
    for d, ent in enumerate(spec):
        if ent is None:
            continue
        idx, n = 0, 1
        for ax in (ent,) if isinstance(ent, str) else ent:
            idx, n = idx * size[ax] + coord[ax], n * size[ax]
        w = a.shape[d] // n
        a = np.take(a, range(idx * w, (idx + 1) * w), axis=d)
    return a


def _rel(have, want):
    return float(np.abs(have - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradient_blocks_match_the_reference(ranks, case):
    """The first batch's loss at 1e-5 and, on every rank, each leaf's
    gradient block within GRAD_REL of the reference leaf's scale against
    the reference gradient's block; the ranks that hold the same block
    hold the same bits, and the blocks gathered whole are the reference's
    gradient."""
    ref, got = ranks
    pre = f"bl/{case}/"
    specs, _ = _specs(case)
    want = _leaves(ref, f"{case}/grad/")
    assert sorted(want) == sorted(specs)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g[pre + "loss0"], ref[f"{case}/loss0"],
                                   rtol=tp_.LOSS_REL)
        have = _leaves(g, pre + "gblock/")
        worst = {k: float(np.abs(have[k] - _np_block(w, specs[k], r)).max()
                          / max(np.abs(w).max(), 1e-30))
                 for k, w in want.items()}
        assert max(worst.values()) <= tp_.GRAD_REL, (r, worst)
        whole = _leaves(g, pre + "grad/")
        for k, w in want.items():
            assert _rel(whole[k], w) <= tp_.GRAD_REL, (r, k)
            np.testing.assert_array_equal(whole[k], got[0][pre + "grad/" + k])


@pytest.mark.parametrize("case", CASES)
def test_two_block_steps_match_the_reference(ranks, case):
    """Two `jit_train_step`s of the block program against the
    reference's sharded `jit_train_step`: the losses at 1e-5, the clip
    norms (the blocks' sums of squares psummed over the axes that split
    them) at 1e-4, each step's update by `_hold_update`, and the
    parameters gathered whole the same on every rank."""
    ref, got = ranks
    pre = f"bl/{case}/"
    np.testing.assert_allclose(got[0][pre + "losses"], ref[f"{case}/losses"],
                               rtol=tp_.LOSS_REL)
    np.testing.assert_allclose(got[0][pre + "gnorms"], ref[f"{case}/gnorms"],
                               rtol=1e-4)
    start = _leaves(ref, f"{case}/param/")
    have, want = [start], [start]
    for s in (1, 2):
        have.append(_leaves(got[0], pre + f"step{s}/"))
        want.append(_leaves(ref, f"{case}/step{s}/"))
        _hold_update(case, have[s - 1], have[s], want[s - 1], want[s],
                     _leaves(ref, f"{case}/v{s}/"), s)
        for g in got:
            for k, a in have[s].items():
                np.testing.assert_array_equal(g[pre + f"step{s}/" + k], a)


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_the_reference(ranks, case):
    """The prefill's last logits (each rank's rows and vocab columns,
    gathered) and its caches ((B/dp, S/M) blocks, gathered), and one
    decode step on the rank's rows and its param-rule block of the
    padded caches, written in place: each within MODEL_REL of the
    reference's scale, the same on every rank."""
    ref, got = ranks
    pre = f"bl/{case}/"
    for r, g in enumerate(got):
        for name in ("prefill", "decode"):
            assert _rel(g[pre + name], ref[f"{case}/{name}"]) <= MODEL_REL, \
                (r, name)
            np.testing.assert_array_equal(g[pre + name], got[0][pre + name])
        want = _leaves(ref, f"{case}/cache/")
        have = _leaves(g, pre + "cache/")
        assert sorted(have) == sorted(want)
        for k, w in want.items():
            assert _rel(have[k], w) <= MODEL_REL, (r, k)


@pytest.mark.parametrize("case", CASES)
def test_block_program_keeps_every_activation_a_block(ranks, case):
    """Inside a step each rank holds its block, never the global view:
    the residual stream entering every layer, the FFN hidden and the
    logits each have this rank's `block_shape` under their activation
    spec ((batch, seq, embed), (batch, seq, mlp), (batch, seq, vocab));
    where the vocab does not split (257 over 2) the logits keep it
    whole. An MoE's hidden are its dense FFN's and its shared expert's
    (the MTP head's block at S - 1 tokens too); granite has none. Under
    Megatron-SP the residual stream is the rank's S/M positions and the
    SP bodies ran (`SP`)."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.parallel import sharding
    _, got = ranks
    pre = f"bl/{case}/"
    _, cfg = _specs(case)
    D, V = cfg.d_model, cfg.vocab_size
    with sharding.use_mesh(abstract_mesh(SHAPE, AXES)):
        def blk(shape, axes):
            return sharding.block_shape(shape, sharding.resolve_spec(
                axes, shape, "act"))
        want = {"residual": blk((B, S, D), ("batch", "seq", "embed")),
                "logits": blk((B, S, V), ("batch", "seq", "vocab")),
                "hidden": sorted(blk((B, s_, f), ("batch", "seq", "mlp"))
                                 for s_, f in _hidden_widths(cfg))}
    if case in SP:
        want["residual"] = (1, S // 2, D)
        assert list(g[pre + "sp_calls"] for g in got[:1])[0].tolist() == \
            list(SP[case])
        for g in got:
            assert sorted(g[pre + "sp_calls"]) == sorted(SP[case])
        want.pop("hidden")      # the SP FFN's columns are its own
    elif case in MOE:
        assert want["hidden"] == sorted((1, s_, f // 2)
                                        for s_, f in _hidden_widths(cfg))
    else:
        assert want["hidden"] == [(1, S, cfg.d_ff // 2)]
    assert want["residual"][:2] == (1, S // 2 if case in SP else S)
    assert want["logits"] == (1, S, V // 2 if V % 2 == 0 else V)
    for g in got:
        assert [tuple(s) for s in g[pre + "shapes/residual"]] == \
            [want["residual"]]
        if "hidden" in want:
            assert sorted(tuple(s) for s in g[pre + "shapes/hidden"]
                          if len(s)) == want["hidden"]
        assert tuple(g[pre + "shapes/logits"]) == want["logits"]
    assert sharding.BLOCK_FAMILIES >= {cfg.family}
    assert BRANCH[case] == _branch(cfg)


def _hidden_widths(cfg) -> set:
    """(tokens a row, width) of every FFN hidden a train step of `cfg`
    computes: its dense FFN, an MoE's first dense FFNs and shared
    experts, and the MTP head's block (S - 1 tokens, the last layer's
    kind)."""
    from repro_torch.models.transformer import layer_plan
    out = set()
    plan = layer_plan(cfg)
    blocks = [(S, k) for k in plan]
    if cfg.mtp_depth:
        blocks.append((S - 1, plan[-1]))
    for s_, k in blocks:
        if k.ffn == "dense":
            out.add((s_, cfg.d_ff))
        elif k.ffn == "dense_big":
            out.add((s_, cfg.moe.d_ff_dense))
        elif k.ffn == "moe" and cfg.moe.n_shared:
            out.add((s_, cfg.moe.n_shared * cfg.moe.d_ff_shared))
    return out


def _branch(cfg) -> str:
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.parallel import collectives, sharding
    if cfg.use_mla:
        return "mla"
    with sharding.use_mesh(abstract_mesh(SHAPE, AXES)):
        return collectives.attend_branch(S, cfg.n_kv_heads,
                                         cfg.n_heads // cfg.n_kv_heads)


@pytest.mark.parametrize("case", MOE)
def test_moe_aux_loss_is_the_reference_s_global_one(ranks, case):
    """The switch aux loss E * sum_e f_e p_e of the first batch, f_e and
    p_e means over every token of the batch (each rank's counts and
    probability sums psummed over the axes that split the tokens): at
    1e-5 against the reference's, the same on every rank; and
    deepseek's MTP loss at 1e-5."""
    ref, got = ranks
    pre = f"bl/{case}/"
    names = (("moe_aux", "mtp_ce") if case.startswith("deepseek")
             else ("moe_aux",))
    for name in names:
        for g in got:
            np.testing.assert_allclose(g[pre + name + "0"],
                                       ref[f"{case}/{name}0"],
                                       rtol=tp_.LOSS_REL)
            np.testing.assert_array_equal(g[pre + name + "0"],
                                          got[0][pre + name + "0"])
    assert float(ref[f"{case}/moe_aux0"]) > 0


@pytest.mark.parametrize("case", ["deepseek", "deepseek_sp"])
def test_mtp_logits_match_the_reference(ranks, case):
    """deepseek-v3's MTP head in the block program (the rank's rows, the
    shifted tokens' embedding and the logits vocab-parallel, its block
    an MoE block on blocks), with and without Megatron-SP in the trunk:
    the logits for token t + 2, gathered whole, within MODEL_REL of the
    reference's scale, the same on every rank."""
    ref, got = ranks
    want = ref[f"{case}/mtp"]
    assert want.shape == (B, S - 1, _specs(case)[1].vocab_size)
    for r, g in enumerate(got):
        assert _rel(g[f"bl/{case}/mtp"], want) <= MODEL_REL, r
        np.testing.assert_array_equal(g[f"bl/{case}/mtp"],
                                      got[0][f"bl/{case}/mtp"])


def _dropped(assignments: str) -> int:
    return sum(k.count(False) for _, k in json.loads(assignments))


@pytest.mark.parametrize("case", MOE)
def test_capacity_drops_match_the_reference_assignment_for_assignment(
        ranks, case):
    """One forward at the case's capacity factor, where assignments drop:
    on every rank each dispatch's expert ids and which assignments kept
    a slot equal the reference's sharded forward's on the same rank (its
    `_dispatch_indices` read by a debug callback a device): the same
    capacity from the same tokens a rank, in the same order."""
    ref, got = ranks
    total = 0
    for r, g in enumerate(got):
        have = str(g[f"bl/{case}/assignments"])
        assert have == str(ref[f"{case}/assignments/{r}"]), r
        total += _dropped(have)
    assert total > 0, "the case must drop"


def test_microbatches_of_an_moe_match_the_reference_split(ranks):
    """granite-moe at microbatches=2 on (2, 2, 2): each of the
    reference's microbatches (rows [0, 2), [2, 4)) split over pod alone,
    whole over data (`sharding.rows(batch, 2)`), its capacity and aux
    reckoned from its own tokens. The loss and the aux at 1e-5, the
    whole gradient within GRAD_REL of its scale against the reference's
    scan over the microbatches, every rank's dispatches equal to the
    reference's; two chunks run. The aux differs from the one-batch
    step's: the split matters."""
    ref, got = ranks
    pre = "bl/granite/mb2"
    want = _leaves(ref, "granite/mb2grad/")
    for r, g in enumerate(got):
        for name in ("loss", "moe_aux"):
            np.testing.assert_allclose(g[f"{pre}/{name}"],
                                       ref[f"granite/mb2/{name}"],
                                       rtol=tp_.LOSS_REL)
        assert int(g[f"{pre}/chunks"]) == 2
        have = _leaves(g, pre + "grad/")
        assert sorted(have) == sorted(want)
        worst = {k: _rel(have[k], w) for k, w in want.items()}
        assert max(worst.values()) <= tp_.GRAD_REL, (r, worst)
        assert str(g[f"{pre}/assignments"]) == \
            str(ref[f"granite/mb2/assignments/{r}"]), r
    assert abs(float(ref["granite/mb2/moe_aux"])
               - float(ref["granite/moe_aux0"])) > 1e-6


def test_chip_smoke_phase16_at_cpu_size(ranks):
    """`chip_smoke.py`'s phase 16 at CPU size (`BLOCKS_CPU`: reduced
    gemma-2b at 3 heads, context parallelism, and codeqwen1.5-7b at 4 kv
    heads, grouped head-TP, depth 2; reduced granite-moe, repeated
    head-TP and 4 experts, and deepseek-v3, MLA, one dense_big layer,
    then MoE, with no MTP head as the card runs it; reduced mamba2-780m
    and recurrentgemma-2b, window attention head-TP at depth 3;
    whisper-base at 3 heads, 7 frames and vocab 257, its encoder local
    and its decoder context-parallel as on the card; on a (data 2,
    model 4) grid): the phase
    runs (its float32 holds against the unsharded steps, within SP_HOLD,
    raise on a miss; an MoE's at a capacity factor where none of its
    assignments drops), and its 8 ranks run in turns in this
    process give, rank by rank, every output the 8 gloo ranks gave for
    the same steps (the loss, each gradient block, the prefill's logits
    and caches, the decode step's logits) within TURNS_REL of its scale
    (TURNS_REL_RECURRENT for the SSM and the hybrid): the same per-rank
    arithmetic, the collectives summed in another order."""
    import torch

    from repro_torch import device as tdevice
    from repro_torch import tree
    from repro_torch.parallel.turns import Turns
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    _, got = ranks
    Z = cs.BLOCKS_CPU
    assert Z.data * Z.model == WORLD
    dev = torch.device("cpu")
    prev = tdevice.set_default("cpu")
    try:
        res = cs.phase_blocks(torch, np, dev, Z, cs._Clock())
        for arch, kw in Z.archs:
            assert res["archs"][arch]["hold"]["rel_max"] <= cs.SP_HOLD
            cfg = cs.blocks_cfg(arch, kw, Z, "float32")
            model, whole, batch, tokens = cs.blocks_inputs(torch, cfg, Z,
                                                           dev)
            preps = Turns((Z.data, Z.model), cs.BLOCK_AXES).run(
                lambda r: cs.blocks_prep(torch, model, whole, batch, tokens,
                                         Z, decode=True))
            outs = Turns((Z.data, Z.model), cs.BLOCK_AXES).run(
                lambda r: cs.blocks_steps(torch, model, cfg, preps[r], Z))
            bound = TURNS_REL_RECURRENT.get(arch, TURNS_REL)
            for r, out in enumerate(outs):
                for k, a in tree.flatten_with_keys(out):
                    want = got[r][f"p16/{arch}/{k}"]
                    assert _rel(a.detach().float().numpy(), want) \
                        <= bound, (arch, r, k)
        assert {a: v["branch"] for a, v in res["archs"].items()} == {
            "gemma-2b": "cp", "codeqwen1.5-7b": "head_tp",
            "granite-moe-1b-a400m": "head_tp", "deepseek-v3-671b": "mla",
            "mamba2-780m": "none", "recurrentgemma-2b": "head_tp",
            "whisper-base": "cp"}
        for arch in ("granite-moe-1b-a400m", "deepseek-v3-671b"):
            r = res["archs"][arch]
            assert r["hold_drops"] == 0 < r["hold_assignments"], arch
    finally:
        tdevice.set_default(prev)
