"""The SSM and RG-LRU hybrid families on the block program, 8 gloo ranks
against the JAX package's sharded step on 8 fake XLA devices.

Under a `DeviceMesh` mamba2 ("ssm") and recurrentgemma ("hybrid") run
each rank's own program on its blocks (`sharding.BLOCK_FAMILIES`): the
batch split over (pod, data), each layer's weights gathered over data
inside it (FSDP); mamba2's `in_z` / `in_x` / `in_dt` and the scan on the
rank's d_inner/M channels and H/M heads, `in_B` / `in_C` contracted over
its d_model/M columns and psummed, the gated norm's sum of squares
psummed over `model`, `out` row-parallel; the RG-LRU on the rank's R/M
lru channels and gate blocks, `out` row-parallel; recurrentgemma's
windowed attention head-TP or context-parallel at the rank's q_offset,
its prefill cache the rolling window, whole over `model`; decode on the
rank's rows, every row's new state written into the param-rule caches.
The reference gets the same partition from GSPMD. One case a branch,
each a reduced config `dataclasses.replace`d the same way in both
packages, on a (2, 2, 2) (pod, data, model) mesh:

  mamba2       reduced mamba2-780m: 16 heads, 8 a rank
  mamba2_v257  mamba2-780m at vocab 257: the tied table whole over
               model, contracted in place over data (`layers.
               _in_place`) in the train step, the prefill and the decode
  rg           reduced recurrentgemma-2b (H 4 / KVH 1): head-TP, window 8
  rg_cp        recurrentgemma-2b at H 3: context parallelism, window 8
  granite_e3   granite-moe at 3 experts: `_moe_local` on model 2, the
               experts replicated over it
  mamba2_b1,   both at one row, whole on every rank: the decode keeps
  rg_b1        each weight block in place, contracting over its data
               rows (`sharding.rows_in_place`, `matmul_block`), as
               GSPMD partitions the reference's long_500k decode

on the conditioned copy of the reference's parameters, at S = 12 tokens
(past the window of 8: the rolling cache wraps). The ranks run once for
the module (`_torch_ranks.run`, job `blocks`, as `test_torch_blocks.py`
runs the dense and MoE cases); the reference's numbers come from two
subprocesses beside them.

Held, as there: the first batch's loss at `LOSS_REL` and each rank's
gradient block within `GRAD_REL` of the leaf's scale, bit-equal on the
ranks that hold the same block; two `jit_train_step`s; the prefill's
logits, its caches and a decode step's logits at `MODEL_REL`; inside a
step the residual stream, the FFN hidden, the mixers' inner activations
(the scans' inputs) and the logits each have this rank's block shape.
And a planted fault: mamba2's gated norm over d_inner without the psum
of its sum of squares over `model` (each rank normalising by its half)
misses the gradient hold."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_ranks
import _train_parity as tp_
from test_torch_blocks import (MODEL_REL, REFERENCE, SHAPE, AXES, WORLD,
                               _leaves, _np_block, _pair, _rel)
from test_torch_mesh_train import OPT, _hold_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 12 tokens: past the window (8), off every cache leaf's dim 2 (the
# reference pads each leaf whose dim 2 equals the prefill length)
B, S, MAX_SEQ = 4, 12, 20
CASES = {"mamba2": ("mamba2-780m", {}),
         "mamba2_v257": ("mamba2-780m", {"vocab_size": 257}),
         "rg": ("recurrentgemma-2b", {}),
         "rg_cp": ("recurrentgemma-2b", {"n_heads": 3}),
         "granite_e3": ("granite-moe-1b-a400m", {"moe": {"n_experts": 3}}),
         "mamba2_b1": ("mamba2-780m", {}),
         "rg_b1": ("recurrentgemma-2b", {})}
# the cases of one row (whole on every rank): the decode keeps its
# weights in place (`sharding.rows_in_place`)
ONE_ROW = ("mamba2_b1", "rg_b1")
# the planted fault's case: mamba2's, its norm without the psum
FAULT = "mamba2_fault"
BRANCH = {"rg": "head_tp", "rg_cp": "cp", "granite_e3": "head_tp",
          "rg_b1": "head_tp"}


def _inputs() -> dict:
    """Every case's conditioned parameters, two batches and a decode
    step's tokens, and the optimizer's settings, as numpy; the fault
    case the mamba2 case's."""
    from repro_torch import tree
    out = {f"opt/{k}": np.asarray(v) for k, v in OPT.items()}
    out.update({"seq": np.asarray(S), "max_seq": np.asarray(MAX_SEQ)})
    for case, (arch, kw) in CASES.items():
        cp, cfg = _pair(arch, kw)
        out.update({f"{case}/param/{k}": a.numpy()
                    for k, a in tree.flatten_with_keys(cp)})
        rows = 1 if case in ONE_ROW else B
        for i in range(2):
            out.update({f"{case}/batch{i}/{k}": v for k, v in
                        tp_.batch(cfg, i, B=rows, S=S).items()})
        out[f"{case}/step_tokens"] = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (rows, 1)).astype(np.int32)
    out.update({FAULT + k[len("mamba2"):]: v for k, v in list(out.items())
                if k.startswith("mamba2/")})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the reference's results, each of the 8 ranks' results)."""
    d = tmp_path_factory.mktemp("blocks_recurrent")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    cases = [[c, a, json.dumps(kw), "0", "0", "0"]
             for c, (a, kw) in CASES.items()]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "in.npz"),
         str(d / f"ref{i}.npz"), json.dumps([c[:5] for c in part])],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env) for i, part in enumerate((cases[:4], cases[4:]))]
    try:
        payload = {f"bl/{k}": v for k, v in inp.items()}
        payload["bl/cases"] = np.asarray(
            cases + [[FAULT, "mamba2-780m", "{}", "0", "0", "1"]])
        got = _torch_ranks.run(["blocks"], WORLD, d, payload)
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


def _specs(case):
    """({leaf key: its resolved param spec} on an abstract (2, 2, 2),
    the case's config)."""
    from repro_torch import tree
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding
    arch, kw = CASES[case]
    cfg = _torch_ranks.block_cfg(arch, json.dumps(kw))
    specs = build_model(cfg).param_specs()
    with sharding.use_mesh(abstract_mesh(SHAPE, AXES)):
        pspecs = sharding.param_pspecs(specs)
    return dict(zip([k for k, _ in tree.flatten_with_keys(specs)],
                    sharding.leaf_specs(specs, pspecs))), cfg


def _worst_block(ref, g, case, pre) -> float:
    """The largest difference of a rank's gradient blocks from the same
    blocks of the reference's gradient, over the leaf's scale."""
    specs, _ = _specs(case)
    have = _leaves(g, pre + "gblock/")
    return max(float(np.abs(have[k] - _np_block(w, specs[k], g["rank"]))
                     .max() / max(np.abs(w).max(), 1e-30))
               for k, w in _leaves(ref, f"{case}/grad/").items())


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradient_blocks_match_the_reference(ranks, case):
    """The first batch's loss at 1e-5 and, on every rank, each leaf's
    gradient block within GRAD_REL of the reference leaf's scale; the
    ranks that hold the same block hold the same bits, and the blocks
    gathered whole are the reference's gradient."""
    ref, got = ranks
    pre = f"bl/{case}/"
    specs, _ = _specs(case)
    want = _leaves(ref, f"{case}/grad/")
    assert sorted(want) == sorted(specs)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g[pre + "loss0"], ref[f"{case}/loss0"],
                                   rtol=tp_.LOSS_REL)
        assert _worst_block(ref, dict(g, rank=r), case, pre) <= \
            tp_.GRAD_REL, r
        whole = _leaves(g, pre + "grad/")
        for k, w in want.items():
            assert _rel(whole[k], w) <= tp_.GRAD_REL, (r, k)
            np.testing.assert_array_equal(whole[k], got[0][pre + "grad/" + k])


def test_planted_fault_norm_without_its_psum_misses_the_hold(ranks):
    """mamba2 with its gated norm's sum of squares left per rank (no
    psum over `model`): outputs of the right shapes that are wrong. Its
    gradient blocks miss GRAD_REL by far on every rank, and its loss
    misses LOSS_REL, where the same case with the psum holds both."""
    ref, got = ranks
    for r, g in enumerate(got):
        good = _worst_block(ref, dict(g, rank=r), "mamba2", "bl/mamba2/")
        bad = _worst_block(ref, dict(g, rank=r), "mamba2", f"bl/{FAULT}/")
        assert good <= tp_.GRAD_REL < 10 * tp_.GRAD_REL < bad, (r, good, bad)
        assert _rel(g[f"bl/{FAULT}/loss0"], ref["mamba2/loss0"]) \
            > tp_.LOSS_REL
        assert _rel(g[f"bl/{FAULT}/prefill"], ref["mamba2/prefill"]) \
            > MODEL_REL


@pytest.mark.parametrize("case", CASES)
def test_two_block_steps_match_the_reference(ranks, case):
    """Two `jit_train_step`s of the block program against the
    reference's sharded `jit_train_step`: the losses at 1e-5, the clip
    norms at 1e-4, each step's update by `_hold_update`, and the
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
    """The prefill's last logits and its caches (the rank's blocks:
    mamba2's state, conv histories; the RG-LRU's state and history; the
    window's rolling layout, gathered), and one decode step on the
    rank's rows and its param-rule block of the padded caches, written
    in place: each within MODEL_REL of the reference's scale, the same
    on every rank."""
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
    the residual stream entering every layer (batch, seq, embed), the
    FFN hidden (batch, seq, mlp; mamba2 has none), the mixers' scan
    inputs (mamba2's (batch, seq, ssm_heads, head_dim), the RG-LRU's
    (batch, seq, rnn)) and the logits (batch, seq, vocab; 257 does not
    split and stays whole) each have this rank's block shape."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.ssm import dims
    from repro_torch.parallel import collectives, sharding
    _, got = ranks
    pre = f"bl/{case}/"
    _, cfg = _specs(case)
    D, V = cfg.d_model, cfg.vocab_size
    rows = 1 if case in ONE_ROW else B
    with sharding.use_mesh(abstract_mesh(SHAPE, AXES)):
        def blk(shape, axes):
            return sharding.block_shape(shape, sharding.resolve_spec(
                axes, shape, "act"))
        want = {"residual": blk((rows, S, D), ("batch", "seq", "embed")),
                "logits": blk((rows, S, V), ("batch", "seq", "vocab"))}
        if cfg.family == "ssm":
            _, H, _, _, P = dims(cfg)
            want["inner"] = blk((rows, S, H, P), ("batch", "seq",
                                                  "ssm_heads", None))
            assert want["inner"] == (1, S, H // 2, P)
        elif cfg.family == "hybrid":
            R = cfg.hybrid.lru_width
            want["inner"] = blk((rows, S, R), ("batch", "seq", "rnn"))
            want["hidden"] = blk((rows, S, cfg.d_ff),
                                 ("batch", "seq", "mlp"))
            assert want["inner"] == (1, S, R // 2)
        if cfg.family != "ssm":
            assert collectives.attend_branch(
                S, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads) == \
                BRANCH[case]
    assert want["residual"] == (1, S, D)
    assert want["logits"] == (1, S, V // 2 if V % 2 == 0 else V)
    for g in got:
        assert [tuple(s) for s in g[pre + "shapes/residual"]] == \
            [want["residual"]]
        assert tuple(g[pre + "shapes/logits"]) == want["logits"]
        for name in ("inner", "hidden"):
            if name in want:
                assert [tuple(s) for s in g[pre + "shapes/" + name]] == \
                    [want[name]], name
        if cfg.family == "ssm":
            assert not len(g[pre + "shapes/hidden"])
    assert cfg.family in sharding.BLOCK_FAMILIES


def test_replicated_vocab_is_contracted_in_place(ranks):
    """mamba2 at vocab 257 (the tied table whole over model 2): every
    logits product of its train steps, prefill and decode takes the
    in-place contraction over data (`layers._unembed_in_place`) on every
    rank, and its gradients held above came through it; a vocab that
    splits over model (256) never does."""
    _, got = ranks
    for g in got:
        assert int(g["bl/mamba2_v257/in_place"]) >= 5
        for case in set(CASES) - {"mamba2_v257"}:
            assert int(g[f"bl/{case}/in_place"]) == 0, case


def test_one_row_decode_keeps_the_weights_in_place(ranks):
    """A decode of one row (whole on every rank of data) contracts every
    projection's weight block where it lies (`sharding.rows_in_place`,
    `matmul_block`: no FSDP gather), on every rank: mamba2's six a
    layer, the RG-LRU's three, the FFN's three and the window
    attention's four; its outputs held above. A decode whose rows split
    over data gathers them (none in place)."""
    _, got = ranks
    from repro_torch.models.transformer import layer_plan
    per = {"ssm": 6, "rec": 3 + 3, "attn_win": 4 + 3}
    for case in ONE_ROW:
        _, cfg = _specs(case)
        want = sum(per[k.mix] for k in layer_plan(cfg))
        for g in got:
            assert int(g[f"bl/{case}/rows_in_place"]) == want, case
    for case in set(CASES) - set(ONE_ROW):
        for g in got:
            assert int(g[f"bl/{case}/rows_in_place"]) == 0, case
