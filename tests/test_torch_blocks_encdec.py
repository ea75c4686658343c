"""The encoder-decoder on the block program, 8 gloo ranks against the JAX
package's sharded step on 8 fake XLA devices.

Under a `DeviceMesh` whisper-base ("encdec") runs each rank's own
program on its blocks (`sharding.BLOCK_FAMILIES`): the batch and its
frame embeddings split over (pod, data), each layer's weights gathered
over data inside it (FSDP); the encoder's self-attention, the decoder's
causal self-attention and its cross-attention each take `attend` 's
branch on their own query length (`transformer._attn_blocks`,
`encdec._cross_blocks`); the FFN's `up` columns and bias over `model`,
its `down` rows over `model`, psummed, its bias added once after the
psum (`ffn._row_parallel_out`); the tied table vocab-parallel, or whole
over `model` and contracted in place over data; the prefill's caches
the rank's blocks, the decode's every row, written in place. The
reference gets the same partition from GSPMD. Two cases, each a reduced
config `dataclasses.replace`d the same way in both packages, on a (2,
2, 2) (pod, data, model) mesh:

  whisper     reduced whisper-base (H 4 / KVH 2, 8 frames, vocab 256):
              grouped head-TP in all three attentions, the vocab split
              over model
  whisper_cp  whisper-base at H 3 / KVH 3, head_dim 16, 7 frames, vocab
              257: full width's partition, the heads whole, the
              encoder's attention local (7 frames off model 2), the
              decoder's self-attention context-parallel at the rank's
              q_offset, its cross-attention context-parallel against
              every frame's K/V held whole, the table whole over model
              and contracted in place over data

on the conditioned copy of the reference's parameters, the FFN's biases
seeded (zeros at init would hide where each is added), at S = 12
tokens. A third case settles a leftover of the MoE family:

  granite_epd reduced granite-moe under EP over (model, data) with the
              replicated MoE (`_moe_replicated`), its capacity factor
              0.5 (drops), also at microbatches=2: a microbatch of 2
              rows splits over pod alone and is whole over data, so the
              tokens must not be gathered over data

The ranks run once for the module (`_torch_ranks.run`, job `blocks`, as
`test_torch_blocks_recurrent.py` runs its cases); the reference's
numbers come from two subprocesses beside them.

Held, as there: the first batch's loss at `LOSS_REL` and each rank's
gradient block within `GRAD_REL` of the leaf's scale, bit-equal on the
ranks that hold the same block; two `jit_train_step`s; the prefill's
logits, its caches (the self-attention's and the frame caches) and a
decode step's logits at `MODEL_REL`; inside a step every encoder and
decoder layer's residual stream, the FFN hidden and the logits each
have this rank's block shape. And a planted fault: the FFN's down bias
added on every rank of `model` before the psum (M times the bias)
misses the hold."""
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
# 12 tokens: off the frame counts (8, 7), so no frame cache is padded
B, S, MAX_SEQ = 4, 12, 20
CASES = {"whisper": ("whisper-base", {}),
         "whisper_cp": ("whisper-base", {"n_heads": 3, "n_kv_heads": 3,
                                         "head_dim": 16,
                                         "frontend": {"n_tokens": 7},
                                         "vocab_size": 257}),
         "granite_epd": ("granite-moe-1b-a400m",
                         {"moe": {"capacity_factor": 0.5}})}
# the cases run with EP over (model, data) and the replicated MoE, in
# both packages (the reference's `perf` flags, the port's `use_mesh`)
EPD = {"granite_epd": {"ep_over_data": True, "moe_impl": "replicated"}}
# the planted fault's case: whisper's, its FFN's down bias before the psum
FAULT = "whisper_fault"
# the branch of each attention (encoder, decoder, cross) a case takes
BRANCH = {"whisper": ("head_tp", "head_tp", "head_tp"),
          "whisper_cp": ("local", "cp", "cp")}


def _inputs() -> dict:
    """Every case's conditioned parameters, two batches (with their frame
    embeddings) and a decode step's tokens, and the optimizer's settings,
    as numpy; the fault case the whisper case's."""
    from repro_torch import tree
    out = {f"opt/{k}": np.asarray(v) for k, v in OPT.items()}
    out.update({"seq": np.asarray(S), "max_seq": np.asarray(MAX_SEQ)})
    rng = np.random.default_rng(3)
    for case, (arch, kw) in CASES.items():
        cp, cfg = _pair(arch, kw)
        out.update({f"{case}/param/{k}": a.numpy()
                    for k, a in tree.flatten_with_keys(cp)})
        for k in [k for k in out if k.startswith(f"{case}/param/")
                  and k.endswith("/b")]:
            # the FFN's biases, zeros at init: seeded, so that each
            # one's block and its place around the psum show in values
            out[k] = (0.1 * rng.standard_normal(out[k].shape)).astype(
                out[k].dtype)
        for i in range(2):
            out.update({f"{case}/batch{i}/{k}": v for k, v in
                        tp_.batch(cfg, i, B=B, S=S).items()})
        out[f"{case}/step_tokens"] = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, 1)).astype(np.int32)
    out.update({FAULT + k[len("whisper"):]: v for k, v in list(out.items())
                if k.startswith("whisper/")})
    return out


def _case(c, arch, kw, fault="0"):
    return [c, arch, json.dumps(kw), "0", str(int(c in EPD)), fault,
            json.dumps(EPD.get(c, {}))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the reference's results, each of the 8 ranks' results)."""
    d = tmp_path_factory.mktemp("blocks_encdec")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    cases = [_case(c, a, kw) for c, (a, kw) in CASES.items()]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    # the reference's case fields: name, arch, kw, sp, mb, its perf flags
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "in.npz"),
         str(d / f"ref{i}.npz"), json.dumps([c[:5] + c[6:] for c in part])],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env) for i, part in enumerate((cases[:2], cases[2:]))]
    try:
        payload = {f"bl/{k}": v for k, v in inp.items()}
        payload["bl/cases"] = np.asarray(
            cases + [_case(FAULT, "whisper-base", {}, "bias")])
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
    with sharding.use_mesh(abstract_mesh(SHAPE, AXES),
                           **EPD.get(case, {})):
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


def test_planted_fault_bias_before_the_psum_misses_the_hold(ranks):
    """whisper with its FFN's down bias added on every rank of `model`
    before the psum of the row-parallel partial sums (the bias M = 2
    times over): outputs of the right shapes that are wrong. Its
    gradient blocks miss GRAD_REL by far on every rank, and its loss and
    prefill logits miss theirs, where the same case with the bias after
    the psum holds them."""
    ref, got = ranks
    for r, g in enumerate(got):
        good = _worst_block(ref, dict(g, rank=r), "whisper", "bl/whisper/")
        bad = _worst_block(ref, dict(g, rank=r), "whisper", f"bl/{FAULT}/")
        assert good <= tp_.GRAD_REL < 10 * tp_.GRAD_REL < bad, (r, good, bad)
        assert _rel(g[f"bl/{FAULT}/loss0"], ref["whisper/loss0"]) \
            > tp_.LOSS_REL
        assert _rel(g[f"bl/{FAULT}/prefill"], ref["whisper/prefill"]) \
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
    """The prefill's last logits and its caches (the self-attention's
    (B/dp, S/M) blocks where the sequence splits, the frame caches'
    rows and kv heads, gathered), and one decode step on the rank's rows
    and its param-rule block of the padded caches, written in place:
    each within MODEL_REL of the reference's scale, the same on every
    rank."""
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


@pytest.mark.parametrize("case", list(BRANCH))
def test_block_program_keeps_every_activation_a_block(ranks, case):
    """Inside a step each rank holds its block, never the global view:
    the residual stream entering every encoder layer (batch, frames,
    embed) and every decoder layer (batch, seq, embed), the FFN hidden
    of both stacks (batch, ·, mlp) and the logits (batch, seq, vocab;
    257 does not split and stays whole) each have this rank's block
    shape; each attention takes the branch `BRANCH` names."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.parallel import collectives, sharding
    _, got = ranks
    pre = f"bl/{case}/"
    _, cfg = _specs(case)
    D, V, F = cfg.d_model, cfg.vocab_size, cfg.frontend.n_tokens
    KVH, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    with sharding.use_mesh(abstract_mesh(SHAPE, AXES)):
        def blk(shape, axes):
            return sharding.block_shape(shape, sharding.resolve_spec(
                axes, shape, "act"))
        want = {"residual": sorted(blk((B, n, D), ("batch", "seq", "embed"))
                                   for n in (F, S)),
                "hidden": sorted(blk((B, n, cfg.d_ff),
                                     ("batch", "seq", "mlp"))
                                 for n in (F, S)),
                "logits": blk((B, S, V), ("batch", "seq", "vocab"))}
        assert tuple(collectives.attend_branch(n, KVH, G)
                     for n in (F, S, S)) == BRANCH[case]
    assert want["residual"] == [(1, F, D), (1, S, D)]
    assert want["hidden"] == [(1, F, cfg.d_ff // 2), (1, S, cfg.d_ff // 2)]
    assert want["logits"] == (1, S, V // 2 if V % 2 == 0 else V)
    for g in got:
        for name in ("residual", "hidden"):
            assert sorted(tuple(s) for s in g[pre + "shapes/" + name]) == \
                want[name], name
        assert tuple(g[pre + "shapes/logits"]) == want["logits"]
    assert cfg.family in sharding.BLOCK_FAMILIES


def test_replicated_vocab_is_contracted_in_place(ranks):
    """whisper at vocab 257 (the tied table whole over model 2): every
    logits product of its train steps, prefill and decode takes the
    in-place contraction over data (`layers._unembed_in_place`) on every
    rank; a vocab that splits over model (256) never does."""
    _, got = ranks
    for g in got:
        assert int(g["bl/whisper_cp/in_place"]) >= 5
        assert int(g["bl/whisper/in_place"]) == 0


def test_ep_over_data_microbatches_match_the_reference_split(ranks):
    """granite-moe under EP over (model, data) with the replicated MoE at
    microbatches=2 on (2, 2, 2): each microbatch of 2 rows splits over
    pod alone and is whole over data, so `_moe_replicated` takes its
    tokens as they lie, as the reference does, and gathers none over
    data (which would give each data rank its row twice). The loss and
    the aux at 1e-5, the whole gradient within GRAD_REL of its scale
    against the reference's scan over the microbatches, every rank's
    dispatches (expert ids and kept slots, at the factor 0.5 that drops)
    equal to the reference's; two chunks run."""
    ref, got = ranks
    pre = "bl/granite_epd/mb2"
    want = _leaves(ref, "granite_epd/mb2grad/")
    for r, g in enumerate(got):
        for name in ("loss", "moe_aux"):
            np.testing.assert_allclose(g[f"{pre}/{name}"],
                                       ref[f"granite_epd/mb2/{name}"],
                                       rtol=tp_.LOSS_REL)
        assert int(g[f"{pre}/chunks"]) == 2
        have = _leaves(g, pre + "grad/")
        assert sorted(have) == sorted(want)
        worst = {k: _rel(have[k], w) for k, w in want.items()}
        assert max(worst.values()) <= tp_.GRAD_REL, (r, worst)
        assert str(g[f"{pre}/assignments"]) == \
            str(ref[f"granite_epd/mb2/assignments/{r}"]), r
