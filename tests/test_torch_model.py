"""The port's serving model held against the JAX package, on the CPU.

`reduced(gemma-2b)` in float32 (3 layers, d_model 64, 4 query heads on
1 kv head, head_dim 16, GeGLU, tied embeddings, zero-centred RMSNorm,
scaled embeddings) and the other dense configs reduced the same way —
codeqwen1.5-7b (qkv bias), phi4-mini-3.8b (tied table), stablelm-12b —
each on 2 kv heads: the parameter specs, the layers, and each decoder's
`forward`, `prefill(last_pos)` and `decode_step` on the reference's own
parameters carried over by `convert.params_from_numpy`.

Tolerances, measured by `test_drift_from_reference_stays_inside_the_
tolerances` (three seeds, six prompts each; the CPU readings are up to
1.27e-5 of scale per block and 1.77e-4 for the whole model). The layers
(norm, RoPE, GeGLU) at 1e-6. Each decoder block, fed the reference's
own input in every mode, at 1e-4 of its output's largest magnitude:
float32 products sum in another order in XLA and in ATen, and the
out-projection's cancellation leaves up to 1.3e-5 of that scale. The
whole model at 1e-3 of that scale: the random network amplifies the
per-block difference about tenfold a layer. Both are looser than the
1e-5 first asked of the model; greedy tokens are held exactly."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import layers as jlayers
from repro.models import transformer as jtrans
from repro.models.module import count_params as jcount
from repro.models.module import is_spec as jis_spec
from repro.models.registry import build_model as jbuild
from repro.serve.kvcache import pad_caches as jpad
from repro_torch import device as tdevice
from repro_torch import tree
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttrans
from repro_torch.models.module import count_params, is_spec
from repro_torch.models.registry import build_model
from repro_torch.serve.kvcache import pad_caches as tpad


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


# the dense decoders: gemma-2b, and the three configs whose features no
# other family takes through a test — codeqwen's qkv bias, phi4-mini's
# tied table, stablelm's untied one (its head_dim of 160 is a full-width
# shape, held on the card)
DENSE = ("gemma-2b", "codeqwen1.5-7b", "phi4-mini-3.8b", "stablelm-12b")


@pytest.fixture(scope="module", params=DENSE)
def both(request):
    jm = jbuild(jreduced(jget_config(request.param)))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(reduced(get_config(request.param)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    return jm, jp, tm, tp


def _near(got, want, rel):
    """|got - want| <= rel * max|want| elementwise, plus rel * |want|."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=rel, atol=rel * np.abs(w).max())


def _leaves_near(got, want, rel):
    jl, tl = jax.tree.leaves(want), tree.leaves(got)
    assert len(jl) == len(tl) > 0
    for a, b in zip(tl, jl):
        _near(a, b, rel)


def test_param_specs_match_reference_leaf_for_leaf():
    for arch in ("gemma-2b", "phi4-mini-3.8b", "codeqwen1.5-7b",
                 "stablelm-12b", "granite-moe-1b-a400m", "recurrentgemma-2b",
                 "mamba2-780m", "deepseek-v3-671b"):
        js = jax.tree.leaves(jbuild(jreduced(jget_config(arch)))
                             .param_specs(), is_leaf=jis_spec)
        tm = build_model(reduced(get_config(arch)))
        ts = tree.leaves(tm.param_specs(), is_leaf=is_spec)
        assert [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in ts] == \
               [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in js], arch
        assert count_params(tm.param_specs()) == jcount(
            jbuild(jreduced(jget_config(arch))).param_specs())
    full = build_model(get_config("gemma-2b"))
    assert count_params(full.param_specs()) == 2_506_172_416


# every config: the port builds them all
BUILT = ("gemma-2b", "phi4-mini-3.8b", "codeqwen1.5-7b", "stablelm-12b",
         "internvl2-2b", "granite-moe-1b-a400m", "recurrentgemma-2b",
         "mamba2-780m", "deepseek-v3-671b", "whisper-base")


@pytest.mark.parametrize("arch", ["whisper-base"])
def test_other_families_raise_not_implemented(arch):
    """The encoder-decoder builds and trains (`test_torch_encdec.py`);
    what stays unimplemented is serving it: the engine, as the
    reference's, passes no frame embeddings, so the serving CLI refuses
    it."""
    assert build_model(reduced(get_config(arch))).param_specs()
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("arch", BUILT)
def test_param_counts_equal_the_reference_at_full_size(arch):
    """`ModelConfig.param_count` / `active_param_count` (an expert leaf
    counting top_k / n_experts when active-only) of every full-size
    config the port builds, against the reference's."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count() > 0
    assert cfg.active_param_count() == jcfg.active_param_count()
    if cfg.moe is not None:
        assert cfg.active_param_count() < cfg.param_count()
    else:
        assert cfg.active_param_count() == cfg.param_count()


def test_init_is_seeded_by_a_generator_and_deterministic():
    tm = build_model(reduced(get_config("gemma-2b")))
    a = tm.init(torch.Generator().manual_seed(3))
    b = tm.init(torch.Generator().manual_seed(3))
    c = tm.init(torch.Generator().manual_seed(4))
    la, lb, lc = tree.leaves(a), tree.leaves(b), tree.leaves(c)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])
    specs = tree.leaves(tm.param_specs(), is_leaf=is_spec)
    for s, x in zip(specs, la):
        assert tuple(x.shape) == s.shape
    # normal leaves: std = scale, else 1/sqrt(shape[-2]); norms are ones
    assert abs(float(a["embed"]["table"].std()) - 1.0) < 0.05
    wq = a["groups"][0]["b0"]["attn"]["wq"]["w"]
    assert abs(float(wq.std()) - 1 / np.sqrt(wq.shape[-2])) < 0.05
    assert torch.equal(a["final_norm"]["scale"], torch.ones(64))
    assert a["final_norm"]["scale"].dtype == torch.float32
    bf = tm.init(torch.Generator().manual_seed(3), "bfloat16")
    assert bf["embed"]["table"].dtype == torch.bfloat16
    assert bf["final_norm"]["scale"].dtype == torch.float32
    with pytest.raises(ValueError, match="Generator"):
        tm.init(None)
    prev = tdevice.set_default("cuda")
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            tm.init(torch.Generator())
    finally:
        tdevice.set_default(prev)


def test_params_from_numpy_holds_the_tree_to_the_specs(both):
    jm, jp, tm, _ = both
    arrays = jax.tree.map(np.asarray, jp)
    arrays["embed"]["table"] = arrays["embed"]["table"][:, :32]
    with pytest.raises(ValueError, match="spec"):
        params_from_numpy(arrays, "cpu", model=tm)


@pytest.mark.parametrize("zc", [False, True])
def test_layers_match_reference(zc):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    got = tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x), 1e-6, zero_centered=zc)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-6, zero_centered=zc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    h = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                           10000.0).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(h), jnp.asarray(pos),
                                      10000.0)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tlayers.act_fn("geglu")(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.act_fn("geglu")(jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        tlayers.softcap(torch.from_numpy(x), 2.0).numpy(),
        np.asarray(jlayers.softcap(jnp.asarray(x), 2.0)), rtol=1e-6,
        atol=1e-6)


def test_bf16_embedding_scale_rounds_like_the_reference():
    """gemma scales embeddings by sqrt(d_model) in the model dtype: JAX
    rounds the weakly typed scalar to bf16 first, and so does the port."""
    jm = jbuild(dataclasses.replace(jreduced(jget_config("gemma-2b")),
                                    d_model=2048, dtype="bfloat16"))
    tm = build_model(dataclasses.replace(reduced(get_config("gemma-2b")),
                                         d_model=2048, dtype="bfloat16"))
    rng = np.random.default_rng(1)
    table = rng.standard_normal((256, 2048)).astype(np.float32)
    toks = np.asarray([[1, 2, 250]], np.int32)
    jt = jnp.asarray(table.astype(ml_dtypes.bfloat16))
    want = jm._embed_in({"embed": {"table": jt}}, jnp.asarray(toks))
    tt = params_from_numpy({"t": table.astype(ml_dtypes.bfloat16)}, "cpu")
    got = tm._embed_in({"embed": {"table": tt["t"]}}, torch.from_numpy(toks))
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16),
        np.asarray(want).view(np.uint16))


BLOCK_REL = 1e-4        # one block on the reference's input
MODEL_REL = 1e-3        # the whole model


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_each_block_matches_reference_on_its_input(both, mode):
    """Every layer fed the reference's own hidden state (and, decoding,
    its own caches), in each mode: outputs and caches at BLOCK_REL."""
    jm, jp, tm, tp = both
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (2, 13)).astype(np.int32)
    cfg, tcfg = jm.cfg, tm.cfg
    kind, tkind = jtrans.layer_plan(cfg)[0], ttrans.layer_plan(tcfg)[0]
    _, caches = jm.prefill(jp, jnp.asarray(toks))
    caches = jpad(caches, 13, 16)
    if mode == "decode":
        toks = rng.integers(0, 256, (2, 1)).astype(np.int32)
        pos = np.asarray([13, 13], np.int32)
        positions = pos[:, None]
    else:
        pos, positions = None, np.broadcast_to(np.arange(13, dtype=np.int32),
                                               (2, 13)).copy()
    x = np.array(jm._embed_in(jp, jnp.asarray(toks)))
    for li in range(cfg.n_layers):
        jpl = jax.tree.map(lambda a: a[li], jp["groups"][0]["b0"])
        tpl = tree.map(lambda a: a[li], tp["groups"][0]["b0"])
        jc = jax.tree.map(lambda a: a[li], caches[0]["b0"]) \
            if mode == "decode" else None
        tc = tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), jc) \
            if jc is not None else None
        jy, _, jnc = jtrans.block_apply(
            jpl, jnp.asarray(x), jnp.asarray(positions), cfg, kind,
            mode=mode, cache=jc, pos=None if pos is None else jnp.asarray(pos))
        ty, aux, tnc = ttrans.block_apply(
            tpl, torch.from_numpy(x), torch.from_numpy(positions), tcfg,
            tkind, mode=mode, cache=tc,
            pos=None if pos is None else torch.from_numpy(pos))
        _near(ty, jy, BLOCK_REL)
        assert float(aux) == 0.0
        if mode == "train":
            assert tnc is None and jnc is None
        else:
            _leaves_near(tnc, jnc, BLOCK_REL)
        x = np.array(jy)


def test_forward_matches_reference(both):
    jm, jp, tm, tp = both
    toks = np.random.default_rng(2).integers(0, 256, (2, 11)).astype(np.int32)
    jl, jx = jm.forward(jp, jnp.asarray(toks))
    tl, tx = tm.forward(tp, torch.from_numpy(toks))
    _near(tl, jl, MODEL_REL)
    assert float(tx["moe_aux"]) == float(jx["moe_aux"]) == 0.0


def test_prefill_with_last_pos_and_decode_match_reference(both):
    jm, jp, tm, tp = both
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    last = np.asarray([6, 15], np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), last_pos=jnp.asarray(last))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks),
                        last_pos=torch.from_numpy(last))
    _near(tl, jl, MODEL_REL)
    _leaves_near(tc, jc, MODEL_REL)
    # decode on the padded caches, per-request positions
    jc, tc = jpad(jc, 16, 24), tpad(tc, 16, 24, tm.cache_specs(2, 24))
    for step in range(3):
        nxt = rng.integers(0, 256, (2, 1)).astype(np.int32)
        pos = np.asarray([16 + step, 16 + step], np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(pos))
        _near(tl, jl, MODEL_REL)
        _leaves_near(tc, jc, MODEL_REL)


def test_decode_step_leaves_its_input_caches_alone(both):
    _, _, tm, tp = both
    _, caches = tm.prefill(tp, torch.ones((1, 4), dtype=torch.int32))
    caches = tpad(caches, 4, 8, tm.cache_specs(1, 8))
    before = [x.clone() for x in tree.leaves(caches)]
    _, new = tm.decode_step(tp, torch.ones((1, 1), dtype=torch.int32),
                            caches, 4)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(caches), before))
    assert not all(torch.equal(a, b) for a, b in zip(tree.leaves(new), before))


def _generate(model, params, prompt, n_new, max_seq, tensor, pad):
    """Greedy generation through prefill + decode (the reference's
    `tests/test_serve.py::_reference_generate`, for either package)."""
    logits, caches = model.prefill(params, tensor([prompt]))
    caches = pad(caches, len(prompt), max_seq)
    out = [int(np.argmax(np.asarray(logits[0, -1])))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        lg, caches = model.decode_step(params, tensor([[out[-1]]]), caches,
                                       pos)
        out.append(int(np.argmax(np.asarray(lg[0, 0]))))
        pos += 1
    return out


@pytest.mark.parametrize("prompt", [[5, 3, 9, 1], [7, 7, 2]])
def test_greedy_tokens_equal_reference(both, prompt):
    jm, jp, tm, tp = both
    want = _generate(jm, jp, prompt, 6, 48,
                     lambda a: jnp.asarray(a, jnp.int32), jpad)
    got = _generate(tm, tp, prompt, 6, 48,
                    lambda a: torch.tensor(a, dtype=torch.int32),
                    lambda c, s, m: tpad(c, s, m, tm.cache_specs(1, m)))
    assert got == want


# -- the measurements the tolerances rest on ----------------------------------
def _rel(got, want) -> float:
    w = np.asarray(want, np.float32)
    return float(np.abs(w - got.float().numpy()).max() / np.abs(w).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_from_reference_stays_inside_the_tolerances(seed):
    """BLOCK_REL and MODEL_REL, measured: the reference's parameters
    from `seed`, six prompts of 16 tokens at batch 2. Each block fed the
    reference's own input, then the whole prefill (logits and caches),
    each as a fraction of the reference tensor's largest magnitude. The
    readings print with `pytest -s`."""
    jm = jbuild(jreduced(jget_config("gemma-2b")))
    tm = build_model(reduced(get_config("gemma-2b")))
    kind, tkind = jtrans.layer_plan(jm.cfg)[0], ttrans.layer_plan(tm.cfg)[0]
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    block, model = [], []
    for i in range(6):
        toks = np.random.default_rng(i).integers(0, 256, (2, 16))
        toks = toks.astype(np.int32)
        pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
        x = np.array(jm._embed_in(jp, jnp.asarray(toks)))
        for li in range(jm.cfg.n_layers):
            jpl = jax.tree.map(lambda a: a[li], jp["groups"][0]["b0"])
            tpl = tree.map(lambda a: a[li], tp["groups"][0]["b0"])
            jy, _, _ = jtrans.block_apply(jpl, jnp.asarray(x),
                                          jnp.asarray(pos), jm.cfg, kind)
            ty, _, _ = ttrans.block_apply(tpl, torch.from_numpy(x),
                                          torch.from_numpy(pos), tm.cfg,
                                          tkind)
            block.append(_rel(ty, jy))
            x = np.array(jy)
        jl, jc = jm.prefill(jp, jnp.asarray(toks))
        tl, tc = tm.prefill(tp, torch.from_numpy(toks))
        model.append(max([_rel(tl, jl)] + [
            _rel(b, a) for a, b in zip(jax.tree.leaves(jc),
                                       tree.leaves(tc))]))
    print(f"seed {seed}: per block max {max(block):.3g}; whole model min "
          f"{min(model):.3g}, median {np.median(model):.3g}, max "
          f"{max(model):.3g}")
    assert max(block) <= BLOCK_REL and max(model) <= MODEL_REL


def test_bf16_decoder_carries_one_ulp_to_the_logits():
    """Why two bf16 runs of the serving model are compared only where
    they do the same arithmetic (`chip_smoke.LOGIT_TOL`): an 18-layer
    bf16 stand-in of gemma-2b at a narrower width (d_model 256, 8 heads
    of 32 on one kv head, d_ff 1024, vocab 4096), with one embedding
    entry raised by one bf16 ulp, moves the last prompt position's
    logits by a large fraction of their largest magnitude."""
    cfg = dataclasses.replace(
        reduced(get_config("gemma-2b")), n_layers=18, d_model=256,
        n_heads=8, n_kv_heads=1, head_dim=32, d_ff=1024, vocab_size=4096,
        dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 37)).astype(np.int32))
    base, _ = model.prefill(params, toks)
    table = params["embed"]["table"]
    row, col = int(toks[0, 5]), 7
    table[row, col] = (table[row, col].float() * (1 + 2 ** -7)).bfloat16()
    moved, _ = model.prefill(params, toks)
    d = float((moved.float() - base.float()).abs().max())
    top = float(base.float().abs().max())
    print(f"one ulp on one embedding entry moves the logits by {d:.4g} "
          f"against a largest |logit| of {top:.4g}")
    assert d > 0.25 * top


@pytest.mark.parametrize("arch", DENSE[1:])
def test_chip_smoke_phase10_at_cpu_size_dense(arch):
    """`chip_smoke.py`'s phase 10 for the dense decoders at a toy size on
    the CPU with the reference's parameters: the paged, bucketed engine
    on six prompts (prefills at their power-of-two buckets), every
    step's logits held against the unpadded reference, tokens agreeing;
    PDServer against the dense greedy decode; the flash shapes phase 2
    holds for it are the buckets and the PDServer batch."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    jm = jbuild(jreduced(jget_config(arch)))
    tm = build_model(reduced(get_config(arch)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(2))), "cpu", model=tm)
    F = chip_smoke.FamilySizes(archs=(arch,), reduce=True, max_batch=4,
                               max_seq=64, page=8,
                               prompts=(5, 9, 17, 30, 40, 50), new=5,
                               pd_batch=2, pd_prompt=10, pd_steps=3,
                               pd_seq=48, reps=1, seed=0)
    out = chip_smoke.phase_family(torch, np, torch.device("cpu"), F, arch,
                                  np.random.default_rng(0),
                                  chip_smoke._Clock(), params=tp)
    assert out["launches"] == {} and out["peak_gib"] is None
    assert out["token_agreement"] == 1.0
    assert out["logit_rel_err"] <= chip_smoke.LOGIT_TOL["float32"]
    assert np.asarray(out["pd_tokens"]).shape == (2, 4)
    layout = chip_smoke.flash_layout(tm.cfg)
    assert chip_smoke.family_flash_shapes(F)[arch] == \
        [layout + (1, n) for n in (8, 16, 32, 64)] + [layout + (2, 10)]
