"""The port's encoder-decoder (whisper-base) and the vision frontend's
splice (internvl2-2b) held against the JAX package, on the CPU.

`repro_torch.models.encdec` and `layers.layernorm` /
`sinusoidal_positions` against `repro.models.encdec` and its layers, on
`reduced(whisper-base)` in float32 (2 encoder and 3 decoder layers,
d_model 64, 4 heads on 2 kv heads of 16, 8 frames of 64) with the
reference's own parameters carried over by `convert.params_from_numpy`;
internvl2-2b's forward with 8 patch embeddings spliced over the first
rows; the gradients of a train step of both; `build_model` of every
config; the serving CLI's refusal of whisper.

Tolerances (`test_torch_model.py`'s, which it measured): each encoder
and decoder layer fed the reference's input at 1e-4 of its output's
scale, the whole model (forward, prefill, decode, the caches) at 1e-3,
greedy tokens exact; `layernorm` at 1e-6; `sinusoidal_positions` at 1e-6
over reduced whisper's 8 frames and, over whisper's 1500, within (p + 1)
2^-22 at position p: XLA's float32 `exp` is one ulp off the correctly
rounded value on 21 of the 256 frequencies, and the angle multiplies
that by the position. Gradients per `_train_parity`."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _train_parity as tp_
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_archs
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.module import is_spec as jis_spec
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.kvcache import pad_caches as jpad
from repro_torch import device as tdevice
from repro_torch import tree
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.module import is_spec
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve.kvcache import pad_caches as tpad
from repro_torch.train import train_loop as tloop

ROOT = Path(__file__).resolve().parent.parent
ARCH = "whisper-base"
BLOCK_REL = 1e-4
MODEL_REL = 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


def _near(got, want, rel):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=rel, atol=rel * np.abs(w).max())


def _inputs(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    emb = rng.standard_normal((B, cfg.frontend.n_tokens,
                               cfg.frontend.d_input)).astype(np.float32)
    return toks, emb


def test_layernorm_and_sinusoidal_positions_match_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    got = tlayers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlayers.layernorm(
        p, jnp.asarray(x), 1e-5)), rtol=1e-6, atol=1e-6)
    got = tlayers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x).bfloat16(), 1e-5)
    assert got.dtype == torch.bfloat16
    assert tlayers.layernorm_spec(64)["scale"].dtype == "float32"
    for n, dim in ((8, 64), (1500, 512)):
        want = np.asarray(jlayers.sinusoidal_positions(jnp.arange(n), dim))
        got = tlayers.sinusoidal_positions(torch.arange(n), dim)
        assert got.dtype == torch.float32 and got.shape == (n, dim)
        bound = (np.arange(n)[:, None] + 1) * 2.0 ** -22 if n > 8 else 1e-6
        assert (np.abs(got.numpy() - want) <= np.maximum(bound, 1e-6)).all()


def test_param_and_cache_specs_match_reference():
    jm, _, tm, _ = tp_.pair(ARCH)
    js = jax.tree.leaves(jm.param_specs(), is_leaf=jis_spec)
    ts = tree.leaves(tm.param_specs(), is_leaf=is_spec)
    assert [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in ts] == \
           [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in js]
    jc = jax.tree.leaves(jm.cache_specs(2, 24), is_leaf=jis_spec)
    tc = tree.leaves(tm.cache_specs(2, 24), is_leaf=is_spec)
    assert [(s.shape, s.axes) for s in tc] == [(s.shape, s.axes) for s in jc]
    assert sorted(tm.cache_specs(2, 24)[0]) == ["k", "v", "xk", "xv"]
    caches = tm.init_cache(2, 24)
    assert all(float(t.abs().sum()) == 0 for t in tree.leaves(caches))


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_build_model_builds_every_config(arch):
    """Every config builds (whisper as `EncDecLM`, the rest as
    `DecoderLM`), full size and reduced, with the reference's
    parameter count."""
    model = build_model(get_config(arch))
    assert isinstance(model, EncDecLM if get_config(arch).family == "encdec"
                      else DecoderLM)
    assert get_config(arch).param_count() == jget_config(arch).param_count()
    small = reduced(get_config(arch))
    assert tree.leaves(build_model(small).param_specs(), is_leaf=is_spec)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_each_layer_matches_reference_on_its_input(mode):
    """Each encoder layer and each decoder layer (self-attention, cross-
    attention, FFN) fed the reference's own input and, decoding, its
    own caches: outputs and new caches at BLOCK_REL."""
    jm, jp, tm, tp = tp_.pair(ARCH)
    cfg, tcfg = jm.cfg, tm.cfg
    toks, emb = _inputs(cfg)
    enc = np.array(jm._encode(jp, jnp.asarray(emb)))
    _near(tm._encode(tp, torch.from_numpy(emb)), enc, BLOCK_REL)
    # the encoder's layers, one by one (train mode only: no cache)
    x = np.asarray(emb) + np.asarray(jlayers.sinusoidal_positions(
        jnp.arange(emb.shape[1]), cfg.d_model))
    for li in range(cfg.enc_layers):
        jpl = jax.tree.map(lambda a: a[li], jp["enc"])
        tpl = tree.map(lambda a: a[li], tp["enc"])
        h = jlayers.layernorm(jpl["ln1"], jnp.asarray(x), cfg.norm_eps)
        jy = jnp.asarray(x) + jencdec._self_attention(jpl["attn"], h, cfg,
                                                      causal=False)[0]
        h = jlayers.layernorm(jpl["ln2"], jy, cfg.norm_eps)
        from repro.models import ffn as jffn
        jy = jy + jffn.ffn_apply(jpl["ffn"], h, "gelu")
        _near(tencdec._enc_layer(tpl, torch.from_numpy(x), tcfg), jy,
              BLOCK_REL)
        x = np.array(jy)
    _, jcache = jm.prefill(jp, jnp.asarray(toks), embeddings=jnp.asarray(emb))
    jcache = jpad(jcache, 12, 16)
    if mode == "decode":
        nxt = np.asarray([[3], [9]], np.int32)
        pos = 12
        x = np.array(jm._dec_embed(jp, jnp.asarray(nxt),
                                   jnp.full((2, 1), pos, jnp.int32)))
    else:
        pos = None
        x = np.array(jm._dec_embed(jp, jnp.asarray(toks), jnp.broadcast_to(
            jnp.arange(12, dtype=jnp.int32), (2, 12))))
    for li in range(cfg.n_layers):
        jpl = jax.tree.map(lambda a: a[li], jp["dec"])
        tpl = tree.map(lambda a: a[li], tp["dec"])
        jc = jax.tree.map(lambda a: a[li], jcache[0])
        tc = tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), jc)
        xj = jnp.asarray(x)
        h = jlayers.layernorm(jpl["ln1"], xj, cfg.norm_eps)
        a, kv = jencdec._self_attention(
            jpl["attn"], h, cfg, causal=True, mode=mode,
            cache=jc if mode == "decode" else None,
            pos=None if pos is None else jnp.asarray(pos, jnp.int32))
        xj = xj + a
        h = jlayers.layernorm(jpl["lnx"], xj, cfg.norm_eps)
        kv_in = {"k": jc["xk"], "v": jc["xv"]} if mode == "decode" \
            else jnp.asarray(enc)
        a, xkv = jencdec._cross_attention(jpl["xattn"], h, kv_in, cfg,
                                          mode=mode)
        xj = xj + a
        h = jlayers.layernorm(jpl["ln2"], xj, cfg.norm_eps)
        from repro.models import ffn as jffn
        xj = xj + jffn.ffn_apply(jpl["ffn"], h, "gelu")
        t_in = {"k": tc["xk"], "v": tc["xv"]} if mode == "decode" \
            else torch.from_numpy(enc)
        ty, tnc = tencdec._dec_layer(
            tpl, torch.from_numpy(x), t_in, tcfg, mode=mode,
            cache=tc if mode == "decode" else None,
            pos=None if pos is None else torch.tensor(pos, dtype=torch.int32))
        _near(ty, xj, BLOCK_REL)
        if mode == "train":
            assert tnc is None
        else:
            want = {"k": kv["k"], "v": kv["v"],
                    "xk": (xkv or {"k": jc["xk"]})["k"],
                    "xv": (xkv or {"v": jc["xv"]})["v"]}
            for k in want:
                _near(tnc[k], want[k], BLOCK_REL)
        x = np.array(xj)


def test_forward_prefill_and_decode_match_reference():
    """forward, prefill (every cache leaf, the frames' xk / xv among
    them) and three decode steps on the padded caches at MODEL_REL."""
    jm, jp, tm, tp = tp_.pair(ARCH)
    toks, emb = _inputs(jm.cfg, seed=1)
    jl, jx = jm.forward(jp, jnp.asarray(toks), embeddings=jnp.asarray(emb))
    tl, tx = tm.forward(tp, torch.from_numpy(toks),
                        embeddings=torch.from_numpy(emb))
    _near(tl, jl, MODEL_REL)
    assert float(tx["moe_aux"]) == float(jx["moe_aux"]) == 0.0
    jl, jc = jm.prefill(jp, jnp.asarray(toks), embeddings=jnp.asarray(emb))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks),
                        embeddings=torch.from_numpy(emb))
    _near(tl, jl, MODEL_REL)
    assert sorted(tc[0]) == sorted(jc[0]) == ["k", "v", "xk", "xv"]
    for k in jc[0]:
        assert tuple(tc[0][k].shape) == jc[0][k].shape
        _near(tc[0][k], jc[0][k], MODEL_REL)
    jc, tc = jpad(jc, 12, 16), tpad(tc, 12, 16, tm.cache_specs(2, 16))
    rng = np.random.default_rng(2)
    for step in range(3):
        nxt = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, 12 + step)
        tl, tc2 = tm.decode_step(tp, torch.from_numpy(nxt), tc, 12 + step)
        _near(tl, jl, MODEL_REL)
        for k in jc[0]:
            _near(tc2[0][k], jc[0][k], MODEL_REL)
        assert not torch.equal(tc2[0]["k"], tc[0]["k"])   # inputs untouched
        assert torch.equal(tc2[0]["xk"], tc[0]["xk"])
        tc = tc2


def _generate(model, params, toks, emb, n_new, max_seq, tensor, pad):
    logits, caches = model.prefill(params, tensor(toks), embeddings=emb)
    caches = pad(caches, toks.shape[1], max_seq)
    out = [np.asarray(logits[:, -1]).argmax(-1)]
    for t in range(n_new - 1):
        lg, caches = model.decode_step(
            params, tensor(out[-1][:, None].astype(np.int32)), caches,
            toks.shape[1] + t)
        out.append(np.asarray(lg[:, 0]).argmax(-1))
    return np.stack(out, 1).tolist()


def test_greedy_tokens_equal_reference():
    jm, jp, tm, tp = tp_.pair(ARCH)
    toks, emb = _inputs(jm.cfg, seed=3)
    want = _generate(jm, jp, toks, jnp.asarray(emb), 6, 24,
                     lambda a: jnp.asarray(a, jnp.int32), jpad)
    with torch.no_grad():
        got = _generate(tm, tp, toks, torch.from_numpy(emb), 6, 24,
                        lambda a: torch.from_numpy(np.asarray(a, np.int32)),
                        lambda c, s, m: tpad(c, s, m, tm.cache_specs(2, m)))
    assert got == want


def test_vision_frontend_splices_patches_like_the_reference():
    """internvl2-2b's patch embeddings replace the first rows of the
    token embeddings in `forward` (and `prefill`); decode takes none."""
    jm, jp, tm, tp = tp_.pair("internvl2-2b")
    toks, emb = _inputs(jm.cfg, S=14, seed=4)
    jl, _ = jm.forward(jp, jnp.asarray(toks), embeddings=jnp.asarray(emb))
    tl, _ = tm.forward(tp, torch.from_numpy(toks),
                       embeddings=torch.from_numpy(emb))
    _near(tl, jl, MODEL_REL)
    x = tm._embed_in(tp, torch.from_numpy(toks), torch.from_numpy(emb))
    assert torch.equal(x[:, :8], torch.from_numpy(emb))
    plain = tm._embed_in(tp, torch.from_numpy(toks))
    assert torch.equal(x[:, 8:], plain[:, 8:])
    jl, _ = jm.prefill(jp, jnp.asarray(toks), embeddings=jnp.asarray(emb))
    tl, _ = tm.prefill(tp, torch.from_numpy(toks),
                       embeddings=torch.from_numpy(emb))
    _near(tl, jl, MODEL_REL)
    # a config without a frontend ignores embeddings, as the reference
    _, _, gm, gp = tp_.pair("gemma-2b")
    assert torch.equal(gm._embed_in(gp, torch.from_numpy(toks)),
                       gm._embed_in(gp, torch.from_numpy(toks),
                                    torch.from_numpy(emb)))


@pytest.mark.parametrize("arch", [ARCH, "internvl2-2b"])
def test_train_step_loss_and_grads_match_reference(arch):
    tp_.hold_loss_and_grads(arch)


@pytest.mark.parametrize("arch", [ARCH, "gemma-2b"])
def test_remat_recomputes_each_layer_with_the_same_grads(arch, monkeypatch):
    """With `cfg.remat`, a forward under grad mode recomputes each layer
    (the decoder's, for whisper) in the backward: the attention calls
    of a train step double there, and the grads are bit-equal to the
    step without remat. Without grad mode there is no recompute."""
    _, _, tm, tp = tp_.pair(arch)
    calls = {"n": 0}
    ref0 = fa_ref.reference

    def counted(*a, **kw):
        calls["n"] += 1
        return ref0(*a, **kw)
    monkeypatch.setattr(fa_ref, "reference", counted)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    monkeypatch.setattr(fa_ops.ref, "reference", counted)
    cfg = tm.cfg
    b = tree_from_numpy(tp_.batch(cfg), "cpu")
    got = {}
    for remat in (False, True):
        m = build_model(dataclasses.replace(cfg, remat=remat))
        calls["n"] = 0
        got[remat] = tloop.value_and_grad(tloop.make_loss_fn(m, m.cfg), tp, b)
        got[remat] = (got[remat], calls["n"])
    (r0, n0), (r1, n1) = got[False], got[True]
    dec = 2 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers
    enc = cfg.enc_layers
    # forward + the backward's recompute of the plain version per call
    assert n0 == 2 * (enc + dec) and n1 == n0 + dec
    assert torch.equal(r0[0][0], r1[0][0])
    for a, c in zip(tree.leaves(r0[1]), tree.leaves(r1[1])):
        assert torch.equal(a, c)
    m = build_model(dataclasses.replace(cfg, remat=True))
    calls["n"] = 0
    with torch.no_grad():
        m.forward(tp, b["tokens"], embeddings=b.get("embeddings"))
    assert calls["n"] == enc + dec


def test_serve_cli_refuses_whisper_as_the_reference_engine_cannot_serve_it():
    """The reference's engine calls an encoder-decoder's prefill with no
    frame embeddings and fails; the port's serving CLI refuses whisper
    with that reason before building anything."""
    jm, jp, _, _ = tp_.pair(ARCH)
    eng = JEngine(jm, jp, max_batch=1, max_seq=16)
    with pytest.raises(TypeError, match="embeddings"):
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run_until_done()
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
