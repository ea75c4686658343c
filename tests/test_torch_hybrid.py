"""The port's Griffin hybrid held against the JAX package, on the CPU,
and the state-cache padding fault of the reference's serving path.

`repro_torch.models.rglru` (the block-diagonal gates, the depthwise
conv, the RG-LRU scan, forward and decode), `collectives.
window_decode_attention` and `reduced(recurrentgemma-2b)` in float32 (3
layers: rec, rec, attn_win; d_model 64, 4 query heads on 1 kv head of
16, window 8, lru_width 64, conv width 4) against `repro.models.rglru`
and the reference's decoder, on the reference's own parameters carried
over by `convert.params_from_numpy`.

The fault: the reference's `pad_caches` pads every cache leaf whose dim
2 equals the prompt length. For the hybrid a window leaf shorter than
the window, the conv history (3 rows) and the RG-LRU state (lru_width
wide) all meet that test at some prompt length, and its `ServeEngine`
then fails. The port pads by the cache spec (`serve.kvcache.
pad_caches`): the tests assert that the reference raises at those
lengths (the recorded divergence), that the port serves them with the
greedy tokens of a cache-free oracle (`forward` recomputed over prompt
+ generated tokens at every step), that it equals the reference where
the reference serves, and that gemma-2b's and granite's padded caches
are bit-equal to what the reference's padding gives.

Tolerances. `rglru_scan` at 1e-5 (the reference's own,
`tests/test_ssm_rglru.py:85`: the Hillis–Steele and the associative
scan reassociate the same float32 products); the gates and the conv at
1e-6; window decode attention at 1e-6; each block at 1e-4 and the whole
model at 1e-3 of the output's largest magnitude, with greedy tokens
exact (the tolerances `test_torch_model.py` measured)."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import rglru as jrglru
from repro.models import transformer as jtrans
from repro.models.module import init_params as jinit
from repro.models.module import is_spec as jis_spec
from repro.models.registry import build_model as jbuild
from repro.obs import metrics as jmetrics
from repro.parallel import collectives as jcoll
from repro.serve import kvcache as jcache
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.pd_disagg import PDServer as JPDServer
from repro_torch import device as tdevice
from repro_torch import tree
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy, tree_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttrans
from repro_torch.models.module import is_spec
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as tmetrics
from repro_torch.parallel import collectives as tcoll
from repro_torch.serve import kvcache as tcache
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.paged import bucketable, pageable
from repro_torch.serve.pd_disagg import PDServer as TPDServer

ROOT = Path(__file__).resolve().parent.parent
ARCH = "recurrentgemma-2b"
SCAN_TOL = 1e-5
BLOCK_REL = 1e-4
MODEL_REL = 1e-3
MAX_SEQ = 96


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


def _both(arch, seed=0):
    jm = jbuild(jreduced(jget_config(arch)))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(reduced(get_config(arch)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def hybrid():
    return _both(ARCH)


@pytest.fixture
def registries():
    jprev, tprev = jmetrics.get_registry(), tmetrics.get_registry()
    yield jmetrics.fresh_registry(), tmetrics.fresh_registry()
    jmetrics.set_registry(jprev)
    tmetrics.set_registry(tprev)


def _near(got, want, rel):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=rel, atol=rel * np.abs(w).max())


def _leaves_near(got, want, rel):
    jl, tl = jax.tree.leaves(want), tree.leaves(got)
    assert len(jl) == len(tl) > 0
    for a, b in zip(tl, jl):
        _near(a, b, rel)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rec_params(seed=0):
    cfg = jreduced(jget_config(ARCH))
    jp = jinit(jrglru.rglru_block_spec(cfg), jax.random.PRNGKey(seed),
               "float32")
    return cfg, reduced(get_config(ARCH)), jp, tree_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


# -- the block's parts -------------------------------------------------------
@pytest.mark.parametrize("R", [2560, 64, 24, 10, 7])
def test_block_count_and_specs_match_reference(R):
    import dataclasses
    jcfg = jreduced(jget_config(ARCH))
    tcfg = reduced(get_config(ARCH))
    jcfg = dataclasses.replace(jcfg, hybrid=dataclasses.replace(
        jcfg.hybrid, lru_width=R))
    tcfg = dataclasses.replace(tcfg, hybrid=dataclasses.replace(
        tcfg.hybrid, lru_width=R))
    assert trglru._nb(tcfg) == jrglru._nb(jcfg)
    for jf, tf in ((jrglru.rglru_block_spec(jcfg),
                    trglru.rglru_block_spec(tcfg)),
                   (jrglru.rglru_cache_spec(jcfg, 3),
                    trglru.rglru_cache_spec(tcfg, 3))):
        js = jax.tree.leaves(jf, is_leaf=jis_spec)
        ts = tree.leaves(tf, is_leaf=is_spec)
        assert [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in ts] == \
               [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in js]


def test_gates_conv_and_block_diag_match_reference():
    jcfg, tcfg, jp, tp = _rec_params(1)
    rng = np.random.default_rng(1)
    R = jcfg.hybrid.lru_width
    x = rng.standard_normal((2, 9, R)).astype(np.float32)
    nb = jrglru._nb(jcfg)
    np.testing.assert_allclose(
        trglru._block_diag(tp["gate_a"], tp["gate_a_b"], _t(x), nb).numpy(),
        np.asarray(jrglru._block_diag(jp["gate_a"], jp["gate_a_b"],
                                      jnp.asarray(x), nb)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        trglru._dconv(_t(x), tp["conv"], tp["conv_b"]).numpy(),
        np.asarray(jrglru._dconv(jnp.asarray(x), jp["conv"], jp["conv_b"])),
        rtol=1e-6, atol=1e-6)
    for got, want in zip(trglru._gates(tp, _t(x), nb),
                         jrglru._gates(jp, jnp.asarray(x), nb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_rglru_scan_matches_reference(S, with_h0):
    """The Hillis–Steele scan against `lax.associative_scan`, with and
    without an initial state, at 1e-5 (the reference's own tolerance
    against its sequential loop), and against a plain loop."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 16)).astype(np.float32)
    b = rng.standard_normal((2, S, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32) if with_h0 else None
    want = np.asarray(jrglru.rglru_scan(
        jnp.asarray(a), jnp.asarray(b),
        None if h0 is None else jnp.asarray(h0)))
    got = trglru.rglru_scan(_t(a), _t(b), None if h0 is None else _t(h0))
    np.testing.assert_allclose(got.numpy(), want, rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    h = np.zeros((2, 16), np.float32) if h0 is None else h0.copy()
    loop = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(loop, 1),
                               rtol=SCAN_TOL, atol=SCAN_TOL)


def test_rglru_forward_and_decode_match_reference_and_each_other():
    """Forward (with its cache, with h0 and conv0) against the
    reference, and the port's decode step by step against its own
    forward over the whole sequence."""
    jcfg, tcfg, jp, tp = _rec_params(2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, jcfg.d_model)).astype(np.float32)
    jy, jc = jrglru.rglru_forward(jp, jnp.asarray(x), jcfg, return_cache=True)
    ty, tc = trglru.rglru_forward(tp, _t(x), tcfg, return_cache=True)
    _near(ty, jy, BLOCK_REL)
    _leaves_near(tc, jc, BLOCK_REL)
    assert tc["h"].dtype == tc["conv"].dtype == torch.float32
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    conv0 = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jy = jrglru.rglru_forward(jp, jnp.asarray(x), jcfg, h0=jnp.asarray(h0),
                              conv0=jnp.asarray(conv0))
    ty = trglru.rglru_forward(tp, _t(x), tcfg, h0=_t(h0), conv0=_t(conv0))
    _near(ty, jy, BLOCK_REL)
    # decode from a 4-token prefix reproduces the forward's later rows
    full = trglru.rglru_forward(tp, _t(x), tcfg)
    _, cache = trglru.rglru_forward(tp, _t(x[:, :4]), tcfg,
                                    return_cache=True)
    for t in range(4, 10):
        jy, jc = jrglru.rglru_decode(
            jp, jnp.asarray(x[:, t:t + 1]),
            jax.tree.map(lambda a: jnp.asarray(a.numpy()), cache), jcfg)
        y, cache = trglru.rglru_decode(tp, _t(x[:, t:t + 1]), cache, tcfg)
        _near(y[:, 0], full[:, t], BLOCK_REL)
        _near(y, jy, BLOCK_REL)
        _leaves_near(cache, jc, BLOCK_REL)


def test_short_prompt_conv_history_is_zero_padded():
    """A prefix shorter than the conv history (S < conv_width - 1): the
    port's cache keeps conv_width - 1 rows, the earliest zero, so
    decode continues the forward exactly; the reference keeps S rows
    and its decode fails on the short history (a recorded divergence)."""
    jcfg, tcfg, jp, tp = _rec_params(3)
    x = np.random.default_rng(3).standard_normal(
        (1, 6, jcfg.d_model)).astype(np.float32)
    full = trglru.rglru_forward(tp, _t(x), tcfg)
    for n in (1, 2):
        _, cache = trglru.rglru_forward(tp, _t(x[:, :n]), tcfg,
                                        return_cache=True)
        assert tuple(cache["conv"].shape) == (1, 3, 64)
        assert not cache["conv"][:, :3 - n].any()
        y, _ = trglru.rglru_decode(tp, _t(x[:, n:n + 1]), cache, tcfg)
        _near(y[:, 0], full[:, n], BLOCK_REL)
        _, jc = jrglru.rglru_forward(jp, jnp.asarray(x[:, :n]), jcfg,
                                     return_cache=True)
        assert jc["conv"].shape[1] == n
        with pytest.raises((TypeError, ValueError)):
            jrglru.rglru_decode(jp, jnp.asarray(x[:, n:n + 1]), jc, jcfg)


def test_rglru_a_initializer():
    """Λ drawn so that sigmoid(Λ)^8 lies in [0.9, 0.999], in float32
    whatever the model dtype, seeded by the generator."""
    tm = build_model(reduced(get_config(ARCH)))
    a = tm.init(torch.Generator().manual_seed(0), "bfloat16")
    b = tm.init(torch.Generator().manual_seed(0), "bfloat16")
    lam = a["groups"][0]["b0"]["rec"]["lam"]
    assert lam.dtype == torch.float32 and lam.shape == (1, 64)
    assert torch.equal(lam, b["groups"][0]["b0"]["rec"]["lam"])
    a8 = torch.sigmoid(lam.double()) ** 8
    assert float(a8.min()) >= 0.9 - 1e-6 and float(a8.max()) <= 0.999 + 1e-6
    assert float(a8.max() - a8.min()) > 0.05


# -- window decode attention --------------------------------------------------
@pytest.mark.parametrize("W", [8, 12])
def test_window_decode_attention_past_the_wrap(W):
    """Per-request positions before, at and past the wrap (pos >= W),
    with W equal to the window (the port's layout) and above it (the
    reference's padded layout, where the window mask cuts)."""
    rng = np.random.default_rng(W)
    B, KVH, G, D, window = 3, 1, 4, 16, 8
    q = rng.standard_normal((B, KVH, G, D)).astype(np.float32)
    kw, vw = (rng.standard_normal((B, W, KVH, D)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((B, KVH, D)).astype(np.float32)
              for _ in range(2))
    pos = np.asarray([3, W, 3 * W + 5], np.int32)
    want = jcoll.window_decode_attention(
        *map(jnp.asarray, (q, kw, vw, kn, vn, pos)), window)
    got = tcoll.window_decode_attention(
        *map(_t, (q, kw, vw, kn, vn, pos)), window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert not np.array_equal(got[1].numpy(), kw)          # written
    scalar = tcoll.window_decode_attention(
        *map(_t, (q, kw, vw, kn, vn)), torch.tensor(W + 2), window)
    per = tcoll.window_decode_attention(
        *map(_t, (q, kw, vw, kn, vn)), torch.full((B,), W + 2), window)
    assert all(torch.equal(a, b) for a, b in zip(scalar, per))


# -- the decoder ----------------------------------------------------------------
def test_layer_plan_and_cache_specs_match_reference(hybrid):
    jm, _, tm, _ = hybrid
    assert [(k.mix, k.ffn) for k in ttrans.layer_plan(tm.cfg)] == \
           [(k.mix, k.ffn) for k in jtrans.layer_plan(jm.cfg)]
    assert ttrans.group_plan(get_config(ARCH)) == \
        [((ttrans.LayerKind("rec", "dense"), ttrans.LayerKind("rec", "dense"),
           ttrans.LayerKind("attn_win", "dense")), 8),
         ((ttrans.LayerKind("rec", "dense"),), 2)]
    for seq in (4, 8, 20):
        js = jax.tree.leaves(jm.cache_specs(2, seq), is_leaf=jis_spec)
        ts = tree.leaves(tm.cache_specs(2, seq), is_leaf=is_spec)
        assert [(s.shape, s.axes, s.dtype) for s in ts] == \
               [(s.shape, s.axes, s.dtype) for s in js]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_each_block_matches_reference_on_its_input(hybrid, mode):
    """rec, rec and attn_win fed the reference's own hidden state (and,
    decoding at a position past the window, its own caches)."""
    jm, jp, tm, tp = hybrid
    rng = np.random.default_rng(4)
    S = 13
    toks = rng.integers(0, 256, (2, S)).astype(np.int32)
    cfg, tcfg = jm.cfg, tm.cfg
    _, caches = jm.prefill(jp, jnp.asarray(toks))
    if mode == "decode":
        toks = rng.integers(0, 256, (2, 1)).astype(np.int32)
        pos = np.asarray([S, S], np.int32)
        positions = pos[:, None]
    else:
        pos, positions = None, np.broadcast_to(np.arange(S, dtype=np.int32),
                                               (2, S)).copy()
    x = np.array(jm._embed_in(jp, jnp.asarray(toks)))
    kinds, tkinds = jtrans.group_plan(cfg)[0][0], ttrans.group_plan(tcfg)[0][0]
    for i, (kind, tkind) in enumerate(zip(kinds, tkinds)):
        key = f"b{i}"
        jpl = jax.tree.map(lambda a: a[0], jp["groups"][0][key])
        tpl = tree.map(lambda a: a[0], tp["groups"][0][key])
        jc = jax.tree.map(lambda a: a[0], caches[0][key]) \
            if mode == "decode" else None
        tc = tree.map(lambda a: _t(a), jc) if jc is not None else None
        jy, _, jnc = jtrans.block_apply(
            jpl, jnp.asarray(x), jnp.asarray(positions), cfg, kind,
            mode=mode, cache=jc, pos=None if pos is None else jnp.asarray(pos))
        ty, aux, tnc = ttrans.block_apply(
            tpl, _t(x), _t(positions), tcfg, tkind, mode=mode, cache=tc,
            pos=None if pos is None else _t(pos))
        _near(ty, jy, BLOCK_REL)
        assert float(aux) == 0.0
        if mode == "train":
            assert tnc is None and jnc is None
        else:
            _leaves_near(tnc, jnc, BLOCK_REL)
        x = np.array(jy)


def test_forward_prefill_and_decode_match_reference(hybrid):
    """The whole model past the window (13 tokens, then decode steps
    at per-request positions), caches padded as each package pads them:
    the reference leaves a 13-token prefill's leaves alone (none has
    dim 2 == 13), and so does the port."""
    jm, jp, tm, tp = hybrid
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 13)).astype(np.int32)
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    tl, tx = tm.forward(tp, _t(toks))
    _near(tl, jl, MODEL_REL)
    jl, jc = jm.prefill(jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, _t(toks))
    _near(tl, jl, MODEL_REL)
    _leaves_near(tc, jc, MODEL_REL)
    jc = jcache.pad_caches(jc, 13, 24)
    tc = tcache.pad_caches(tc, 13, 24, tm.cache_specs(2, 24))
    _leaves_near(tc, jc, MODEL_REL)
    for step in range(4):
        nxt = rng.integers(0, 256, (2, 1)).astype(np.int32)
        pos = np.asarray([13 + step, 13 + step], np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, _t(nxt), tc, _t(pos))
        _near(tl, jl, MODEL_REL)
        _leaves_near(tc, jc, MODEL_REL)


# -- serving: the fault and its repair -----------------------------------------
def _oracle(model, params, prompt, n_new):
    """Greedy tokens with no cache: `forward` over prompt + generated
    tokens, recomputed at every step."""
    toks, out = list(prompt), []
    for _ in range(n_new):
        lg, _ = model.forward(params, torch.tensor([toks], dtype=torch.int32))
        out.append(int(torch.argmax(lg[0, -1])))
        toks.append(out[-1])
    return out


def _port_generate(model, params, prompt, n_new, max_seq):
    """The port's unpadded reference: prefill, spec-driven padding,
    dense decode at batch 1."""
    logits, caches = model.prefill(params, torch.tensor([prompt],
                                                        dtype=torch.int32))
    caches = tcache.pad_caches(caches, len(prompt), max_seq,
                               model.cache_specs(1, max_seq))
    out = [int(torch.argmax(logits[0, -1]))]
    for t in range(n_new - 1):
        lg, caches = model.decode_step(
            params, torch.tensor([[out[-1]]], dtype=torch.int32), caches,
            len(prompt) + t)
        out.append(int(torch.argmax(lg[0, 0])))
    return out


def _serve(engine_cls, model, params, prompts, new, **kw):
    eng = engine_cls(model, params, **kw)
    rids = [eng.submit(list(p), max_new_tokens=new) for p in prompts]
    res = eng.run_until_done()
    return eng, [res[r] for r in rids]


@pytest.mark.parametrize("n", [3, 5, 64])
def test_reference_engine_raises_where_state_leaves_collide(hybrid, n):
    """Prompts of conv_width - 1, fewer than the window, and lru_width
    tokens: the reference's `pad_caches` grows a conv, window or state
    leaf to max_seq and its engine fails to install it."""
    jm, jp, _, _ = hybrid
    prompt = np.random.default_rng(n).integers(0, 256, n).tolist()
    with pytest.raises(ValueError, match="Incompatible shapes"):
        _serve(JEngine, jm, jp, [prompt], 4, max_batch=2, max_seq=MAX_SEQ)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 64, 12])
def test_port_engine_serves_every_length_like_the_cache_free_oracle(
        hybrid, n):
    """The port's `ServeEngine` (dense: the hybrid is neither pageable
    nor bucketable) and its unpadded reference give the oracle's greedy
    tokens at the colliding lengths, at 1 and 2 tokens (shorter than
    the conv history), and at 12 (past the window)."""
    _, _, tm, tp = hybrid
    prompt = np.random.default_rng(n).integers(0, 256, n).tolist()
    te, tt = _serve(TEngine, tm, tp, [prompt], 5, max_batch=2,
                    max_seq=MAX_SEQ)
    assert not te.paged and not te.bucketed
    want = _oracle(tm, tp, prompt, 5)
    assert tt == [want]
    assert _port_generate(tm, tp, prompt, 5, MAX_SEQ) == want
    te.close()


def test_engine_matches_reference_engine_where_it_serves(hybrid,
                                                         registries):
    """Prompts the reference serves (longer than the window, not 64): the
    same tokens as the JAX engine and its trusted path, the same
    `serve0/` counters and ring DMA counters; two waves on two slots, so
    a slot's state leaves are installed over a finished request's."""
    jm, jp, tm, tp = hybrid
    jreg, treg = registries
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).tolist() for n in (12, 9, 20, 10)]
    je, jt = _serve(JEngine, jm, jp, prompts, 5, max_batch=2,
                    max_seq=MAX_SEQ)
    te, tt = _serve(TEngine, tm, tp, prompts, 5, max_batch=2,
                    max_seq=MAX_SEQ)
    assert tt == jt == [_oracle(tm, tp, p, 5) for p in prompts]
    assert te.prefill_compiles == je.prefill_compiles == 4
    assert {k: v for k, v in treg.snapshot().items()
            if k.startswith("serve0/")} == \
           {k: v for k, v in jreg.snapshot().items()
            if k.startswith("serve0/")} != {}
    assert (te.ring.dma_writes, te.ring.dma_reads) == \
           (je.ring.dma_writes, je.ring.dma_reads)
    je.close()
    te.close()


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-1b-a400m"])
def test_attention_caches_pad_bit_equal_to_the_reference(arch):
    """What a gemma or granite cache gets is unchanged: the spec-driven
    padding equals the reference's shape-driven one, bit for bit, on
    seeded caches of a prefill's shapes at every prompt length the tests
    serve and at max_seq itself."""
    jm = jbuild(jreduced(jget_config(arch)))
    tm = build_model(reduced(get_config(arch)))
    rng = np.random.default_rng(1)
    for n in (1, 3, 5, 16, 48):
        jc = jax.tree.map(
            lambda s: rng.standard_normal(s.shape).astype(np.float32),
            jm.cache_specs(2, n), is_leaf=jis_spec)
        want = jcache.pad_caches(jax.tree.map(jnp.asarray, jc), n, 48)
        got = tcache.pad_caches(tree_from_numpy(jc, "cpu"), n, 48,
                                tm.cache_specs(2, 48))
        wl, gl = jax.tree.leaves(want), tree.leaves(got)
        assert len(wl) == len(gl) == 2 * len(jm.groups)
        for w, g in zip(wl, gl):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hybrid_padding_follows_the_spec():
    """Each leaf of a hybrid cache grows on the axis its spec names: the
    window leaf to min(window, s_max) with token p in slot p mod W, the
    state leaves not at all, whatever their length."""
    tm = build_model(reduced(get_config(ARCH)))
    specs = tm.cache_specs(1, MAX_SEQ)
    for n in (3, 5, 64):
        caches = tree.map(lambda s: torch.randn(s.shape),
                          tm.cache_specs(1, n), is_leaf=is_spec)
        got = tcache.pad_caches(caches, n, MAX_SEQ, specs)
        for a, b, s in zip(tree.leaves(caches), tree.leaves(got),
                           tree.leaves(specs, is_leaf=is_spec)):
            assert tuple(b.shape) == s.shape
            if "window" in s.axes:
                assert a.shape[2] == min(8, n)
                assert torch.equal(b[:, :, :a.shape[2]], a)
                assert not b[:, :, a.shape[2]:].any()
            else:
                assert b is a
    # a leaf longer than its spec allows is refused
    wide = tree.map(lambda s: torch.zeros(s.shape), tm.cache_specs(1, 8),
                    is_leaf=is_spec)
    with pytest.raises(ValueError, match="spec"):
        tcache.pad_caches(wide, 8, 4, tm.cache_specs(1, 4))


# -- PDServer -----------------------------------------------------------------
def _count_ingests(monkeypatch, kvcache_module, record):
    real = kvcache_module.PagedKVPool.ingest

    def ingest(self, alloc, kv, *a, **kw):
        record.append((tuple(kv.shape[1:]), len(alloc.logical_pages)))
        return real(self, alloc, kv, *a, **kw)
    monkeypatch.setattr(kvcache_module.PagedKVPool, "ingest", ingest)


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-1b-a400m",
                                  ARCH])
def test_pdserver_serve_matches_reference_and_pages_leaf_by_leaf(
        arch, monkeypatch):
    """`tests/test_serve.py::test_pd_disagg_end_to_end_invariant`'s
    prompts: tokens equal the reference's and the trusted path's, stats
    equal. The page round trip's ingests, leaf by leaf: gemma's and
    granite's equal the reference's (k and v of every layer and row);
    recurrentgemma's differ as the padding does — the reference pads a
    4-token prompt's window leaves (k and v of its one attn_win layer,
    2 rows each) to max_seq and pages them, 6 pages of 8 tokens per row,
    while the port keeps them at the window and pages none; state leaves
    take no page on either side."""
    jm, jp, tm, tp = _both(arch, 1)
    prompts = np.asarray([[4, 8, 15, 16], [23, 42, 3, 7]], np.int32)
    jrec, trec = [], []
    from repro.serve import kvcache as jkv_mod
    _count_ingests(monkeypatch, jkv_mod, jrec)
    _count_ingests(monkeypatch, tcache, trec)
    jt, js = JPDServer(jm, jp, max_seq=48, page_tokens=8).serve(prompts,
                                                              n_steps=5)
    tt, ts = TPDServer(tm, tp, max_seq=48, page_tokens=8).serve(prompts,
                                                              n_steps=5)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    for b, prompt in enumerate(prompts):
        assert tt[b].tolist() == _port_generate(tm, tp, list(prompt), 6, 48)
    assert (ts.n_leaves, ts.payload_bytes, ts.header_bytes) == \
           (js.n_leaves, js.payload_bytes, js.header_bytes)
    assert ts.header_bytes == 64 * ts.n_leaves
    if arch == ARCH:
        hd = tm.cfg.resolved_head_dim
        assert jrec == [((1, hd), 6)] * 4 and trec == []
    else:
        L, kvh = tm.cfg.n_layers, tm.cfg.n_kv_heads
        assert trec == jrec == [((kvh, tm.cfg.resolved_head_dim), 6)] \
            * (2 * L * 2)


# -- parameters crossing from the reference ------------------------------------
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", ARCH])
def test_bf16_params_cross_with_their_named_dtypes(arch):
    """A bf16 model's parameters from the reference: the expert-stacked
    leaves, the RG-LRU gates and conv arrive in bf16, bit for bit; the
    leaves whose spec names float32 (norm scales, the router, Λ) in
    float32; a leaf of another dtype than its spec names is refused."""
    import dataclasses
    jm = jbuild(dataclasses.replace(jreduced(jget_config(arch)),
                                    dtype="bfloat16"))
    tm = build_model(dataclasses.replace(reduced(get_config(arch)),
                                         dtype="bfloat16"))
    arrays = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(arrays, "cpu", model=tm)
    specs = tree.leaves(tm.param_specs(), is_leaf=is_spec)
    named = 0
    for spec, a, t in zip(specs, jax.tree.leaves(arrays), tree.leaves(tp)):
        want = torch.float32 if spec.dtype == "float32" else torch.bfloat16
        assert t.dtype == want
        named += spec.dtype == "float32" and spec.init != "ones"
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16) if want ==
            torch.bfloat16 else t.numpy(),
            a.view(np.uint16) if want == torch.bfloat16 else a)
    blk = tp["groups"][0]["b0"]
    if arch == ARCH:
        assert blk["rec"]["lam"].dtype == torch.float32
        assert blk["rec"]["gate_a"].dtype == torch.bfloat16
        arrays["groups"][0]["b0"]["rec"]["lam"] = \
            arrays["groups"][0]["b0"]["rec"]["lam"].astype(jnp.bfloat16)
    else:
        assert blk["moe"]["router"]["w"].dtype == torch.float32
        assert blk["moe"]["experts"]["gate"].shape == (2, 4, 64, 32)
        arrays["groups"][0]["b0"]["moe"]["router"]["w"] = \
            arrays["groups"][0]["b0"]["moe"]["router"]["w"].astype(
                jnp.bfloat16)
    assert named > 0
    with pytest.raises(ValueError, match="spec"):
        params_from_numpy(arrays, "cpu", model=tm)


# -- eligibility and the CLI ----------------------------------------------------
def test_eligibility_matches_reference(hybrid):
    from repro.serve import paged as jpaged
    jm, _, tm, _ = hybrid
    assert (pageable(tm), bucketable(tm)) == \
           (jpaged.pageable(jm), jpaged.bucketable(jm)) == (False, False)


@pytest.mark.parametrize("pd", [False, True])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", ARCH])
def test_serve_cli_serves_both_families_on_the_cpu(arch, pd):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--requests",
            "3", "--max-new", "4"]
    if pd:
        toks, stats = tlaunch.main(argv + ["--pd"])
        assert toks.shape == (3, 5) and stats.payload_bytes > 0
    else:
        res = tlaunch.main(argv)
        assert sorted(res) == [0, 1, 2] and all(len(v) == 4
                                                for v in res.values())


# -- chip_smoke phase 10 at CPU size ---------------------------------------------
class _Clock:                           # no card: nothing to time
    def sync(self):
        pass

    def wall(self, fn):
        fn()
        return 0.0

    def span(self, fn, spans):
        return fn()

    def spans_ms(self, spans):
        return 0.0


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", ARCH])
def test_chip_smoke_phase10_at_cpu_size(arch):
    """`chip_smoke.py`'s phase 10 — the engine on six prompts plus, for
    the hybrid, the colliding lengths (conv_width - 1, lru_width), every
    step held against the unpadded reference; PDServer against the
    dense greedy decode — at a toy size on the CPU with the reference's
    parameters. granite's tokens equal the JAX engine's; recurrentgemma's
    (the reference cannot serve these lengths) the cache-free oracle's."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    jm, jp, tm, tp = _both(arch, 2)
    F = chip_smoke.FamilySizes(archs=(arch,), reduce=True, max_batch=4,
                               max_seq=MAX_SEQ, page=8,
                               prompts=(5, 9, 17, 30, 40, 50), new=5,
                               pd_batch=2, pd_prompt=10, pd_steps=3,
                               pd_seq=48, reps=1, seed=0)
    out = chip_smoke.phase_family(torch, np, torch.device("cpu"), F, arch,
                                  np.random.default_rng(0), _Clock(),
                                  params=tp)
    assert out["launches"] == {} and out["peak_gib"] is None
    assert out["token_agreement"] == 1.0
    assert out["logit_rel_err"] <= chip_smoke.LOGIT_TOL["float32"]
    lens = [len(p) for p in out["prompts"]]
    if arch == ARCH:
        assert lens == [5, 9, 17, 30, 40, 50, 3, 64]
        assert out["tokens"] == [_oracle(tm, tp, p, 5)
                                 for p in out["prompts"]]
    else:
        assert lens == [5, 9, 17, 30, 40, 50]
        je, jt = _serve(JEngine, jm, jp, out["prompts"], F.new,
                        max_batch=F.max_batch, max_seq=F.max_seq,
                        page_tokens=F.page, device_ring=True)
        assert out["tokens"] == jt
        je.close()
    assert np.asarray(out["pd_tokens"]).shape == (2, 4)
    layout = chip_smoke.flash_layout(tm.cfg)
    assert chip_smoke.family_flash_shapes(F)[arch] == \
        [layout + (1, n) for n in lens] + [layout + (2, 10)]
    # batch 1 against the engine's batch of 4, step by step and block by
    # block, in float32 too; the router's choices for the MoE alone
    witness = out["batch_witness"]
    tol = chip_smoke.LOGIT_TOL["float32"]
    assert len(witness["rel_by_step"]) == F.new
    assert witness["layers"] == tm.cfg.n_layers
    assert len(witness["hidden_rel_by_layer_step1"]) == tm.cfg.n_layers
    assert len(witness["hidden_rel_last_layer_by_step"]) == F.new - 1
    assert witness["float32"]["rel_by_step"][1] <= tol
    assert witness["hidden_first_over_tol"] is None
    if arch == ARCH:
        assert "flips_by_step" not in witness
    else:
        assert witness["flips_by_step"][0] == 0
        assert witness["before_first_flip"] <= tol
        assert witness["float32"]["flips_by_step"] == witness["flips_by_step"]
    assert out["page_shapes"] == [
        chip_smoke.page_key(*s)
        for s in chip_smoke.family_page_shapes(F)[arch]]


def test_phase2_holds_every_phase10_page():
    """Phase 2 holds and times the page kernels at each page that phase
    10's round trips move at full width: granite's K/V pages, the dense
    decoders' (codeqwen's 32 kv heads of 128, phi4-mini's 8 of 128,
    stablelm's 8 of 160) and deepseek's latent pages (18,432 B, not a
    whole number of the copy loop's 512 x 16-byte passes), in pools of
    pd_seq / page pages; the hybrid and the SSM page none."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    F = chip_smoke.FAMILIES
    n = F.pd_seq // F.page
    assert chip_smoke.family_page_shapes(F) == {
        "granite-moe-1b-a400m": [(n, (16, 8, 64), "bfloat16")],
        "recurrentgemma-2b": [], "mamba2-780m": [],
        "codeqwen1.5-7b": [(n, (16, 32, 128), "bfloat16")],
        "phi4-mini-3.8b": [(n, (16, 8, 128), "bfloat16")],
        "stablelm-12b": [(n, (16, 8, 160), "bfloat16")],
        "deepseek-v3-671b": [(n, (16, 1, 576), "bfloat16")]}
    assert (16 * 576 * 2) % (512 * 16) != 0
    assert chip_smoke.page_key(n, (16, 1, 576), "bfloat16") == \
        "128 pages of 16x1x576 bfloat16"


def test_flash_shapes_hold_every_phase10_shape():
    """Phase 2 holds and times each prefill attention shape that phase
    10 launches at full width: FLASH_SHAPES lists them, keyed by the
    model's head layout and window (the attention-free SSM launches
    none; MLA's head dim is its (Dk, Dv) pair), and gemma-2b's main
    shape is the serving path's layout."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs.base import get_config

    shapes = chip_smoke.family_flash_shapes(chip_smoke.FAMILIES)
    assert sorted(shapes) == sorted(chip_smoke.FAMILIES.archs)
    for arch, want in shapes.items():
        assert bool(want) == (not get_config(arch).is_attention_free), arch
        assert set(want) <= set(chip_smoke.FLASH_SHAPES), arch
    assert chip_smoke.flash_layout(get_config("recurrentgemma-2b")) == \
        (10, 1, 256, 2048)
    assert chip_smoke.flash_layout(get_config("mamba2-780m")) is None
    assert chip_smoke.flash_layout(get_config("deepseek-v3-671b")) == \
        chip_smoke.MLA_LAYOUT == (128, 128, (192, 128), 0)
    assert chip_smoke.flash_key(chip_smoke.MLA_LAYOUT, "1x511") == \
        "H128/KVH128/D192v128 1x511"
    assert chip_smoke.flash_layout(get_config(chip_smoke.SERVE.arch)) == \
        chip_smoke.FLASH_MAIN[:4]
    assert chip_smoke.flash_key((10, 1, 256, 2048), "1x3000") == \
        "H10/KVH1/D256/W2048 1x3000"
    assert chip_smoke.causal_pairs(5, 0) == 15
    assert chip_smoke.causal_pairs(5, 2) == 1 + 2 * 4
    assert len(set(chip_smoke.FLASH_SHAPES)) == len(chip_smoke.FLASH_SHAPES)
