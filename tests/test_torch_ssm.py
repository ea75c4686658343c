"""The port's Mamba-2 (SSD) family held against the JAX package, on the
CPU, and the faults of the reference's serving path on it.

`repro_torch.models.ssm` (the chunked SSD scan, the depthwise conv, the
block's forward and decode, the cache specs) and `reduced(mamba2-780m)`
in float32 (3 layers of `ssm` blocks, d_model 64, 16 heads of 8, d_state
16, one group, d_conv 4, chunk 16) against `repro.models.ssm` and the
reference's decoder, on the reference's own parameters carried over by
`convert.params_from_numpy`.

The faults: the reference's `ServeEngine` asserts on a prompt shorter
than the conv history (1 and 2 tokens), and its `pad_caches` pads every
cache leaf whose dim 2 equals the prompt length — the conv leaves at
d_conv - 1 = 3 tokens and the state leaf at n_heads = 16 — so its engine
then fails to install them. The port pads by the cache spec and
zero-pads a short conv history: the tests assert that the reference
raises at those lengths, that the port serves them with the greedy
tokens of a cache-free oracle (`forward` recomputed over prompt +
generated tokens at every step), and that it equals the reference where
the reference serves (5 and 12 tokens).

Tolerances. `ssd_chunked` at 1e-4 (the reference's own against its
token-by-token oracle, `tests/test_ssm_rglru.py:51`: the port's padded
fixed chunks and the reference's halved ones reassociate the same
float32 recurrence); the conv at 1e-6; each block at 1e-4 and the whole
model at 1e-3 of the output's largest magnitude, greedy tokens exact
(the tolerances `test_torch_model.py` measured)."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import ssm as jssm
from repro.models import transformer as jtrans
from repro.models.module import init_params as jinit
from repro.models.module import is_spec as jis_spec
from repro.models.registry import build_model as jbuild
from repro.obs import metrics as jmetrics
from repro.serve import kvcache as jcache
from repro.serve import paged as jpaged
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.pd_disagg import PDServer as JPDServer
from repro_torch import device as tdevice
from repro_torch import tree
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy, tree_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import module as tmodule
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttrans
from repro_torch.models.module import Spec, is_spec
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as tmetrics
from repro_torch.serve import kvcache as tcache
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.paged import bucketable, pageable
from repro_torch.serve.pd_disagg import PDServer as TPDServer

ROOT = Path(__file__).resolve().parent.parent
ARCH = "mamba2-780m"
SCAN_TOL = 1e-4
BLOCK_REL = 1e-4
MODEL_REL = 1e-3
MAX_SEQ = 48


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


def _both(seed=0):
    jm = jbuild(jreduced(jget_config(ARCH)))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(reduced(get_config(ARCH)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def mamba():
    return _both()


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


def _ssd_naive(xh, dt, A, Bm, Cm, Dp, h0=None):
    """Token-by-token discrete SSD recurrence (the reference tests'
    oracle, with an initial state)."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    state = np.zeros((B, H, N, P)) if h0 is None else h0.astype(np.float64)
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        a = np.exp(dt[:, t] * A)
        Bh = np.repeat(Bm[:, t], rep, axis=1)
        Ch = np.repeat(Cm[:, t], rep, axis=1)
        state = a[..., None, None] * state + \
            (dt[:, t, :, None] * Bh)[..., None] * xh[:, t, :, None, :]
        ys[:, t] = np.einsum("bhn,bhnp->bhp", Ch, state) \
            + Dp[None, :, None] * xh[:, t]
    return ys, state


def _ssd_inputs(S, G, seed=0, H=4, P=8, N=16, B=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((B, S, G, N)).astype(np.float32),
            rng.standard_normal((B, S, G, N)).astype(np.float32),
            rng.standard_normal((H,)).astype(np.float32))


# -- the scan ---------------------------------------------------------------------
@pytest.mark.parametrize("S", [32, 17, 31])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunked_matches_reference_and_oracle(chunk, G, S):
    """The port's padded fixed chunks against the reference's halved
    ones (at 17 and 31 the reference falls back to chunks of one token)
    and against the token-by-token recurrence, y and the final state."""
    args = _ssd_inputs(S, G)
    want_y, want_f = _ssd_naive(*args)
    jy, jf = jssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    ty, tf = tssm.ssd_chunked(*map(_t, args), chunk)
    for got, ref in ((ty, want_y), (tf, want_f), (ty, jy), (tf, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)
    assert ty.dtype == torch.float32 and tf.dtype == torch.float32


def test_ssd_chunked_carries_an_initial_state_and_keeps_the_dtype():
    args = _ssd_inputs(23, 2, seed=3)
    h0 = np.random.default_rng(4).standard_normal((2, 4, 16, 8)).astype(
        np.float32)
    want_y, want_f = _ssd_naive(*args, h0=h0)
    jy, jf = jssm.ssd_chunked(*map(jnp.asarray, args), 8,
                              h0=jnp.asarray(h0))
    ty, tf = tssm.ssd_chunked(*map(_t, args), 8, h0=_t(h0))
    for got, ref in ((ty, want_y), (tf, want_f), (ty, jy), (tf, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)
    # x in bf16: y comes back in bf16, the state in float32
    xb = _t(args[0]).to(torch.bfloat16)
    yb, fb = tssm.ssd_chunked(xb, *map(_t, args[1:]), 8)
    assert yb.dtype == torch.bfloat16 and fb.dtype == torch.float32


def test_pad_steps_add_nothing_to_the_state():
    """Chunks of 16 over 17 tokens pad 15 steps of x = B = C = dt = 0:
    the final state is the one of 17 tokens in one chunk, and so is y."""
    args = _ssd_inputs(17, 1, seed=5)
    y1, f1 = tssm.ssd_chunked(*map(_t, args), 16)
    y2, f2 = tssm.ssd_chunked(*map(_t, args), 17)
    torch.testing.assert_close(f1, f2, atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(y1, y2, atol=SCAN_TOL, rtol=SCAN_TOL)


def test_long_chunks_keep_the_decay_in_float32():
    """One chunk of 256 steps whose running log-decay reaches ~-5000:
    the decay between two positions is summed over the steps between
    them, so y holds the token-by-token oracle at 1e-4 where a
    difference of the two running sums would lose bits."""
    args = list(_ssd_inputs(256, 1, seed=6, B=1))
    args[1] = np.random.default_rng(7).uniform(
        1.0, 2.0, args[1].shape).astype(np.float32)
    args[2] = -np.random.default_rng(8).uniform(
        8.0, 16.0, args[2].shape).astype(np.float32)
    want_y, want_f = _ssd_naive(*args)
    ty, tf = tssm.ssd_chunked(*map(_t, args), 256)
    np.testing.assert_allclose(ty.numpy(), want_y, atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(tf.numpy(), want_f, atol=SCAN_TOL,
                               rtol=SCAN_TOL)


# -- the block's parts ----------------------------------------------------------
def _block_params(seed=0):
    cfg = jreduced(jget_config(ARCH))
    jp = jinit(jssm.mamba2_spec(cfg), jax.random.PRNGKey(seed), "float32")
    return cfg, reduced(get_config(ARCH)), jp, tree_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def test_specs_and_dims_match_reference():
    for size in ("reduced", "full"):
        jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
        if size == "reduced":
            jcfg, tcfg = jreduced(jcfg), reduced(tcfg)
        assert tssm.dims(tcfg) == jssm.dims(jcfg)
        js = jax.tree.leaves(jssm.mamba2_spec(jcfg), is_leaf=jis_spec)
        ts = tree.leaves(tssm.mamba2_spec(tcfg), is_leaf=is_spec)
        assert [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in ts] == \
               [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in js]
        js = jax.tree.leaves(jssm.mamba2_cache_spec(jcfg, 3),
                             is_leaf=jis_spec)
        ts = tree.leaves(tssm.mamba2_cache_spec(tcfg, 3), is_leaf=is_spec)
        assert [(s.shape, s.axes, s.init, s.dtype) for s in ts] == \
               [(s.shape, s.axes, s.init, s.dtype) for s in js]
    assert tssm.dims(get_config(ARCH)) == (3072, 48, 1, 128, 64)


def test_dconv_and_projections_match_reference():
    jcfg, tcfg, jp, tp = _block_params()
    x = np.random.default_rng(1).standard_normal((2, 9, 64)).astype(
        np.float32)
    for w, b in (("conv_x", "conv_x_b"), ("conv_B", "conv_B_b")):
        F_ = jp[w].shape[1]
        xi = np.random.default_rng(2).standard_normal((2, 9, F_)).astype(
            np.float32)
        _near(tssm._dconv(_t(xi), tp[w], tp[b] + 0.5),
              jssm._dconv(jnp.asarray(xi), jp[w], jp[b] + 0.5), 1e-6)
    for got, want in zip(tssm._proj_inputs(tp, _t(x), tcfg),
                         jssm._proj_inputs(jp, jnp.asarray(x), jcfg)):
        assert got.dtype == torch.float32
        _near(got, want, 1e-6)


@pytest.mark.parametrize("S", [1, 2, 3, 9, 40])
def test_mamba2_forward_and_decode_match_reference(S):
    """The block's forward with its cache, then three decode steps from
    that cache, against the reference's (at every S it serves; the
    reference's prefill asserts below the conv history, where the port's
    cache is checked against the zero-padded history instead)."""
    jcfg, tcfg, jp, tp = _block_params(1)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    ty, tc = tssm.mamba2_forward(tp, _t(x), tcfg, return_cache=True)
    _near(ty, jssm.mamba2_forward(jp, jnp.asarray(x), jcfg), BLOCK_REL)
    K = tcfg.ssm.d_conv
    if S >= K - 1:
        _, jc = jssm.mamba2_forward(jp, jnp.asarray(x), jcfg,
                                    return_cache=True)
        _leaves_near(tc, jc, BLOCK_REL)
    else:
        jc = {k: jnp.asarray(v.numpy()) for k, v in tc.items()}
        with pytest.raises(AssertionError, match="conv receptive field"):
            jssm.mamba2_forward(jp, jnp.asarray(x), jcfg, return_cache=True)
    for _ in range(3):
        x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jy, jc = jssm.mamba2_decode(jp, jnp.asarray(x1), jc, jcfg)
        ty, tc = tssm.mamba2_decode(tp, _t(x1), tc, tcfg)
        _near(ty, jy, BLOCK_REL)
        _leaves_near(tc, jc, BLOCK_REL)
    assert all(v.dtype == torch.float32 for v in tc.values())


def test_decode_continues_the_forward():
    """Decode from a prefill's cache gives the forward over the longer
    sequence, row for row (the O(1) step is the recurrence)."""
    _, tcfg, _, tp = _block_params(2)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 12, 64)).astype(np.float32))
    full = tssm.mamba2_forward(tp, x, tcfg)
    _, cache = tssm.mamba2_forward(tp, x[:, :8], tcfg, return_cache=True)
    for t in range(8, 12):
        y, cache = tssm.mamba2_decode(tp, x[:, t:t + 1], cache, tcfg)
        _near(y[:, 0], full[:, t].numpy(), BLOCK_REL)


def test_short_prompt_conv_history_is_zero_padded():
    """A prompt shorter than d_conv - 1 leaves d_conv - 1 rows of conv
    history, zeros first, the prompt's pre-conv rows last."""
    _, tcfg, _, tp = _block_params()
    x = torch.randn(1, 1, 64, generator=torch.Generator().manual_seed(0))
    _, cache = tssm.mamba2_forward(tp, x, tcfg, return_cache=True)
    K = tcfg.ssm.d_conv
    z, xc, Bm, Cm, _ = tssm._proj_inputs(tp, x, tcfg)
    for name, raw in (("conv_x", xc), ("conv_B", Bm), ("conv_C", Cm)):
        assert cache[name].shape[1] == K - 1
        assert not cache[name][:, :K - 2].any()
        assert torch.equal(cache[name][:, -1:], raw.float())


def test_a_log_initializer():
    """log U[1, 16] in float32 from the generator, seeded."""
    spec = Spec((5000,), ("ssm_heads",), init="a_log", dtype="float32")
    a = tmodule.init_params({"a": spec}, generator=torch.Generator()
                            .manual_seed(3), device="cpu")["a"]
    b = tmodule.init_params({"a": spec}, generator=torch.Generator()
                            .manual_seed(3), device="cpu")["a"]
    assert a.dtype == torch.float32 and torch.equal(a, b)
    u = torch.exp(a)
    assert float(u.min()) >= 1.0 and float(u.max()) <= 16.0
    assert abs(float(u.mean()) - 8.5) < 0.2
    with pytest.raises(ValueError, match="Generator"):
        tmodule.init_params({"a": spec}, device="cpu")


# -- the decoder ----------------------------------------------------------------
def test_layer_plan_and_cache_specs_match_reference(mamba):
    jm, _, tm, _ = mamba
    assert [(k.mix, k.ffn) for k in ttrans.layer_plan(tm.cfg)] == \
           [(k.mix, k.ffn) for k in jtrans.layer_plan(jm.cfg)] == \
           [("ssm", "none")] * 3
    for seq in (4, 16, 20):
        js = jax.tree.leaves(jm.cache_specs(2, seq), is_leaf=jis_spec)
        ts = tree.leaves(tm.cache_specs(2, seq), is_leaf=is_spec)
        assert [(s.shape, s.axes, s.dtype) for s in ts] == \
               [(s.shape, s.axes, s.dtype) for s in js]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_each_block_matches_reference_on_its_input(mamba, mode):
    """Each ssm block fed the reference's own hidden state (and, in
    decode, its own caches)."""
    jm, jp, tm, tp = mamba
    rng = np.random.default_rng(4)
    S = 13
    toks = rng.integers(0, 256, (2, S)).astype(np.int32)
    _, caches = jm.prefill(jp, jnp.asarray(toks))
    if mode == "decode":
        toks = rng.integers(0, 256, (2, 1)).astype(np.int32)
        pos = np.asarray([S, S], np.int32)
        positions = pos[:, None]
    else:
        pos, positions = None, np.broadcast_to(np.arange(S, dtype=np.int32),
                                               (2, S)).copy()
    x = np.array(jm._embed_in(jp, jnp.asarray(toks)))
    kind, tkind = jtrans.group_plan(jm.cfg)[0][0][0], \
        ttrans.group_plan(tm.cfg)[0][0][0]
    for li in range(jm.cfg.n_layers):
        jpl = jax.tree.map(lambda a: a[li], jp["groups"][0]["b0"])
        tpl = tree.map(lambda a: a[li], tp["groups"][0]["b0"])
        jc = jax.tree.map(lambda a: a[li], caches[0]["b0"]) \
            if mode == "decode" else None
        tc = tree.map(_t, jc) if jc is not None else None
        jy, _, jnc = jtrans.block_apply(
            jpl, jnp.asarray(x), jnp.asarray(positions), jm.cfg, kind,
            mode=mode, cache=jc, pos=None if pos is None else jnp.asarray(pos))
        ty, aux, tnc = ttrans.block_apply(
            tpl, _t(x), _t(positions), tm.cfg, tkind, mode=mode, cache=tc,
            pos=None if pos is None else _t(pos))
        _near(ty, jy, BLOCK_REL)
        assert float(aux) == 0.0
        if mode == "train":
            assert tnc is None and jnc is None
        else:
            _leaves_near(tnc, jnc, BLOCK_REL)
        x = np.array(jy)


def test_forward_prefill_and_decode_match_reference(mamba):
    """The whole model: forward, prefill with its caches, the caches
    padded as each package pads them (13 tokens: no leaf has dim 2 ==
    13, so the reference leaves them alone, as the port does), then
    decode steps; greedy tokens equal."""
    jm, jp, tm, tp = mamba
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 13)).astype(np.int32)
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    tl, _ = tm.forward(tp, _t(toks))
    _near(tl, jl, MODEL_REL)
    assert torch.equal(tl.argmax(-1), _t(np.asarray(jl).argmax(-1)))
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
        assert torch.equal(tl.argmax(-1), _t(np.asarray(jl).argmax(-1)))


# -- serving: the faults and their repair ---------------------------------------
def _oracle(model, params, prompt, n_new):
    """Greedy tokens with no cache: `forward` over prompt + generated
    tokens, recomputed at every step."""
    toks, out = list(prompt), []
    for _ in range(n_new):
        lg, _ = model.forward(params, torch.tensor([toks], dtype=torch.int32))
        out.append(int(torch.argmax(lg[0, -1])))
        toks.append(out[-1])
    return out


def _serve(engine_cls, model, params, prompts, new, **kw):
    eng = engine_cls(model, params, **kw)
    rids = [eng.submit(list(p), max_new_tokens=new) for p in prompts]
    res = eng.run_until_done()
    return eng, [res[r] for r in rids]


@pytest.mark.parametrize("n, fault", [
    (1, (AssertionError, "conv receptive field")),
    (2, (AssertionError, "conv receptive field")),
    (3, (ValueError, "Incompatible shapes")),
    (16, (ValueError, "Incompatible shapes"))])
def test_reference_engine_raises_where_the_port_serves_like_the_oracle(
        mamba, n, fault):
    """Prompts shorter than the conv history (the reference's prefill
    asserts), of d_conv - 1 tokens (its padding grows the conv leaves)
    and of n_heads tokens (it grows the state leaf): the reference's
    engine raises; the port's (dense: mamba2 is neither pageable nor
    bucketable) serves the cache-free oracle's greedy tokens."""
    jm, jp, tm, tp = mamba
    assert n in (1, 2, tm.cfg.ssm.d_conv - 1, tssm.dims(tm.cfg)[1])
    prompt = np.random.default_rng(n).integers(0, 256, n).tolist()
    with pytest.raises(fault[0], match=fault[1]):
        _serve(JEngine, jm, jp, [prompt], 4, max_batch=2, max_seq=MAX_SEQ)
    te, tt = _serve(TEngine, tm, tp, [prompt], 5, max_batch=2,
                    max_seq=MAX_SEQ)
    assert not te.paged and not te.bucketed
    assert tt == [_oracle(tm, tp, prompt, 5)]
    te.close()


def test_engine_matches_reference_engine_where_it_serves(mamba, registries):
    """Prompts of 5 and 12 tokens, which the reference serves: the same
    tokens as the JAX engine and the oracle, the same `serve0/` and ring
    DMA counters; four requests on two slots, so a slot's state leaves
    are installed over a finished request's."""
    jm, jp, tm, tp = mamba
    jreg, treg = registries
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 12, 12, 5)]
    je, jt = _serve(JEngine, jm, jp, prompts, 5, max_batch=2,
                    max_seq=MAX_SEQ)
    te, tt = _serve(TEngine, tm, tp, prompts, 5, max_batch=2,
                    max_seq=MAX_SEQ)
    assert tt == jt == [_oracle(tm, tp, p, 5) for p in prompts]
    assert te.prefill_compiles == je.prefill_compiles == 2
    assert {k: v for k, v in treg.snapshot().items()
            if k.startswith("serve0/")} == \
           {k: v for k, v in jreg.snapshot().items()
            if k.startswith("serve0/")} != {}
    assert (te.ring.dma_writes, te.ring.dma_reads) == \
           (je.ring.dma_writes, je.ring.dma_reads)
    je.close()
    te.close()


def test_state_padding_follows_the_spec():
    """Every mamba2 cache leaf is a state or conv leaf: the spec-driven
    padding passes each through, whatever its length."""
    tm = build_model(reduced(get_config(ARCH)))
    specs = tm.cache_specs(1, MAX_SEQ)
    caches = tree.map(lambda s: torch.randn(s.shape), tm.cache_specs(1, 3),
                      is_leaf=is_spec)
    for n in (1, 3, 16):
        got = tcache.pad_caches(caches, n, MAX_SEQ, specs)
        assert all(b is a for a, b in zip(tree.leaves(caches),
                                          tree.leaves(got)))


def _count_ingests(monkeypatch, kvcache_module, record):
    real = kvcache_module.PagedKVPool.ingest

    def ingest(self, alloc, kv, *a, **kw):
        record.append((tuple(kv.shape[1:]), len(alloc.logical_pages)))
        return real(self, alloc, kv, *a, **kw)
    monkeypatch.setattr(kvcache_module.PagedKVPool, "ingest", ingest)


def test_pdserver_serve_matches_reference_and_pages_nothing(mamba,
                                                            monkeypatch):
    """`PDServer` on 2 x 5 tokens: tokens equal to the reference's and
    to the port's dense greedy decode, transfer stats equal; mamba2's
    cache has no sequence leaf, so neither package pages anything."""
    jm, jp, tm, tp = mamba
    prompts = np.asarray([[4, 8, 15, 16, 5], [23, 42, 3, 7, 9]], np.int32)
    jrec, trec = [], []
    from repro.serve import kvcache as jkv_mod
    _count_ingests(monkeypatch, jkv_mod, jrec)
    _count_ingests(monkeypatch, tcache, trec)
    jt, js = JPDServer(jm, jp, max_seq=MAX_SEQ, page_tokens=8).serve(
        prompts, n_steps=5)
    tt, ts = TPDServer(tm, tp, max_seq=MAX_SEQ, page_tokens=8).serve(
        prompts, n_steps=5)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    for b, prompt in enumerate(prompts):
        assert tt[b].tolist() == _oracle(tm, tp, list(prompt), 6)
    assert (ts.n_leaves, ts.payload_bytes, ts.header_bytes) == \
           (js.n_leaves, js.payload_bytes, js.header_bytes)
    assert ts.n_leaves == 4 and jrec == trec == []


def test_eligibility_matches_reference(mamba):
    jm, _, tm, _ = mamba
    assert (pageable(tm), bucketable(tm)) == \
           (jpaged.pageable(jm), jpaged.bucketable(jm)) == (False, False)


def test_bf16_params_cross_with_their_named_dtypes():
    """A bf16 mamba2's parameters from the reference: the projections and
    convs in bf16, bit for bit; A_log, dt_bias, D and the norm scale in
    float32, as their specs name."""
    import dataclasses
    jm = jbuild(dataclasses.replace(jreduced(jget_config(ARCH)),
                                    dtype="bfloat16"))
    tm = build_model(dataclasses.replace(reduced(get_config(ARCH)),
                                         dtype="bfloat16"))
    arrays = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(arrays, "cpu", model=tm)
    specs = tree.leaves(tm.param_specs(), is_leaf=is_spec)
    for spec, a, t in zip(specs, jax.tree.leaves(arrays), tree.leaves(tp)):
        want = torch.float32 if spec.dtype == "float32" else torch.bfloat16
        assert t.dtype == want
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16) if want ==
            torch.bfloat16 else t.numpy(),
            a.view(np.uint16) if want == torch.bfloat16 else a)
    blk = tp["groups"][0]["b0"]["ssm"]
    assert blk["A_log"].dtype == torch.float32
    assert blk["in_x"].dtype == torch.bfloat16


@pytest.mark.parametrize("pd", [False, True])
def test_serve_cli_serves_mamba2_on_the_cpu(pd):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--max-new", "4"]
    if pd:
        toks, stats = tlaunch.main(argv + ["--pd"])
        assert toks.shape == (3, 5) and stats.payload_bytes > 0
    else:
        res = tlaunch.main(argv)
        assert sorted(res) == [0, 1, 2] and all(len(v) == 4
                                                for v in res.values())


def test_param_count_equals_the_reference_at_full_size():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert cfg.param_count() == jcfg.param_count() == \
        cfg.active_param_count() > 7e8


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


def test_chip_smoke_phase10_at_cpu_size():
    """`chip_smoke.py`'s phase 10 for mamba2 — the dense engine on the
    six prompts plus 2, d_conv - 1 and n_heads tokens (where the
    reference's serving path fails), every step held against the
    unpadded reference; PDServer against the dense greedy decode — at a
    toy size on the CPU with the reference's parameters: tokens equal
    the cache-free oracle's; no flash shape."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    _, _, tm, tp = _both(2)
    F = chip_smoke.FamilySizes(archs=(ARCH,), reduce=True, max_batch=4,
                               max_seq=MAX_SEQ, page=8,
                               prompts=(5, 9, 17, 30, 40), new=5,
                               pd_batch=2, pd_prompt=10, pd_steps=3,
                               pd_seq=32, reps=1, seed=0)
    out = chip_smoke.phase_family(torch, np, torch.device("cpu"), F, ARCH,
                                  np.random.default_rng(0), _Clock(),
                                  params=tp)
    assert out["launches"] == {} and out["peak_gib"] is None
    assert out["token_agreement"] == 1.0
    assert out["logit_rel_err"] <= chip_smoke.LOGIT_TOL["float32"]
    assert [len(p) for p in out["prompts"]] == [5, 9, 17, 30, 40, 2, 3, 16]
    assert out["tokens"] == [_oracle(tm, tp, p, 5) for p in out["prompts"]]
    assert np.asarray(out["pd_tokens"]).shape == (2, 4)
    assert out["pd_pages"] == 0 and out["forward"] is None
    # batch 1 against the engine's batch of 4 (no router), in float32 too
    witness = out["batch_witness"]
    assert "flips_by_step" not in witness
    assert len(witness["rel_by_step"]) == F.new
    assert len(witness["hidden_rel_by_layer_step1"]) == tm.cfg.n_layers
    assert witness["float32"]["rel_by_step"][1] \
        <= chip_smoke.LOGIT_TOL["float32"]
    assert out["page_shapes"] == [] \
        and chip_smoke.family_page_shapes(F)[ARCH] == []
    assert chip_smoke.family_flash_shapes(F)[ARCH] == []
