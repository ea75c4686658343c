"""The port's MLA family (deepseek-v3) held against the JAX package, on
the CPU.

`repro_torch.models.mla` (the queries, the latent, the expanded-form
forward through the flash kernel's plain version, the absorbed-form
decode against the latent cache), `collectives.
seqparallel_decode_attention(v_dims=)`, the multi-token-prediction head
and `reduced(deepseek-v3-671b)` in float32 (3 layers: one `mla` +
`dense_big`, two `mla` + `moe` with 4 experts top-2 and a shared one,
sigmoid + bias routing; d_model 64, 4 heads, q_lora 32, kv_lora 32,
qk_nope 16 + qk_rope 8, v_head 16; MTP depth 1) against
`repro.models.mla` and the reference's decoder, on the reference's own
parameters carried over by `convert.params_from_numpy`.

deepseek serves paged (every cache leaf is the sequence-indexed latent)
and unbucketed (MoE): its engine, `PDServer` (whose page round trip
moves the latent) and the CLI are held against the reference's.

Tolerances. Each MLA function and each block at 1e-4 of its output's
largest magnitude, the whole model (forward, MTP logits, prefill,
decode) at 1e-3, greedy tokens exact (the tolerances
`test_torch_model.py` measured); the absorbed decode after an expanded
prefill against an expanded `forward` over the whole sequence at 1e-4
of scale (both float32: they differ in association only, the latent
products taken before or after the attention)."""
import dataclasses
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import mla as jmla
from repro.models import transformer as jtrans
from repro.models.module import init_params as jinit
from repro.models.module import is_spec as jis_spec
from repro.models.registry import build_model as jbuild
from repro.obs import metrics as jmetrics
from repro.parallel import collectives as jcoll
from repro.serve import kvcache as jcache
from repro.serve import paged as jpaged
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.pd_disagg import PDServer as JPDServer
from repro_torch import device as tdevice
from repro_torch import tree
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy, tree_from_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import mla as tmla
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
ARCH = "deepseek-v3-671b"
BLOCK_REL = 1e-4
MODEL_REL = 1e-3
ABSORB_REL = 1e-4
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
def deepseek():
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


def _mla_params(seed=0, cfg_of=lambda c: c):
    jcfg = cfg_of(jreduced(jget_config(ARCH)))
    tcfg = cfg_of(reduced(get_config(ARCH)))
    jp = jinit(jmla.mla_spec(jcfg), jax.random.PRNGKey(seed), "float32")
    return jcfg, tcfg, jp, tree_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu")


def _positions(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()


# -- the mixer's parts ----------------------------------------------------------
@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_spec_matches_reference(size, q_lora):
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    if size == "reduced":
        jcfg, tcfg = jreduced(jcfg), reduced(tcfg)
    if not q_lora:                       # the w_q branch of the spec
        jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(
            jcfg.mla, q_lora_rank=0))
        tcfg = dataclasses.replace(tcfg, mla=dataclasses.replace(
            tcfg.mla, q_lora_rank=0))
    js = jax.tree.leaves(jmla.mla_spec(jcfg), is_leaf=jis_spec)
    ts = tree.leaves(tmla.mla_spec(tcfg), is_leaf=is_spec)
    assert [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in ts] == \
           [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in js]
    assert tmla.latent_dim(tcfg) == jmla.latent_dim(jcfg)
    js = jmla.mla_cache_spec(jcfg, 2, 9)
    ts = tmla.mla_cache_spec(tcfg, 2, 9)
    assert (ts.shape, ts.axes, ts.init, ts.dtype) == \
           (js.shape, js.axes, js.init, js.dtype)
    if size == "full":
        assert tmla.latent_dim(tcfg) == 576


@pytest.mark.parametrize("q_lora", [True, False])
def test_queries_latent_and_forward_match_reference(q_lora):
    """`_queries` (with and without the q-lora), `_latent` and the
    expanded `mla_forward` with its latent cache."""
    def cfg_of(c):
        return c if q_lora else dataclasses.replace(
            c, mla=dataclasses.replace(c.mla, q_lora_rank=0))
    jcfg, tcfg, jp, tp = _mla_params(1, cfg_of)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    pos = _positions(2, 11)
    for jf, tf in ((jmla._queries, tmla._queries),
                   (jmla._latent, tmla._latent)):
        for got, want in zip(tf(tp, _t(x), _t(pos), tcfg),
                             jf(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)):
            _near(got, want, BLOCK_REL)
    jy, jc = jmla.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                              return_cache=True)
    ty, tc = tmla.mla_forward(tp, _t(x), _t(pos), tcfg, return_cache=True)
    _near(ty, jy, BLOCK_REL)
    _near(tc, jc, BLOCK_REL)
    assert tc.shape == (2, 11, 1, tmla.latent_dim(tcfg))
    _near(tmla.mla_forward(tp, _t(x), _t(pos), tcfg),
          jmla.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg),
          BLOCK_REL)


def test_mla_decode_matches_reference():
    """Absorbed decode steps at per-request positions against the
    reference's, from a prefill's latent padded to 20 rows."""
    jcfg, tcfg, jp, tp = _mla_params(2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    _, jc = jmla.mla_forward(jp, jnp.asarray(x), jnp.asarray(_positions(2, 7)),
                             jcfg, return_cache=True)
    jc = jnp.pad(jc, ((0, 0), (0, 13), (0, 0), (0, 0)))
    tc = _t(jc)
    for step, pos in enumerate(([7, 7], [8, 8], [9, 12])):
        x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
        p = np.asarray(pos, np.int32)
        jy, jc = jmla.mla_decode(jp, jnp.asarray(x1), jc, jnp.asarray(p),
                                 jcfg)
        ty, tc = tmla.mla_decode(tp, _t(x1), tc, _t(p), tcfg)
        _near(ty, jy, BLOCK_REL)
        _near(tc, jc, BLOCK_REL)
    # a scalar position too
    jy, _ = jmla.mla_decode(jp, jnp.asarray(x1), jc, 13, jcfg)
    ty, _ = tmla.mla_decode(tp, _t(x1), tc, 13, tcfg)
    _near(ty, jy, BLOCK_REL)


@pytest.mark.parametrize("pos", [0, 5, 9])
def test_seqparallel_decode_attention_v_dims_matches_reference(pos):
    """MLA's absorbed mode of the local branch: the new latent written at
    pos, V = the cache's first v_dims columns, v_cache None."""
    rng = np.random.default_rng(pos)
    B, S, H, C, V = 2, 10, 4, 40, 32
    q = rng.standard_normal((B, 1, H, C)).astype(np.float32)
    cache = rng.standard_normal((B, S, 1, C)).astype(np.float32)
    new = rng.standard_normal((B, 1, C)).astype(np.float32)
    kw = dict(sm_scale=1 / math.sqrt(24), v_dims=V)
    jo, jk, jv = jcoll.seqparallel_decode_attention(
        jnp.asarray(q), jnp.asarray(cache), None, jnp.asarray(new), None,
        jnp.asarray(pos, jnp.int32), **kw)
    tcache = _t(cache)
    to, tk, tv = tcoll.seqparallel_decode_attention(
        _t(q), tcache, None, _t(new), None, torch.tensor(pos), **kw)
    assert jv is None and tv is None
    assert to.shape == (B, 1, H, V)
    _near(to, jo, 1e-6)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tk[:, pos, 0].numpy(), new[:, 0])
    # the caller's cache is left as it was
    assert np.array_equal(tcache.numpy(), cache)


def test_expanded_keys_are_materialised_and_take_the_tma_route(monkeypatch):
    """The expanded keys are a tensor of their own (no stride-0 head
    axis), so the prefill's q, k, v in bf16 are operands the TMA entry
    reads: `route` names `flash_attention`, never the generic entry. At
    TMA-readable head dims (nope 32 + rope 16, v 32); the reduced
    config's 24 are not a multiple of 16."""
    def cfg_of(c):
        return dataclasses.replace(c, dtype="bfloat16",
                                   mla=dataclasses.replace(
                                       c.mla, qk_nope_head_dim=32,
                                       qk_rope_head_dim=16, v_head_dim=32))
    tcfg = cfg_of(reduced(get_config(ARCH)))
    spec = tmla.mla_spec(tcfg)
    from repro_torch.models.module import init_params
    tp = init_params(spec, "bfloat16", device="cpu",
                     generator=torch.Generator().manual_seed(0))
    seen = []
    real = fa_ops.attention

    def attention(q, k, v, **kw):
        seen.append((fa_ops.route(q, k, v), tuple(q.shape), tuple(k.shape),
                     tuple(v.shape), k.stride(1), kw.get("sm_scale")))
        return real(q, k, v, **kw)
    monkeypatch.setattr(fa_ops, "attention", attention)
    x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    tmla.mla_forward(tp, x, torch.from_numpy(_positions(2, 9)), tcfg)
    assert seen == [("flash_attention", (2, 4, 9, 48), (2, 4, 9, 48),
                     (2, 4, 9, 32), 48, None)]


def test_mla_forward_sp_waits_for_slice_8():
    """`mla_forward_sp` runs on a mesh (`test_torch_seq_parallel.py`
    holds it on 8 gloo ranks, `test_torch_mesh_grads.py` its
    gradients): with no mesh, or an abstract one, there are no ranks to
    shard over, and an input that requires grad is no longer refused
    before the collectives (training through it came with ROADMAP slice
    8e)."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.parallel import sharding
    jcfg, tcfg, jp, tp = _mla_params()
    x = torch.zeros(1, 4, 64)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no DeviceMesh"):
        tmla.mla_forward_sp(tp, x, pos, tcfg)
    with sharding.use_mesh(abstract_mesh((1, 4), ("data", "model"))):
        with pytest.raises(RuntimeError, match="no DeviceMesh"):
            tmla.mla_forward_sp(tp, x.requires_grad_(), pos, tcfg)


# -- the decoder ----------------------------------------------------------------
def test_layer_plan_specs_and_cache_specs_match_reference(deepseek):
    jm, _, tm, _ = deepseek
    assert [(k.mix, k.ffn) for k in ttrans.layer_plan(tm.cfg)] == \
           [(k.mix, k.ffn) for k in jtrans.layer_plan(jm.cfg)] == \
           [("mla", "dense_big"), ("mla", "moe"), ("mla", "moe")]
    js = jax.tree.leaves(jm.param_specs(), is_leaf=jis_spec)
    ts = tree.leaves(tm.param_specs(), is_leaf=is_spec)
    assert [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in ts] == \
           [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in js]
    assert "mtp" in tm.param_specs()
    for seq in (4, 16, 20):
        js = jax.tree.leaves(jm.cache_specs(2, seq), is_leaf=jis_spec)
        ts = tree.leaves(tm.cache_specs(2, seq), is_leaf=is_spec)
        assert [(s.shape, s.axes, s.dtype) for s in ts] == \
               [(s.shape, s.axes, s.dtype) for s in js]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_each_block_matches_reference_on_its_input(deepseek, mode):
    """The mla + dense_big block and the mla + moe blocks, each fed the
    reference's own hidden state (and, in decode, its own latent)."""
    jm, jp, tm, tp = deepseek
    rng = np.random.default_rng(4)
    S = 13
    toks = rng.integers(0, 256, (2, S)).astype(np.int32)
    _, caches = jm.prefill(jp, jnp.asarray(toks))
    caches = jcache.pad_caches(caches, S, 20)
    if mode == "decode":
        toks = rng.integers(0, 256, (2, 1)).astype(np.int32)
        pos = np.asarray([S, S - 2], np.int32)
        positions = pos[:, None]
    else:
        pos, positions = None, _positions(2, S)
    x = np.array(jm._embed_in(jp, jnp.asarray(toks)))
    for gi, ((kinds, count), (tkinds, _)) in enumerate(
            zip(jm.groups, tm.groups)):
        for li in range(count):
            jpl = jax.tree.map(lambda a: a[li], jp["groups"][gi]["b0"])
            tpl = tree.map(lambda a: a[li], tp["groups"][gi]["b0"])
            jc = jax.tree.map(lambda a: a[li], caches[gi]["b0"]) \
                if mode == "decode" else None
            tc = tree.map(_t, jc) if jc is not None else None
            jy, jaux, jnc = jtrans.block_apply(
                jpl, jnp.asarray(x), jnp.asarray(positions), jm.cfg,
                kinds[0], mode=mode, cache=jc,
                pos=None if pos is None else jnp.asarray(pos))
            ty, taux, tnc = ttrans.block_apply(
                tpl, _t(x), _t(positions), tm.cfg, tkinds[0], mode=mode,
                cache=tc, pos=None if pos is None else _t(pos))
            _near(ty, jy, BLOCK_REL)
            _near(taux, jaux, BLOCK_REL)
            if mode == "train":
                assert tnc is None and jnc is None
            else:
                _leaves_near(tnc, jnc, BLOCK_REL)
            x = np.array(jy)


def test_forward_mtp_prefill_and_decode_match_reference(deepseek):
    """The whole model: `forward`'s logits, its MoE aux and its MTP
    logits; prefill with its latent caches, padded as each package pads
    them; decode steps at per-request positions; greedy tokens equal."""
    jm, jp, tm, tp = deepseek
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 13)).astype(np.int32)
    jl, je = jm.forward(jp, jnp.asarray(toks))
    tl, te = tm.forward(tp, _t(toks))
    _near(tl, jl, MODEL_REL)
    _near(te["moe_aux"], je["moe_aux"], MODEL_REL)
    assert te["mtp_logits"].shape == (2, 12, 256)
    _near(te["mtp_logits"], je["mtp_logits"], MODEL_REL)
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


def test_one_token_forward_where_the_reference_raises(deepseek):
    """`forward` of one token: the MTP block attends over no token. The
    reference's chunked attention divides by that length and raises; the
    port returns MTP logits of no row, and the trunk's logits equal the
    prefill's."""
    jm, jp, tm, tp = deepseek
    with pytest.raises(ZeroDivisionError):
        jm.forward(jp, jnp.asarray([[5]], jnp.int32))
    tl, te = tm.forward(tp, torch.tensor([[5]], dtype=torch.int32))
    assert te["mtp_logits"].shape == (1, 0, 256)
    jl, _ = jm.prefill(jp, jnp.asarray([[5]], jnp.int32))
    _near(tl, jl, MODEL_REL)


def test_absorbed_decode_agrees_with_the_expanded_forward(deepseek):
    """Decode in the absorbed form after an expanded prefill gives, at
    each new position, the logits an expanded `forward` over the whole
    sequence gives there: the same attention, the latent products taken
    before or after it."""
    _, _, tm, tp = deepseek
    rng = np.random.default_rng(8)
    seq = rng.integers(0, 256, (2, 16)).astype(np.int32)
    full, _ = tm.forward(tp, _t(seq))
    _, caches = tm.prefill(tp, _t(seq[:, :10]))
    caches = tcache.pad_caches(caches, 10, 24, tm.cache_specs(2, 24))
    for t in range(10, 16):
        lg, caches = tm.decode_step(tp, _t(seq[:, t:t + 1]), caches, t)
        _near(lg[:, 0], full[:, t].numpy(), ABSORB_REL)


# -- serving ----------------------------------------------------------------------
def _serve(engine_cls, model, params, prompts, new, **kw):
    eng = engine_cls(model, params, **kw)
    rids = [eng.submit(list(p), max_new_tokens=new) for p in prompts]
    res = eng.run_until_done()
    return eng, [res[r] for r in rids]


def _oracle(model, params, prompt, n_new):
    toks, out = list(prompt), []
    for _ in range(n_new):
        lg, _ = model.forward(params, torch.tensor([toks], dtype=torch.int32))
        out.append(int(torch.argmax(lg[0, -1])))
        toks.append(out[-1])
    return out


def test_paged_engine_matches_reference_engine(deepseek, registries):
    """deepseek's engine is paged at exact prompt lengths (pageable, not
    bucketable, as the reference decides): tokens equal to the JAX
    engine's and the cache-free oracle's at 1 to 20 tokens, the same
    `serve0/` and `pagepool0/` counters and ring DMA counters; every
    page back in the pool."""
    jm, jp, tm, tp = deepseek
    jreg, treg = registries
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).tolist() for n in (1, 5, 20, 12, 3)]
    je, jt = _serve(JEngine, jm, jp, prompts, 5, max_batch=2,
                    max_seq=MAX_SEQ, page_tokens=8)
    te, tt = _serve(TEngine, tm, tp, prompts, 5, max_batch=2,
                    max_seq=MAX_SEQ, page_tokens=8)
    assert te.paged and not te.bucketed
    assert tt == jt == [_oracle(tm, tp, p, 5) for p in prompts]
    assert te.prefill_compiles == je.prefill_compiles == 5
    for scope in ("serve0/", "pagepool0/"):
        assert {k: v for k, v in treg.snapshot().items()
                if k.startswith(scope)} == \
               {k: v for k, v in jreg.snapshot().items()
                if k.startswith(scope)} != {}
    assert (te.ring.dma_writes, te.ring.dma_reads) == \
           (je.ring.dma_writes, je.ring.dma_reads)
    assert len(te.pool._free) == te.pool.n_pages - 1
    je.close()
    te.close()


def _count_ingests(monkeypatch, kvcache_module, record):
    real = kvcache_module.PagedKVPool.ingest

    def ingest(self, alloc, kv, *a, **kw):
        record.append((tuple(kv.shape[1:]), len(alloc.logical_pages)))
        return real(self, alloc, kv, *a, **kw)
    monkeypatch.setattr(kvcache_module.PagedKVPool, "ingest", ingest)


def test_pdserver_serve_matches_reference_and_pages_the_latent(monkeypatch):
    """`PDServer` on 2 x 4 tokens: tokens equal to the reference's and the
    oracle's, stats equal; the page round trip moves the latent (one
    leaf a layer group, kv_lora + rope wide), every (layer, row) as 6
    pages of 8 tokens, as the reference's."""
    jm, jp, tm, tp = _both(1)
    prompts = np.asarray([[4, 8, 15, 16], [23, 42, 3, 7]], np.int32)
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
    assert ts.n_leaves == len(tm.groups) == 2
    assert trec == jrec == [((1, tmla.latent_dim(tm.cfg)), 6)] \
        * (tm.cfg.n_layers * 2)


def test_eligibility_matches_reference(deepseek):
    jm, _, tm, _ = deepseek
    assert (pageable(tm), bucketable(tm)) == \
           (jpaged.pageable(jm), jpaged.bucketable(jm)) == (True, False)


def test_bf16_params_cross_with_their_named_dtypes():
    """A bf16 deepseek's parameters from the reference, MTP head
    included: bf16 leaves bit for bit, the router and norm scales in
    float32, as their specs name."""
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
    assert tp["mtp"]["proj"].dtype == torch.bfloat16
    assert tp["mtp"]["block"]["mla"]["w_uk"].dtype == torch.bfloat16


@pytest.mark.parametrize("pd", [False, True])
def test_serve_cli_serves_deepseek_with_a_depth_cut(pd, capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--max-new", "4", "--layers", "2"]
    if pd:
        toks, stats = tlaunch.main(argv + ["--pd"])
        assert toks.shape == (3, 5) and stats.payload_bytes > 0
    else:
        res = tlaunch.main(argv)
        assert sorted(res) == [0, 1, 2] and all(len(v) == 4
                                                for v in res.values())
    assert "depth cut 3 -> 2 layers" in capsys.readouterr().out


def test_param_counts_equal_the_reference_at_full_size_and_at_the_cut():
    """61 layers: 682,636,480,256 parameters, as the reference counts;
    the card's cut to 4 layers (3 dense, 1 MoE) with the MTP head: the
    reference's count of the same cut."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert cfg.param_count() == jcfg.param_count() == 682_636_480_256
    assert cfg.active_param_count() == jcfg.active_param_count()
    cut = dataclasses.replace(cfg, n_layers=4)
    jcut = dataclasses.replace(jcfg, n_layers=4)
    assert cut.param_count() == jcut.param_count()
    assert 26.7e9 < cut.param_count() < 26.8e9


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
    """`chip_smoke.py`'s phase 10 for deepseek — the paged engine on the
    six prompts, every step held against the unpadded reference at the
    engine's batch, the router witness in bf16's stead in float32 (a CPU
    run has the memory); PDServer against the dense greedy decode,
    migrating the latent; the forward of 16 tokens whose last hidden row
    is prefill's to the bit, its last logits within the logit bound —
    at a toy size on the CPU with the reference's parameters: tokens
    equal the JAX engine's."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    jm, jp, tm, tp = _both(2)
    F = chip_smoke.FamilySizes(archs=(ARCH,), reduce=True, max_batch=4,
                               max_seq=MAX_SEQ, page=8,
                               prompts=(5, 9, 17, 30, 40), new=5,
                               pd_batch=2, pd_prompt=10, pd_steps=3,
                               pd_seq=32, reps=1, seed=0, mtp_len=16)
    out = chip_smoke.phase_family(torch, np, torch.device("cpu"), F, ARCH,
                                  np.random.default_rng(0), _Clock(),
                                  params=tp)
    assert out["launches"] == {} and out["peak_gib"] is None
    assert out["token_agreement"] == 1.0
    assert out["logit_rel_err"] <= chip_smoke.LOGIT_TOL["float32"]
    assert [len(p) for p in out["prompts"]] == [5, 9, 17, 30, 40]
    je, jt = _serve(JEngine, jm, jp, out["prompts"], F.new,
                    max_batch=F.max_batch, max_seq=F.max_seq,
                    page_tokens=F.page, device_ring=True)
    assert out["tokens"] == jt
    je.close()
    assert np.asarray(out["pd_tokens"]).shape == (2, 4)
    # the latent of 3 layers x 2 rows, 4 pages each; 40 values of 4 bytes
    # a layer a token
    assert out["pd_pages"] == 3 * 2 * 4
    assert out["pd_token_bytes"] == 3 * tmla.latent_dim(tm.cfg) * 4
    assert out["forward"]["mtp_shape"] == [1, 15, 256]
    assert out["forward"]["logit_rel_err"] <= chip_smoke.LOGIT_TOL["float32"]
    witness = out["batch_witness"]
    assert len(witness["rel_by_step"]) == F.new
    assert witness["layers"] == tm.cfg.n_layers
    assert witness["float32"]["flips_by_step"] == witness["flips_by_step"]
    assert witness["float32"]["rel_by_step"][1] \
        <= chip_smoke.LOGIT_TOL["float32"]
    # the latent leaf's pages, as phase 2 holds them
    assert out["page_shapes"] == [chip_smoke.page_key(
        4, (8, 1, tmla.latent_dim(tm.cfg)), tm.cfg.dtype)]
    assert chip_smoke.family_page_shapes(F)[ARCH] == \
        [(4, (8, 1, tmla.latent_dim(tm.cfg)), tm.cfg.dtype)]
    layout = chip_smoke.flash_layout(tm.cfg)
    assert layout == (4, 4, (24, 16), 0)
    assert chip_smoke.family_flash_shapes(F)[ARCH] == \
        [layout + (1, n) for n in (5, 9, 17, 30, 40)] \
        + [layout + (2, 10), layout + (1, 16), layout + (1, 15)]
