"""The port's MoE family held against the JAX package, on the CPU.

`repro_torch.models.moe` (the router of both kinds, the load-balance
aux, capacity and dispatch slots, the expert loop) against
`repro.models.moe` on seeded numpy inputs, and `reduced(granite-moe-1b-
a400m)` in float32 (2 layers, d_model 64, 4 query heads on 2 kv heads,
4 experts top-2 of width 32, SwiGLU, tied embeddings) against the
reference's decoder and engines on the reference's own
parameters carried over by `convert.params_from_numpy`.

Tolerances. The router's weights and aux at 1e-6 (float32 softmax or
sigmoid, a renormalisation and a mean: a few ulps of their ~0.1-1
values); its expert ids exactly, except where a row's two candidates
score within 1e-6 of each other — there XLA and ATen may order them
either way, and the test accepts either and counts such rows (none in
these seeds). Dispatch slots exactly (integer cumsums). The expert loop
and `moe_apply` at 1e-4 of the output's largest magnitude; each block at
1e-4 and the whole model at 1e-3, with greedy tokens exact: the
tolerances `test_torch_model.py` measured for the dense decoder, whose
float32 sums differ in order between XLA and ATen in the same way."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import moe as jmoe
from repro.models import transformer as jtrans
from repro.models.module import init_params as jinit
from repro.models.module import is_spec as jis_spec
from repro.models.registry import build_model as jbuild
from repro.obs import metrics as jmetrics
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.kvcache import pad_caches as jpad
from repro_torch import device as tdevice
from repro_torch import tree
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy, tree_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttrans
from repro_torch.models.module import is_spec
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as tmetrics
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.kvcache import pad_caches as tpad

ARCH = "granite-moe-1b-a400m"
ROUTE_TOL = 1e-6
BLOCK_REL = 1e-4
MODEL_REL = 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


@pytest.fixture(scope="module")
def granite():
    jm = jbuild(jreduced(jget_config(ARCH)))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(reduced(get_config(ARCH)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    return jm, jp, tm, tp


@pytest.fixture
def registries():
    jprev, tprev = jmetrics.get_registry(), tmetrics.get_registry()
    yield jmetrics.fresh_registry(), tmetrics.fresh_registry()
    jmetrics.set_registry(jprev)
    tmetrics.set_registry(tprev)


def _cfgs(kind: str):
    """(reference cfg, port cfg) of a router kind: granite's softmax, or
    deepseek's sigmoid + bias with a shared expert."""
    arch = ARCH if kind == "softmax" else "deepseek-v3-671b"
    return jreduced(jget_config(arch)), reduced(get_config(arch))


def _moe_params(jcfg, seed: int):
    """The reference's MoE parameters from `seed` (a random router bias
    where there is one), as jax arrays and as the port's tensors."""
    jp = jinit(jmoe.moe_spec(jcfg), jax.random.PRNGKey(seed), "float32")
    if "bias" in jp["router"]:
        jp["router"]["bias"] = jnp.asarray(np.random.default_rng(seed)
                                           .standard_normal(
            jp["router"]["bias"].shape).astype(np.float32) * 0.1)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


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


# -- specs ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["softmax", "sigmoid_bias"])
def test_moe_spec_matches_reference(kind):
    jcfg, tcfg = _cfgs(kind)
    js = jax.tree.leaves(jmoe.moe_spec(jcfg), is_leaf=jis_spec)
    ts = tree.leaves(tmoe.moe_spec(tcfg), is_leaf=is_spec)
    assert [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in ts] == \
           [(s.shape, s.axes, s.init, s.scale, s.dtype) for s in js]
    assert tmoe._router_type(tcfg) == jmoe._router_type(jcfg) == kind


# -- routing --------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["softmax", "sigmoid_bias"])
def test_route_matches_reference(kind, seed):
    """Weights within 1e-6 and ids equal, row by row; where ids differ,
    the two experts must score within 1e-6 in the reference (a near-tie
    either library may order either way), counted and printed."""
    jcfg, tcfg = _cfgs(kind)
    jp, tp = _moe_params(jcfg, seed)
    x = np.random.default_rng(seed).standard_normal(
        (3, 9, jcfg.d_model)).astype(np.float32)
    jw, jidx, jaux = jmoe.route(jp, jnp.asarray(x), jcfg)
    tw, tidx, taux = tmoe.route(tp, torch.from_numpy(x), tcfg)
    assert tidx.dtype == torch.int32 and tw.dtype == torch.float32
    jw, jidx = np.asarray(jw), np.asarray(jidx)
    tw, tidx = tw.numpy(), tidx.numpy()
    logits = x @ np.asarray(jp["router"]["w"])
    if kind == "softmax":
        score = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    else:
        score = np.asarray(jax.nn.sigmoid(jnp.asarray(logits))) \
            + np.asarray(jp["router"]["bias"])
    ties = 0
    for r in np.ndindex(jidx.shape[:-1]):
        if (jidx[r] == tidx[r]).all():
            np.testing.assert_allclose(tw[r], jw[r], rtol=0, atol=ROUTE_TOL)
            continue
        ties += 1
        for a, b in zip(jidx[r], tidx[r]):
            assert abs(score[r][a] - score[r][b]) <= ROUTE_TOL, (r, a, b)
    print(f"{kind} seed {seed}: {ties} rows with a near-tie ordered "
          "otherwise")
    assert abs(float(taux) - float(jaux)) <= ROUTE_TOL


@pytest.mark.parametrize("tokens,k,E,cf", [(1, 8, 32, 1.25), (7, 2, 4, 1.25),
                                          (4096, 8, 32, 1.25),
                                          (100, 2, 4, 1.0), (3, 1, 64, 2.0)])
def test_capacity_matches_reference(tokens, k, E, cf):
    jcfg = dataclasses.replace(
        jreduced(jget_config(ARCH)),
        moe=dataclasses.replace(jreduced(jget_config(ARCH)).moe, top_k=k,
                                n_experts=E, capacity_factor=cf))
    tcfg = dataclasses.replace(
        reduced(get_config(ARCH)),
        moe=dataclasses.replace(reduced(get_config(ARCH)).moe, top_k=k,
                                n_experts=E, capacity_factor=cf))
    assert tmoe._capacity(tokens, tcfg) == jmoe._capacity(tokens, jcfg)


@pytest.mark.parametrize("C", [4, 8, 64])
@pytest.mark.parametrize("E", [4, 8, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dispatch_indices_exact(seed, E, C):
    rng = np.random.default_rng(seed)
    A = 96
    idx = rng.integers(0, E, A).astype(np.int32)
    w = rng.random(A).astype(np.float32)
    jslot, jkeep = jmoe._dispatch_indices(jnp.asarray(idx), jnp.asarray(w),
                                          E, C)
    tslot, tkeep = tmoe._dispatch_indices(torch.from_numpy(idx),
                                          torch.from_numpy(w), E, C)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert tslot.dtype == torch.int32


# -- the expert FFNs ------------------------------------------------------------
def test_experts_ffn_matches_reference():
    rng = np.random.default_rng(5)
    E, C, D, F = 4, 6, 16, 8
    h, g, u = (rng.standard_normal(s).astype(np.float32)
               for s in ((E, C, D), (E, D, F), (E, D, F)))
    d = rng.standard_normal((E, F, D)).astype(np.float32)
    want = jmoe._experts_ffn(*map(jnp.asarray, (g, u, d, h)), "swiglu")
    got = tmoe._experts_ffn(*map(torch.from_numpy, (g, u, d, h)), "swiglu")
    _near(got, want, BLOCK_REL)


@pytest.mark.parametrize("kind", ["softmax", "sigmoid_bias"])
def test_moe_local_and_moe_apply_match_reference(kind):
    jcfg, tcfg = _cfgs(kind)
    jp, tp = _moe_params(jcfg, 7)
    x = np.random.default_rng(7).standard_normal(
        (2, 11, jcfg.d_model)).astype(np.float32)
    jw, jidx, _ = jmoe.route(jp, jnp.asarray(x), jcfg)
    want = jmoe._moe_local(jp, jnp.asarray(x), jw, jidx, jcfg)
    got = tmoe._moe_local(tp, torch.from_numpy(x),
                          torch.from_numpy(np.array(jw)),
                          torch.from_numpy(np.array(jidx)), tcfg)
    _near(got, want, BLOCK_REL)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    _near(ty, jy, BLOCK_REL)
    assert abs(float(taux) - float(jaux)) <= ROUTE_TOL


# -- the decoder ------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_each_block_matches_reference_on_its_input(granite, mode):
    jm, jp, tm, tp = granite
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (2, 13)).astype(np.int32)
    cfg, tcfg = jm.cfg, tm.cfg
    kind, tkind = jtrans.layer_plan(cfg)[0], ttrans.layer_plan(tcfg)[0]
    assert (tkind.mix, tkind.ffn) == (kind.mix, kind.ffn) == ("attn", "moe")
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
        jy, jaux, jnc = jtrans.block_apply(
            jpl, jnp.asarray(x), jnp.asarray(positions), cfg, kind,
            mode=mode, cache=jc, pos=None if pos is None else jnp.asarray(pos))
        ty, taux, tnc = ttrans.block_apply(
            tpl, torch.from_numpy(x), torch.from_numpy(positions), tcfg,
            tkind, mode=mode, cache=tc,
            pos=None if pos is None else torch.from_numpy(pos))
        _near(ty, jy, BLOCK_REL)
        assert float(jaux) > 0 and abs(float(taux) - float(jaux)) <= ROUTE_TOL
        if mode == "train":
            assert tnc is None and jnc is None
        else:
            _leaves_near(tnc, jnc, BLOCK_REL)
        x = np.array(jy)


def test_forward_prefill_and_decode_match_reference(granite):
    jm, jp, tm, tp = granite
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (2, 11)).astype(np.int32)
    jl, jx = jm.forward(jp, jnp.asarray(toks))
    tl, tx = tm.forward(tp, torch.from_numpy(toks))
    _near(tl, jl, MODEL_REL)
    assert abs(float(tx["moe_aux"]) - float(jx["moe_aux"])) <= \
        ROUTE_TOL * jm.cfg.n_layers and float(jx["moe_aux"]) > 0
    jl, jc = jm.prefill(jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks))
    _near(tl, jl, MODEL_REL)
    _leaves_near(tc, jc, MODEL_REL)
    jc = jpad(jc, 11, 16)
    tc = tpad(tc, 11, 16, tm.cache_specs(2, 16))
    _leaves_near(tc, jc, MODEL_REL)
    for step in range(3):
        nxt = rng.integers(0, 256, (2, 1)).astype(np.int32)
        pos = np.asarray([11 + step, 11 + step], np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(pos))
        _near(tl, jl, MODEL_REL)
        _leaves_near(tc, jc, MODEL_REL)


def _reference_generate(model, params, prompt, n_new, max_seq):
    logits, caches = model.prefill(params, jnp.asarray([prompt]))
    caches = jpad(caches, len(prompt), max_seq)
    out = [int(jnp.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        lg, caches = model.decode_step(params, jnp.asarray([[out[-1]]]),
                                       caches, jnp.int32(pos))
        out.append(int(jnp.argmax(lg[0, 0])))
        pos += 1
    return out


def _port_generate(model, params, prompt, n_new, max_seq):
    logits, caches = model.prefill(params, torch.tensor([prompt],
                                                        dtype=torch.int32))
    caches = tpad(caches, len(prompt), max_seq, model.cache_specs(1, max_seq))
    out = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        lg, caches = model.decode_step(
            params, torch.tensor([[out[-1]]], dtype=torch.int32), caches, pos)
        out.append(int(torch.argmax(lg[0, 0])))
        pos += 1
    return out


@pytest.mark.parametrize("prompt", [[5, 3, 9, 1], [7, 7, 2],
                                    [4, 8, 15, 16, 23, 42, 1, 2, 3]])
def test_greedy_tokens_equal_reference(granite, prompt):
    jm, jp, tm, tp = granite
    assert _port_generate(tm, tp, prompt, 6, 48) == \
        _reference_generate(jm, jp, prompt, 6, 48)


# -- serving ------------------------------------------------------------------
def _serve(engine_cls, model, params, prompts, new, **kw):
    eng = engine_cls(model, params, **kw)
    rids = [eng.submit(list(p), max_new_tokens=new) for p in prompts]
    res = eng.run_until_done()
    return eng, [res[r] for r in rids]


@pytest.mark.parametrize("paged", [True, False])
def test_engine_matches_reference_engine_and_counters(granite, registries,
                                                      paged):
    """granite serves paged and unbucketed (exact prompt lengths; MoE
    capacity would see bucket padding), or dense: the same tokens as the
    JAX engine and the trusted path, the same `serve0/` / `pagepool0/`
    counters (one prefill length per distinct prompt length) and ring
    DMA counters."""
    jm, jp, tm, tp = granite
    jreg, treg = registries
    prompts = [[5, 3, 9, 1], [7, 7, 2], [1, 2, 3, 4, 5, 6, 7, 8, 9],
               [9, 8, 7]]
    kw = dict(max_batch=2, max_seq=48, paged=paged, page_tokens=8)
    je, jt = _serve(JEngine, jm, jp, prompts, 5, **kw)
    te, tt = _serve(TEngine, tm, tp, prompts, 5, **kw)
    assert tt == jt == [_reference_generate(jm, jp, p, 5, 48)
                        for p in prompts]
    assert te.paged == je.paged == paged and not te.bucketed
    assert te.prefill_compiles == je.prefill_compiles == 3
    snap = {k: v for k, v in treg.snapshot().items()
            if k.startswith(("serve0/", "pagepool0/"))}
    assert snap == {k: v for k, v in jreg.snapshot().items()
                    if k.startswith(("serve0/", "pagepool0/"))} != {}
    assert (te.ring.dma_writes, te.ring.dma_reads) == \
           (je.ring.dma_writes, je.ring.dma_reads)
    je.close()
    te.close()
