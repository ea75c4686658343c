"""The port's serving engine held against the JAX package, on the CPU.

`repro_torch.serve.engine.ServeEngine` (paged and dense, bucketed
prefill, the inline-SEND submit path, the SRQ watermark, the device
recv ring with the fused poll, retirement, reserve / activate) against
`repro.serve.engine.ServeEngine` on `reduced(gemma-2b)` in float32 with
the reference's own parameters carried over: the same tokens, token for
token, on the seeded prompts of `tests/test_serve.py` and
`tests/test_serve_cluster.py`; the same `serve0/` and `pagepool0/`
registry counters and ring DMA counters; pool MR contents equal outside
the null page at the model-level tolerance of `test_torch_model.py`
(1e-3 of their largest magnitude); and `chip_smoke.py`'s phase 6 at a
toy size."""
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
from repro.core.descriptors import OP_KV_ACTIVATE as J_ACTIVATE
from repro.core.descriptors import make_descriptor as jdesc
from repro.models.registry import build_model as jbuild
from repro.obs import metrics as jmetrics
from repro.serve import paged as jpaged
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.kvcache import pad_caches as jpad
from repro_torch import device as tdevice
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.descriptors import OP_KV_ACTIVATE, make_descriptor
from repro_torch.launch import serve as tlaunch
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as tmetrics
from repro_torch.serve import paged as tpaged
from repro_torch.serve.engine import ServeEngine as TEngine

ROOT = Path(__file__).resolve().parent.parent
MODEL_REL = 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


@pytest.fixture(scope="module")
def gemma():
    jm = jbuild(jreduced(jget_config("gemma-2b")))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(reduced(get_config("gemma-2b")))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    return jm, jp, tm, tp


@pytest.fixture
def registries():
    """Fresh default registries in both packages, so engine and pool
    scopes are `serve0/` and `pagepool0/` on both sides."""
    jprev, tprev = jmetrics.get_registry(), tmetrics.get_registry()
    yield jmetrics.fresh_registry(), tmetrics.fresh_registry()
    jmetrics.set_registry(jprev)
    tmetrics.set_registry(tprev)


def _reference_generate(model, params, prompt, n_new, max_seq):
    """Greedy generation through prefill+decode (the reference's trusted
    path, `tests/test_serve.py::_reference_generate`)."""
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


def _serve(engine_cls, model, params, prompts, new, **kw):
    eng = engine_cls(model, params, **kw)
    rids = [eng.submit(list(p), max_new_tokens=new) for p in prompts]
    res = eng.run_until_done()
    return eng, [res[r] for r in rids]


def _scoped(snapshot: dict, prefixes=("serve0/", "pagepool0/")) -> dict:
    return {k: v for k, v in snapshot.items() if k.startswith(prefixes)}


def test_bucketing_and_eligibility_match_reference(gemma):
    for n in (1, 2, 3, 5, 8, 9, 33, 64, 100):
        assert tpaged.bucket_len(n, 64) == jpaged.bucket_len(n, 64)
    with pytest.raises(ValueError):
        tpaged.bucket_len(0, 64)
    for arch in ("gemma-2b", "granite-moe-1b-a400m"):
        jm = jbuild(jreduced(jget_config(arch)))
        tm = build_model(reduced(get_config(arch)))
        assert (tpaged.pageable(tm), tpaged.bucketable(tm)) == \
               (jpaged.pageable(jm), jpaged.bucketable(jm))
    moe = build_model(reduced(get_config("granite-moe-1b-a400m")))
    assert tpaged.pageable(moe) and not tpaged.bucketable(moe)


@pytest.mark.parametrize("paged", [True, False])
def test_engine_matches_reference_engine_and_counters(gemma, registries,
                                                      paged):
    """`test_serve_engine_matches_reference`'s prompts: the same tokens
    as the JAX engine and its trusted path, the same registry counters
    and the same ring DMA counters."""
    jm, jp, tm, tp = gemma
    jreg, treg = registries
    prompts = [[5, 3, 9, 1], [7, 7, 2]]
    kw = dict(max_batch=2, max_seq=48, paged=paged)
    je, jt = _serve(JEngine, jm, jp, prompts, 6, **kw)
    te, tt = _serve(TEngine, tm, tp, prompts, 6, **kw)
    assert tt == jt
    assert tt == [_reference_generate(jm, jp, p, 6, 48) for p in prompts]
    assert te.paged == je.paged == paged and te.bucketed == je.bucketed
    assert _scoped(treg.snapshot()) == _scoped(jreg.snapshot()) != {}
    assert (te.ring.dma_writes, te.ring.dma_reads) == \
           (je.ring.dma_writes, je.ring.dma_reads)
    assert te.prefill_compiles == je.prefill_compiles
    je.close()
    te.close()


def test_paged_and_dense_match_reference_and_pool_contents(gemma):
    """`test_paged_matches_dense_and_reference`'s prompts, paged and
    dense; the page MRs hold what the reference's hold, the null page
    aside (the port never writes it back)."""
    jm, jp, tm, tp = gemma
    prompts = [[5, 3, 9, 1], [7, 7, 2], [1, 2, 3, 4, 5, 6, 7, 8, 9]]
    exp = [_reference_generate(jm, jp, p, 6, 64) for p in prompts]
    je, jt = _serve(JEngine, jm, jp, prompts, 6, max_batch=2, max_seq=64,
                    paged=True, page_tokens=8)
    tp_, tp_toks = _serve(TEngine, tm, tp, prompts, 6, max_batch=2,
                          max_seq=64, paged=True, page_tokens=8)
    td, td_toks = _serve(TEngine, tm, tp, prompts, 6, max_batch=2,
                         max_seq=64, paged=False)
    assert tp_toks == td_toks == jt == exp
    assert len(tp_.pool.mrs) == len(je.pool.mrs) == 2      # k and v
    for tmr, jmr in zip(tp_.pool.mrs, je.pool.mrs):
        got = tp_.pool.pd.mr_array(tmr)
        want = np.asarray(je.pool.pd.mr_array(jmr))
        assert tuple(got.shape) == want.shape
        assert not got[0].any()                 # never written
        g, w = got[1:].numpy(), want[1:]
        np.testing.assert_allclose(g, w, rtol=MODEL_REL,
                                   atol=MODEL_REL * np.abs(w).max())
    for e in (je, tp_, td):
        e.close()


def test_bucketed_prefill_matches_reference(gemma):
    """`test_bucketed_prefill_compile_count`: 11 prompt lengths, the
    same tokens as the JAX engine (which that test holds to the unpadded
    trusted path) and the same count of distinct padded lengths."""
    jm, jp, tm, tp = gemma
    prompts = [list(range(1, n + 1)) for n in range(1, 12)]
    kw = dict(max_batch=2, max_seq=64, page_tokens=8)
    je, jt = _serve(JEngine, jm, jp, prompts, 2, **kw)
    te, tt = _serve(TEngine, tm, tp, prompts, 2, **kw)
    assert te.bucketed and tt == jt
    assert te.prefill_compiles == je.prefill_compiles
    assert te.prefill_compiles <= math.ceil(math.log2(64)) + 1
    je.close()
    te.close()


def test_burst_of_five_on_two_slots_completes_like_reference(gemma):
    jm, jp, tm, tp = gemma
    prompts = [[1 + i, 2, 3] for i in range(5)]
    je, jt = _serve(JEngine, jm, jp, prompts, 4, max_batch=2, max_seq=48)
    te, tt = _serve(TEngine, tm, tp, prompts, 4, max_batch=2, max_seq=48)
    assert all(len(t) == 4 for t in tt) and tt == jt
    assert te.srq_refills == je.srq_refills
    je.close()
    te.close()


def test_engine_dicts_bounded_and_pages_returned(gemma):
    _, _, tm, tp = gemma
    eng = TEngine(tm, tp, max_batch=2, max_seq=64, page_tokens=8)
    for wave in range(3):
        rids = [eng.submit([1 + wave, 2, 3 + i], max_new_tokens=3)
                for i in range(4)]
        res = eng.run_until_done()
        assert all(len(res[r]) == 3 for r in rids)
        assert not eng.requests and not eng.pinned_prompts
    assert len(eng.pool._free) == eng.pool.n_pages - 1   # all but null
    assert (eng.pool.table == 0).all()
    assert eng.pool.pages_allocated == eng.pool.pages_freed > 0
    fabric = eng.fabric
    eng.close()
    assert not eng._finished
    assert not fabric.qps and not fabric._listeners


def test_reserve_and_activate_match_reference(gemma):
    """The decode-pod side of a disaggregated admit: reserve pages, land
    the prefill caches in them, go live on an OP_KV_ACTIVATE descriptor
    — the same tokens as the reference engine doing the same."""
    jm, jp, tm, tp = gemma
    prompt = np.arange(1, 18, dtype=np.int32)       # 17 tokens, 3 pages
    out = []
    for eng_cls, model, params, tensor, op, desc in (
            (JEngine, jm, jp, lambda a: jnp.asarray(a), J_ACTIVATE, jdesc),
            (TEngine, tm, tp, lambda a: torch.from_numpy(a), OP_KV_ACTIVATE,
             make_descriptor)):
        eng = eng_cls(model, params, max_batch=2, max_seq=64, page_tokens=8)
        logits, caches = model.prefill(params, tensor(prompt[None]))
        first = int(np.argmax(np.asarray(logits[0, -1])))
        lease = eng.reserve(7, prompt.size, 4, first)
        assert len(lease) == len(eng.pool.mrs)
        eng.pool.fill(lease[0][1], caches)
        eng._post_descriptor(desc(op, src=7))
        out.append(eng.run_until_done()[7])
        eng.close()
    assert out[1] == out[0] == _reference_generate(jm, jp, list(prompt), 4,
                                                   64)


def test_chip_smoke_phase6_at_cpu_size_matches_reference_engine(gemma):
    """`chip_smoke.py`'s phase 6 — paged, bucketed engine on a device
    recv ring with the fused poll, six requests on four slots, checked
    there against the port's unpaged reference — at a toy size on the
    CPU with a stand-in timer, and its tokens against the JAX engine's
    on the same parameters and prompts."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    class Clock:                        # no card: nothing to time
        def sync(self):
            pass

        def wall(self, fn):
            fn()
            return 0.0

        def span(self, fn, spans):
            return fn()

        def spans_ms(self, spans):
            return 0.0

    jm, jp, tm, tp = gemma
    Z = chip_smoke.ServeSizes(arch="gemma-2b", reduce=True, max_batch=4,
                              max_seq=64, page=8,
                              prompts=(3, 5, 9, 17, 30, 40), new=6, reps=1,
                              seed=0)
    out = chip_smoke.phase_serve(torch, np, torch.device("cpu"), Z,
                                 np.random.default_rng(0), Clock(),
                                 params=tp)
    assert out["launches"] == {} and out["peak_gib"] is None
    assert out["token_agreement"] == 1.0
    assert out["logit_rel_err"] <= chip_smoke.LOGIT_TOL["float32"]
    je, jt = _serve(JEngine, jm, jp, out["prompts"], Z.new,
                    max_batch=Z.max_batch, max_seq=Z.max_seq,
                    page_tokens=Z.page, device_ring=True)
    assert out["tokens"] == jt
    je.close()


def test_serve_cli_on_the_cpu():
    res = tlaunch.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                        "--requests", "3", "--max-new", "4"])
    assert sorted(res) == [0, 1, 2] and all(len(v) == 4 for v in res.values())
    toks, stats = tlaunch.main(["--reduced", "--device", "cpu", "--pd",
                                "--requests", "2", "--max-new", "3"])
    assert toks.shape == (2, 4) and stats.payload_bytes > 0
