"""The port's disaggregated serving cluster held against the JAX package,
on the CPU.

`repro_torch.serve.router.Router` + `serve.pd_disagg.PrefillPod` + paged
`ServeEngine` decode pods on one `Fabric(pods=4)` against the same
cluster of `repro.serve` on `reduced(gemma-2b)` in float32 with the
reference's parameters carried over (`convert.params_from_numpy`): the
same tokens, the same `router0/`, `prefillpod<i>/`, `kvtransfer<i>/`,
`serve<i>/` and `fabric0/` registry counters, the same descriptor-fetch
DMAs and migrated pages, and a clean teardown — also across the seeded
decode-pod kill. `PDServer.serve` with `quantize_bits` 0 and 8 against
`repro.serve.pd_disagg.PDServer`, also with the reference's
`vectorized`, `staged` and `use_kernel` options; the migration
contract; the `--pd`
CLI; and `chip_smoke.py`'s phase 8 at a toy size."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import verbs as jverbs
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.registry import build_model as jbuild
from repro.obs import metrics as jmetrics
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.pd_disagg import PDServer as JPDServer
from repro.serve.pd_disagg import PrefillPod as JPod
from repro.serve.router import Router as JRouter
from repro_torch import device as tdevice
from repro_torch import verbs as tverbs
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.kvtransfer import KVTransferEngine as TKV
from repro_torch.launch import serve as tlaunch
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as tmetrics
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.pd_disagg import PDServer as TPDServer
from repro_torch.serve.pd_disagg import PrefillPod as TPod
from repro_torch.serve.router import Router as TRouter

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

PROMPTS = [[5, 3, 9, 1], [7, 7, 2], [1, 2, 3, 4, 5], [9, 8, 7],
           [4, 8, 15, 16], [23, 42, 3]]
SCOPES = ("router", "prefillpod", "kvtransfer", "serve", "pagepool",
          "fabric")


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
    """Fresh default registries in both packages, so every scope index
    (router0, prefillpod0/1, fabric0, ...) lines up across them, and the
    process-wide QP numbers (the fabric's `qp<n>` scopes) pinned alike."""
    jverbs.QueuePair._next_qp_num = tverbs.QueuePair._next_qp_num = 1 << 12
    jprev, tprev = jmetrics.get_registry(), tmetrics.get_registry()
    yield jmetrics.fresh_registry(), tmetrics.fresh_registry()
    jmetrics.set_registry(jprev)
    tmetrics.set_registry(tprev)


def _run(side, model, params, prompts, new, faults=None, **kw):
    V, E, P, R = side
    fabric, router, engines, pods = chip_smoke.build_cluster(
        V, E, P, R, model, params, faults=faults, **kw)
    d0 = sum(qp.desc_fetch_dmas for qp in fabric.qps.values())
    rids = [router.submit(p, max_new_tokens=new) for p in prompts]
    res = router.run_until_done()
    out = dict(tokens=[res[r] for r in rids],
               desc_dmas=sum(qp.desc_fetch_dmas
                             for qp in fabric.qps.values()) - d0,
               migrated=sum(p.kv.pages_migrated for p in pods),
               replays=sum(p.kv.transfers_replayed for p in pods),
               failovers=router.failovers,
               alive=[fabric.alive(g) for g in chip_smoke.DECODE_GIDS],
               compiles=[p.prefill_compiles for p in pods],
               drained=all(not e._finished for e in engines))
    router.close()
    out["clean"] = not fabric.qps and not fabric.routes \
        and not fabric._listeners
    return out


JSIDE = (jverbs, JEngine, JPod, JRouter)
TSIDE = (tverbs, TEngine, TPod, TRouter)


def _scoped(snapshot: dict) -> dict:
    return {k: v for k, v in snapshot.items() if k.startswith(SCOPES)}


def _oracle(model, params, prompts, new, engine_cls, **kw):
    eng = engine_cls(model, params, vectorized=False, **kw)
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    res = eng.run_until_done()
    eng.close()
    return [res[r] for r in rids]


def test_cluster_matches_reference_tokens_counters_and_teardown(
        gemma, registries):
    """`test_cluster_bit_exact_vs_single_pod` on both packages: the same
    tokens as the reference cluster and the single-pod oracle, the same
    registry counters, descriptor fetches and migrated pages, and
    `Router.close` leaves no QP, route or listener behind."""
    jm, jp, tm, tp = gemma
    jreg, treg = registries
    kw = dict(max_batch=2, max_seq=64, page=8)
    jo = _run(JSIDE, jm, jp, PROMPTS, 6, **kw)
    to = _run(TSIDE, tm, tp, PROMPTS, 6, **kw)
    counters = _scoped(treg.snapshot())
    assert counters == _scoped(jreg.snapshot())
    assert {"router0/requests_routed", "prefillpod0/prefill_compiles",
            "prefillpod1/requests_processed",
            "kvtransfer0/pages_migrated"} <= set(counters)
    assert to["tokens"] == jo["tokens"]
    assert to == jo
    assert to["migrated"] > 0 and to["failovers"] == 0
    assert to["clean"] and to["drained"]
    assert to["tokens"] == _oracle(tm, tp, PROMPTS, 6, TEngine, max_batch=2,
                                   max_seq=64, page_tokens=8)


def test_cluster_survives_decode_pod_kill_like_reference(gemma, registries):
    """`test_cluster_survives_decode_pod_kill`: FaultModel(seed=7) kills
    pod3 mid-run on both packages; the orphans re-route through the
    survivor with the same failovers and replays, and the tokens still
    equal the single-pod oracle's."""
    jm, jp, tm, tp = gemma
    jreg, treg = registries
    kw = dict(max_batch=2, max_seq=64, page=8)
    jf = jverbs.FaultModel(seed=7).kill_after("pod3/dev0", 2)
    tf = tverbs.FaultModel(seed=7).kill_after("pod3/dev0", 2)
    jo = _run(JSIDE, jm, jp, PROMPTS, 6, faults=jf, **kw)
    to = _run(TSIDE, tm, tp, PROMPTS, 6, faults=tf, **kw)
    assert _scoped(treg.snapshot()) == _scoped(jreg.snapshot())
    assert to == jo
    assert to["alive"] == [True, False] and tf.kills_triggered == 1
    assert to["failovers"] >= 1
    assert to["tokens"] == _oracle(tm, tp, PROMPTS, 6, TEngine, max_batch=2,
                                   max_seq=64, page_tokens=8)


def test_sweep_shape_keeps_desc_dmas_per_token_flat_like_reference(gemma):
    """`bench_serve_cluster.py`'s sweep shape (8 slots a decode pod,
    max_seq 64, pages of 8, its prompts, 4 tokens each) at 1 and 24
    sessions: the same tokens, descriptor fetches and prefill lengths as
    the reference; DMAs per token flat within the bench's 1.2x."""
    jm, jp, tm, tp = gemma
    kw = dict(max_batch=8, max_seq=64, page=8)
    rates = []
    for n in (1, 24):
        prompts = [chip_smoke.sweep_prompt(i) for i in range(n)]
        jo = _run(JSIDE, jm, jp, prompts, 4, **kw)
        to = _run(TSIDE, tm, tp, prompts, 4, **kw)
        assert to == jo
        rates.append(to["desc_dmas"] / (4 * n))
        assert max(to["compiles"]) <= 7
    assert rates[1] <= rates[0] * 1.2


def test_migration_contract_matches_reference(gemma):
    """`test_migrate_pages_one_fused_launch_per_leaf_run` on both
    packages: a 17-token prompt is 3 pages, one WQE chain (one doorbell,
    one descriptor fetch), one gather + one scatter fused launch per
    cache-leaf run, and the pages land equal to the reference's."""
    out = []
    for (V, E, P, _), m, p, reg in (
            (JSIDE, *gemma[:2], jmetrics),
            (TSIDE, *gemma[2:], tmetrics)):
        fabric = V.Fabric(pods=2)
        eng = E(m, p, max_batch=2, max_seq=64, fabric=fabric,
                gid="pod1/dev0", service="serve/pod1/dev0", page_tokens=8)
        pod = P(m, p, fabric=fabric, gid="pod0/dev0",
                decode_gids=["pod1/dev0"], max_seq=64, page_tokens=8)
        prompt = np.arange(1, 18, dtype=np.int32)
        _, caches = pod._run_prefill(prompt)
        assert pod.pool.pages_for(17) == 3
        src = pod.pool.alloc(3)
        pod.pool.fill(src, caches)
        lease = eng.reserve(0, 17, 4, 0)
        runs = [(mr, src, rkey, dst)
                for mr, (rkey, dst) in zip(pod.pool.mrs, lease)]
        l0 = reg.get_registry().snapshot().get("fused/launches", 0)
        d0, f0 = pod.kv.ep.qp.doorbell_writes, pod.kv.ep.qp.desc_fetch_dmas
        pod.kv.migrate_pages(runs)
        n = len(pod.pool.mrs)
        assert reg.get_registry().snapshot().get("fused/launches", 0) \
            - l0 == 2 * n
        assert pod.kv.ep.qp.doorbell_writes - d0 == 1
        assert pod.kv.ep.qp.desc_fetch_dmas - f0 == 1
        assert pod.kv.pages_migrated == 3 * n
        out.append([np.asarray(r.numpy() if isinstance(r, torch.Tensor)
                               else r)[np.asarray(lease[i][1])]
                    for i, r in enumerate(eng.pool.regions())])
        pod.close()
        eng.close()
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=1e-3,
                                   atol=1e-3 * np.abs(a).max())


@pytest.mark.parametrize("bits", [0, 8])
def test_pdserver_serve_matches_reference(gemma, bits):
    """`PDServer.serve` — prefill, one verbs SEND through a
    KVTransferEngine (int8 on the wire at 8 bits), the paged ingest
    round trip, greedy decode — token for token against the
    reference's, with the same transfer byte accounting; also on a
    shared fabric, which it leaves as it found it."""
    jm, jp, tm, tp = gemma
    prompts = np.random.default_rng(bits).integers(
        0, jm.cfg.vocab_size, (3, 8)).astype(np.int32)
    jt, js = JPDServer(jm, jp, max_seq=48, page_tokens=8,
                       quantize_bits=bits).serve(prompts, n_steps=6)
    tt, ts = TPDServer(tm, tp, max_seq=48, page_tokens=8,
                       quantize_bits=bits).serve(prompts, n_steps=6)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert (ts.n_leaves, ts.payload_bytes, ts.header_bytes) == \
           (js.n_leaves, js.payload_bytes, js.header_bytes)
    fabric = tverbs.Fabric(pods=2)
    st, _ = TPDServer(tm, tp, max_seq=48, page_tokens=8, quantize_bits=bits,
                      fabric=fabric).serve(prompts, n_steps=6)
    np.testing.assert_array_equal(st, tt)
    assert not fabric.qps and not fabric.routes and not fabric._listeners


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("vectorized", [True, False])
def test_pdserver_reference_options_match_reference(gemma, vectorized,
                                                    staged, monkeypatch):
    """`PDServer(vectorized=)` and `serve(staged=)`, the reference's
    options with its defaults: tokens and transfer stats equal to the
    reference's in each combination, the staged baseline taken exactly
    when asked for, and the scalar oracle's fabric built when
    `vectorized` is False."""
    jm, jp, tm, tp = gemma
    prompts = np.random.default_rng(3).integers(
        0, jm.cfg.vocab_size, (2, 8)).astype(np.int32)
    jt, js = JPDServer(jm, jp, max_seq=48, page_tokens=8,
                       vectorized=vectorized).serve(prompts, n_steps=4,
                                                    staged=staged)
    calls, fabrics = [], []
    real_staged = TKV.transfer_staged
    real_init = TKV.__init__

    def spy_staged(self, caches):
        calls.append(self.fabric.vectorized)
        return real_staged(self, caches)

    def spy_init(self, *a, **kw):
        real_init(self, *a, **kw)
        fabrics.append(self.fabric.vectorized)
    monkeypatch.setattr(TKV, "transfer_staged", spy_staged)
    monkeypatch.setattr(TKV, "__init__", spy_init)
    tt, ts = TPDServer(tm, tp, max_seq=48, page_tokens=8,
                       vectorized=vectorized).serve(prompts, n_steps=4,
                                                    staged=staged)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert (ts.n_leaves, ts.payload_bytes, ts.header_bytes) == \
           (js.n_leaves, js.payload_bytes, js.header_bytes)
    assert calls == ([vectorized] if staged else [])
    assert fabrics == [vectorized]


def test_pdserver_takes_the_reference_examples_call(gemma):
    """`examples/serve_pd_disaggregated.py`'s call,
    `serve(prompts, n_steps=8, use_kernel=True)`: accepted (the device
    picks the route, so the flag changes nothing) and equal to the
    reference's tokens and stats, and to the call without the flag."""
    jm, jp, tm, tp = gemma
    prompts = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (4, 8)).astype(np.int32)
    jt, js = JPDServer(jm, jp, max_seq=48, page_tokens=8).serve(
        prompts, n_steps=8, use_kernel=True)
    server = TPDServer(tm, tp, max_seq=48, page_tokens=8)
    tt, ts = server.serve(prompts, n_steps=8, use_kernel=True)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert (ts.n_leaves, ts.payload_bytes, ts.header_bytes) == \
           (js.n_leaves, js.payload_bytes, js.header_bytes)
    np.testing.assert_array_equal(server.serve(prompts, n_steps=8)[0], tt)


@pytest.mark.parametrize("quantize", [False, True])
def test_pd_cli_on_the_cpu(quantize):
    argv = ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--pd",
            "--requests", "2", "--max-new", "3"]
    toks, stats = tlaunch.main(argv + (["--quantize-kv"] if quantize
                                       else []))
    assert toks.shape == (2, 4)
    assert stats.payload_bytes > 0 and stats.header_bytes == 128


def test_chip_smoke_phase8_at_cpu_size_matches_reference(gemma):
    """`chip_smoke.py`'s phase 8 — (a) the cluster against the oracle,
    (b) through a decode-pod kill, (c) the sweep, (d) the migration
    contract, (e) PDServer against the unpaged greedy decode — at a toy
    size on the CPU with a stand-in timer, and its tokens against the
    reference cluster and PDServer on the same parameters and prompts."""
    class Clock:
        def sync(self):
            pass

    jm, jp, tm, tp = gemma
    C = chip_smoke.ClusterSizes(
        arch="gemma-2b", reduce=True, max_batch=2, max_seq=64, page=8,
        prompts=(5, 30, 17, 3, 9, 12, 7, 20), new=6, sweep_batch=2,
        sweep_seq=64, sweep_page=8, sessions=(1, 8, 12), sweep_new=4,
        pd_batch=2, pd_prompt=16, pd_steps=6, pd_seq=48)
    out = chip_smoke.phase_cluster(torch, np, torch.device("cpu"), C,
                                   np.random.default_rng(0), Clock(),
                                   params=tp)
    assert out["launches"] == {} and out["peak_gib"] is None
    assert out["diffs"] == {"a": [], "b": []}
    assert out["worst_rel"]["a"] <= chip_smoke.LOGIT_TOL["float32"]
    n = len(C.prompts)
    assert [out["tokens_a"][i] for i in range(n)] == \
        [out["oracle"][i] for i in range(n)] == \
        [out["tokens_b"][i] for i in range(n)]
    assert out["info"]["b"]["failovers"] >= 1
    kw = dict(max_batch=C.max_batch, max_seq=C.max_seq, page=C.page)
    ref = _run(JSIDE, jm, jp, out["prompts"], C.new, **kw)
    assert ref["tokens"] == [out["tokens_a"][i] for i in range(n)]
    for row in out["sweep"]:
        prompts = [chip_smoke.sweep_prompt(i) for i in range(row["sessions"])]
        ref = _run(JSIDE, jm, jp, prompts, C.sweep_new,
                   max_batch=C.sweep_batch, max_seq=C.sweep_seq,
                   page=C.sweep_page)
        assert row["tokens_out"] == ref["tokens"]
        assert row["desc_dmas_per_token"] == ref["desc_dmas"] / (
            row["sessions"] * C.sweep_new)
    assert out["migration"]["doorbells"] == out["migration"]["desc_dmas"] \
        == 1
    for bits in (0, 8):
        jt, _ = JPDServer(jm, jp, max_seq=C.pd_seq, page_tokens=C.page,
                          quantize_bits=bits).serve(out["pd_prompts"],
                                                    n_steps=C.pd_steps)
        assert out["pd"][bits]["tokens"] == np.asarray(jt).tolist()


def test_migration_past_the_send_queue_posts_in_chains_where_reference_fails(
        gemma):
    """A 599-token prompt in pages of 4 tokens is 150 pages a leaf: 300
    RDMA_WRITEs, more than the 256 a send queue holds. The port posts
    them as two chains (two doorbells, two descriptor fetches) and the
    pages land; the reference posts them whole, is refused ("send queue
    full"), takes that for a dead peer and gives up after its replays
    (ROADMAP Queue 3)."""
    prompt = (np.arange(1, 600) % 200).astype(np.int32)
    for (V, E, P, _), m, p in ((JSIDE, *gemma[:2]), (TSIDE, *gemma[2:])):
        fabric = V.Fabric(pods=2)
        eng = E(m, p, max_batch=1, max_seq=1024, fabric=fabric,
                gid="pod1/dev0", service="serve/pod1/dev0", page_tokens=4)
        pod = P(m, p, fabric=fabric, gid="pod0/dev0",
                decode_gids=["pod1/dev0"], max_seq=1024, page_tokens=4)
        _, caches = pod._run_prefill(prompt)
        k = pod.pool.pages_for(prompt.size)
        assert k == 150 and 2 * k > pod.kv.ep.qp.max_send_wr
        src = pod.pool.alloc(k)
        pod.pool.fill(src, caches)
        lease = eng.reserve(0, int(prompt.size), 4, 0)
        runs = [(mr, src, rkey, dst)
                for mr, (rkey, dst) in zip(pod.pool.mrs, lease)]
        if V is jverbs:
            with pytest.raises(jverbs.QPStateError, match="replays"):
                pod.kv.migrate_pages(runs)
            continue
        d0 = pod.kv.ep.qp.doorbell_writes
        assert pod.kv.migrate_pages(runs) == "pod1/dev0"
        assert pod.kv.ep.qp.doorbell_writes - d0 == 2
        assert pod.kv.transfers_replayed == 0
        for i, (s, d) in enumerate(zip(pod.pool.regions(),
                                       eng.pool.regions())):
            assert torch.equal(s[torch.from_numpy(src)],
                               d[torch.from_numpy(lease[i][1])])
        pod.close()
        eng.close()
