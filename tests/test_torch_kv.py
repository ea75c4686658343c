"""The torch port's KV-cache transfer leg held against the JAX package.

On the CPU the port's kv_ingest wrapper takes its plain version; these
tests hold it against the reference's Pallas kernel in interpret mode
and its `ref.py`, then the T2 path above it (`rx_engine`, `PagedKVPool`,
`pad_caches`, the shadow table), the model's cache specs, the T1 int8
codec, and the whole leg — `KVTransferEngine` transfer, transfer_many,
page migration and failover over a `Fabric` — against
`repro.core.kvtransfer` on the same seeded numpy caches. Tolerance is
exact throughout: this path moves data, and the int8 codec is compared
bit for bit with the reference's own output."""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import verbs as jverbs
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import kvtransfer as jkv
from repro.core import rx_engine as jrx
from repro.core import shadow as jshadow
from repro.core import tx_engine as jtx
from repro.core.descriptors import TransferPlan as JPlan
from repro.kernels.kv_ingest import ref as jref
from repro.kernels.kv_ingest.kv_ingest import kv_ingest as pallas_ingest
from repro.models.module import is_spec as jis_spec
from repro.models.registry import build_model as jbuild
from repro.obs import metrics as jmetrics
from repro.serve import kvcache as jcache
from repro.serve.pd_disagg import PDServer
from repro_torch import device as tdevice
from repro_torch import tree as ttree
from repro_torch import verbs as tverbs
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.core import kvtransfer as tkv
from repro_torch.core import rx_engine as trx
from repro_torch.core import shadow as tshadow
from repro_torch.core import tx_engine as ttx
from repro_torch.core.descriptors import TransferPlan
from repro_torch.kernels import _build
from repro_torch.kernels.kv_ingest import ops as kv_ops
from repro_torch.kernels.kv_ingest import ref as kv_ref
from repro_torch.models.module import Spec, is_spec
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as tmetrics
from repro_torch.serve import kvcache as tcache

_COUNTERS = {"doorbell_writes", "desc_fetch_dmas", "launches",
             "transfers_replayed", "route_reresolutions", "pages_migrated",
             "transmits", "staged_transmits", "wire_sends", "disconnects",
             "nodes_killed", "kills_triggered", "wire_packets",
             "dma_writes", "dma_reads"}


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


_MAKERS = {
    "float32": lambda r, s: r.standard_normal(s).astype(np.float32),
    "bfloat16": lambda r, s: r.standard_normal(s).astype(ml_dtypes.bfloat16),
    "int32": lambda r, s: r.integers(-2**31, 2**31 - 1, s, dtype=np.int32),
    "uint8": lambda r, s: r.integers(0, 256, s, dtype=np.uint8),
}


def _t(a: np.ndarray) -> torch.Tensor:
    return tree_from_numpy(a, "cpu")


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or a (jax/numpy) array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _same_bits(a, b):
    x, y = _bits(a), _bits(b)
    assert x.shape == y.shape and x.dtype == y.dtype, (x.dtype, y.dtype)
    np.testing.assert_array_equal(x, y)


def _counters(metrics, before) -> dict:
    reg = metrics.get_registry()
    out: dict = {}
    for path, v in reg.diff(before, reg.snapshot()).items():
        if path.rsplit("/", 1)[-1] in _COUNTERS and isinstance(v, int):
            key = reg.group_key(path)
            out[key] = out.get(key, 0) + v
    return {k: v for k, v in out.items() if v}


# -- the kernel's plain version ------------------------------------------------
@pytest.mark.parametrize("dtype", list(_MAKERS))
@pytest.mark.parametrize("n", [1, 5, 16])
@pytest.mark.parametrize("feat", [(3,), (2, 5)], ids=["F3", "F2x5"])
def test_kv_ingest_matches_pallas_interpret_and_ref(dtype, n, feat):
    rng = np.random.default_rng(n * 7 + len(feat))
    P, T = 20, 4
    pages = _MAKERS[dtype](rng, (P, T) + feat)
    payload = _MAKERS[dtype](rng, (n, T) + feat)
    ids = rng.choice(P, size=n, replace=False)
    want = pallas_ingest(jnp.asarray(pages), jnp.asarray(payload),
                         jnp.asarray(ids, jnp.int32), interpret=True)
    _same_bits(want, jref.reference(jnp.asarray(pages),
                                    jnp.asarray(payload), ids))
    tp = _t(pages)
    got = kv_ops.kv_ingest(tp, _t(payload), ids)
    assert got is tp                    # in place, the same tensor
    _same_bits(got, want)


def test_kv_ingest_casts_payload_and_repeated_ids_keep_the_last():
    """float32 payload into bf16 pages rounds like the reference's
    astype; a repeated id keeps its last row, as the Pallas grid does."""
    rng = np.random.default_rng(3)
    pages = _MAKERS["bfloat16"](rng, (8, 2, 6))
    payload = _MAKERS["float32"](rng, (6, 2, 6))
    ids = np.array([3, 7, 3, 1, 7, 3])
    want = pallas_ingest(jnp.asarray(pages), jnp.asarray(payload),
                         jnp.asarray(ids, jnp.int32), interpret=True)
    got = kv_ops.kv_ingest(_t(pages), _t(payload), ids)
    _same_bits(got, want)
    # the plain version alone takes unique ids: fed the deduped ids it
    # agrees too
    keep = np.array([3, 4, 5])                  # last of 1, 7 and 3
    plain = kv_ref.ingest(_t(pages), torch.from_numpy(ids[keep]),
                          _t(payload)[keep].to(torch.bfloat16))
    _same_bits(plain, want)


def test_kv_ingest_refuses_bad_input_before_any_launch():
    pages = torch.zeros((4, 2, 3))
    before = dict(_build.LAUNCHES)
    with pytest.raises(IndexError):
        kv_ops.kv_ingest(pages, torch.ones((1, 2, 3)), [4])
    with pytest.raises(IndexError):
        kv_ops.gather_pages(pages, [-1])
    with pytest.raises(ValueError):
        kv_ops.kv_ingest(pages, torch.ones((1, 2, 4)), [0])
    with pytest.raises(ValueError):
        kv_ops.kv_ingest(pages, torch.ones((2, 2, 3)), [0])
    with pytest.raises(ValueError):
        kv_ops.kv_ingest(pages, np.ones((1, 2, 3), np.float32), [0])
    with pytest.raises(ValueError):
        kv_ops.kv_ingest(pages.transpose(1, 2), torch.ones((1, 3, 2)), [0])
    assert _build.LAUNCHES == before and not pages.any()


# -- T2: rx_engine, the shadow table, the paged pool ---------------------------
def _shadowed(mod, n_pages=12):
    sh = mod.ShadowTable(n_pages)
    sh.register_region("a", 5, 4)
    sh.register_region("b", 4, 4)
    sh.release_region("a")
    sh.register_region("c", 6, 4)
    return sh


def test_shadow_translate_matches_reference_in_int64():
    t, j = _shadowed(tshadow), _shadowed(jshadow)
    ids = np.array([[5, 9], [14, 6]])
    got, want = t.translate(ids), j.translate(ids)
    assert got.dtype == np.int64 and want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert t.page_map == j.page_map and t.free == j.free
    assert t.utilization == j.utilization


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rx_engine_ingest_and_gather_match_reference(dtype):
    rng = np.random.default_rng(9)
    pages = _MAKERS[dtype](rng, (12, 4, 1, 8))
    payload = _MAKERS[dtype](rng, (6, 4, 1, 8))
    logical = np.arange(9, 15)
    t, j = _shadowed(tshadow), _shadowed(jshadow)
    want = jrx.ingest(jnp.asarray(pages), jnp.asarray(payload), logical, j,
                      use_kernel=True)
    got = trx.ingest(_t(pages), _t(payload), logical, t, use_kernel=True)
    _same_bits(got, want)
    _same_bits(trx.ingest(_t(pages), _t(payload), logical, t), want)
    _same_bits(trx.gather_pages(got, logical, t),
               jrx.gather_pages(want, logical, j))
    _same_bits(trx.gather_pages(got, [3, 0, 3]),
               jrx.gather_pages(want, [3, 0, 3]))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_pool_roundtrip_and_isolation_match_reference(use_kernel):
    """The analogues of the reference's paged-pool tests: a ragged
    sequence round-trips, two sequences never alias, and the pool's
    pages equal the reference pool's bit for bit."""
    rng = np.random.default_rng(1)
    kv13 = rng.standard_normal((13, 2, 8)).astype(np.float32)
    kv16 = rng.standard_normal((16, 2, 8)).astype(np.float32)
    jp = jcache.PagedKVPool(n_pages=8, page_tokens=4, feature_shape=(2, 8),
                            dtype="float32")
    tp = tcache.PagedKVPool(n_pages=8, page_tokens=4, feature_shape=(2, 8),
                            dtype="float32")
    for pool, arr in ((jp, jnp.asarray), (tp, _t)):
        a1, a2 = pool.allocate(13), pool.allocate(16)
        pool.ingest(a1, arr(kv13), use_kernel=use_kernel)
        pool.ingest(a2, arr(kv16), use_kernel=use_kernel)
        _same_bits(pool.gather(a1, 13), kv13)
        _same_bits(pool.gather(a2, 16), kv16)
        pool.free(a1)
        a3 = pool.allocate(4)
        pool.ingest(a3, arr(2 * kv16[:4]), use_kernel=use_kernel)
        _same_bits(pool.gather(a2, 16), kv16)       # untouched by a3
    _same_bits(tp.pages, jp.pages)
    assert tp.shadow.page_map == jp.shadow.page_map


def test_paged_pool_allocates_on_the_default_device():
    pool = tcache.PagedKVPool(4, 2, (3,), torch.bfloat16)
    assert pool.pages.device.type == "cpu"
    assert pool.pages.dtype == torch.bfloat16


def _caches_np(rng, specs, *, dtype=np.float32):
    """Seeded numpy caches at the shapes of a reference spec tree: one
    numpy tree that seeds both packages."""
    import jax
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(dtype),
                        specs, is_leaf=jis_spec)


def test_pad_caches_matches_reference():
    rng = np.random.default_rng(4)
    tree_np = [{"b0": {"k": rng.standard_normal((2, 3, 5, 1, 4)),
                       "v": rng.standard_normal((2, 3, 5, 1, 4))},
                "w": rng.standard_normal((2, 3, 7)),
                "s": rng.standard_normal((2, 3))}]
    tree_np = [{k: (v.astype(np.float32) if not isinstance(v, dict) else
                    {kk: vv.astype(np.float32) for kk, vv in v.items()})
                for k, v in tree_np[0].items()}]
    import jax
    # the port pads as the spec tree at length 8 says: the sequence
    # leaves to 8, the state leaves as they are (the reference decides by
    # dim 2 == 5, which these leaves meet or miss alike)
    kv = Spec((2, 3, 8, 1, 4), ("layers", "batch", "kv_seq", None, None))
    specs = [{"b0": {"k": kv, "v": kv},
              "w": Spec((2, 3, 7), ("layers", "batch", "rnn")),
              "s": Spec((2, 3), ("layers", "batch"))}]
    want = jcache.pad_caches(jax.tree.map(jnp.asarray, tree_np), 5, 8)
    got = tcache.pad_caches(tree_from_numpy(tree_np, "cpu"), 5, 8, specs)
    wl, gl = jax.tree.leaves(want), ttree.leaves(got)
    assert len(wl) == len(gl) == 4
    for w, g in zip(wl, gl):
        _same_bits(g, w)
    assert tcache.pad_caches(got, 8, 8, specs) is got


# -- the model's spec layer -----------------------------------------------------
@pytest.mark.parametrize("arch,size", [
    ("gemma-2b", "reduced"), ("gemma-2b", "full"),
    ("granite-moe-1b-a400m", "reduced"), ("phi4-mini-3.8b", "full"),
    ("recurrentgemma-2b", "reduced"), ("recurrentgemma-2b", "full"),
    ("mamba2-780m", "reduced"), ("mamba2-780m", "full"),
    ("deepseek-v3-671b", "reduced"), ("deepseek-v3-671b", "full")])
def test_cache_specs_match_reference(arch, size):
    import jax
    cfg = get_config(arch)
    jcfg = jget_config(arch)
    if size == "reduced":
        cfg, jcfg = reduced(cfg), jreduced(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for batch, seq in ((2, 8), (4, 32768)):
        got = build_model(cfg).cache_specs(batch, seq)
        want = jbuild(jcfg).cache_specs(batch, seq)
        gl = ttree.leaves(got, is_leaf=is_spec)
        wl = jax.tree.leaves(want, is_leaf=jis_spec)
        assert [(s.shape, s.axes, s.init, s.dtype) for s in gl] == \
               [(s.shape, s.axes, s.init, s.dtype) for s in wl]
    if arch == "gemma-2b" and size == "full":
        assert [s.shape for s in gl] == [(18, 4, 32768, 1, 256)] * 2
        cache = build_model(cfg).init_cache(1, 4, device="cpu")
        assert [(c.dtype, c.shape) for c in ttree.leaves(cache)] == \
               [(torch.bfloat16, (18, 1, 4, 1, 256))] * 2


def test_other_mixers_wait_for_their_slice():
    """None waits any longer: the encoder-decoder family (slice 6e),
    like the ssm and mla mixers before it, builds caches of the
    reference's specs — its decoder's k / v and the frames' xk / xv —
    and the ssm and mla mixers build theirs
    (`test_cache_specs_match_reference`)."""
    import jax
    cfg = reduced(get_config("whisper-base"))
    got = build_model(cfg).cache_specs(2, 8)
    want = jbuild(jreduced(jget_config("whisper-base"))).cache_specs(2, 8)
    assert [(s.shape, s.axes, s.init, s.dtype)
            for s in ttree.leaves(got, is_leaf=is_spec)] == \
        [(s.shape, s.axes, s.init, s.dtype)
         for s in jax.tree.leaves(want, is_leaf=jis_spec)]
    assert sorted(got[0]) == ["k", "v", "xk", "xv"]
    for arch in ("mamba2-780m", "deepseek-v3-671b", "whisper-base"):
        cache = build_model(reduced(get_config(arch))).init_cache(
            2, 8, device="cpu")
        assert ttree.leaves(cache)


def test_tree_leaves_follow_jax_order():
    import jax
    t = {"v": [1, {"z": 2, "a": 3}], "k": (4, None, 5), "b": 6}
    assert ttree.leaves(t) == jax.tree.leaves(t)
    doubled = ttree.map(lambda x: 2 * x, t)
    assert ttree.leaves(doubled) == [2 * x for x in jax.tree.leaves(t)]
    assert isinstance(doubled["k"], tuple) and doubled["k"][1] is None


# -- T1: accounting and the int8 wire codec ------------------------------------
def test_account_matches_reference():
    rng = np.random.default_rng(2)
    caches = [{"b0": {"k": rng.standard_normal((3, 2, 8, 1, 16)).astype(
        ml_dtypes.bfloat16), "v": rng.integers(0, 9, (3, 2, 8, 1, 16),
                                               dtype=np.uint8)}}]
    import jax
    want = jkv.account(jax.tree.map(jnp.asarray, caches), JPlan())
    got = tkv.account(tree_from_numpy(caches, "cpu"), TransferPlan())
    assert (got.n_leaves, got.payload_bytes, got.header_bytes) == \
           (want.n_leaves, want.payload_bytes, want.header_bytes) == \
           (2, 3 * 2 * 8 * 16 * 3, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_wire_codec_bit_equal_to_reference(dtype):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 3, 64)) * rng.uniform(0.01, 50, (4, 3, 1))
         ).astype(np.float32)
    x[0, 0] = 0.0                       # an all-zero row: the 1e-12 floor
    x = x.astype(_MAKERS[dtype](rng, 1).dtype)
    jq, js = jtx._quantize(jnp.asarray(x), 8)
    tq, ts = ttx._quantize(_t(x), 8)
    _same_bits(tq, jq)
    _same_bits(ts, js)
    _same_bits(ttx._dequantize(tq, ts, tq.new_empty(0, dtype=_t(x).dtype)
                               .dtype), jtx._dequantize(jq, js, x.dtype))
    with pytest.raises(ValueError):
        ttx._quantize(_t(x), 4)


def test_transmit_is_the_identity_without_a_pod_axis():
    reg = tmetrics.get_registry()
    t0 = reg.scope("tx_engine").counter("transmits").value
    s0 = reg.scope("tx_engine").counter("staged_transmits").value
    tree_ = {"k": torch.ones(2)}
    assert ttx.transmit(tree_, None, TransferPlan(quantize_bits=8)) is tree_
    assert ttx.transmit_staged(tree_, None, TransferPlan()) is tree_
    assert reg.scope("tx_engine").counter("transmits").value == t0 + 1
    assert reg.scope("tx_engine").counter("staged_transmits").value == s0 + 1


# -- the engine ------------------------------------------------------------------
def _models():
    jmodel = jbuild(jreduced(jget_config("gemma-2b")))
    tmodel = build_model(reduced(get_config("gemma-2b")))
    return jmodel, tmodel


def _both_caches(seed, batch=2, seq=8):
    jmodel, tmodel = _models()
    import jax
    caches_np = _caches_np(np.random.default_rng(seed),
                           jmodel.cache_specs(batch, seq))
    return (jmodel, jax.tree.map(jnp.asarray, caches_np)), \
        (tmodel, tree_from_numpy(caches_np, "cpu")), caches_np


def _leaves_equal(got, want):
    import jax
    gl, wl = ttree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl) > 0
    for g, w in zip(gl, wl):
        _same_bits(g, w)


def _engine_run(pkg, model, caches):
    V, kvmod, metrics = (jverbs, jkv, jmetrics) if pkg == "jax" else \
        (tverbs, tkv, tmetrics)
    before = metrics.get_registry().snapshot()
    eng = kvmod.KVTransferEngine(model, 2, 8)
    one = eng.transfer(caches)
    single = eng.stats
    d0 = eng.ep.qp.doorbell_writes
    outs = eng.transfer_many([caches, caches, caches])
    obs = dict(doorbells=eng.ep.qp.doorbell_writes - d0, wr_id=eng._wr_id,
               stats=(eng.stats.n_leaves, eng.stats.payload_bytes,
                      eng.stats.header_bytes, single.payload_bytes),
               delivered=[one] + outs)
    eng.close()
    obs["released"] = (len(eng.fabric.qps), len(eng.fabric._listeners))
    obs["counters"] = _counters(metrics, before)
    return obs


def test_transfer_and_transfer_many_match_reference():
    (jm, jc), (tm, tc), _ = _both_caches(0)
    want, got = _engine_run("jax", jm, jc), _engine_run("torch", tm, tc)
    for key in ("doorbells", "wr_id", "stats", "released", "counters"):
        assert got[key] == want[key], key
    assert got["doorbells"] == 1 and got["wr_id"] == 4
    for g, w in zip(got["delivered"], want["delivered"]):
        _leaves_equal(g, w)


def test_delivery_is_by_reference_so_senders_must_not_write_in_place():
    """One process has no pod axis, so the SEND delivers the sender's
    own tensors (as the reference does). Torch tensors are mutable: a
    write to a posted tree after the transfer shows in what was
    delivered — the rule in ROADMAP Queue 3."""
    _, (tm, tc), _ = _both_caches(1)
    eng = tkv.KVTransferEngine(tm, 2, 8)
    out = eng.transfer(tc)
    assert all(a is b for a, b in zip(ttree.leaves(out), ttree.leaves(tc)))
    ttree.leaves(tc)[0].add_(1.0)
    assert torch.equal(ttree.leaves(out)[0], ttree.leaves(tc)[0])
    eng.close()


def _migrate(pkg, model, n_pages=40, chunk=8, dtype="float32"):
    """Pages of every layer of a leaf as one MR record, moved pod0 ->
    pod1 in chains of 2*chunk WRs (one WR per page per leaf)."""
    V, kvmod, metrics = (jverbs, jkv, jmetrics) if pkg == "jax" else \
        (tverbs, tkv, tmetrics)
    V.ProtectionDomain._next_key = 0x5000
    rng = np.random.default_rng(8)
    f = V.Fabric(pods=2)
    eng = kvmod.KVTransferEngine(model, 2, 8, fabric=f)
    src_pd = f.node("pod0/dev0").pd
    dst_pd = f.node(eng.decode_gid).pd
    src = [src_pd.reg_mr(f"src{i}", _MAKERS[dtype](
        rng, (n_pages, 3, 4, 1, 16))) for i in range(2)]
    dst = [dst_pd.reg_mr(f"dst{i}", np.zeros(
        (n_pages, 3, 4, 1, 16), _MAKERS[dtype](rng, 1).dtype))
        for i in range(2)]
    perm = rng.permutation(n_pages)
    per_chain = []
    before = metrics.get_registry().snapshot()
    for c in range(0, n_pages, chunk):
        ids = np.arange(c, min(c + chunk, n_pages))
        runs = [(s, ids, d.rkey, perm[ids]) for s, d in zip(src, dst)]
        b = metrics.get_registry().snapshot()
        d0, f0 = eng.ep.qp.doorbell_writes, eng.ep.qp.desc_fetch_dmas
        landed = eng.migrate_pages(runs)
        per_chain.append((landed, eng.ep.qp.doorbell_writes - d0,
                          eng.ep.qp.desc_fetch_dmas - f0,
                          _counters(metrics, b).get("fused/launches", 0)))
    return dict(per_chain=per_chain, migrated=eng.pages_migrated,
                regions=[_bits(dst_pd.engine.regions[f"dst{i}"])
                         for i in range(2)],
                sources=[_bits(src_pd.engine.regions[f"src{i}"])
                         for i in range(2)],
                counters=_counters(metrics, before), perm=perm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_migrate_pages_matches_reference_and_fuses_per_leaf(dtype):
    """k pages across L=2 leaves per chain: ONE doorbell, ONE descriptor
    fetch, 2*L fused launches — and the pages land bit-exact, in both
    packages alike. bf16 pages (the model's cache dtype) stay on the
    device from the source gather to the scatter: numpy cannot hold
    them."""
    jm, tm = _models()
    got = _migrate("torch", tm, dtype=dtype)
    want = _migrate("jax", jm, dtype=dtype)
    assert got["per_chain"] == want["per_chain"]
    assert got["counters"] == want["counters"]
    assert got["migrated"] == want["migrated"] == 80
    assert {c[1:] for c in got["per_chain"]} == {(1, 1, 4)}
    for g, w, s in zip(got["regions"], want["regions"], got["sources"]):
        _same_bits(g, w)
        np.testing.assert_array_equal(g[got["perm"]], s)


def test_migration_chain_of_256_wrs_fits_the_connection():
    """The engine's connection has a queue depth of 256 under CQ-credit
    flow control: a 256-WR chain (128 pages x 2 leaves) posts, lands and
    retires in one flush; 257 are refused by the send queue, and the
    refusal is a failover, not a wedge."""
    _, tm = _models()
    got = _migrate("torch", tm, n_pages=256, chunk=128)
    assert {c[1:] for c in got["per_chain"]} == {(1, 1, 4)}
    f = tverbs.Fabric(pods=2)
    eng = tkv.KVTransferEngine(tm, 2, 8, fabric=f)
    assert eng.ep.qp.max_send_wr == 256
    assert eng.ep.send_cq.ring.capacity == 256
    eng.close()


def _failover(pkg, model, caches, vectorized=True):
    V, kvmod, metrics = (jverbs, jkv, jmetrics) if pkg == "jax" else \
        (tverbs, tkv, tmetrics)
    before = metrics.get_registry().snapshot()
    fm = V.FaultModel(seed=7)
    f = V.Fabric(pods=3, faults=fm, vectorized=vectorized)
    eng = kvmod.KVTransferEngine(model, 2, 8, fabric=f)
    eng.transfer(caches)
    clean = eng.transfers_replayed
    primary = eng.decode_gid
    fm.kill_after(primary, 1)
    out = eng.transfer(caches)
    obs = dict(clean=clean, replayed=eng.transfers_replayed,
               reres=eng.route_reresolutions, moved=eng.decode_gid != primary,
               dead=sorted(f.dead_gids), delivered=out)
    eng.close()
    obs["released"] = (len(f.qps), len(f._listeners))
    obs["counters"] = _counters(metrics, before)
    return obs


@pytest.mark.parametrize("vectorized", [True, False])
def test_transfer_replays_through_node_kill_like_reference(vectorized):
    (jm, jc), (tm, tc), _ = _both_caches(5)
    got = _failover("torch", tm, tc, vectorized)
    want = _failover("jax", jm, jc, vectorized)
    _leaves_equal(got.pop("delivered"), want.pop("delivered"))
    assert got == want
    assert (got["clean"], got["replayed"], got["reres"]) == (0, 1, 1)
    assert got["moved"] and got["released"] == (0, 0)


def test_kv_leg_as_a_whole_matches_reference():
    """The slice's path at a small size, as `chip_smoke.py` phase 5 runs
    it at full width: transfer -> pad_caches -> the paged round trip
    (PDServer's) -> equal to the padded caches, against the reference."""
    (jm, jc), (tm, tc), _ = _both_caches(12, batch=2, seq=13)
    jeng = jkv.KVTransferEngine(jm, 2, 13)
    teng = tkv.KVTransferEngine(tm, 2, 13)
    jout, tout = jeng.transfer(jc), teng.transfer(tc)
    specs = tm.cache_specs(2, 24)
    jpad = jcache.pad_caches(jout, 13, 24)
    tpad = tcache.pad_caches(tout, 13, 24, specs)
    want = PDServer._page_roundtrip(
        SimpleNamespace(max_seq=24, page_tokens=8), jpad, use_kernel=True)
    got = tcache.page_roundtrip(tpad, 24, 8, specs)
    _leaves_equal(got, want)
    _leaves_equal(got, jpad)
    jeng.close()
    teng.close()
