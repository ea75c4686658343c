"""The torch port's routed fabric held bit-exact against the JAX package.

The same seeded scenarios run through `repro.verbs.Fabric` (the
reference) and `repro_torch.verbs.Fabric` (on the CPU, where every
kernel wrapper takes its plain version): connection-manager bring-up,
routed delivery, multi-destination fusion, the RNR retry schedule, the
fabric-scope SRQ, teardown, and the unreliable fabric — seeded
drop/delay/duplicate schedules, node and pod kills with disconnect
events, and DCQCN-style rate control. Completions, MR contents, stall
points and registry counter deltas must agree; under faults the port's
vectorized datapath is held against the reference's scalar oracle.
Tolerance is exact: the fabric moves data and does no arithmetic."""
import ml_dtypes
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # offline rig: sampled fallback
    from _hyp import given, settings, st

from repro import verbs as jverbs
from repro.obs import metrics as jmetrics
from repro.verbs import faults as jfaults
from repro_torch import device as tdevice
from repro_torch import verbs as tverbs
from repro_torch.convert import to_host
from repro_torch.obs import metrics as tmetrics
from repro_torch.verbs import faults as tfaults

PACKAGES = {"jax": (jverbs, jmetrics), "torch": (tverbs, tmetrics)}
# registry leaves the fabric contract is stated in
_COUNTERS = {
    "doorbell_writes", "desc_fetch_dmas", "dma_writes", "dma_reads",
    "launches", "rnr_retries", "rnr_exhausted", "rnr_backoff_units",
    "drops_injected", "delays_injected", "duplicates_absorbed",
    "rnr_naks_dropped", "retry_exhausted", "wire_packets",
    "kills_triggered", "disconnects", "nodes_killed", "intra_pod_hops",
    "wire_sends", "ecn_marks", "rate_decreases", "rate_increases",
    "throttled_wrs", "pacing_rounds", "wrs_stashed", "transmits",
    "staged_transmits"}


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


def _host(x):
    return None if x is None else np.asarray(to_host(x))


def _counters(metrics, before) -> dict:
    """Registry counter deltas since `before`, summed per instance-free
    path, restricted to the fabric contract counters."""
    reg = metrics.get_registry()
    out: dict = {}
    for path, v in reg.diff(before, reg.snapshot()).items():
        if path.rsplit("/", 1)[-1] in _COUNTERS and isinstance(v, int):
            key = reg.group_key(path)
            out[key] = out.get(key, 0) + v
    return {k: v for k, v in out.items() if v}


def _wcs(wcs) -> list:
    return [(w.wr_id, w.opcode, w.status, w.length, _host(w.data))
            for w in wcs]


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], b[key]
        if key.endswith("wcs"):
            assert len(x) == len(y), key
            for p, q in zip(x, y):
                assert p[:4] == q[:4], key
                if p[4] is None or q[4] is None:
                    assert p[4] is None and q[4] is None, key
                else:
                    np.testing.assert_array_equal(p[4], q[4])
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, (key, x, y)


# -- connection manager ------------------------------------------------------
def _cm_bringup(pkg):
    V, _ = PACKAGES[pkg]
    f = V.Fabric(pods=2)
    addr = f.node("pod1/dev0").listen("svc", depth=32)
    ep = f.connect("svc")
    obs = dict(
        states=(ep.qp.state.name, ep.peer.qp.state.name),
        routes=(f.routes[ep.qp.qp_num] == ep.peer.address,
                f.routes[ep.peer.qp.qp_num] == ep.address),
        gids=(ep.address.gid, ep.remote.gid, addr.gid),
        resolved=f.node("pod0/dev0").resolve("svc") == addr,
        discover=sorted(f.discover()))
    wc = ep.send(np.array([1, 2], np.int32), wr_id=3)
    obs["send_wcs"] = _wcs([wc])
    errors = []
    for bad in (lambda: f.node("pod0/dev0").resolve("nope"),
                lambda: f.node("pod1/dev0").listen("svc"),
                lambda: f.connect(V.FabricAddress("pod1/dev0", 424242)),
                lambda: f.node("podX/dev9")):
        with pytest.raises(V.QPStateError):
            bad()
        errors.append(True)
    obs["errors"] = errors
    # a bare RESET QP at a fabric address: the CM drives its ladder too
    pd = V.ProtectionDomain()
    qp = V.QueuePair(pd, V.CompletionQueue(32), V.CompletionQueue(32))
    baddr = f.register_qp(qp, "pod1/dev0")
    ep2 = f.connect(baddr)
    qp.post_recv(V.RecvWR(wr_id=8))
    ep2.post_send(V.SendWR(wr_id=8, payload=np.array([5], np.int64)))
    ep2.flush()
    obs["bare_wcs"] = _wcs(qp.recv_cq.poll())
    with pytest.raises(V.QPStateError):
        f.connect(baddr)                # now RTS: refused
    return obs


def test_cm_bringup_resolve_and_addressed_qps_match_reference():
    _assert_same(_cm_bringup("torch"), _cm_bringup("jax"))


def test_failed_connect_leaks_no_qp_context():
    f = tverbs.Fabric(pods=2)
    cm = f.node("pod0/dev0")
    n_ctx = len(cm.pd.engine._qps)
    for _ in range(5):
        with pytest.raises(tverbs.QPStateError):
            cm.connect(tverbs.FabricAddress("pod1/dev0", 424242))
    assert len(cm.pd.engine._qps) == n_ctx
    assert not f.qps and not f.routes and not f.gid_of


# -- routed delivery ----------------------------------------------------------
_KINDS = ["send_inline", "send_big", "send_unsig", "write", "write_bad",
          "read"]


def _make_wrs(V, kinds, rkey, rng):
    wrs = []
    for i, kind in enumerate(kinds):
        if kind == "send_inline":
            wrs.append(V.SendWR(wr_id=i, payload=np.array(
                [i, 7, i * i], np.int32)))
        elif kind == "send_big":
            wrs.append(V.SendWR(wr_id=i, inline=False, payload=rng
                                .standard_normal(40).astype(np.float32)))
        elif kind == "send_unsig":
            wrs.append(V.SendWR(wr_id=i, signaled=False,
                                payload=np.array([i], np.int64)))
        elif kind in ("write", "write_bad"):
            k = int(rng.integers(1, 4))
            offs = rng.choice(8, size=k, replace=False)
            wrs.append(V.SendWR(
                wr_id=i, opcode=V.IBV_WR_RDMA_WRITE,
                remote_key=0xDEAD if kind == "write_bad" else rkey,
                remote_offsets=offs,
                payload=rng.standard_normal((k, 4)).astype(np.float32)))
        elif kind == "read":
            k = int(rng.integers(1, 4))
            wrs.append(V.SendWR(
                wr_id=i, opcode=V.IBV_WR_RDMA_READ, remote_key=rkey,
                remote_offsets=rng.choice(8, size=k, replace=False)))
    return wrs


def _run_routed(pkg, kinds, n_recv, seed, *, vectorized=True, faults=None,
                retry_cnt=7, rnr_retry=7):
    """One WQE chain over a 2-pod fabric; `faults` is a
    (seed, drop, delay, dup) schedule or None."""
    V, metrics = PACKAGES[pkg]
    V.ProtectionDomain._next_key = 0x7000
    before = metrics.get_registry().snapshot()
    fm = None if faults is None else V.FaultModel(
        faults[0], drop=faults[1], delay=faults[2], dup=faults[3])
    f = V.Fabric(pods=2, vectorized=vectorized, faults=fm,
                 retry_cnt=retry_cnt, rnr_retry=rnr_retry)
    cm = f.node("pod1/dev0")
    dst = cm.pd.reg_mr("dst", np.zeros((8, 4), np.float32))
    ep = f.connect(cm.listen(depth=1024, max_wr=256, srq=None),
                   depth=1024, max_wr=256)
    for i in range(n_recv):
        ep.peer.post_recv(V.RecvWR(wr_id=100 + i))
    rng = np.random.default_rng(seed)
    ep.post_send(_make_wrs(V, kinds, dst.rkey, rng))
    flushed = ep.flush()
    return dict(flushed=flushed, stalled=len(ep.qp.sq),
                region=_host(cm.pd.engine.regions["dst"]),
                send_wcs=_wcs(ep.poll()),
                recv_wcs=_wcs(ep.peer.recv_cq.poll()),
                counters=_counters(metrics, before))


@settings(max_examples=20, deadline=None)
@given(st.lists(st.sampled_from(_KINDS), min_size=1, max_size=24),
       st.integers(0, 24))
def test_routed_delivery_matches_reference(kinds, n_recv):
    """Random opcode mixes and recv budgets (mid-chain RNR stalls):
    completions, MR contents, stall points and counters of the port's
    routed fabric equal the reference's."""
    seed = len(kinds) * 101 + n_recv
    _assert_same(_run_routed("torch", kinds, n_recv, seed),
                 _run_routed("jax", kinds, n_recv, seed))


def _multi_destination(pkg):
    V, metrics = PACKAGES[pkg]
    before = metrics.get_registry().snapshot()
    f = V.Fabric(pods=4)
    eps, mrs = [], []
    for p in range(4):
        cm = f.node(f"pod{p}/dev0")
        mrs.append(cm.pd.reg_mr(f"dst{p}", np.zeros((16, 4), np.float32)))
        eps.append(f.connect(cm.listen(depth=64, srq=None), depth=64))
    for i, (ep, mr) in enumerate(zip(eps, mrs)):
        ep.post_send([V.SendWR(
            wr_id=j, opcode=V.IBV_WR_RDMA_WRITE, remote_key=mr.rkey,
            remote_offsets=[j],
            payload=np.full((1, 4), float(10 * i + j), np.float32),
            signaled=False) for j in range(16)])
    obs = dict(processed=f.flush(*eps),
               fetches=[ep.qp.desc_fetch_dmas for ep in eps],
               scatters=[ep.peer.qp.ctx.dma_launches for ep in eps])
    for i, ep in enumerate(eps):
        obs[f"region{i}"] = _host(ep.peer.qp.pd.engine.regions[f"dst{i}"])
    obs["counters"] = _counters(metrics, before)
    return obs


def test_multi_destination_pass_fuses_per_destination():
    """One pass over chains to 4 pods: one descriptor fetch per chain
    and one fused scatter per destination, in both packages alike."""
    got = _multi_destination("torch")
    _assert_same(got, _multi_destination("jax"))
    assert got["fetches"] == [1] * 4 and got["scatters"] == [1] * 4


def _mr_sourced(pkg, vectorized):
    """SENDs and WRITEs whose payload is read from a bf16 MR (the KV
    cache's dtype): sideband SENDs, SENDs landing in a posted MR and
    WRITEs, each run sourcing several records of one MR (the fused
    gather) and a single one (the per-WR source)."""
    V, metrics = PACKAGES[pkg]
    V.ProtectionDomain._next_key = 0x6000
    before = metrics.get_registry().snapshot()
    rng = np.random.default_rng(21)
    f = V.Fabric(pods=2, vectorized=vectorized)
    cm0, cm1 = f.node("pod0/dev0"), f.node("pod1/dev0")
    src = cm0.pd.reg_mr("src", rng.standard_normal((8, 2, 3)).astype(
        ml_dtypes.bfloat16))
    land = cm1.pd.reg_mr("land", np.zeros((8, 2, 3), ml_dtypes.bfloat16))
    dst = cm1.pd.reg_mr("dst", np.zeros((8, 2, 3), ml_dtypes.bfloat16))
    ep = f.connect(cm1.listen(depth=64, srq=None), depth=64)
    for i in range(3):
        ep.peer.post_recv(V.RecvWR(wr_id=100 + i))
    for i in range(3):
        ep.peer.post_recv(V.RecvWR(wr_id=200 + i, mr=land, offsets=[5 - i]))
    wrs = [V.SendWR(wr_id=i, mr=src, offsets=[i, i + 1], inline=False)
           for i in range(3)]
    wrs += [V.SendWR(wr_id=10 + i, mr=src, offsets=[7 - i], inline=False)
            for i in range(3)]
    wrs += [V.SendWR(wr_id=20 + i, opcode=V.IBV_WR_RDMA_WRITE, mr=src,
                     offsets=[i], remote_key=dst.rkey,
                     remote_offsets=[(3 * i) % 8]) for i in range(4)]
    wrs.append(V.SendWR(wr_id=30, opcode=V.IBV_WR_RDMA_WRITE, mr=src,
                        offsets=[6], remote_key=dst.rkey,
                        remote_offsets=[7]))
    ep.post_send(wrs)
    ep.flush()
    return dict(send_wcs=_wcs_meta(ep.poll()),
                recv=[(w.wr_id, w.status, w.length,
                       None if w.data is None else _bf16_bits(w.data))
                      for w in ep.peer.recv_cq.poll()],
                land=_bf16_bits(cm1.pd.engine.regions["land"]),
                region=_bf16_bits(cm1.pd.engine.regions["dst"]),
                counters=_counters(metrics, before))


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _wcs_meta(wcs) -> list:
    return [(w.wr_id, w.opcode, w.status, w.length) for w in wcs]


@pytest.mark.parametrize("vectorized", [True, False])
def test_bf16_mr_sourced_payloads_match_reference(vectorized):
    """Payloads read from a bf16 MR stay on the device from the source
    gather to the landing scatter (numpy has no bf16), and deliver and
    land exactly what the reference does."""
    got = _mr_sourced("torch", vectorized)
    want = _mr_sourced("jax", vectorized)
    assert got["send_wcs"] == want["send_wcs"]
    assert got["counters"] == want["counters"]
    assert len(got["recv"]) == len(want["recv"]) == 6
    for g, w in zip(got["recv"], want["recv"]):
        assert g[:3] == w[:3]
        if g[3] is None or w[3] is None:
            assert g[3] is None and w[3] is None
        else:
            np.testing.assert_array_equal(g[3], w[3])
    for key in ("land", "region"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["region"].any() and got["land"].any()


# -- RNR retry/backoff --------------------------------------------------------
def _rnr(pkg, refill_at, budget):
    V, metrics = PACKAGES[pkg]
    before = metrics.get_registry().snapshot()

    def refill(qp, tries):
        if tries == refill_at:
            ep.peer.qp.rq.append(V.RecvWR(wr_id=55))

    f = V.Fabric(rnr_retry=budget, on_rnr_backoff=refill)
    ep = f.connect(f.node(f.gids[0]).listen(depth=32, srq=None), depth=32)
    ep.post_send(V.SendWR(wr_id=9, payload=np.array([4], np.int64)))
    ep.flush()
    return dict(recv_wcs=_wcs(ep.peer.recv_cq.poll()),
                send_wcs=_wcs(ep.poll()), stalled=len(ep.qp.sq),
                sums=(f.rnr_retries, f.rnr_exhausted, f.rnr_backoff_units),
                counters=_counters(metrics, before))


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 5), st.integers(0, 6))
def test_rnr_retry_schedule_matches_reference(refill_at, budget):
    """A SEND into an empty pool succeeds iff the receiver refills
    within the budget; retries, exponential backoff units, exhaustion
    and the IBV_WC_RNR_ERR completion all equal the reference's."""
    got = _rnr("torch", refill_at, budget)
    _assert_same(got, _rnr("jax", refill_at, budget))
    steps = min(refill_at, budget)
    assert got["sums"][2] == (1 << steps) - 1


def _rnr_chain(pkg):
    V, _ = PACKAGES[pkg]
    f = V.Fabric(rnr_retry=0)
    cm = f.node(f.gids[0])
    mr = cm.pd.reg_mr("dst", np.zeros((4, 2), np.float32))
    ep = f.connect(cm.listen(depth=32, srq=None), depth=32)
    ep.post_send([
        V.SendWR(wr_id=0, payload=np.array([1], np.int64)),
        V.SendWR(wr_id=1, opcode=V.IBV_WR_RDMA_WRITE, remote_key=mr.rkey,
                 remote_offsets=[2], payload=np.full((1, 2), 7.0,
                                                     np.float32))])
    out = dict(flushed=ep.flush(), stalled=len(ep.qp.sq),
               send_wcs=_wcs(ep.poll()),
               region=_host(cm.pd.engine.regions["dst"]))
    # the flow-control credit of an RNR_ERR retirement is handed back
    f2 = V.Fabric(rnr_retry=0)
    ep2 = f2.connect(f2.node(f2.gids[0]).listen(depth=8, srq=None,
                                                flow_control=True),
                     depth=8, flow_control=True)
    ep2.post_send(V.SendWR(wr_id=1, payload=np.array([1], np.int64)))
    ep2.flush()
    out["credit"] = (f2.rnr_exhausted, ep2.peer.recv_cq.fc_reserved,
                     ep2.send_cq.fc_reserved)
    return out


def test_rnr_exhaustion_unblocks_chain_and_releases_credit():
    got = _rnr_chain("torch")
    _assert_same(got, _rnr_chain("jax"))
    assert got["flushed"] == 2 and got["credit"] == (1, 0, 0)


# -- fabric-scope SRQ and teardown -------------------------------------------
def _srq_tenants(pkg):
    V, _ = PACKAGES[pkg]
    f = V.Fabric(srq_max_wr=64)
    hits = []
    f.on_srq_limit(lambda s: hits.append("a"))
    f.on_srq_limit(lambda s: hits.append("b"))
    pool = f.shared_srq()
    pool.post_recv([V.RecvWR(wr_id=i) for i in range(4)])
    pool.arm(2)
    eps = [f.connect(f.node(f.gids[0]).listen(depth=64, srq="fabric"),
                     depth=64) for _ in range(2)]
    for j, ep in enumerate(eps):
        ep.post_send([V.SendWR(payload=np.array([j], np.int64),
                               signaled=False),
                      V.SendWR(payload=np.array([j + 10], np.int64),
                               signaled=False)])
        ep.flush()
    wcs = [w for ep in eps for w in ep.peer.recv_cq.poll()]
    return dict(recv_wcs=_wcs(wcs), left=len(pool),
                takes=[pool.taken_by_qp[ep.peer.qp.qp_num] for ep in eps],
                hits=hits, events=pool.limit_events)


def test_fabric_scope_srq_serves_tenants_and_fans_out_the_watermark():
    got = _srq_tenants("torch")
    _assert_same(got, _srq_tenants("jax"))
    assert got["takes"] == [2, 2] and got["hits"] == ["a", "b"]


def test_disconnect_releases_every_fabric_registration():
    f = tverbs.Fabric(srq_max_wr=32)
    addr = f.node(f.gids[0]).listen("svc", depth=32, srq="fabric")
    ep = f.connect(addr, depth=32)
    qpns = {ep.qp.qp_num, ep.peer.qp.qp_num}
    pool = f.shared_srq()
    assert ep.peer.qp in pool.qps
    f.disconnect(ep)
    assert not qpns & (set(f.routes) | set(f.gid_of) | set(f.qps))
    assert ep.peer.qp not in pool.qps
    assert ep.peer not in f._listeners[addr.qpn].accepted
    ep2 = f.connect(addr, depth=32)
    assert ep2.qp.state == tverbs.QPState.RTS
    f.disconnect(ep2)
    f.unlisten(addr)
    with pytest.raises(tverbs.QPStateError):
        f.connect(addr, depth=32)
    with pytest.raises(tverbs.QPStateError):
        f.node(f.gids[0]).resolve("svc")


# -- the unreliable fabric ----------------------------------------------------
_FKINDS = ["send_inline", "send_big", "send_unsig", "write", "read"]


@settings(max_examples=12, deadline=None)
@given(st.lists(st.sampled_from(_FKINDS), min_size=1, max_size=24),
       st.integers(0, 24), st.integers(0, 1_000_000))
def test_faulted_delivery_port_matches_reference_oracle(kinds, n_recv, seed):
    """For a seeded drop/delay/dup schedule over any opcode mix and recv
    budget: the port's vectorized datapath, the port's scalar oracle and
    the reference's scalar oracle give the same completions, MR
    contents, stall points and injection counters."""
    kw = dict(faults=(seed, 0.25, 0.15, 0.1), retry_cnt=2, rnr_retry=2)
    ref = _run_routed("jax", kinds, n_recv, seed, vectorized=False, **kw)
    _assert_same(_run_routed("torch", kinds, n_recv, seed, vectorized=False,
                             **kw), ref)
    vec = _run_routed("torch", kinds, n_recv, seed, vectorized=True, **kw)
    # the oracle launches no kernel: compare the vectorized side without
    # the fused-launch contract, which only it carries
    vec["counters"] = {k: v for k, v in vec["counters"].items()
                       if not k.endswith("/launches")}
    _assert_same(vec, ref)


def _run_sends(pkg, seed, *, faults, retry_cnt=1, n=16):
    V, metrics = PACKAGES[pkg]
    V.ProtectionDomain._next_key = 0x7000
    before = metrics.get_registry().snapshot()
    fm = None if faults is None else V.FaultModel(seed, **faults)
    f = V.Fabric(pods=2, faults=fm, retry_cnt=retry_cnt)
    ep = f.connect(f.node("pod1/dev0").listen(depth=1024, max_wr=256,
                                              srq=None),
                   depth=1024, max_wr=256)
    for i in range(n):
        ep.peer.post_recv(V.RecvWR(wr_id=100 + i))
    ep.post_send([V.SendWR(wr_id=i, payload=np.array(
        [i, seed % 97, i * i], np.int64)) for i in range(n)])
    ep.flush()
    return dict(send_wcs=_wcs(ep.poll()), recv_wcs=_wcs(
        ep.peer.recv_cq.poll()), counters=_counters(metrics, before))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 1_000_000), st.integers(0, 90))
def test_lossy_link_never_phantoms_success(seed, drop_pct):
    """The delivered set is exactly the SUCCESS-retired set, every other
    WR retires IBV_WC_RETRY_EXC_ERR, payloads are bit-exact, and all of
    it equals the reference under the same schedule."""
    got = _run_sends("torch", seed, faults=dict(drop=drop_pct / 100.0))
    _assert_same(got, _run_sends("jax", seed,
                                 faults=dict(drop=drop_pct / 100.0)))
    ok = {w[0] for w in got["send_wcs"] if w[2] == tverbs.IBV_WC_SUCCESS}
    bad = {w[0] for w in got["send_wcs"]
           if w[2] == tverbs.IBV_WC_RETRY_EXC_ERR}
    assert ok | bad == set(range(16)) and not ok & bad
    assert {int(w[4][0]) for w in got["recv_wcs"]} == ok


@pytest.mark.parametrize("faults,retry_cnt,n", [
    (dict(drop=1.0), 2, 4),             # the retry budget runs out
    (dict(delay=0.8), 0, 8),            # delay spends no budget
    (dict(dup=1.0), 1, 8),              # duplicates absorbed once
], ids=["drop", "delay", "dup"])
def test_per_verdict_semantics_match_reference(faults, retry_cnt, n):
    got = _run_sends("torch", 3, faults=faults, retry_cnt=retry_cnt, n=n)
    _assert_same(got, _run_sends("jax", 3, faults=faults,
                                 retry_cnt=retry_cnt, n=n))
    st_ = {w[2] for w in got["send_wcs"]}
    assert st_ == ({tverbs.IBV_WC_RETRY_EXC_ERR} if "drop" in faults
                   else {tverbs.IBV_WC_SUCCESS})


def _nak_drop(pkg):
    V, metrics = PACKAGES[pkg]
    before = metrics.get_registry().snapshot()
    calls = []

    def refill(qp, tries):
        calls.append(tries)
        ep.peer.qp.rq.append(V.RecvWR(wr_id=55))

    fm = V.FaultModel(1, rnr_nak_drop=1.0)
    f = V.Fabric(pods=2, faults=fm, rnr_retry=3, on_rnr_backoff=refill)
    ep = f.connect(f.node("pod1/dev0").listen(depth=32, srq=None), depth=32)
    ep.post_send(V.SendWR(wr_id=9, payload=np.array([4], np.int64)))
    ep.flush()
    return dict(calls=calls, send_wcs=_wcs(ep.poll()),
                recv_wcs=_wcs(ep.peer.recv_cq.poll()),
                counters=_counters(metrics, before))


def test_rnr_nak_drop_suppresses_backoff_hook():
    got = _nak_drop("torch")
    _assert_same(got, _nak_drop("jax"))
    assert got["calls"] == [] and \
        got["send_wcs"][0][2] == tverbs.IBV_WC_RNR_ERR


def _kill_mid_flush(pkg):
    V, metrics = PACKAGES[pkg]
    before = metrics.get_registry().snapshot()
    events, srv_ev, cm_ev = [], [], []
    fm = V.FaultModel(0).kill_after("pod1/dev0", 3)
    f = V.Fabric(pods=2, faults=fm)
    f.node("pod1/dev0").add_on_disconnect(lambda e: cm_ev.append(e))
    f.node("pod0/dev0").add_on_disconnect(lambda e: cm_ev.append(e))
    addr = f.node("pod1/dev0").listen(
        depth=64, srq=None, on_disconnect=lambda e: srv_ev.append(e))
    ep = f.connect(addr, depth=64, on_disconnect=lambda e: events.append(e))
    for i in range(6):
        ep.peer.post_recv(V.RecvWR(wr_id=100 + i))
    ep.post_send([V.SendWR(wr_id=i, payload=np.array([i], np.int64))
                  for i in range(6)])
    ep.flush()
    out = dict(send_wcs=_wcs(ep.poll()), dead=sorted(f.dead_gids),
               events=[e.qp is ep.qp for e in events], srv=len(srv_ev),
               cm=[e.gid for e in cm_ev], state=ep.qp.state.name)
    refused = []
    for bad in (lambda: f.connect(addr, depth=32),
                lambda: f.node("pod1/dev0").listen(depth=32),
                lambda: f.connect(f.node("pod0/dev0").listen(
                    depth=32, srq=None), src_gid="pod1/dev0")):
        with pytest.raises(V.QPStateError):
            bad()
        refused.append(True)
    out["refused"] = refused
    out["counters"] = _counters(metrics, before)
    return out


def test_kill_after_mid_flush_flushes_survivors_and_fans_out_events():
    got = _kill_mid_flush("torch")
    _assert_same(got, _kill_mid_flush("jax"))
    assert [w[2] for w in got["send_wcs"]] == \
        [tverbs.IBV_WC_SUCCESS] * 2 + [tverbs.IBV_WC_WR_FLUSH_ERR] * 4
    assert got["events"] == [True] and got["dead"] == ["pod1/dev0"]


def _disconnects_and_kills(pkg):
    V, metrics = PACKAGES[pkg]
    before = metrics.get_registry().snapshot()
    client, server = [], []
    f = V.Fabric(pods=2, devices_per_pod=2)
    addr = f.node("pod1/dev0").listen(
        depth=32, srq=None, on_disconnect=lambda e: server.append(e))
    ep = f.connect(addr, depth=32, on_disconnect=lambda e: client.append(e))
    f.disconnect(ep)                    # the client hangs up
    ep2 = f.connect(addr, depth=32, on_disconnect=lambda e: client.append(e))
    f.disconnect(ep2.peer)              # the server hangs up
    ep3 = f.connect(f.node("pod1/dev1").listen(depth=32, srq=None),
                    depth=32)
    ep3.post_send(V.SendWR(wr_id=7, payload=np.array([1], np.int64)))
    f.kill_node("pod1/dev1")            # a device, not its pod
    alive = [f.alive(g) for g in f.gids]
    wcs = _wcs(ep3.poll())
    f.kill_pod("pod1")
    return dict(events=(len(client), len(server)), alive=alive,
                send_wcs=wcs, dead=sorted(f.dead_gids),
                counters=_counters(metrics, before))


def test_disconnect_events_and_device_and_pod_kills_match_reference():
    got = _disconnects_and_kills("torch")
    _assert_same(got, _disconnects_and_kills("jax"))
    assert got["events"] == (1, 1)
    assert got["alive"] == [True, True, True, False]
    assert got["dead"] == ["pod1/dev0", "pod1/dev1"]


def _rate_control(pkg):
    V, metrics = PACKAGES[pkg]
    f = V.Fabric(pods=2, rate_control=dict(
        line_rate=16, ecn_watermark=8, min_rate=1.0, ai_increment=4.0))
    ep = f.connect(f.node("pod1/dev0").listen(depth=256, srq=None),
                   depth=256, max_wr=256)
    for i in range(64):
        ep.peer.post_recv(V.RecvWR(wr_id=100 + i))
    ep.post_send([V.SendWR(wr_id=i, payload=np.array([i], np.int64),
                           signaled=False) for i in range(64)])
    ep.flush()
    out = dict(delivered=len(ep.peer.recv_cq.poll()),
               rounds=f.ratectl.pacing_rounds)
    scope = metrics.scope_of(f).path
    snap = metrics.get_registry().snapshot()
    out["route"] = {k[len(scope):]: v for k, v in snap.items()
                    if k.startswith(scope + "/route:")}
    for _ in range(16):
        f.process_many([ep.qp])
    out["rate"] = metrics.get_registry().snapshot()[
        f"{scope}/route:pod0/dev0->pod1/dev0/current_rate"]
    return out


def test_rate_control_marks_backs_off_and_recovers_like_reference():
    got = _rate_control("torch")
    _assert_same(got, _rate_control("jax"))
    assert got["delivered"] == 64 and got["rounds"] > 1
    assert got["route"]["/route:pod0/dev0->pod1/dev0/ecn_marks"] > 0
    assert got["rate"] == 16.0


def test_fault_and_route_scopes_rehome_under_the_fabric():
    fm = tverbs.FaultModel(0, drop=0.5)
    f = tverbs.Fabric(pods=2, faults=fm)
    assert tmetrics.scope_of(fm).path.startswith(
        tmetrics.scope_of(f).path + "/")
    f2 = tverbs.Fabric(pods=2)
    assert f2.ratectl is None
    ep = f2.connect(f2.node("pod1/dev0").listen(depth=32, srq=None),
                    depth=32)
    assert tmetrics.scope_of(ep.qp).path.startswith(
        tmetrics.scope_of(f2).path + "/")


# -- device hop and loopback ---------------------------------------------------
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_intra_pod_hop_copies_and_same_gid_stays_by_reference(kind):
    """pod0/dev0 -> pod0/dev1 materializes a copy (on the logical rig a
    copy on the tensor's own device: no host round trip); pod0/dev0 ->
    pod0/dev0 hands over the sender's own object."""
    f = tverbs.Fabric(pods=1, devices_per_pod=2)
    assert f.mesh is None               # no cards: the logical rig
    payload = np.arange(12, dtype=np.float32).reshape(3, 4)
    if kind == "tensor":
        payload = torch.from_numpy(payload)
    delivered = []
    for dst in ("pod0/dev1", "pod0/dev0"):
        ep = f.connect(f.node(dst).listen(depth=32, srq=None), depth=32,
                       src_gid="pod0/dev0")
        ep.peer.post_recv(tverbs.RecvWR(wr_id=5))
        ep.post_send(tverbs.SendWR(wr_id=5, inline=False, payload=payload))
        ep.flush()
        [wc] = ep.peer.recv_cq.poll()
        np.testing.assert_array_equal(_host(wc.data), _host(payload))
        delivered.append(wc.data)
    hop, local = delivered
    assert hop is not payload and local is payload
    if kind == "tensor":
        assert hop.data_ptr() != payload.data_ptr()
    else:
        assert not np.shares_memory(hop, payload)
    assert f.intra_pod_hops == 1


# -- the verdict hash ----------------------------------------------------------
def test_hash01_bit_equal_to_reference():
    """splitmix64 over (seed, flow, psn, attempt): a seed gives the same
    loss schedule in both packages, bit for bit."""
    rng = np.random.default_rng(11)
    tuples = np.concatenate([
        rng.integers(0, 2**63, (5000, 4), dtype=np.int64),
        rng.integers(0, 64, (5000, 4), dtype=np.int64)])
    for seed, flow, psn, attempt in tuples.tolist():
        assert tfaults._hash01(seed, flow, psn, attempt) == \
            jfaults._hash01(seed, flow, psn, attempt)
    assert tfaults._RNR_SALT == jfaults._RNR_SALT


def test_flow_ids_follow_attach_order():
    """Flow ids come from Fabric.attach order, not qp numbers, so two
    packages with different qp numbering draw the same verdicts."""
    out = {}
    for pkg, (V, _) in PACKAGES.items():
        fm = V.FaultModel(5)
        f = V.Fabric(pods=2, faults=fm)
        eps = [f.connect(f.node("pod1/dev0").listen(depth=8, srq=None),
                         depth=8) for _ in range(3)]
        out[pkg] = [fm._flows[q] for ep in eps
                    for q in (ep.peer.qp.qp_num, ep.qp.qp_num)]
    assert out["torch"] == out["jax"] == list(range(6))
