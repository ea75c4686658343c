"""The torch port's verbs datapath held bit-exact against the JAX package.

The same seeded chains run through `repro.verbs` (the reference) and
`repro_torch.verbs` (on the CPU, where every kernel wrapper takes its
plain version), vectorized and scalar, with `ProtectionDomain._next_key`
pinned in both packages so the WRs address the same keys: completions,
MR contents, stall points, stalled descriptors and registry counter
deltas must all agree. Tolerance is exact: the datapath moves data and
does no arithmetic."""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # offline rig: sampled fallback
    from _hyp import given, settings, st

from repro import verbs as jverbs
from repro.core import notification as jnotification
from repro.core import offload_engine as joffload
from repro.obs import metrics as jmetrics
from repro_torch import device as tdevice
from repro_torch import verbs as tverbs
from repro_torch.convert import regions_from_numpy, to_host
from repro_torch.core import notification as tnotification
from repro_torch.core import offload_engine as toffload
from repro_torch.obs import metrics as tmetrics

PACKAGES = {"jax": (jverbs, jmetrics), "torch": (tverbs, tmetrics)}
_COUNTERS = ("doorbell_writes", "desc_fetch_dmas", "dma_writes", "dma_reads",
             "launches", "ring_launches", "dma_launches")


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


def _host(x):
    return None if x is None else np.asarray(to_host(x))


def _counters(metrics, before, after) -> dict:
    """Registry counter deltas summed per instance-free path, restricted
    to the datapath contract counters."""
    reg = metrics.get_registry()
    out: dict = {}
    for path, v in reg.diff(before, after).items():
        if path.rsplit("/", 1)[-1] in _COUNTERS and isinstance(v, int):
            key = reg.group_key(path)
            out[key] = out.get(key, 0) + v
    return {k: v for k, v in out.items() if v}


# -- dispatch: the test_line_rate chain property, across packages ------------
_KINDS = ["send_inline", "send_f64", "send_u8", "send_big", "send_unsig",
          "send_mr", "write", "write_f64", "write_bad", "read", "read_land"]
# one-sided WRs naming a record outside an MR: the remote MR (WRITE,
# READ) or the local landing MR (READ). The port completes them with
# IBV_WC_ACCESS_ERR and moves nothing, which is what the reference does
# for a bad rkey — so `oob_as_bad_key` turns them into bad-rkey WRs.
_OOB_KINDS = ["write_oob", "read_oob", "land_oob"]


def _run_chain(pkg, kinds, n_recv, use_srq, vectorized,
               oob_as_bad_key=False):
    """Post one mixed WQE chain and return everything observable."""
    V, metrics = PACKAGES[pkg]
    V.ProtectionDomain._next_key = 0x7000
    before = metrics.get_registry().snapshot()
    srq = V.SharedReceiveQueue(max_wr=256) if use_srq else None
    pair = V.VerbsPair(depth=1024, publish_every=8, srq=srq,
                       vectorized=vectorized)
    dst = pair.pd.reg_mr("dst", np.zeros((8, 4), np.float32))
    src = pair.pd.reg_mr("src", np.arange(32, dtype=np.float32)
                         .reshape(8, 4))
    land = pair.pd.reg_mr("land", np.zeros((8, 4), np.float32))
    rng = np.random.default_rng(len(kinds) * 101 + n_recv)
    recvs = [V.RecvWR(wr_id=100 + i) for i in range(n_recv)]
    if use_srq:
        srq.post_recv(recvs)
    else:
        for r in recvs:
            pair.server.post_recv(r)
    wrs = []
    for i, kind in enumerate(kinds):
        if kind == "send_inline":
            wrs.append(V.SendWR(wr_id=i, payload=np.array(
                [i, 7, i * i], np.int32)))
        elif kind == "send_f64":
            wrs.append(V.SendWR(wr_id=i, payload=np.array(
                [i + 0.5, -i], np.float64)))
        elif kind == "send_u8":
            wrs.append(V.SendWR(wr_id=i, payload=np.arange(
                1 + i % 7, dtype=np.uint8)))
        elif kind == "send_mr":
            k = int(rng.integers(1, 4))
            wrs.append(V.SendWR(wr_id=i, payload=None, mr=src,
                                offsets=rng.choice(8, size=k, replace=False)))
        elif kind == "send_big":
            wrs.append(V.SendWR(wr_id=i, inline=False, payload=rng
                                .standard_normal(40).astype(np.float32)))
        elif kind == "send_unsig":
            wrs.append(V.SendWR(wr_id=i, signaled=False,
                                payload=np.array([i], np.int64)))
        elif kind in ("write", "write_f64", "write_bad", "write_oob"):
            k = int(rng.integers(1, 4))
            offs = rng.choice(8, size=k, replace=False)
            pay = rng.standard_normal((k, 4))
            bad = kind == "write_bad" or (kind == "write_oob"
                                          and oob_as_bad_key)
            if kind == "write_oob" and not oob_as_bad_key:
                offs[-1] = 8                # one record past the MR
            wrs.append(V.SendWR(
                wr_id=i, opcode=V.IBV_WR_RDMA_WRITE,
                remote_key=0xDEAD if bad else dst.rkey,
                remote_offsets=offs,
                payload=pay if kind == "write_f64" else
                pay.astype(np.float32)))
        elif kind in ("read", "read_land", "read_oob", "land_oob"):
            k = int(rng.integers(1, 4))
            offs = rng.choice(8, size=k, replace=False)
            extra = {} if kind in ("read", "read_oob") else dict(
                mr=land, offsets=rng.choice(8, size=k, replace=False))
            oob = kind in _OOB_KINDS and not oob_as_bad_key
            if oob and kind == "read_oob":
                offs[0] = -1                # before the MR
            elif oob:
                extra["offsets"][-1] = 9    # past the local landing MR
            wrs.append(V.SendWR(
                wr_id=i, opcode=V.IBV_WR_RDMA_READ,
                remote_key=0xDEAD if kind in _OOB_KINDS and oob_as_bad_key
                else dst.rkey, remote_offsets=offs, **extra))
    pair.client.post_send(wrs)
    processed = pair.client.flush()
    out = dict(
        processed=processed, stalled=len(pair.client.sq),
        send_wcs=pair.client_cq.poll(), recv_wcs=pair.server_recv_cq.poll(),
        regions={n: _host(pair.pd.engine.regions[n])
                 for n in ("dst", "src", "land")},
        descs=[np.asarray(ps.desc) for ps in pair.client.sq])
    out["counters"] = _counters(metrics, before,
                                metrics.get_registry().snapshot())
    return out


def _assert_same(a, b, counters=True):
    assert a["processed"] == b["processed"]
    assert a["stalled"] == b["stalled"]
    for name, ra in a["regions"].items():
        rb = b["regions"][name]
        assert ra.dtype == rb.dtype, name
        np.testing.assert_array_equal(ra, rb)
    assert len(a["descs"]) == len(b["descs"])
    for da, db in zip(a["descs"], b["descs"]):
        np.testing.assert_array_equal(da, db)      # stalled WQEs bit-equal
    for key in ("send_wcs", "recv_wcs"):
        wa, wb = a[key], b[key]
        assert [(w.wr_id, w.opcode, w.status, w.length) for w in wa] == \
               [(w.wr_id, w.opcode, w.status, w.length) for w in wb], key
        for x, y in zip(wa, wb):
            hx, hy = _host(x.data), _host(y.data)
            if hx is None or hy is None:
                assert hx is None and hy is None
            else:
                assert hx.dtype == hy.dtype
                np.testing.assert_array_equal(hx, hy)
    if counters:
        assert a["counters"] == b["counters"]


@settings(max_examples=25, deadline=None)
@given(st.lists(st.sampled_from(_KINDS), min_size=1, max_size=24),
       st.integers(0, 24), st.sampled_from([False, True]),
       st.sampled_from([False, True]))
def test_dispatch_matches_reference(kinds, n_recv, use_srq, vectorized):
    """Random opcode mixes + random recv budgets (mid-chain RNR stalls
    when the budget runs short), both dispatch paths: the port matches
    the reference on completions, MR contents, stall points, stalled
    descriptors and counter deltas."""
    _assert_same(_run_chain("torch", kinds, n_recv, use_srq, vectorized),
                 _run_chain("jax", kinds, n_recv, use_srq, vectorized))


@settings(max_examples=10, deadline=None)
@given(st.lists(st.sampled_from(_KINDS), min_size=1, max_size=24),
       st.integers(0, 24), st.sampled_from([False, True]))
def test_port_vectorized_matches_port_oracle(kinds, n_recv, use_srq):
    """Inside the port, the batch-wise dispatch stays bit-exact with the
    element-at-a-time oracle (launch counters legitimately differ)."""
    _assert_same(_run_chain("torch", kinds, n_recv, use_srq, True),
                 _run_chain("torch", kinds, n_recv, use_srq, False),
                 counters=False)


@settings(max_examples=10, deadline=None)
@given(st.lists(st.sampled_from(_KINDS + _OOB_KINDS), min_size=1,
                max_size=16),
       st.integers(0, 16), st.sampled_from([False, True]))
def test_out_of_range_wrs_fail_like_a_bad_key(kinds, n_recv, vectorized):
    """A WRITE or READ naming a record outside the remote MR, or a READ
    landing outside its local MR, completes with IBV_WC_ACCESS_ERR and
    moves nothing, in its place in the chain: the port's run equals the
    reference's run of the same chain with those WRs given a bad rkey —
    completions, MR contents and counters — on both dispatch paths."""
    a = _run_chain("torch", kinds, n_recv, True, vectorized)
    b = _run_chain("jax", kinds, n_recv, True, vectorized,
                   oob_as_bad_key=True)
    # a stalled WQE carries its rkey and offsets, which differ by design
    assert len(a["descs"]) == len(b["descs"])
    a["descs"] = b["descs"] = []
    _assert_same(a, b)


@pytest.mark.parametrize("vectorized", [True, False])
def test_out_of_range_wrs_leave_the_datapath_working(vectorized):
    """Out-of-range WRs mid-chain fail alone: the good WRs around them
    complete, nothing stays queued on the server's context, and the next
    flush of the same pair works."""
    pair = tverbs.VerbsPair(depth=64, vectorized=vectorized)
    dst = pair.pd.reg_mr("dst", np.zeros((8, 4), np.float32))
    land = pair.pd.reg_mr("land", np.zeros((8, 4), np.float32))
    W, R = tverbs.IBV_WR_RDMA_WRITE, tverbs.IBV_WR_RDMA_READ

    def write(i, offs):
        return tverbs.SendWR(wr_id=i, opcode=W, remote_key=dst.rkey,
                             remote_offsets=offs, payload=np.full(
                                 (len(offs), 4), i, np.float32))

    def read(i, offs, landing=None):
        extra = {} if landing is None else dict(mr=land, offsets=landing)
        return tverbs.SendWR(wr_id=i, opcode=R, remote_key=dst.rkey,
                             remote_offsets=offs, **extra)

    pair.client.post_send([write(1, [0]), write(2, [8]), write(3, [1, -1]),
                           write(4, [2]), read(5, [0]), read(6, [1 << 40]),
                           read(7, [0, 2], landing=[3, 8]),
                           read(8, [2], landing=[4])])
    assert pair.client.flush() == 8
    wcs = pair.client_cq.poll()
    assert [(w.wr_id, w.status) for w in wcs] == [
        (1, 0), (2, tverbs.IBV_WC_ACCESS_ERR), (3, tverbs.IBV_WC_ACCESS_ERR),
        (4, 0), (5, 0), (6, tverbs.IBV_WC_ACCESS_ERR),
        (7, tverbs.IBV_WC_ACCESS_ERR), (8, 0)]
    np.testing.assert_array_equal(_host(wcs[4].data), np.full((1, 4), 1.0))
    ctx = pair.server.ctx
    assert len(ctx._dma_done) == len(ctx._dma_queue)    # nothing left queued
    got = _host(pair.pd.mr_array(dst))
    np.testing.assert_array_equal(got[:3], [[1] * 4, [0] * 4, [4] * 4])
    np.testing.assert_array_equal(_host(pair.pd.mr_array(land))[4], [4] * 4)
    pair.client.post_send([write(9, [7]), read(10, [7])])
    assert pair.client.flush() == 2
    wcs = pair.client_cq.poll()
    assert [(w.wr_id, w.status) for w in wcs] == [(9, 0), (10, 0)]
    np.testing.assert_array_equal(_host(wcs[1].data), np.full((1, 4), 9.0))


def test_out_of_range_dma_and_recv_postings_are_refused():
    """submit_dma refuses an out-of-range op before queueing it, so a
    handler's bad request leaves its context working; post_recv refuses
    a recv WR whose offsets fall outside its MR."""
    eng = toffload.OffloadEngine()
    eng.register_dma_region("kv", np.arange(64, dtype=np.float32))
    op = toffload.install_batched_read(eng, "kv", value_size=4)
    with pytest.raises(IndexError):
        eng.handle_packet(op, np.array([1, 16]))
    np.testing.assert_array_equal(
        _host(eng.handle_packet(op, np.array([15, 0]))),
        np.r_[np.arange(60, 64), np.arange(4)].astype(np.float32))
    ctx = toffload.QPContext(1, eng)
    with pytest.raises(IndexError):
        ctx.submit_dma("WRITE", "kv", np.array([64]), 1, buf=np.zeros(1))
    assert not ctx._dma_queue
    srq = tverbs.SharedReceiveQueue(max_wr=8)
    pair = tverbs.VerbsPair(srq=srq)
    mr = pair.pd.reg_mr("m", np.zeros((4, 2), np.float32))
    with pytest.raises(IndexError):
        srq.post_recv([tverbs.RecvWR(wr_id=1, mr=mr, offsets=[0]),
                       tverbs.RecvWR(wr_id=2, mr=mr, offsets=[4])])
    assert len(srq) == 0
    plain = tverbs.VerbsPair()
    mr = plain.pd.reg_mr("m", np.zeros((4, 2), np.float32))
    with pytest.raises(IndexError):
        plain.server.post_recv(tverbs.RecvWR(wr_id=1, mr=mr, offsets=[-1]))
    assert not plain.server.rq


def test_rnr_mid_chain_stalls_identically():
    kinds = ["send_big"] * 5 + ["write"] + ["send_big"] * 3
    for use_srq in (False, True):
        a = _run_chain("torch", kinds, 4, use_srq, vectorized=True)
        b = _run_chain("jax", kinds, 4, use_srq, vectorized=True)
        assert a["processed"] == b["processed"] == 4
        assert a["stalled"] == b["stalled"] == 5
        _assert_same(a, b)


# -- launch contracts ---------------------------------------------------------
def _launches_per_flush(kind: str, n: int = 32) -> float:
    """fused/launches delta around one flush of an n-WR chain."""
    srq = tverbs.SharedReceiveQueue(max_wr=2 * n)
    pair = tverbs.VerbsPair(srq=srq, depth=4 * n, max_wr=2 * n)
    dst = pair.pd.reg_mr("dst", np.zeros((n, 4), np.float32))
    src = pair.pd.reg_mr("src", np.ones((n, 4), np.float32))
    srq.post_recv([tverbs.RecvWR(wr_id=i) for i in range(n)])
    if kind == "write":
        wrs = [tverbs.SendWR(wr_id=i, opcode=tverbs.IBV_WR_RDMA_WRITE,
                             remote_key=dst.rkey, remote_offsets=[i],
                             payload=np.full((1, 4), i, np.float32))
               for i in range(n)]
    elif kind == "read":
        wrs = [tverbs.SendWR(wr_id=i, opcode=tverbs.IBV_WR_RDMA_READ,
                             remote_key=dst.rkey, remote_offsets=[i])
               for i in range(n)]
    elif kind == "send_mr":
        wrs = [tverbs.SendWR(wr_id=i, mr=src, offsets=[i], inline=False)
               for i in range(n)]
    else:
        wrs = [tverbs.SendWR(wr_id=i, payload=np.arange(8, dtype=np.int32))
               for i in range(n)]
    fused = tmetrics.get_registry().scope("fused").counter("launches")
    pair.client.post_send(wrs)
    before = fused.value
    pair.client.flush()
    return float(fused.value - before)


@pytest.mark.parametrize("kind,expected", [("write", 1.0), ("read", 1.0),
                                           ("send_mr", 1.0),
                                           ("send_inline", 0.0)])
def test_launches_per_flush(kind, expected):
    assert _launches_per_flush(kind) == expected


# -- ring / CQ ------------------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(st.integers(3, 17), st.integers(1, 12),
       st.lists(st.integers(-3, 9), min_size=1, max_size=40),
       st.sampled_from([False, True]))
def test_ring_matches_reference(capacity, publish_every, ops, device):
    """Random produce/consume interleavings across many wraparound laps:
    the port's ring (host or device-resident) matches the reference's
    element-at-a-time ring on every drained descriptor, the slot/flag
    memory, the protocol state and the DMA counters."""
    rings = [tnotification.Ring(capacity, publish_every=publish_every,
                                device=device),
             jnotification.Ring(capacity, publish_every=publish_every,
                                vectorized=False)]
    seq = 0
    for op in ops:
        if op <= 0:
            got = [r.consume(None if op == 0 else -op) for r in rings]
            np.testing.assert_array_equal(got[0], got[1])
        else:
            r0 = rings[0]
            n = min(op, r0.capacity - (r0.head - r0._published_tail))
            if n <= 0:
                continue
            batch = np.arange(seq * 8, (seq + n) * 8,
                              dtype=np.int64).reshape(n, 8)
            seq += n
            assert rings[0].produce(batch) == rings[1].produce(batch) == n
    for a, b in zip(rings[0].consume(), rings[1].consume()):
        np.testing.assert_array_equal(a, b)
    t, j = rings
    assert (t.head, t.tail, t._published_tail, t._since_publish) == \
           (j.head, j.tail, j._published_tail, j._since_publish)
    assert (t.dma_writes, t.dma_reads) == (j.dma_writes, j.dma_reads)
    np.testing.assert_array_equal(t.slots_view(), j.slots_view())
    np.testing.assert_array_equal(t.flags_view(), j.flags_view())


def test_fused_poll_matches_reference():
    """enable_fused_poll on both packages: each poll of a CQ with staged
    CQEs is ONE produce_consume launch, with the reference's CQE stream."""
    from repro.verbs import wqe
    cqs, counts = [], []
    for V, metrics in (PACKAGES["torch"], PACKAGES["jax"]):
        cqs.append(V.CompletionQueue(64, 8, device_ring=True)
                   .enable_fused_poll())
        counts.append(metrics.get_registry().scope("fused")
                      .counter("ring_launches"))
    for batch in ([0, 1, 2], [3], list(range(4, 20)), []):
        launches, polled = [], []
        for q, c in zip(cqs, counts):
            for i in batch:
                q.push(wqe.encode_cqe(wr_id=i, opcode=0, status=0,
                                      length=8), data=f"p{i}")
            before = c.value
            polled.append([(w.wr_id, w.status, w.length, w.data)
                           for w in q.poll()])
            launches.append(c.value - before)
        assert polled[0] == polled[1]
        assert launches == [1 if batch else 0] * 2
    for q in cqs:
        for i in range(30, 40):
            q.push(wqe.encode_cqe(wr_id=i, opcode=0, status=0, length=0))
    assert [w.wr_id for w in cqs[0].poll(4)] == \
           [w.wr_id for w in cqs[1].poll(4)] == list(range(30, 34))
    assert [w.wr_id for w in cqs[0].poll()] == \
           [w.wr_id for w in cqs[1].poll()] == list(range(34, 40))


def test_auto_device_depth_policy():
    """`device=None` resolves through DEVICE_RING_AUTO_DEPTH for the
    ring's torch device type; explicit kwargs and the oracle win, and
    with no measured entry for the device type every ring stays on the
    host: the CPU has none, the card's (4096) is the depth at which
    chip_smoke.py phase 7's crossover found the device ring ahead."""
    assert "cpu" not in tnotification.DEVICE_RING_AUTO_DEPTH
    assert tnotification.DEVICE_RING_AUTO_DEPTH.get("cuda") == 4096
    assert not tnotification.Ring(8192).device
    tnotification.DEVICE_RING_AUTO_DEPTH["cpu"] = 64
    try:
        assert tnotification.Ring(64).device
        assert not tnotification.Ring(32).device
        assert not tnotification.Ring(128, device=False).device
        assert tnotification.Ring(16, device=True).device
        assert not tnotification.Ring(128, vectorized=False).device
        assert tverbs.CompletionQueue(128, 8).ring.device
    finally:
        del tnotification.DEVICE_RING_AUTO_DEPTH["cpu"]


# -- the device-ring rig of chip_smoke, at CPU size ---------------------------
def _smoke_rig(pkg, vectorized, n_blocks=64, rec=16, n=24):
    """The chip_smoke.py main path at a small size: blocks on the server,
    `local` on the client, an SRQ, and (vectorized) a device-resident
    server recv CQ with the fused poll armed."""
    V, metrics = PACKAGES[pkg]
    V.ProtectionDomain._next_key = 0x9000
    before = metrics.get_registry().snapshot()
    rng = np.random.default_rng(7)
    blocks = rng.standard_normal((n_blocks, rec)).astype(np.float32)
    local = rng.standard_normal((n, rec)).astype(np.float32)
    pd = V.ProtectionDomain()
    if pkg == "torch":
        mrs = regions_from_numpy(pd, {"blocks": blocks, "local": local})
    else:
        mrs = {k: pd.reg_mr(k, a) for k, a in
               (("blocks", blocks), ("local", local))}
    t = V.LoopbackTransport(vectorized=vectorized)
    srq = V.SharedReceiveQueue(max_wr=4 * n + 16)
    ccq, scq = (V.CompletionQueue(4 * n, 8, vectorized) for _ in range(2))
    rcq = V.CompletionQueue(2 * n, 8, vectorized, device_ring=vectorized)
    if vectorized:
        rcq.enable_fused_poll()
    client = V.QueuePair(pd, ccq, max_send_wr=4 * n, vectorized=vectorized)
    server = V.QueuePair(pd, scq, rcq, srq=srq, vectorized=vectorized)
    V.connect(client, server, t)
    offs = rng.choice(n_blocks, size=n, replace=False)
    seen = []
    W, R = V.IBV_WR_RDMA_WRITE, V.IBV_WR_RDMA_READ
    blk, loc = mrs["blocks"], mrs["local"]
    chains = [
        [V.SendWR(wr_id=i, opcode=W, remote_key=blk.rkey,
                  remote_offsets=[int(o)], payload=local[i:i + 1] * 2)
         for i, o in enumerate(offs)],
        [V.SendWR(wr_id=i, opcode=R, remote_key=blk.rkey,
                  remote_offsets=[int(o)], mr=loc, offsets=[i])
         for i, o in enumerate(offs)],
        [V.SendWR(wr_id=i, mr=loc, offsets=[i], inline=False)
         for i in range(n)],
        [V.SendWR(wr_id=i, payload=np.arange(8, dtype=np.int32) + i)
         for i in range(4 * n)],          # two laps of the recv ring
        [V.SendWR(wr_id=i, opcode=W, remote_key=blk.rkey,
                  remote_offsets=[int(offs[i])], payload=local[i:i + 1])
         if i % 4 == 0 else
         V.SendWR(wr_id=i, opcode=R, remote_key=blk.rkey,
                  remote_offsets=[int(offs[i])])
         if i % 4 == 1 else
         V.SendWR(wr_id=i, mr=loc, offsets=[i % n], inline=False)
         if i % 4 == 2 else
         V.SendWR(wr_id=i, opcode=W, remote_key=0xDEAD,
                  remote_offsets=[0], payload=local[:1])
         for i in range(16)],
    ]
    budgets = [0, 0, n, 4 * n, 2]       # a short budget: RNR mid-chain
    for chain, budget in zip(chains, budgets):
        srq.post_recv([V.RecvWR(wr_id=1000 + k) for k in range(budget)])
        client.post_send(chain)
        seen.append((client.flush(), len(client.sq)))
        seen.append([(w.wr_id, w.opcode, w.status, w.length, _host(w.data))
                     for q in (ccq, rcq) for w in q.poll()])
    srq.post_recv([V.RecvWR(wr_id=2000 + k) for k in range(8)])
    seen.append((client.flush(), len(client.sq)))
    seen.append([(w.wr_id, w.opcode, w.status, w.length, _host(w.data))
                 for q in (ccq, rcq) for w in q.poll()])
    regions = {k: _host(pd.engine.regions[k]) for k in ("blocks", "local")}
    return seen, regions, _counters(metrics, before,
                                    metrics.get_registry().snapshot())


def _same_stream(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert x == y
            continue
        assert [w[:4] for w in x] == [w[:4] for w in y]
        for wx, wy in zip(x, y):
            if wx[4] is None or wy[4] is None:
                assert wx[4] is None and wy[4] is None
            else:
                np.testing.assert_array_equal(wx[4], wy[4])


def test_smoke_rig_matches_reference_and_oracle():
    """The chip_smoke main path at CPU size: the port's device-ring rig
    matches the reference's identical rig (counters included) and the
    port's scalar oracle (CQE streams and MR contents)."""
    vec, vec_mr, vec_c = _smoke_rig("torch", True)
    ref, ref_mr, ref_c = _smoke_rig("jax", True)
    orc, orc_mr, _ = _smoke_rig("torch", False)
    for other, other_mr in ((ref, ref_mr), (orc, orc_mr)):
        _same_stream(vec, other)
        for k in vec_mr:
            np.testing.assert_array_equal(vec_mr[k], other_mr[k])
    assert vec_c == ref_c
    assert vec_c["fused/ring_launches"] > 0
    _, _, orc_c = _smoke_rig("torch", False)
    for k in ("qp/doorbell_writes", "qp/desc_fetch_dmas",
              "cq/ring/dma_writes", "cq/ring/dma_reads"):
        assert vec_c[k] == orc_c[k], k


# -- engine / registration ----------------------------------------------------
def test_install_batched_read_matches_reference():
    region = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    offs = np.array([5, 1, 9, 1, 0], np.int64)
    out = []
    for mod, metrics in ((toffload, tmetrics), (joffload, jmetrics)):
        eng = mod.OffloadEngine()
        eng.register_dma_region("kv", region)
        op = mod.install_batched_read(eng, "kv", value_size=4)
        fused = metrics.get_registry().scope("fused").counter("launches")
        before = fused.value
        resp = eng.handle_packet(op, offs)
        ctx = eng._qps[0]
        out.append((_host(resp), ctx.dma_launches, fused.value - before))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:] == (1, 1)


@pytest.mark.parametrize("src,demoted", [
    (np.float64, np.float32), (np.int64, np.int32), (np.float32, np.float32),
    (np.uint8, np.uint8)])
def test_reg_mr_demotes_like_reference(src, demoted):
    arr = (np.arange(24).reshape(6, 4) * 1.37).astype(src)
    jmr = jverbs.ProtectionDomain()
    tmr = tverbs.ProtectionDomain()
    j = np.asarray(jmr.engine.regions[jmr.reg_mr("m", arr).name])
    mr = tmr.reg_mr("m", arr)
    t = _host(tmr.mr_array(mr))
    assert j.dtype == t.dtype == np.dtype(demoted)
    np.testing.assert_array_equal(t, j)
    assert mr.record == 4 and mr.n_records == 6 and mr.shape == (6, 4)
    t[0, 0] = 99                          # the region is the pd's copy
    assert arr[0, 0] != 99 or src == np.uint8


def test_submit_dma_snapshots_tensor_buffers():
    """A tensor source mutated after submit_dma must not change what
    lands (JAX arrays are immutable; torch tensors are not)."""
    eng = toffload.OffloadEngine()
    eng.register_dma_region("mem", np.zeros((4, 2), np.float32))
    ctx = toffload.QPContext(0, eng)
    scratch = torch.full((1, 2), 1.0)
    ctx.submit_dma("WRITE", "mem", np.array([0]), 2, buf=scratch)
    scratch[:] = 9.0
    ctx.submit_dma("WRITE", "mem", np.array([1]), 2, buf=scratch)
    ctx._flush()
    got = _host(eng.regions["mem"])
    np.testing.assert_allclose(got[0], 1.0)
    np.testing.assert_allclose(got[1], 9.0)
