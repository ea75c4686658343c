"""The port's storage tenant held against the JAX package, on the CPU.

`repro_torch.core.offload_engine.install_list_traversal` (the server-side
list walk, one launch of `kernels/list_walk` per request; its plain
version on CPU tensors) against `repro.core.offload_engine`'s: hits, a
miss stopped by `max_hops`, the `-1` tail that wraps to the last record,
a float32 key and the `dma_launches` count, exactly; the out-of-range
`next` / `head` raise beside the reference's clamp. `SolarBlockStore`
(`read_flexins`, `read_rdma`, `read_cpu`) against `repro.core.solar` on
the same seed: data exact, checksums at rtol 1e-5 (the reference test's
tolerance). And `chip_smoke.py`'s phase 9 at a toy size."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.descriptors import OP_LIST_TRAVERSAL as J_LIST
from repro.core.offload_engine import OffloadEngine as JEngine
from repro.core.offload_engine import install_list_traversal as jinstall
from repro.core.solar import SolarBlockStore as JStore
from repro_torch import device as tdevice
from repro_torch.core.descriptors import OP_LIST_TRAVERSAL
from repro_torch.core.offload_engine import OffloadEngine, QPContext
from repro_torch.core.offload_engine import install_list_traversal
from repro_torch.core.solar import BLOCK_WORDS, SolarBlockStore, draw_blocks
from repro_torch.kernels.list_walk import ops as lw_ops

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


def _engines(rec: np.ndarray, value: int, max_hops: int):
    j = JEngine()
    j.register_dma_region("list", rec.ravel())
    jinstall(j, "list", value_size=value, max_hops=max_hops)
    t = OffloadEngine()
    t.register_dma_region("list", rec.ravel())
    install_list_traversal(t, "list", value_size=value, max_hops=max_hops)
    return j, t


def _walk_both(j, t, packet):
    want = np.asarray(j.handle_packet(J_LIST, packet))
    got = t.handle_packet(OP_LIST_TRAVERSAL, packet)
    return got.numpy(), want


@pytest.fixture(scope="module")
def seeded_list():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rng = np.random.default_rng(5)
    rec, order = chip_smoke.linked_list(np, rng, 200, 8)
    return chip_smoke, rec, order


@pytest.mark.parametrize("max_hops", [0, 1, 16, 64, 400])
def test_list_walk_matches_reference_on_a_seeded_list(seeded_list,
                                                      max_hops):
    """Hits, misses stopped by max_hops, the -1 tail (the reference's
    arr[-1]: the last record), negative heads, long walks."""
    chip_smoke, rec, order = seeded_list
    j, t = _engines(rec, 8, max_hops)
    rng = np.random.default_rng(max_hops)
    packets = [(float(rec[order[s + d], 0]), int(order[s]))
               for s, d in zip(rng.integers(0, 100, 6),
                               rng.integers(0, 100, 6))]
    packets += [(-1.0, int(order[0])), (-1.0, int(order[-3])),
                (-1.0, -1), (-1.0, -200), (float(rec[order[7], 0]), -1)]
    for packet in packets:
        got, want = _walk_both(j, t, packet)
        np.testing.assert_array_equal(got, want)
    # the chip_smoke cases, with their expected (hops, record)
    recs = torch.from_numpy(rec)
    for what, key, head, hops, exp in chip_smoke.walk_cases(rec, order, 64):
        v, h, p = lw_ops.list_traverse(recs, key, head, hops)
        assert (h, p) == exp, what
        jj, _ = _engines(rec, 8, hops)
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(jj.handle_packet(J_LIST, (key, head))))


def test_list_walk_miss_terminates_via_max_hops_like_reference():
    """`tests/test_core.py::test_list_traversal_miss_terminates_via_max_hops`:
    a cycle with an absent key stops after max_hops and answers the
    record the cursor rests on — the reference's record."""
    rec = np.zeros((3, 2 + 8), np.float32)
    rec[0] = [100, 1] + [0] * 8
    rec[1] = [200, 2] + [1] * 8
    rec[2] = [300, 0] + [2] * 8
    for max_hops in (1, 2, 7, 30):
        j, t = _engines(rec, 8, max_hops)
        got, want = _walk_both(j, t, (999.0, 0))
        assert got.shape == (8,)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, rec[max_hops % 3, 2:])


def test_list_walk_compares_the_key_as_float32_and_counts_one_launch():
    """The key crosses as float32: 0.1 (a float64 packet), an int key
    in an int64 packet and a key that only float32 rounding matches
    all find their record as in the reference; every walk counts one
    fused launch on its context."""
    rec = np.zeros((4, 4), np.float32)
    rec[:, 0] = [np.float32(0.1), 20, np.float32(16777217.0), 7]
    rec[:, 1] = [1, 2, 3, -1]
    rec[:, 2:] = np.arange(8, dtype=np.float32).reshape(4, 2)
    j, t = _engines(rec, 2, 8)
    for packet in ((0.1, 0), np.array([20, 0]), (16777217.0, 0),
                   (16777216.0, 0), (np.float64(7.0), 1), (8.5, 0)):
        got, want = _walk_both(j, t, packet)
        np.testing.assert_array_equal(got, want)
    ctx = t._qps[0]
    assert ctx.dma_launches == 6
    assert j._qps[0].dma_launches == 6


def test_out_of_range_next_and_head_raise_where_the_reference_clamps():
    """The divergence (ROADMAP Queue 3): a `next` past the records is
    clamped by the reference's indexing (here to the last record, which
    answers); the port raises IndexError, as it does for a head outside
    [-n, n) and a next that is NaN."""
    rec = np.array([[10, 1, 0], [20, 9, 1], [30, -1, 2], [40, -1, 3]],
                   np.float32)
    j, t = _engines(rec, 1, 8)
    # 0 -> 1 -> 9, read as the last record, whose next -1 ends the walk
    np.testing.assert_array_equal(
        np.asarray(j.handle_packet(J_LIST, (99.0, 0))), [3.0])
    with pytest.raises(IndexError):
        t.handle_packet(OP_LIST_TRAVERSAL, (99.0, 0))
    assert np.asarray(j.handle_packet(J_LIST, (99.0, 7))).shape == (1,)
    for head in (4, -5, 100):
        with pytest.raises(IndexError):
            t.handle_packet(OP_LIST_TRAVERSAL, (99.0, head))
    rec[1, 1] = np.nan
    _, t = _engines(rec, 1, 8)
    with pytest.raises(IndexError):
        t.handle_packet(OP_LIST_TRAVERSAL, (99.0, 0))
    # a walk that stops before the bad pointer is fine
    np.testing.assert_array_equal(
        t.handle_packet(OP_LIST_TRAVERSAL, (20.0, 0)).numpy(), [1.0])


def test_list_traverse_rejects_bad_records():
    with pytest.raises(ValueError):
        lw_ops.list_traverse(torch.zeros(4, 3, dtype=torch.float64), 1, 0, 4)
    with pytest.raises(ValueError):
        lw_ops.list_traverse(torch.zeros(4, 1), 1, 0, 4)
    with pytest.raises(TypeError):
        lw_ops.list_traverse(np.zeros((4, 3), np.float32), 1, 0, 4)


def test_blocks_are_the_reference_draw():
    np.testing.assert_array_equal(
        draw_blocks(200, 4),
        np.random.default_rng(4).standard_normal(
            (200, BLOCK_WORDS)).astype(np.float32))


@pytest.mark.parametrize("lbas", [[5, 1, 33, 60], [7], [0, 0, 63, 5, 5],
                                  list(range(64)) * 5])
def test_solar_reads_match_reference(lbas):
    """`test_solar_paths_agree` on both packages, same seed: FlexiNS
    (one custom-opcode SEND, one gather, a fused checksum), RDMA_READ
    chunks of the client's max_send_wr, and the CPU loop — data exact,
    checksums within rtol 1e-5; one fused launch per FlexiNS read."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    lbas = np.asarray(lbas, np.int32)
    j, t = JStore(64, seed=2), SolarBlockStore(64, seed=2)
    jd, jc = j.read_flexins(lbas)
    td, tc = t.read_flexins(lbas)
    cd, cc = t.read_cpu(lbas)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(td.numpy(), cd)
    np.testing.assert_array_equal(cd, j.read_cpu(lbas)[0])
    for want in (np.asarray(jc), cc):
        assert chip_smoke.crc_error(np, tc.numpy(), want) <= \
            chip_smoke.CRC_RTOL
    if lbas.tolist() == [5, 1, 33, 60]:     # the reference test's own case
        np.testing.assert_allclose(tc.numpy(), cc, rtol=1e-5)
    tr = t.read_rdma(lbas)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(j.read_rdma(lbas)))
    ctx = t.engine._qps[t.pair.server.qp_num]
    assert isinstance(ctx, QPContext) and ctx.dma_launches >= 1
    l0 = ctx.dma_launches
    t.read_flexins(lbas)
    assert ctx.dma_launches - l0 == 1


def test_reference_checksum_fails_an_elementwise_rtol_against_its_own_cpu_loop():
    """Why `chip_smoke.CRC_RTOL` scales by the request's largest
    checksum: on the reference alone, the jitted float32 sum and the
    numpy loop of `read_cpu` differ by about an ulp of the partial sums,
    which an elementwise rtol of 1e-5 rejects where a block's sum nears
    zero; against the request's largest checksum the same difference is
    more than ten times inside 1e-5."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    j = JStore(1 << 14, seed=0)
    lbas = np.random.default_rng(384).integers(0, 1 << 14, 384) \
        .astype(np.int32)
    crc = np.asarray(j.read_flexins(lbas)[1])
    crc_c = j.read_cpu(lbas)[1]
    assert not np.allclose(crc, crc_c, rtol=1e-5, atol=0)
    assert chip_smoke.crc_error(np, crc, crc_c) <= chip_smoke.CRC_RTOL / 10


def test_solar_lba_outside_the_store_raises():
    t = SolarBlockStore(16)
    for bad in ([16], [-1], [3, 99]):
        with pytest.raises(IndexError):
            t.read_flexins(np.asarray(bad))
        with pytest.raises(IndexError):
            t.read_rdma(np.asarray(bad))


def test_chip_smoke_phase9_at_cpu_size_matches_reference():
    """`chip_smoke.py`'s phase 9 — the store, Fig. 17's reads, list walks
    through OP_LIST_TRAVERSAL over the verbs pair — at a toy size on the
    CPU, and the same reads on the reference's store."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    class Clock:
        def sync(self):
            pass

        def wall(self, fn):
            fn()
            return 0.0

    Q = chip_smoke.StoreSizes(n_blocks=256, clients=(1, 4), depth=8,
                              records=512, value=8, max_hops=32, walks=6,
                              reps=1, seed=3)
    out = chip_smoke.phase_storage(torch, np, torch.device("cpu"), Q,
                                   np.random.default_rng(0), Clock())
    assert out["launches"] == {} and out["peak_gib"] is None
    assert [r["lbas"] for r in out["reads"]] == [8, 32]
    assert len(out["walks"]) == Q.walks
    assert any(hit for hit, _ in out["walks"])
    j = JStore(Q.n_blocks, seed=Q.seed)
    t = SolarBlockStore(Q.n_blocks, seed=Q.seed)
    for r in out["reads"]:
        lbas = np.random.default_rng(r["lbas"]).integers(
            0, Q.n_blocks, r["lbas"]).astype(np.int32)
        np.testing.assert_array_equal(t.read_flexins(lbas)[0].numpy(),
                                      np.asarray(j.read_flexins(lbas)[0]))
