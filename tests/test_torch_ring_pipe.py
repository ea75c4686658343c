"""The port's T3 pipe gather (`kernels/ring_pipe`) held against the JAX
package, on the CPU.

`repro_torch.kernels.ring_pipe.ops.ring_consume` takes its plain version
(`ref.consume`, an `index_select`) for CPU tensors; here it is held
exactly against the reference's Pallas kernel run in interpret mode and
against its plain `ref.reference`, on numpy-seeded inputs; the
out-of-range raise is shown beside the reference's fill and clamp; the
Fig. 10b round trip (`Ring` -> consume -> gather) matches the
reference's; and `chip_smoke.py`'s phase 2 rows for this kernel and the
list walk, and its phase 7, run at a toy size."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.descriptors import OP_KV_WRITE as J_KV_WRITE
from repro.core.descriptors import make_descriptor as jdesc
from repro.core.notification import Ring as JRing
from repro.kernels.ring_pipe import ops as jops
from repro.kernels.ring_pipe import ref as jref
from repro_torch import device as tdevice
from repro_torch.core.descriptors import OP_KV_WRITE, make_descriptor
from repro_torch.core.notification import Ring
from repro_torch.kernels.ring_pipe import ops
from repro_torch.kernels.ring_pipe import ref

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


class Clock:
    """chip_smoke's timer on a machine without a card: nothing to time."""

    def sync(self):
        pass

    def ms(self, fn, iters=20, warmup=3, cold=False, median=False):
        fn()
        return 0.0

    def wall(self, fn):
        fn()
        return 0.0


def _slots(rng, dtype, n, w):
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal((n, w)).astype(dtype)
    return rng.integers(0, 200, (n, w)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
@pytest.mark.parametrize("n", [0, 1, 13, 64])
def test_ring_consume_matches_pallas_kernel_and_plain_reference(dtype, n):
    rng = np.random.default_rng(n)
    slots = _slots(rng, dtype, 32, 24)
    idx = rng.integers(0, 32, n)          # repeats when n > 1
    got = ops.ring_consume(torch.from_numpy(slots), idx)
    assert got.dtype == torch.from_numpy(slots).dtype
    assert tuple(got.shape) == (n, 24)
    plain = np.asarray(jref.reference(jnp.asarray(slots), idx))
    np.testing.assert_array_equal(got.numpy(), plain)
    np.testing.assert_array_equal(got.numpy(), slots[idx])
    if n:       # the Pallas grid cannot be empty, even in interpret mode
        kern = np.asarray(jops.ring_consume(
            jnp.asarray(slots), jnp.asarray(idx, jnp.int32), interpret=True))
        np.testing.assert_array_equal(got.numpy(), kern)


def test_device_tensor_index_and_plain_version_agree():
    rng = np.random.default_rng(1)
    slots = torch.from_numpy(_slots(rng, np.float32, 16, 5))
    idx = torch.from_numpy(rng.permutation(16))
    got = ops.ring_consume(slots, idx)
    assert torch.equal(got, ref.consume(slots, idx))
    assert torch.equal(got, slots[idx])


def test_out_of_range_index_raises_where_the_reference_fills_or_clamps():
    """The divergence (ROADMAP Queue 3): the reference's plain version
    fills a row at an index past the slots (NaN for floats) and its
    Pallas BlockSpec clamps it to the last slot; the port raises
    IndexError before anything is gathered."""
    slots = np.arange(12, dtype=np.float32).reshape(4, 3)
    bad = np.array([1, 5])
    plain = np.asarray(jref.reference(jnp.asarray(slots), bad))
    assert np.isnan(plain[1]).all()
    kern = np.asarray(jops.ring_consume(jnp.asarray(slots),
                                        jnp.asarray(bad, jnp.int32),
                                        interpret=True))
    np.testing.assert_array_equal(kern[1], slots[3])
    for idx in ([1, 5], [4], [-1], [0, -5]):
        with pytest.raises(IndexError):
            ops.ring_consume(torch.from_numpy(slots), np.asarray(idx))


def test_wrapper_rejects_bad_slots():
    with pytest.raises(TypeError):
        ops.ring_consume(np.zeros((4, 3), np.float32), [0])
    with pytest.raises(ValueError):
        ops.ring_consume(torch.zeros(4, 3, 2), [0])
    with pytest.raises(ValueError):
        ops.ring_consume(torch.zeros(3, 4).t(), [0])
    with pytest.raises(ValueError):
        ops.ring_consume(torch.zeros(4, 3, device="meta"), [0])


@pytest.mark.parametrize("device_ring", [False, True])
def test_fig10b_round_trip_matches_reference(device_ring):
    """`benchmarks/bench_transfer.py`'s Fig. 10b round trip — produce a
    descriptor, drain it, gather its payload slot — and a drained batch
    of OP_KV_WRITE descriptors naming a seeded permutation of the slots,
    on the port's host and device rings, against the reference's ring
    and interpret-mode kernel; ring DMA counters equal."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    rng = np.random.default_rng(1)
    slots = rng.standard_normal((64, 16)).astype(np.float32)
    src = rng.permutation(64)
    jr, tr = JRing(64), Ring(64, device=device_ring)
    ts = torch.from_numpy(slots)

    def jrt(descs):
        jr.produce(descs)
        d = jr.consume()
        return np.asarray(jops.ring_consume(
            jnp.asarray(slots), jnp.asarray(d[:, 1], jnp.int32),
            interpret=True))

    for _ in range(2):
        for descs, jdescs in (
                (np.stack([make_descriptor(OP_KV_WRITE, src=int(s), dst=i)
                           for i, s in enumerate(src)]),
                 np.stack([jdesc(J_KV_WRITE, src=int(s), dst=i)
                           for i, s in enumerate(src)])),
                (make_descriptor(OP_KV_WRITE, src=3)[None],
                 jdesc(J_KV_WRITE, src=3)[None])):
            got = chip_smoke.t3_round_trip(tr, ts, descs, ops.ring_consume)
            want = jrt(jdescs)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                got.numpy(), slots[descs[:, 1]])
        tr.force_publish()
        jr.force_publish()
    assert (tr.dma_writes, tr.dma_reads, tr.head, tr.tail) == \
           (jr.dma_writes, jr.dma_reads, jr.head, jr.tail)


def test_chip_smoke_phase7_at_cpu_size_matches_reference():
    """`chip_smoke.py`'s phase 7 (host and device rings, a drained batch
    of every slot, one descriptor) at a toy size on the CPU: its
    payloads equal the reference's gather of the same slots."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    P = chip_smoke.PipeSizes(slots=64, width=16, reps=2)
    rng = np.random.default_rng(0)
    out = chip_smoke.phase_t3(torch, np, torch.device("cpu"), P, rng,
                              Clock())
    assert out["launches"] == {}
    assert set(out["timing"]) == {"host", "device"}
    for t in out["timing"].values():
        assert t["dma_writes"] == 2 + 2 * P.reps
    # the same draws, replayed: the slots come from a torch generator
    # seeded from the numpy stream, the permutation from the stream
    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(int(rng.integers(1 << 31)))
    slots = torch.randn((P.slots, P.width), generator=g)
    src = rng.permutation(P.slots)
    want = np.asarray(jref.reference(jnp.asarray(slots.numpy()), src))
    np.testing.assert_array_equal(out["payload"].numpy(), want)


def test_chip_smoke_pipe_kernel_rows_at_cpu_size():
    """`chip_smoke.py`'s phase 2 rows for ring_pipe_consume and
    list_traverse (exactness, edge cases, the index raises) at a toy
    size on the CPU, where both wrappers take their plain versions."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    P = chip_smoke.PipeSizes(slots=64, width=16, reps=1)
    Q = chip_smoke.StoreSizes(n_blocks=64, clients=(1,), depth=4,
                              records=256, value=4, max_hops=16, walks=2,
                              reps=1, seed=0)
    rows = chip_smoke.phase_pipe_kernels(
        torch, np, torch.device("cpu"), P, Q, np.random.default_rng(0),
        Clock())
    assert set(rows) == {"ring_pipe", "list_walk"}
    assert rows["ring_pipe"]["entry"] == "ring_pipe_consume"
    assert rows["list_walk"]["entry"] == "list_traverse"
    assert rows["ring_pipe"]["max_abs_err"] == 0.0
    assert rows["ring_pipe"]["bound_by"] == "bytes"
