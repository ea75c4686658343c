"""The port's kernel modules held against the JAX package, on the CPU.

On a CPU tensor each wrapper of `repro_torch.kernels` runs its plain
PyTorch version (`ref.py`); these tests hold those against the reference
kernels on seeded numpy inputs — `wr_scatter` in Pallas interpret mode
and through its `ref.py`, the gather and the desc_ring ops through their
jitted CPU versions and oracles. The CUDA kernels themselves run only on
the card, where `chip_smoke.py` holds each against the same plain
versions. Tolerance is exact: these kernels move data and do no
arithmetic."""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.desc_ring import ops as jring
from repro.kernels.desc_ring import ref as jring_ref
from repro.kernels.wr_scatter import ops as jops
from repro.kernels.wr_scatter import ref as jref
from repro.kernels.wr_scatter.wr_scatter import wr_scatter
from repro_torch import device as tdevice
from repro_torch.kernels import _build
from repro_torch.kernels.desc_ring import ops as tring
from repro_torch.kernels.desc_ring import ref as tring_ref
from repro_torch.kernels.wr_scatter import ops as tops
from repro_torch.kernels.wr_scatter import ref as tref
from repro_torch.obs import metrics as tmetrics


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


# dtype -> (record shape, numpy value maker); record byte widths 16, 12,
# 10 and 14: only float32 rows are a multiple of 16 bytes
_DTYPES = {
    "float32": ((4,), lambda r, s: r.standard_normal(s).astype(np.float32)),
    "int32": ((3,), lambda r, s: r.integers(-2**31, 2**31 - 1, s,
                                            dtype=np.int32)),
    "uint8": ((5, 2), lambda r, s: r.integers(0, 256, s, dtype=np.uint8)),
    "bfloat16": ((7,), lambda r, s: r.standard_normal(s).astype(
        ml_dtypes.bfloat16)),
}


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or a (jax/numpy) array, for exact
    comparison across dtypes numpy lacks."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("m", [1, 5, 64])
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_scatter_matches_pallas_and_ref(dtype, m):
    rec, make = _DTYPES[dtype]
    rng = np.random.default_rng(m * 7 + len(dtype))
    R = 80
    region = make(rng, (R,) + rec)
    vals = make(rng, (m,) + rec)
    offs = rng.choice(R, size=m, replace=False)
    pallas = wr_scatter(jnp.asarray(region), jnp.asarray(vals),
                        offs.astype(np.int32), interpret=True)
    oracle = jref.reference(jnp.asarray(region), jnp.asarray(vals), offs)
    t_region = _to_torch(region)
    fused = tmetrics.get_registry().scope("fused").counter("launches")
    before = fused.value
    got = tops.scatter_records(t_region, offs, _to_torch(vals))
    assert fused.value - before == 1
    assert got is t_region                         # in place
    plain = tref.scatter(_to_torch(region), torch.from_numpy(offs),
                         _to_torch(vals))
    for other in (pallas, oracle):
        np.testing.assert_array_equal(_bits(got), _bits(other))
    np.testing.assert_array_equal(_bits(plain), _bits(got))


def test_scatter_casts_host_vals_like_reference():
    """float64 host rows into an int32 region: float64 -> float32 ->
    int32, as the reference's jnp.asarray + astype does."""
    rng = np.random.default_rng(0)
    region = np.zeros((16, 3), np.int32)
    vals = rng.standard_normal((4, 3)) * 1e3
    offs = np.array([3, 0, 9, 15])
    exp = np.asarray(jops.scatter_records(jnp.asarray(region), offs, vals))
    got = tops.scatter_records(torch.from_numpy(region.copy()), offs, vals)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_scatter_one_broadcasting_form_matches_reference():
    region = np.arange(40, dtype=np.float32).reshape(10, 4)
    offsets = np.array([[1, 7], [3, 2]])
    buf = np.float32(-5.0)
    exp = np.asarray(jops.scatter_one(jnp.asarray(region), offsets, buf))
    got = tops.scatter_one(torch.from_numpy(region.copy()), offsets, buf)
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("n,L", [(1, 6), (7, 6), (33, 3), (12, 1)])
def test_gather_matches_reference(n, L):
    rng = np.random.default_rng(n * 10 + L)
    region = rng.standard_normal((24, 6)).astype(np.float32)
    offs = rng.integers(0, region.size // L, n)
    idx = offs[:, None] * L + np.arange(L)
    oracle = np.asarray(jref.reference_gather(jnp.asarray(region), idx))
    jitted = np.asarray(jops.gather_records(jnp.asarray(region), offs, L))
    got = tops.gather_records(torch.from_numpy(region), offs, L)
    assert tuple(got.shape) == (n, L)             # exactly n rows, no pad
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(got.numpy(), jitted[:n])


def test_offsets_out_of_range_raise():
    region = torch.zeros((4, 2))
    with pytest.raises(IndexError):
        tops.scatter_records(region, [4], np.ones((1, 2), np.float32))
    with pytest.raises(IndexError):
        tops.scatter_records(region, [-1], np.ones((1, 2), np.float32))
    with pytest.raises(IndexError):
        tops.gather_records(region, [4], 2)


def test_wrappers_refuse_devices_without_kernel_or_plain_version():
    """No hidden fallback: a tensor neither on the card nor on the CPU
    is refused, never copied somewhere the wrapper can handle it."""
    meta = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError):
        tops.scatter_records(meta, [0], np.ones((1, 2), np.float32))
    with pytest.raises(ValueError):
        tops.gather_records(meta, [0], 2)
    slots = torch.empty((4, 8), dtype=torch.int64, device="meta")
    flags = torch.empty((4,), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        tring.consume(slots, flags, 0, 4)
    with pytest.raises(ValueError):
        tops.scatter_records(torch.zeros((4, 2)).t(), [0], np.ones(4))


def test_build_failure_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("wr_rows", {})


# -- desc_ring ------------------------------------------------------------------
def _jslots(slots) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(slots)).view(np.int64)


@pytest.mark.parametrize("cap", [4, 8, 13])
def test_desc_ring_ops_match_reference(cap):
    """produce / consume / produce_consume across wraparounds and lap
    flips: the port's ops (plain versions on CPU) match the reference's
    jitted ops and its numpy oracle — slots, flags and drained rows."""
    rng = np.random.default_rng(cap)
    width = 8
    j_slots, j_flags = jring.alloc(cap, width)
    t_slots, t_flags = tring.alloc(cap, width, torch.device("cpu"))
    o_slots = np.zeros((cap, width), np.int64)
    o_flags = np.zeros((cap,), np.uint8)
    head = tail = 0
    for step in range(40):
        kind = step % 3
        n = int(rng.integers(0, cap - (head - tail) + 1))
        batch = rng.integers(-2**62, 2**62, (n, width), dtype=np.int64)
        limit = int(rng.integers(0, cap + 1))
        if kind == 0 and n:
            j_slots, j_flags = jring.produce(j_slots, j_flags, head, batch)
            tring.produce(t_slots, t_flags, head, batch)
            o_slots, o_flags = jring_ref.reference_produce(
                o_slots, o_flags, batch, head)
            head += n
            continue
        if kind == 1:
            if limit == 0:
                continue
            j_rows = jring.consume(j_slots, j_flags, tail, limit)
            t_rows = tring.consume(t_slots, t_flags, tail, limit)
        else:
            j_slots, j_flags, j_rows = jring.produce_consume(
                j_slots, j_flags, head, tail, batch, limit)
            t_rows = tring.produce_consume(t_slots, t_flags, head, tail,
                                           batch, limit)
            if n:
                o_slots, o_flags = jring_ref.reference_produce(
                    o_slots, o_flags, batch, head)
            head += n
        rot, k = jring_ref.reference_consume(o_slots, o_flags, tail)
        o_rows = rot[:min(k, limit)]
        np.testing.assert_array_equal(t_rows, j_rows)
        np.testing.assert_array_equal(t_rows, o_rows)
        tail += t_rows.shape[0]
        np.testing.assert_array_equal(t_slots.numpy(), _jslots(j_slots))
        np.testing.assert_array_equal(t_flags.numpy(), np.asarray(j_flags))
        np.testing.assert_array_equal(t_slots.numpy(), o_slots)
    assert head > cap and tail > cap          # several laps were crossed


def test_desc_ring_plain_consume_clamps_like_full_scan():
    """ref.consume scans only `limit` slots; its k equals the reference's
    full-ring k clamped to `limit`, for every tail and limit."""
    cap = 6
    rng = np.random.default_rng(1)
    for _ in range(30):
        flags = rng.integers(0, 2, cap).astype(np.uint8)
        slots = rng.integers(0, 100, (cap, 8)).astype(np.int64)
        tail = int(rng.integers(0, 2 * cap))
        rot, k_full = jring_ref.reference_consume(slots, flags, tail)
        for limit in range(cap + 1):
            rows, k = tring_ref.consume(torch.from_numpy(slots),
                                        torch.from_numpy(flags), tail, limit)
            assert k == min(k_full, limit)
            np.testing.assert_array_equal(rows.numpy(), rot[:limit])


def test_ring_ops_count_ring_launches():
    slots, flags = tring.alloc(8, 8, torch.device("cpu"))
    c = tmetrics.get_registry().scope("fused").counter("ring_launches")
    before = c.value
    tring.produce(slots, flags, 0, np.ones((3, 8), np.int64))
    tring.consume(slots, flags, 0, 8)
    tring.produce_consume(slots, flags, 3, 3, np.ones((2, 8), np.int64), 8)
    assert c.value - before == 3
