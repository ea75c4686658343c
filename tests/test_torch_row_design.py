"""The row copies on the CPU: the launch path that the three wrappers
of `repro_torch.kernels.wr_scatter.ops`, `kernels.kv_ingest.ops` and
`kernels.ring_pipe.ops` share, and the wrappers against the JAX
package's kernels.

`csrc/wr_rows.cu` holds one word-copy kernel under four entry points.
The kernel runs only on the card; here the launch path runs against a
stand-in library, and the wrappers (their plain versions on CPU
tensors) are held against the reference's `wr_scatter`, `kv_ingest` and
`ring_pipe` kernels in Pallas interpret mode, exactly: these kernels
move data and do no arithmetic."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.kv_ingest import ops as jkv
from repro.kernels.ring_pipe import ops as jring
from repro.kernels.wr_scatter import ops as jwr
from repro.kernels.wr_scatter.wr_scatter import wr_scatter as jpallas
from repro_torch import device as tdevice
from repro_torch.kernels import _build
from repro_torch.kernels.kv_ingest import ops as kv_ops
from repro_torch.kernels.ring_pipe import ops as rp_ops
from repro_torch.kernels.wr_scatter import ops as wr_ops

@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


def _shifted(n_bytes: int, dtype, shift: int) -> torch.Tensor:
    """A view `shift` elements into a fresh tensor (the allocator aligns
    the fresh one to at least 16 bytes)."""
    size = torch.tensor([], dtype=dtype).element_size()
    base = torch.zeros(n_bytes // size + 1, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[shift:shift + n_bytes // size]


# -- the launch path ----------------------------------------------------------
class _Lib:
    """A stand-in for the loaded `wr_rows` library: records each call."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry

    def kernel_error_string(self, rc):
        return b"stand-in error"


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(_build, "load", lambda name, sig: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 7)
    _build.reset_launches()
    yield fake
    _build.reset_launches()


ENTRIES = ["scatter_rows", "gather_rows", "ingest_pages",
           "ring_pipe_consume"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_launch_rows_calls_the_entry_once_and_counts_it(lib, entry):
    a = _shifted(4096 * 8, torch.float32, 0).view(8, 1024)
    b = _shifted(4096 * 4, torch.float32, 1).view(4, 1024)
    offs = torch.arange(4)
    assert wr_ops.launch_rows(entry, a, b, offs, 4, 4096) is None
    assert lib.calls == [(entry, (a.data_ptr(), b.data_ptr(),
                                  offs.data_ptr(), 4, 4096, 7))]
    assert _build.LAUNCHES == {entry: 1}


def test_every_entry_has_the_row_signature():
    assert set(wr_ops._SIG) == set(ENTRIES)
    assert all(sig == wr_ops._ROW for sig in wr_ops._SIG.values())


def test_launch_rows_raises_on_a_failed_launch_and_counts_nothing(
        monkeypatch):
    fake = _Lib(rc=1)
    monkeypatch.setattr(_build, "load", lambda name, sig: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    _build.reset_launches()
    a = torch.zeros(4, 1024)
    with pytest.raises(RuntimeError, match="ingest_pages"):
        wr_ops.launch_rows("ingest_pages", a, a, torch.arange(4), 4, 4096)
    assert _build.LAUNCHES == {} and len(fake.calls) == 1


def test_cpu_wrappers_and_empty_calls_launch_nothing(lib):
    region = torch.zeros(40, 1024)
    wr_ops.scatter_records(region, np.arange(4), np.ones((4, 1024),
                                                         np.float32))
    wr_ops.gather_records(region, np.arange(4), 1024)
    kv_ops.kv_ingest(region, torch.ones(3, 1024), np.arange(3))
    kv_ops.gather_pages(region, np.arange(3))
    rp_ops.ring_consume(region, np.arange(5))
    wr_ops.scatter_records(region, np.arange(0), np.ones((0, 1024),
                                                         np.float32))
    assert lib.calls == [] and _build.LAUNCHES == {}


# -- the wrappers against the reference ----------------------------------------
def _make(rng, dtype: str, shape):
    if dtype == "bfloat16":
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.standard_normal(shape).astype(dtype)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


# (dtype, record shape, rows moved, rows in the region): 4 KiB records,
# 8 KiB bf16 pages, 16-byte rows, a 64 KiB row, and rows of 12 and 14
# bytes (the kernel's 4- and 2-byte words)
SHAPES = [("float32", (1024,), 9, 24), ("bfloat16", (16, 1, 256), 5, 12),
          ("float32", (4,), 33, 80), ("uint8", (65536,), 2, 5),
          ("int32", (3,), 13, 40), ("bfloat16", (7,), 6, 20)]


@pytest.mark.parametrize("dtype,rec,m,R", SHAPES)
def test_scatter_and_gather_records_match_reference(dtype, rec, m, R):
    rng = np.random.default_rng(m + R)
    region = _make(rng, dtype, (R,) + rec)
    vals = _make(rng, dtype, (m,) + rec)
    offs = rng.choice(R, size=m, replace=False)
    want = jpallas(jnp.asarray(region), jnp.asarray(vals),
                   offs.astype(np.int32), interpret=True)
    jregion = jwr.scatter_records(jnp.asarray(region), offs, vals)
    np.testing.assert_array_equal(_bits(jregion), _bits(want))
    t = _torch(region)
    assert wr_ops.scatter_records(t, offs, _torch(vals)) is t
    np.testing.assert_array_equal(_bits(t), _bits(want))
    F = int(np.prod(rec))
    got = wr_ops.gather_records(t.reshape(R, F), offs, F)
    jgot = jwr.gather_records(jnp.asarray(want).reshape(R, F), offs, F)
    np.testing.assert_array_equal(_bits(got), _bits(jgot)[:m])


@pytest.mark.parametrize("dtype,rec,m,R", SHAPES)
def test_kv_ingest_and_page_gather_match_reference(dtype, rec, m, R):
    rng = np.random.default_rng(7 * m + R)
    pages = _make(rng, dtype, (R,) + rec)
    payload = _make(rng, dtype, (m,) + rec)
    ids = rng.choice(R, size=m, replace=False).astype(np.int32)
    want = jkv.kv_ingest(jnp.asarray(pages), jnp.asarray(payload),
                         jnp.asarray(ids), interpret=True)
    t = _torch(pages)
    assert kv_ops.kv_ingest(t, _torch(payload), ids) is t
    np.testing.assert_array_equal(_bits(t), _bits(want))
    np.testing.assert_array_equal(_bits(kv_ops.gather_pages(t, ids)),
                                  _bits(payload))


@pytest.mark.parametrize("dtype,rec,m,R", SHAPES)
def test_ring_consume_matches_reference(dtype, rec, m, R):
    rng = np.random.default_rng(3 * m + R)
    W = int(np.prod(rec))
    slots = _make(rng, dtype, (R, W))
    idx = rng.integers(0, R, m).astype(np.int32)     # repeats allowed
    want = jring.ring_consume(jnp.asarray(slots), jnp.asarray(idx),
                              interpret=True)
    got = rp_ops.ring_consume(_torch(slots), idx)
    np.testing.assert_array_equal(_bits(got), _bits(want))
