"""The port's attention held against the JAX package, on the CPU.

On a CPU tensor `repro_torch.kernels.flash_attention.ops.attention` runs
its plain version (`ref.py`); these tests hold it against the reference's
Pallas kernel in interpret mode and its `ref.py` at the sweep, window and
softcap cases of `tests/test_kernels.py`, then the model-layer functions
above it — `chunked_attention` (the flash kernel's one caller),
`decode_partials` / `finalize_partials` and the local branch of
`seqparallel_decode_attention` — against `repro.models.attention` and
`repro.parallel.collectives` on the same seeded numpy inputs. Tolerances
are the reference's own: 2e-5 in float32 (summation order) and 2e-2 in
bf16 (the output's rounding); 1e-5 for the decode partials, computed in
float32 on both sides."""
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.flash_attention.flash_attention import flash_attention
from repro.models import attention as jattn
from repro.parallel import collectives as jcoll
from repro_torch import device as tdevice
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention as tattn
from repro_torch.parallel import collectives as tcoll


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


def _pair(rng, shape, dtype):
    """The same values as a jax array and a torch tensor."""
    a = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        b = a.astype(ml_dtypes.bfloat16)
        return (jnp.asarray(b),
                torch.from_numpy(b.view(np.uint16).copy()).view(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


SWEEP = [(2, 4, 2, 256, 64), (1, 2, 1, 128, 32), (1, 8, 8, 128, 128),
         (2, 4, 1, 256, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KVH,S,D", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_reference_oracle(B, H, KVH, S, D, causal, dtype):
    rng = np.random.default_rng(S + D + H)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in (
        (B, H, S, D), (B, KVH, S, D), (B, KVH, S, D)))
    got = fa_ops.attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (B, H, S, D)
    _close(got, jfa_ref.reference(jq, jk, jv, causal=causal), _tol(dtype))


@pytest.mark.parametrize("dtype,B,H,KVH,S,D,causal", [
    ("float32", 2, 4, 2, 256, 64, True),
    ("bfloat16", 2, 4, 1, 256, 64, False),
    ("float32", 1, 8, 8, 128, 128, False),
])
def test_plain_flash_matches_interpret_mode_pallas(dtype, B, H, KVH, S, D,
                                                   causal):
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in (
        (B, H, S, D), (B, KVH, S, D), (B, KVH, S, D)))
    want = flash_attention(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                           interpret=True)
    _close(fa_ops.attention(tq, tk, tv, causal=causal), want, _tol(dtype))


@pytest.mark.parametrize("window", [32, 64, 128])
def test_plain_flash_window(window):
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (1, 2, 256, 64), "float32")
                                    for _ in range(3))
    got = fa_ops.attention(tq, tk, tv, causal=True, window=window)
    _close(got, jfa_ref.reference(jq, jk, jv, causal=True, window=window),
           2e-5)
    if window == 64:
        _close(got, flash_attention(jq, jk, jv, causal=True, window=window,
                                    block_q=64, block_k=64, interpret=True),
               2e-5)


def test_plain_flash_softcap_and_scale():
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (1, 2, 128, 64), "float32")
                                    for _ in range(3))
    got = fa_ops.attention(tq, tk, tv, causal=True, sm_scale=0.2, cap=20.0)
    _close(got, flash_attention(jq, jk, jv, causal=True, sm_scale=0.2,
                                cap=20.0, block_q=64, block_k=64,
                                interpret=True), 2e-5)
    _close(got, jfa_ref.reference(jq, jk, jv, causal=True, sm_scale=0.2,
                                  cap=20.0), 2e-5)


def test_flash_wrapper_takes_strided_views_and_any_length():
    """The (B,S,H,D) -> (B,H,S,D) views chunked_attention hands over need
    no copy; ragged lengths and Sq < Sk run (the Pallas kernel asserts
    that its blocks divide them; the reference's ref.py does not)."""
    rng = np.random.default_rng(3)
    for Sq, Sk in ((3, 3), (100, 100), (70, 200)):
        (jq, tq) = _pair(rng, (2, Sq, 4, 16), "float32")
        (jk, tk), (jv, tv) = (_pair(rng, (2, Sk, 2, 16), "float32")
                              for _ in range(2))
        got = fa_ops.attention(tq.transpose(1, 2), tk.transpose(1, 2),
                               tv.transpose(1, 2), causal=True)
        want = jfa_ref.reference(jq.transpose(0, 2, 1, 3),
                                 jk.transpose(0, 2, 1, 3),
                                 jv.transpose(0, 2, 1, 3), causal=True)
        _close(got, want, 2e-5)


def test_flash_wrapper_checks_and_counts_no_launch_on_the_cpu():
    t = torch.zeros((1, 2, 4, 8))
    before = dict(_build.LAUNCHES)
    fa_ops.attention(t, t[:, :1], t[:, :1])
    assert _build.LAUNCHES == before            # the plain version ran
    with pytest.raises(ValueError, match="no kernel or plain version"):
        fa_ops.attention(*(torch.zeros((1, 2, 4, 8), device="meta"),) * 3)
    with pytest.raises(TypeError):
        fa_ops.attention(t, t.double(), t)
    with pytest.raises(ValueError, match="group"):
        fa_ops.attention(torch.zeros((1, 3, 4, 8)), t, t)
    with pytest.raises(ValueError, match="agree"):
        fa_ops.attention(t, torch.zeros((1, 2, 4, 4)), t)
    assert fa_ref.NEG == jfa_ref.NEG == tattn.NEG


def test_chip_smoke_half_ulp_bound_passes_rounding_and_catches_a_shift():
    """`chip_smoke.py`'s bf16 bound on the flash kernel: a float32 result
    rounded to bf16 stays within it everywhere; two bf16 ulps off, or a
    shift of 2e-3 on values near 0.03 (what a skipped k-tile does to a
    late row at S = 4096), leave it at every element."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    # magnitudes 0.01 to 10, where FLASH_EPS is below half an ulp
    r32 = 10 ** (3 * torch.rand(4096, generator=gen) - 2) * torch.sign(
        torch.randn(4096, generator=gen))
    rounded = r32.bfloat16()
    assert float(chip_smoke.bf16_half_ulps(torch, rounded, r32).max()) <= 1
    bits = rounded.view(torch.int16)
    for off in (-2, 2):                 # two ulps away from r32's bf16
        moved = (bits + off).view(torch.bfloat16)
        assert bool((chip_smoke.bf16_half_ulps(torch, moved, r32) > 1).all())
    late = 0.03 * torch.rand(4096, generator=gen) + 0.015
    assert bool((chip_smoke.bf16_half_ulps(
        torch, (late + 2e-3).bfloat16(), late) > 1).all())


# -- the model layer ----------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,KVH,G,D,kw", [
    (3, 1, 4, 16, {}),
    (100, 2, 2, 32, {}),
    (64, 1, 8, 16, {"window": 16}),
    (48, 2, 1, 16, {"cap": 20.0, "sm_scale": 0.2}),
    (40, 1, 2, 16, {"causal": False}),
])
def test_chunked_attention_matches_reference(S, KVH, G, D, kw, dtype):
    rng = np.random.default_rng(S * G)
    (jq, tq) = _pair(rng, (2, S, KVH, G, D), dtype)
    (jk, tk), (jv, tv) = (_pair(rng, (2, S, KVH, D), dtype)
                          for _ in range(2))
    got = tattn.chunked_attention(tq, tk, tv, q_chunk=16, kv_chunk=32, **kw)
    want = jattn.chunked_attention(jq, jk, jv, q_chunk=16, kv_chunk=32, **kw)
    assert got.shape == want.shape and got.dtype == tq.dtype
    _close(got, want, _tol(dtype))
    _close(tattn.reference_attention(tq, tk, tv, **kw),
           jattn.reference_attention(jq, jk, jv, **kw), _tol(dtype))
    # the reference's tiling knobs do not change the port's result
    assert torch.equal(got, tattn.chunked_attention(tq, tk, tv, **kw))
    assert torch.equal(got, tcoll.attend(tq, tk, tv, **kw))


def test_chunked_attention_q_offset_matches_reference():
    """A query offset (context parallelism's shard offset) is taken as
    the reference takes it, query row r at q_offset + r for the masks."""
    rng = np.random.default_rng(4)
    (jq, tq) = _pair(rng, (1, 4, 1, 2, 8), "float32")
    (jk, tk), (jv, tv) = (_pair(rng, (1, 12, 1, 8), "float32")
                          for _ in range(2))
    for kw in (dict(causal=True), dict(causal=True, window=5)):
        want = jattn.chunked_attention(jq, jk, jv, q_offset=8, **kw)
        got = tattn.chunked_attention(tq, tk, tv, q_offset=8, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


def test_chunked_attention_q_offset_raises():
    """A negative query offset raises."""
    t = torch.zeros((1, 4, 1, 2, 8))
    k = torch.zeros((1, 12, 1, 8))
    with pytest.raises(ValueError, match="q_offset"):
        tattn.chunked_attention(t, k, k, q_offset=-4)


@pytest.mark.parametrize("pos_kind", ["scalar", "per_request"])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_decode_partials_match_reference(pos_kind, cap):
    rng = np.random.default_rng(11)
    B, S, KVH, G, D = 3, 24, 2, 2, 16
    (jq, tq) = _pair(rng, (B, KVH, G, D), "float32")
    (jk, tk), (jv, tv) = (_pair(rng, (B, S, KVH, D), "float32")
                          for _ in range(2))
    pos = 13 if pos_kind == "scalar" else np.asarray([0, 9, 23], np.int32)
    kvp = np.arange(S)
    em = rng.random(S) > 0.3
    em[0] = True
    j = jattn.decode_partials(jq, jk, jv, jnp.asarray(kvp), jnp.asarray(pos),
                              cap=cap, extra_mask=jnp.asarray(em))
    t = tattn.decode_partials(tq, tk, tv, torch.from_numpy(kvp),
                              torch.as_tensor(pos), cap=cap,
                              extra_mask=torch.from_numpy(em))
    for a, b in zip(t, j):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        _np(tattn.finalize_partials(t[0], t[2])),
        _np(jattn.finalize_partials(j[0], j[2])), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [5, [0, 7, 15], [3, 16, -1]])
def test_seqparallel_decode_local_branch_matches_reference(dtype, pos):
    """The per-request write at `pos` (rows out of range keep their
    cache), then decode_partials and finalize_partials over the whole
    cache; the caches passed in are left as they were."""
    rng = np.random.default_rng(5)
    B, S, KVH, G, D = 3, 16, 1, 4, 16
    (jq, tq) = _pair(rng, (B, KVH, G, D), dtype)
    (jkc, tkc), (jvc, tvc) = (_pair(rng, (B, S, KVH, D), dtype)
                              for _ in range(2))
    (jkn, tkn), (jvn, tvn) = (_pair(rng, (B, KVH, D), dtype)
                              for _ in range(2))
    kc0 = tkc.clone()
    jp = jnp.asarray(np.asarray(pos, np.int32))
    jo, jk2, jv2 = jcoll.seqparallel_decode_attention(jq, jkc, jvc, jkn, jvn,
                                                      jp)
    to, tk2, tv2 = tcoll.seqparallel_decode_attention(
        tq, tkc, tvc, tkn, tvn, torch.as_tensor(np.asarray(pos)))
    assert to.dtype == tq.dtype
    np.testing.assert_allclose(_np(to), _np(jo), atol=1e-5 if dtype ==
                               "float32" else 2e-2, rtol=1e-5 if dtype ==
                               "float32" else 2e-2)
    np.testing.assert_array_equal(_np(tk2), _np(jk2))
    np.testing.assert_array_equal(_np(tv2), _np(jv2))
    assert torch.equal(tkc, kc0)
