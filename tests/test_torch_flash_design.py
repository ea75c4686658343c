"""The design of the port's Hopper flash kernel, held on the CPU.

The TMA/wgmma kernel (`csrc/flash_attention.cu`, entry `flash_attention`)
runs only on the card; what of it a CPU can hold is held here against
the JAX package: the exact three-term split of P that keeps P V in
float32 (`ref.split3`), the split-KV schedule the wrapper plans
(`ops.plan` / `ops.schedule`, the kernel's own block decoding) with its
merge (`ref.partial_state` / `ref.merge_states`) against the reference's
Pallas kernel in interpret mode at 2e-5, and the wrapper's route between
its two bf16 entries (`ops.route`); and the query offset a
context-parallel shard passes (`q_offset`): the live k-tiles against a
brute-force mask, the split schedule at an offset against the
reference's `chunked_attention(q_offset=)`, the segments' independence
of the offset and of padding, and the plain version with its gradients
against `jax.grad` of the reference."""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention import ops as jfa_ops
from repro.models.attention import chunked_attention as jattention
from repro_torch import device as tdevice
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models.attention import chunked_attention as tattention


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


def test_split3_terms_are_bf16_and_sum_to_p_exactly():
    """hi + mid + lo, summed in float32 in that order, is every float32 p
    in [2^-100, 1] bit for bit: the kernel's P V in three bf16 products
    keeps the reference's float32 P."""
    rng = np.random.default_rng(0)
    p = np.exp2(-100 * rng.random(1 << 16)).astype(np.float32)
    # edges: 1, 2^-100, and values one float32 ulp either side of a tie
    tie = np.float32(1 + 2 ** -8)
    p = np.concatenate([p, np.float32([1.0, 2.0 ** -100]),
                        np.float32([np.nextafter(tie, np.float32(2)),
                                    np.nextafter(tie, np.float32(0))]),
                        (rng.random(4096) * (1 - 2 ** -24)).astype(
                            np.float32)]).astype(np.float32)
    t = torch.from_numpy(p)
    hi, mid, lo = fa_ref.split3(t)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(back, t)
    # each term keeps 8 significant bits at most and shrinks by 2^-8
    assert bool((mid.float().abs() <= hi.float().abs() * 2 ** -8).all())
    assert bool((lo.float().abs() <= mid.float().abs() * 2 ** -8).all())


def _pair(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _split_model(q, k, v, *, chunk, q_offset=0, **kw):
    """The kernel's split-KV launch in plain torch: each block of
    `ops.schedule` leaves its q-tile's state for its key range, and the
    states of a q-tile merge into its rows (a q-tile of one block
    normalises its own). Row r sits at q_offset + r."""
    B, H, Sq, _ = q.shape
    Sk, Dv = k.shape[2], v.shape[3]
    out = torch.empty((B, H, Sq, Dv))
    blocks = fa_ops.schedule(B, H, Sq, Sk, chunk=chunk,
                             causal=kw.get("causal", True),
                             window=kw.get("window", 0), q_offset=q_offset)
    by_tile: dict = {}
    for qt, bh, s, ns, t0, t1 in blocks:
        by_tile.setdefault(qt, {}).setdefault(bh, []).append((s, ns, t0, t1))
    for qt, heads in by_tile.items():
        q0, q1 = qt * fa_ops.ROWS, min((qt + 1) * fa_ops.ROWS, Sq)
        ranges = heads[0]
        # every (batch, head) of a q-tile takes the same splits, and they
        # tile its live k-tiles exactly, in order
        assert len(heads) == B * H and all(r == ranges for r in
                                           heads.values())
        assert [s for s, *_ in ranges] == list(range(ranges[0][1]))
        assert all(a[3] == b[2] for a, b in zip(ranges, ranges[1:]))
        lo, hi = fa_ops.k_tiles(q0, Sq, Sk, kw.get("causal", True),
                                kw.get("window", 0), q_offset)
        assert ranges[0][2] == lo and ranges[-1][3] == max(hi, lo)
        states = [fa_ref.partial_state(
            q[:, :, q0:q1], k, v, t0 * fa_ops.KEYS, min(t1 * fa_ops.KEYS, Sk),
            q_lo=q_offset + q0, **kw) for _, _, t0, t1 in ranges]
        out[:, :, q0:q1] = fa_ref.merge_states(states, q.dtype)
    return out, blocks


SPLIT_CASES = [
    # B, H, KVH, Sq, Sk, D, kwargs, SMs, Pallas blocks (q, k)
    (1, 2, 1, 384, 384, 32, dict(causal=True), 16, (64, 64)),
    (1, 2, 2, 512, 512, 16, dict(causal=True, window=200), 16, (64, 64)),
    (2, 2, 1, 200, 200, 16, dict(causal=True), 12, (40, 40)),
    (1, 2, 1, 100, 300, 16, dict(causal=False), 8, (20, 60)),
    (1, 4, 2, 256, 256, 16, dict(causal=True, window=70, cap=20.0,
                                 sm_scale=0.2), 16, (64, 64)),
]


@pytest.mark.parametrize("B,H,KVH,Sq,Sk,D,kw,sms,blocks", SPLIT_CASES)
def test_split_schedule_and_merge_match_interpret_mode_pallas(
        B, H, KVH, Sq, Sk, D, kw, sms, blocks):
    """The split-KV model at a plan that splits (few SMs), causal,
    windowed, capped and ragged, against the reference's Pallas kernel in
    interpret mode at the reference's float32 tolerance."""
    rng = np.random.default_rng(Sq + Sk + D)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s) for s in (
        (B, H, Sq, D), (B, KVH, Sk, D), (B, KVH, Sk, D)))
    chunk, max_split = fa_ops.plan(B, H, Sq, Sk, sms=sms,
                                   causal=kw.get("causal", True),
                                   window=kw.get("window", 0))
    assert max_split > 1, "the case must exercise the merge"
    got, sched = _split_model(tq, tk, tv, chunk=chunk, **kw)
    assert max(ns for *_, ns, _, _ in sched) == max_split
    want = jfa_ops.attention(jq, jk, jv, block_q=blocks[0],
                             block_k=blocks[1], interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=2e-5, rtol=2e-5)


def test_plan_fills_the_card_at_short_prompts_and_splits_nothing_long():
    """gemma-2b's prefill shapes (H 8, KVH 1) on 132 SMs: S = 512 has 32
    q-tiles and is split; S = 4096 has 256 and is not; a prompt of one
    tile is never split."""
    for S, split in ((512, True), (1024, True), (4096, False), (8, False),
                     (64, False)):
        chunk, max_split = fa_ops.plan(1, 8, S, S, causal=True, window=0,
                                       sms=132)
        assert (max_split > 1) == split, (S, chunk, max_split)
        blocks = fa_ops.schedule(1, 8, S, S, causal=True, window=0,
                                 chunk=chunk)
        if split:
            assert len(blocks) > 32 * (S // 512)
        assert max(t1 - t0 for *_, t0, t1 in blocks) <= max(chunk, 1)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_route_takes_tma_where_it_can_and_generic_elsewhere():
    """Which C entry each edge shape takes, and no launch on the CPU."""
    T = "flash_attention"
    Gn = "flash_attention_generic"
    strided = _bf16(2, 77, 8, 256).transpose(1, 2)       # (B,S,H,D) view
    kv = _bf16(2, 77, 1, 256).transpose(1, 2)
    cases = [
        ((_bf16(1, 8, 512, 256), _bf16(1, 1, 512, 256),
          _bf16(1, 1, 512, 256)), T),                    # serving shape
        ((strided, kv, kv), T),
        ((_bf16(1, 2, 90, 16), _bf16(1, 1, 90, 16), _bf16(1, 1, 90, 16)),
         T),
        ((_bf16(1, 2, 90, 20), _bf16(1, 1, 90, 20), _bf16(1, 1, 90, 20)),
         Gn),                                            # D off 16
        ((_bf16(1, 4, 100, 64), _bf16(1, 1, 100, 64), _bf16(1, 1, 100, 24)),
         Gn),                                            # Dv off 16
        ((_bf16(1, 1, 50, 68)[..., :64], _bf16(1, 1, 50, 64),
          _bf16(1, 1, 50, 64)), Gn),                     # rows off 16 B
        ((_bf16(1, 1, 50, 72)[..., 4:68], _bf16(1, 1, 50, 64),
          _bf16(1, 1, 50, 64)), Gn),                     # base off 16 B
        ((_bf16(1, 2, 8, 64), _bf16(1, 2, 0, 64), _bf16(1, 2, 0, 64)),
         Gn),                                            # no keys
        ((torch.zeros(1, 2, 90, 20), torch.zeros(1, 1, 90, 20),
          torch.zeros(1, 1, 90, 20)), T),                # float32
        ((_bf16(1, 2, 64, 64).as_strided((1, 2, 64, 64),
                                          (3, 4096, 64, 1)),
          _bf16(1, 1, 64, 64), _bf16(1, 1, 64, 64)), T),  # B=1, odd stride
    ]
    for (q, k, v), want in cases:
        assert fa_ops.route(q, k, v) == want, (q.shape, q.stride(), want)
    launches, shapes = dict(_build.LAUNCHES), dict(_build.BY_SHAPE)
    for (q, k, v), _ in cases:
        out = fa_ops.attention(q, k, v)
        assert out.shape == (*q.shape[:3], v.shape[3])
    assert _build.LAUNCHES == launches and _build.BY_SHAPE == shapes


def test_chip_smoke_reads_ptxas_registers_and_spills_per_instance():
    """`chip_smoke.py` phase 2 checks the Dv = 256 TMA/wgmma instance for
    spills from nvcc's -Xptxas -v lines; the parser keeps each template
    instance apart."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_"
        "18_flash_attention_cu_ddac23b621flash_fwd_sm90_kernelILi4EEEv14CUt"
        "ensorMap_stS1_S1_P13__nv_bfloat16NS_11FlashParamsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf_18_"
        "flash_attention_cu_ddac21flash_fwd_bf16_kernelILi32EEEvPK13__nv_"
        "bfloat16S3_S3_PS1_NS_7StridesEiiiiiiffiii' for 'sm_90a'",
        "    88 bytes stack frame, 132 bytes spill stores, 100 bytes spill "
        "loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__37354dda_"
        "18_flash_attention_cu_ddac23b618flash_merge_kernelEP13__nv_bfloat16"
        "NS_11FlashParamsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers"])
    assert chip_smoke.ptxas_report(log) == {
        "flash_fwd_sm90_kernel<4>": (168, 0, 0),
        "flash_fwd_bf16_kernel<32>": (255, 132, 100),
        "flash_merge_kernel": (32, 0, 0)}


@pytest.mark.parametrize("n", [5, 77, 300, 1000, 1500, 2100, 3000, 3900])
def test_split_segments_of_a_prompt_do_not_move_when_padded(n):
    """A prompt of n tokens and the same prompt padded to its bucket (the
    serving engine's power-of-two prefill) get the same chunk, and every
    q-tile of the prompt splits its keys at the same absolute segment
    boundaries; the padded launch may only add segments past the last
    real row's keys, which leave a row's state exact (a merge with an
    empty state adds zeros). So the kernel gives both runs bit-equal
    rows, which `chip_smoke.py` phase 6 holds against the reference."""
    bucket = 1 << (n - 1).bit_length()
    kw = dict(causal=True, window=0)
    chunk, _ = fa_ops.plan(1, 8, n, n, sms=132, **kw)
    assert fa_ops.plan(1, 8, bucket, bucket, sms=132, **kw)[0] == chunk

    def segments(S):
        by = {}
        for qt, bh, s, ns, t0, t1 in fa_ops.schedule(1, 8, S, S, chunk=chunk,
                                                     **kw):
            if bh == 0:
                by.setdefault(qt, []).append((t0, t1))
        return by

    short, padded = segments(n), segments(bucket)
    for qt, segs in short.items():
        last = min((qt + 1) * fa_ops.ROWS, n) - 1       # last real row
        need = last // fa_ops.KEYS + 1                  # its k-tiles
        assert segs[-1][1] == need
        # the padded q-tile's segments, cut at the real rows' keys
        cut = [(t0, min(t1, need)) for t0, t1 in padded[qt] if t0 < need]
        assert cut == segs, (qt, segs, padded[qt])


# -- the query offset -------------------------------------------------------
def _live_tiles(q0, Sq, Sk, causal, window, q_offset):
    """The k-tiles holding a key live for some row of the q-tile at q0,
    from the whole mask (the reference's `_mask` at qpos = q_offset +
    row)."""
    rows = np.arange(q0, min(q0 + fa_ops.ROWS, Sq))[:, None] + q_offset
    keys = np.arange(Sk)[None, :]
    live = np.ones((rows.shape[0], Sk), bool)
    if causal:
        live &= rows >= keys
    if window:
        live &= keys > rows - window
    return sorted({int(j) // fa_ops.KEYS for j in np.nonzero(live.any(0))[0]})


def _offset_cases(n):
    """Seeded (Sq, Sk, q_offset, causal, window): a shard's rows inside
    the keys (q_offset + Sq <= Sk) and, not causal, any offset."""
    rng = np.random.default_rng(21)
    out = []
    for i in range(n):
        Sk = int(rng.integers(1, 1200))
        Sq = int(rng.integers(1, min(Sk, 600) + 1))
        causal = bool(i % 4 != 3)
        off = int(rng.integers(0, Sk - Sq + 1))
        window = int(rng.choice([0, 0, 1, 64, 100, 257, 700]))
        out.append((Sq, Sk, off, causal, window))
    # shards of a 4096-token prompt over 16 ranks, as the card runs them
    out += [(256, 4096, 256 * r, True, w) for r in (0, 1, 7, 15)
            for w in (0, 2048)]
    return out


@pytest.mark.parametrize("Sq,Sk,q_offset,causal,window", _offset_cases(40))
def test_k_tiles_and_schedule_at_an_offset_equal_the_live_tiles(
        Sq, Sk, q_offset, causal, window):
    """`ops.k_tiles` (the kernel's own bound, shared by its host plan,
    its block decoding and its merge) gives exactly the k-tiles that
    hold a live key for some row of each q-tile, its rows at q_offset +
    row; and `ops.schedule` covers that range in order, split at
    absolute multiples of the chunk."""
    for q0 in range(0, Sq, fa_ops.ROWS):
        lo, hi = fa_ops.k_tiles(q0, Sq, Sk, causal, window, q_offset)
        assert list(range(lo, hi)) == _live_tiles(q0, Sq, Sk, causal,
                                                  window, q_offset), q0
    for sms in (8, 132):
        chunk, max_split = fa_ops.plan(2, 4, Sq, Sk, causal=causal,
                                       window=window, sms=sms,
                                       q_offset=q_offset)
        by = {}
        for qt, bh, s, ns, t0, t1 in fa_ops.schedule(
                2, 4, Sq, Sk, causal=causal, window=window, chunk=chunk,
                q_offset=q_offset):
            if bh == 0:
                by.setdefault(qt, []).append((t0, t1, ns))
        assert max(ns for segs in by.values() for *_, ns in segs) \
            == max_split
        for qt, segs in by.items():
            lo, hi = fa_ops.k_tiles(qt * fa_ops.ROWS, Sq, Sk, causal,
                                    window, q_offset)
            assert segs[0][0] == lo and segs[-1][1] == max(hi, lo)
            assert all(a[1] == b[0] and b[0] % chunk == 0
                       for a, b in zip(segs, segs[1:]))


OFFSET_SPLIT_CASES = [
    # B, H, KVH, Sq, Sk, D, q_offset, kwargs, SMs
    (1, 2, 1, 256, 1024, 32, 768, dict(causal=True), 8),
    (1, 2, 1, 200, 700, 16, 333, dict(causal=True), 12),
    (1, 2, 2, 256, 1024, 16, 512, dict(causal=True, window=300), 8),
    (1, 4, 2, 130, 600, 16, 256, dict(causal=True, window=70, cap=20.0,
                                      sm_scale=0.2), 16),
    (2, 2, 1, 100, 300, 16, 50, dict(causal=False), 8),
]


@pytest.mark.parametrize("B,H,KVH,Sq,Sk,D,q_offset,kw,sms",
                         OFFSET_SPLIT_CASES)
def test_split_schedule_at_an_offset_matches_reference_chunked_attention(
        B, H, KVH, Sq, Sk, D, q_offset, kw, sms):
    """The split-KV model of a launch at a query offset (a late shard's
    q-tiles split their long key ranges) against the reference's
    `chunked_attention(q_offset=)` — its context-parallel path's call —
    at the reference's float32 tolerance; the plain version with the
    offset too."""
    rng = np.random.default_rng(Sq + Sk + q_offset)
    G = H // KVH
    q = rng.standard_normal((B, Sq, KVH, G, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    want = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_offset=q_offset,
                                 q_chunk=64, kv_chunk=64, **kw))
    want = want.reshape(B, Sq, H, D).transpose(0, 2, 1, 3)
    tq = torch.from_numpy(q).reshape(B, Sq, H, D).transpose(1, 2)
    tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (k, v))
    chunk, max_split = fa_ops.plan(B, H, Sq, Sk, sms=sms,
                                   causal=kw.get("causal", True),
                                   window=kw.get("window", 0),
                                   q_offset=q_offset)
    assert max_split > 1, "the case must exercise the merge"
    got, _ = _split_model(tq, tk, tv, chunk=chunk, q_offset=q_offset, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    plain = fa_ops.attention(tq, tk, tv, q_offset=q_offset, **kw)
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("r", [1, 5, 15])
def test_segments_are_absolute_whatever_the_offset(r):
    """With one chunk, a shard at q_offset = 256 r (its q-tiles aligned
    to the whole call's) splits each row's keys exactly where the whole
    4096-token call splits that row's: the segments are absolute."""
    S, n, off = 4096, 256, 256 * r
    kw = dict(causal=True, window=0)
    chunk = 4

    def segments(Sq, q_offset, tile0):
        by = {}
        for qt, bh, s, ns, t0, t1 in fa_ops.schedule(
                1, 8, Sq, S, chunk=chunk, q_offset=q_offset, **kw):
            if bh == 0:
                by.setdefault(qt + tile0, []).append((t0, t1))
        return by

    whole, shard = segments(S, 0, 0), segments(n, off, off // fa_ops.ROWS)
    assert shard and all(shard[t] == whole[t] for t in shard)


@pytest.mark.parametrize("n,q_offset", [(5, 1000), (77, 256), (200, 3840),
                                        (300, 129), (1000, 2048)])
def test_split_segments_of_an_offset_shard_do_not_move_when_padded(
        n, q_offset):
    """The padding-stability property at an offset: a shard of n rows
    and the same shard padded to its power of two, against the same
    keys, get the same chunk, and every q-tile's segments, cut at its
    real rows' keys, are the same."""
    bucket = 1 << (n - 1).bit_length()
    Sk = q_offset + bucket
    kw = dict(causal=True, window=0, q_offset=q_offset)
    chunk, _ = fa_ops.plan(1, 8, n, Sk, sms=132, **kw)
    assert fa_ops.plan(1, 8, bucket, Sk, sms=132, **kw)[0] == chunk

    def segments(Sq):
        by = {}
        for qt, bh, s, ns, t0, t1 in fa_ops.schedule(1, 8, Sq, Sk,
                                                     chunk=chunk, **kw):
            if bh == 0:
                by.setdefault(qt, []).append((t0, t1))
        return by

    short, padded = segments(n), segments(bucket)
    for qt, segs in short.items():
        last = q_offset + min((qt + 1) * fa_ops.ROWS, n) - 1
        need = last // fa_ops.KEYS + 1
        assert segs[-1][1] == need
        cut = [(t0, min(t1, need)) for t0, t1 in padded[qt] if t0 < need]
        assert cut == segs, (qt, segs, padded[qt])


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True,
                                                        window=9),
                                dict(causal=True, cap=4.0)])
def test_offset_plain_version_and_gradients_match_jax_grad(kw):
    """`chunked_attention(q_offset=)` of both packages, forward at 2e-5
    and gradients (through `_Attention`, whose recompute masks at the
    same offset) within 1e-5 of their scale of `jax.grad`'s."""
    B, Sq, Sk, KVH, G, D, off = 2, 12, 40, 1, 3, 8, 21
    rng = np.random.default_rng(len(kw))
    q = rng.standard_normal((B, Sq, KVH, G, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    w = rng.standard_normal((B, Sq, KVH, G, D)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jattention(q, k, v, q_offset=off, **kw) * w)
    jout = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      q_offset=off, **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (q, k, v))
    out = tattention(tq, tk, tv, q_offset=off, **kw)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-5)
    (out * torch.from_numpy(w)).sum().backward()
    for t, j in zip((tq, tk, tv), jgrads):
        j = np.asarray(j)
        assert np.abs(t.grad.numpy() - j).max() <= 1e-5 * np.abs(j).max()


def test_offset_calls_are_keyed_apart_and_checked():
    """`shape_key` tells an offset call apart ("@<offset>"), so
    `_build.BY_SHAPE` counts offset launches apart from plain ones; a
    negative offset raises before any launch."""
    assert fa_ops.shape_key(1, 256, 4096, True, 3840) == "1x256x4096@3840"
    assert fa_ops.shape_key(1, 256, 4096, True) == "1x256x4096"
    assert fa_ops.shape_key(4, 128, 1500, False, 0) == "4x128x1500/nc"
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q_offset"):
        fa_ops.prepare(q, q[:, :1], q[:, :1], q_offset=-1)
