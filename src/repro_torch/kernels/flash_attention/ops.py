"""Flash attention: one call of the hand-written kernels per call.

Replaces the reference's `kernels/flash_attention/flash_attention.py::
flash_attention` (the `pl.pallas_call` at line 110). On a CUDA tensor
`attention` makes one call of a C entry point of
`csrc/flash_attention.cu`, the one `route` names for the operands:

  * `flash_attention`, bfloat16 operands a TMA tensor map can read
    (16-byte aligned, unit column stride, the other strides a multiple
    of 8 elements, head dims a multiple of 16; every serving-path
    shape): Hopper's kernel — a producer warp keeps a two-stage ring of
    K/V tiles full with TMA loads, two consumer warpgroups run `wgmma`
    for S = Q K^T and for P V (P from registers, kept float32 as three
    bf16 terms), masks run only on the tiles they cross, and `plan`
    splits the key range of long q-tiles so the blocks fill the SMs at
    short prompts. A split call is two launches, the kernel and the
    merge of its float32 partials (scratch allocated here), still one
    counted call. float32 operands go to the same entry's CUDA-core
    kernel (no TF32).
  * `flash_attention_generic`, every other bfloat16 operand: the
    `mma.sync` kernel, staged through registers element by element
    where rows are off 16 bytes.

Both keep float32 statistics and accumulator, GQA by `h // G`, causal
and window masks, tanh softcap, and a query offset: with `q_offset`,
query row r sits at absolute position q_offset + r for the masks (a
context-parallel shard's rows; the reference's
`chunked_attention(q_offset=)`), the output rows staying local. Its bound on the card is operations:
4 B H S^2 D / 2 causal FLOPs over the bf16 tensor-core rate (0.069 ms
for gemma-2b at S = 4096); the three-term P makes the kernels' own work
twice that. On a CPU tensor `attention` is the plain version in
`ref.py`; any other device raises, and so does a build or launch error.
`attention` is one call of the custom operator
`repro_torch::flash_attention`: under `FakeTensorMode` (the dry-run,
`launch.dryrun`) it gives its output's shape and dtype alone, launching
nothing and allocating no scores, and `torch.utils.flop_counter` counts
it as 2 B H Sq Sk (Dk + Dv) (`flops`). Gradients: where an operand
requires grad, the operator's backward differentiates the plain version,
recomputed on the operands' device (no backward kernel yet).
`_build.LAUNCHES[entry]` counts the calls made on the card, and
`_build.BY_SHAPE[entry]` the same by `shape_key`.

Differences from the reference's `kernels/flash_attention`, on purpose:

  * Fixed tiles with masked tails: any Sq and Sk run (the Pallas kernel
    asserts that its blocks divide them). `block_q` / `block_k` are
    not taken: the tiles are the kernels' own.
  * Any strides: q, k and v are read through the strides they carry,
    so a permuted view needs no copy, and the result is a (B, H, Sq,
    Dv) view of a tensor laid out (B, Sq, H, Dv) in memory — the
    layout `models.attention.chunked_attention` hands back.
  * Which kernel runs depends on the operands' alignment and head dims
    (`route`); both compute the same function to the same tolerance.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

_P, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {
    "flash_attention": [_P] * 5 + [_INT] * 8 + [_F, _F] + [_INT] * 4
    + [_P, _P],
    "flash_attention_generic": [_P] * 5 + [_INT] * 7 + [_F, _F]
    + [_INT] * 3 + [_P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
ROWS = 128          # query rows of one block of the TMA path
KEYS = 64           # keys of one k-tile


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.ndim != 4:
            raise ValueError(f"{name} must be a 4-D tensor (B, heads, S, D)")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share one dtype of {list(_DTYPES)}; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, _, Dk = q.shape
    if k.shape[0] != B or v.shape[0] != B or k.shape[2] != v.shape[2] \
            or k.shape[1] != v.shape[1] or k.shape[3] != Dk:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads do not group over "
                         f"{k.shape[1]} kv heads")


def _tma_ok(t) -> bool:
    """A 4-D tensor map can read `t`: 16-byte aligned, unit column
    stride, every other stride of a dimension longer than 1 a positive
    multiple of 8 elements (16 bytes), the head dim a multiple of 16."""
    return (t.shape[3] % 16 == 0 and t.stride(3) == 1
            and t.data_ptr() % 16 == 0
            and all(st > 0 and st % 8 == 0
                    for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1))


def route(q, k, v) -> str:
    """The C entry point that takes these operands on the card."""
    if q.dtype == torch.float32:
        return "flash_attention"
    if k.shape[2] > 0 and all(_tma_ok(t) for t in (q, k, v)):
        return "flash_attention"
    return "flash_attention_generic"


def k_tiles(q0: int, Sq: int, Sk: int, causal: bool, window: int,
            q_offset: int = 0):
    """The k-tiles [lo, hi) holding a live key for some real row of the
    TMA path's q-tile at q0 (the kernel's `k_tiles`): its rows sit at
    q_offset + q0 ... , the key bound clamped by Sk; hi <= lo: none."""
    first = q_offset + q0
    last = q_offset + min(q0 + ROWS, Sq) - 1
    hi = -(-Sk // KEYS)
    if causal:
        hi = min(hi, last // KEYS + 1)
    lo = (first - window + 1) // KEYS if window and first - window + 1 > 0 \
        else 0
    return lo, hi


def n_splits(lo: int, hi: int, chunk: int) -> int:
    """Blocks a q-tile with live k-tiles [lo, hi) takes: one per segment
    [j chunk, (j + 1) chunk) of the key axis it meets (the kernel's
    `n_splits`). The segments are absolute, so a row's keys fall into
    the same ones whatever rows beyond it the launch holds."""
    return -(-hi // chunk) - lo // chunk if hi > lo else 1


def _tiles(Sq, Sk, causal, window, q_offset=0) -> list:
    return [k_tiles(r * ROWS, Sq, Sk, causal, window, q_offset)
            for r in range(-(-Sq // ROWS))]


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=512)
def _chunk(B, H, Sq, Sk, causal, window, sms, q_offset=0) -> int:
    """Of the chunks max_n / k (k = 1 .. 16), the one whose blocks, dealt
    to `sms` SMs in launch order one at a time (each costing its k-tiles
    plus one for its q-tile's load and epilogue; a split adding one for
    the merge), finish first."""
    top = max(hi - lo for lo, hi in _tiles(Sq, Sk, causal, window,
                                           q_offset))

    def finish(chunk) -> int:
        free = [0] * sms
        blocks = schedule(B, H, Sq, Sk, causal=causal, window=window,
                          chunk=chunk, q_offset=q_offset)
        for *_, t0, t1 in blocks:
            heapq.heappush(free, heapq.heappop(free) + 1 + t1 - t0)
        return max(free) + any(b[3] > 1 for b in blocks)

    if top <= 1:
        return max(top, 1)
    return min({-(-top // k) for k in range(1, 17)},
               key=lambda c: (finish(c), -c))


def _segment(lo, hi, chunk, s, ns) -> tuple[int, int]:
    """Block s's k-tiles [t0, t1) of a q-tile with live range [lo, hi)."""
    if ns == 1:
        return lo, max(hi, lo)
    seg = (lo // chunk + s) * chunk
    return max(seg, lo), min(seg + chunk, hi)


def plan(B, H, Sq, Sk, *, causal, window, sms,
         q_offset=0) -> tuple[int, int]:
    """(chunk, max_split) of a TMA-path launch. A q-tile whose live
    k-tiles meet several segments [j chunk, (j + 1) chunk) of the key
    axis takes a block per segment, and the merge combines them;
    `max_split` is the most blocks one q-tile takes (1: no split, no
    merge). `chunk` is planned for the lengths' power-of-two class
    (`_chunk` of Sq and Sk rounded up to powers of two), so a prompt and
    the same prompt padded to its bucket split every row's keys alike
    and get bit-equal rows: at short prompts the blocks fill the SMs, at
    long ones nothing is split. A `q_offset` call plans for its own
    offset (a late shard's rows reach far more keys than the first's)."""
    chunk = _chunk(B, H, _pow2(Sq), _pow2(Sk), bool(causal), int(window),
                   sms, int(q_offset))
    return chunk, max(n_splits(lo, hi, chunk)
                      for lo, hi in _tiles(Sq, Sk, causal, window,
                                           q_offset))


def schedule(B, H, Sq, Sk, *, causal, window, chunk,
             q_offset=0) -> list[tuple]:
    """The blocks of a TMA-path launch in launch order, as the kernel
    decodes `blockIdx.x`: (q-tile, b*H + h, split, splits, first k-tile,
    end k-tile), q-tiles longest (last) first."""
    blocks = []
    tiles = _tiles(Sq, Sk, causal, window, q_offset)
    for r in reversed(range(len(tiles))):
        lo, hi = tiles[r]
        ns = n_splits(lo, hi, chunk)
        for bh in range(B * H):
            for s in range(ns):
                blocks.append((r, bh, s, ns,
                               *_segment(lo, hi, chunk, s, ns)))
    return blocks


_SMS: dict = {}


def sm_count(device) -> int:
    """The card's SM count (what `plan` spreads the blocks over)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _strides(t) -> list:
    """t's element strides, a dimension of length 1 given the head dim's
    (its coordinate is always 0; a tensor map wants some aligned value)."""
    return [st if n > 1 else t.shape[3]
            for n, st in zip(t.shape[:3], t.stride()[:3])] + [t.stride(3)]


@dataclass
class Call:
    """One prepared call of a C entry point: `run()` launches it again
    on the same operands (what `chip_smoke.py` times)."""
    lib: ctypes.CDLL | None     # None: Sq = 0, nothing to launch
    entry: str
    args: tuple
    out: torch.Tensor
    keep: tuple             # the strides array and the scratch

    def run(self):
        _build.check(self.lib, getattr(self.lib, self.entry)(*self.args),
                     self.entry)


def prepare(q, k, v, *, causal=True, window=0, sm_scale=None, cap=0.0,
            q_offset=0, entry=None) -> Call:
    """The output and the arguments of the one C call `attention` makes
    for CUDA operands (validated by `_check` first); `entry` names
    another bf16 entry than `route`'s (`chip_smoke.py` times the generic
    kernel on the serving shapes with it)."""
    B, H, Sq, Dk = q.shape
    KVH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dk)
    if Dk > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims ({Dk}, {Dv}) above the kernel's "
                         f"{MAX_HEAD_DIM}")
    if B * H > 65535 or max(Sq, Sk) >= 2 ** 31:
        raise ValueError(f"B*H={B * H} or S={max(Sq, Sk)} out of range")
    if q_offset < 0 or q_offset + Sq >= 2 ** 31:
        raise ValueError(f"q_offset {q_offset} out of range")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = np.asarray([*_strides(q), *_strides(k), *_strides(v),
                          *out.stride()], np.int64)
    entry = entry or route(q, k, v)
    lib = _build.load("flash_attention", _SIG) if Sq else None
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides.ctypes.data)
    shape = (B, H, KVH, Sq, Sk, Dk, Dv, float(sm_scale), float(cap or 0.0),
             int(bool(causal)), int(window or 0), int(q_offset))
    stream = _build.stream_ptr(q.device)
    scratch = None
    if entry == "flash_attention_generic":
        args = (*head, *shape, stream)
    else:
        chunk = 1
        if q.dtype == torch.bfloat16 and Sq:
            chunk, max_split = plan(B, H, Sq, Sk, causal=bool(causal),
                                    window=int(window or 0),
                                    sms=sm_count(q.device),
                                    q_offset=int(q_offset))
            if max_split > 1:
                rows = B * H * -(-Sq // ROWS) * ROWS
                scratch = torch.empty(max_split * rows * (Dv + 2),
                                      dtype=torch.float32, device=q.device)
        args = (*head, _DTYPES[q.dtype], *shape, chunk,
                None if scratch is None else scratch.data_ptr(), stream)
    return Call(lib, entry, args, out, (strides, scratch))


def shape_key(B: int, Sq: int, Sk: int, causal: bool,
              q_offset: int = 0) -> str:
    """A call's key in `_build.BY_SHAPE`: "BxSq" for a causal call with
    as many keys as queries, "BxSqxSk" for another key count, "/nc"
    after either for a call with no causal mask (an encoder, a
    cross-attention), and "@<q_offset>" last for a call whose queries
    start at a non-zero position (a context-parallel shard)."""
    key = f"{B}x{Sq}" if Sk == Sq else f"{B}x{Sq}x{Sk}"
    key = key if causal else key + "/nc"
    return f"{key}@{q_offset}" if q_offset else key


def _forward(q, k, v, kw):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if q.device.type == "cpu":
        return ref.reference(q, k, v, **kw)
    call = prepare(q, k, v, **kw)
    if q.shape[2] == 0:
        return call.out
    call.run()
    _build.count(call.entry, shape_key(q.shape[0], q.shape[2], k.shape[2],
                                       kw["causal"], kw["q_offset"]))
    return call.out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, sm_scale: float, cap: float,
              q_offset: int) -> torch.Tensor:
    """The forward as one operator: `_forward` on real tensors; under
    `FakeTensorMode` (the dry-run) only its output's shape and dtype,
    with no launch and no (Sq, Sk) scores."""
    return _forward(q, k, v, dict(causal=causal, window=window,
                                  sm_scale=sm_scale, cap=cap,
                                  q_offset=q_offset))


@_flash_op.register_fake
def _(q, k, v, causal, window, sm_scale, cap, q_offset):
    B, H, Sq, _ = q.shape
    return q.new_empty((B, Sq, H, v.shape[3])).transpose(1, 2)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """2 B H Sq Sk (Dk + Dv) whatever the mask: S = Q K^T and P V over
    every key, what the reference's `hlo_cost.analyze` counts for its
    kernel's dots."""
    B, H, Sq, Dk = q_shape
    return 2 * B * H * Sq * k_shape[2] * (Dk + v_shape[3])


class _Attention:
    """The forward's gradient: the backward recomputes the plain version
    on the operands' device and differentiates it, as XLA differentiates
    the reference's plain `chunked_attention` (its Pallas kernel has no
    backward). The recompute materialises the (Sq, Sk) scores and is no
    kernel launch."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, sm_scale, cap, q_offset = inputs
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, sm_scale=sm_scale,
                      cap=cap, q_offset=q_offset)

    @staticmethod
    def backward(ctx, grad):
        """(dq, dk, dv), None where an operand needs no gradient."""
        ops = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in ops if t.requires_grad]
        with torch.enable_grad():
            out = ref.reference(*ops, **ctx.kw)
            got = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(got) if t.requires_grad else None for t in ops)


_flash_op.register_autograd(
    lambda ctx, grad: (*_Attention.backward(ctx, grad),) + (None,) * 5,
    setup_context=_Attention.setup_context)


def attention(q, k, v, *, causal=True, window=0, sm_scale=None, cap=0.0,
              q_offset=0):
    """q: (B,H,Sq,Dk); k: (B,KVH,Sk,Dk); v: (B,KVH,Sk,Dv) -> (B,H,Sq,Dv)
    in q's dtype (float32 or bfloat16), query head h reading kv head
    h // (H // KVH), query row r at position q_offset + r for the masks.
    The default `sm_scale` is 1/sqrt(Dk). One call of the
    `repro_torch::flash_attention` operator: where grad mode is on and
    an operand requires grad, the result carries a `grad_fn` (the
    recompute backward of `_Attention`) on either device; otherwise the
    call makes no autograd record."""
    _check(q, k, v)
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} is negative")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _flash_op(q, k, v, bool(causal), int(window or 0),
                     float(sm_scale), float(cap or 0.0), int(q_offset))


reference = ref.reference
