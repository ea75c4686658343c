"""Flash attention: ONE launch of the hand-written kernel per call.

On a CUDA tensor `attention` is one launch of `csrc/flash_attention.cu`
(online softmax over fixed 64 x 64 tiles, float32 statistics and
accumulator, GQA by `h // G`, causal and window masks, tanh softcap);
on a CPU tensor it is the plain version in `ref.py`; any other device
raises, and so does a build or launch error. `_build.LAUNCHES
["flash_attention"]` counts the launches made on the card.

Differences from the reference's `kernels/flash_attention`, on purpose:

  * Fixed tiles with masked tails: any Sq and Sk run (the Pallas kernel
    asserts that its blocks divide them). `block_q` / `block_k` are
    not taken: the tiles are the kernel's own.
  * Any strides: q, k and v are read through the strides they carry,
    so a permuted view needs no copy, and the result is a (B, H, Sq,
    Dv) view of a tensor laid out (B, Sq, H, Dv) in memory — the
    layout `models.attention.chunked_attention` hands back.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

_P, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"flash_attention": [_P, _P, _P, _P, _P, _INT, _INT, _INT, _INT,
                            _INT, _INT, _INT, _INT, _F, _F, _INT, _INT, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


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


def attention(q, k, v, *, causal=True, window=0, sm_scale=None, cap=0.0):
    """q: (B,H,Sq,Dk); k: (B,KVH,Sk,Dk); v: (B,KVH,Sk,Dv) -> (B,H,Sq,Dv)
    in q's dtype (float32 or bfloat16), query head h reading kv head
    h // (H // KVH). The default `sm_scale` is 1/sqrt(Dk)."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref.reference(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale, cap=cap)
    B, H, Sq, Dk = q.shape
    KVH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if Dk > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims ({Dk}, {Dv}) above the kernel's "
                         f"{MAX_HEAD_DIM}")
    if B * H > 65535 or max(Sq, Sk) >= 2 ** 31:
        raise ValueError(f"B*H={B * H} or S={max(Sq, Sk)} out of range")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if Sq == 0:
        return out
    strides = np.asarray([*q.stride(), *k.stride(), *v.stride(),
                          *out.stride()], np.int64)
    lib = _build.load("flash_attention", _SIG)
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        strides.ctypes.data, _DTYPES[q.dtype], B, H, KVH, Sq, Sk, Dk, Dv,
        float(sm_scale), float(cap or 0.0), int(bool(causal)),
        int(window or 0), _build.stream_ptr(q.device))
    _build.check(lib, rc, "flash_attention")
    _build.count("flash_attention")
    return out


reference = ref.reference
