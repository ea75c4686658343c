"""Time the TMA bulk-copy ring (`ring.cu` here) against the row-copy
kernel the port ships (`src/repro_torch/csrc/wr_rows.cu`, one 16-byte
word per thread) and the library call, at the main paths' shapes.

    python3 tools/row_ring/probe.py        # from the repo root, on a card

Each shape is first held exact (ring, word copy and plain result equal),
then timed with `chip_smoke.Timer.rounds`: 5 rounds of 20 turns, every
call after a clean-L2 eviction (a 256 MiB read), the versions
interleaved in a seeded order per round; median of the round medians and
their spread, in ms. The ring's plan: min(rows, 4 x SMs) one-warp CTAs,
4 stages of one row (rows up to 8 KiB). Prints the card's `nvidia-smi`
line, one line per shape and a JSON object of the numbers.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CTAS_PER_SM, STAGES, STAGE_MAX = 4, 4, 8192


def plan(rows: int, row_bytes: int, sms: int) -> tuple[int, int, int]:
    """(grid, stages, stage bytes): stages as even as 16-byte multiples
    allow, each at most STAGE_MAX; min(rows, CTAS_PER_SM x sms) CTAs; no
    more stages than the busiest CTA has tiles."""
    n = -(-row_bytes // STAGE_MAX)
    stage = -(-(-(-row_bytes // n)) // 16) * 16
    chunks = -(-row_bytes // stage)
    grid = min(rows, CTAS_PER_SM * sms)
    return grid, min(STAGES, -(-rows // grid) * chunks), stage


def build_ring():
    from repro_torch.kernels import _build
    src = Path(__file__).resolve().parent / "ring.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"libring_rows-{digest.hexdigest()[:12]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(out), str(src)], capture_output=True,
                              text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n"
                               f"{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ring_rows.argtypes = [P, P, P, I64, I64, INT, I64, I64, I64, P]
    lib.ring_rows.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.wr_scatter import ops as wr_ops

    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ring, word = build_ring(), _build.load("wr_rows", wr_ops._SIG)
    stream = _build.stream_ptr(dev)
    T = cs.Timer(torch)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def case(name, entry, scatter, dst, src, offs, library):
        n = offs.numel()
        row_bytes = math.prod(src.shape[1:] if scatter else dst.shape[1:]) \
            * dst.element_size()
        args = (dst.data_ptr(), src.data_ptr(), offs.data_ptr(), n,
                row_bytes)
        grid, stages, stage = plan(n, row_bytes, sms)

        def k_word():
            _build.check(word, getattr(word, entry)(*args, stream), entry)

        def k_ring():
            _build.check(ring, ring.ring_rows(*args, int(scatter), grid,
                                              stages, stage, stream),
                         "ring_rows")
        # exact: each design's rows, written over zeros, equal the plain
        # result
        for fn in (k_word, k_ring):
            if scatter:
                dst[offs] = 0
            else:
                dst.zero_()
            fn()
            got = dst[offs] if scatter else dst
            cs.check(torch.equal(got, src if scatter else src[offs]),
                     f"{name}: {fn.__name__} != plain")
        t = T.rounds({"word": k_word, "ring": k_ring, "library": library})
        res = {k: dict(ms=v["ms"], lo=v["lo"], hi=v["hi"])
               for k, v in t.items()}
        res["bound_ms"] = cs.bound_ms(2 * n * row_bytes + 8 * n)
        res["plan"] = dict(grid=grid, stages=stages, stage_bytes=stage)
        print(f"{name}: " + "  ".join(
            f"{k} {v['ms']:.4f} ({v['lo']:.4f}-{v['hi']:.4f})"
            for k, v in res.items() if k in t)
            + f"  bound {res['bound_ms']:.4f} ms  ring plan {res['plan']}",
            flush=True)
        return res

    out = {}
    S = cs.FULL
    R, L, m = S.blocks, S.rec, S.n
    region = torch.rand((R, L), generator=gen, device=dev)
    offs = torch.from_numpy(rng.choice(R, size=m, replace=False)).to(dev)
    vals = torch.rand((m, L), generator=gen, device=dev)
    out["scatter 12 GiB"] = case(
        "scatter_rows 4096 x 4 KiB into 12 GiB", "scatter_rows", True,
        region, vals, offs, lambda: region.index_put_((offs,), vals))
    rec = torch.empty_like(vals)
    out["gather records"] = case(
        "gather_rows 4096 x 4 KiB from 12 GiB", "gather_rows", False, rec,
        region, offs, lambda: region.index_select(0, offs))
    del region
    small = torch.zeros((m, L), device=dev)
    perm = torch.from_numpy(rng.permutation(m)).to(dev)
    out["scatter 16 MiB"] = case(
        "scatter_rows 4096 x 4 KiB into 16 MiB", "scatter_rows", True,
        small, vals, perm, lambda: small.index_put_((perm,), vals))
    slots = torch.randn((m, L), generator=gen, device=dev)
    out["ring gather"] = case(
        "ring_pipe_consume 4096 of 4096 slots of 4 KiB",
        "ring_pipe_consume", False, rec, slots, perm,
        lambda: slots.index_select(0, perm))
    del small, slots, rec, vals
    K = cs.KV
    n = K.seq // K.page
    page = (K.page, 1, 256)         # gemma-2b: 1 kv head of 256
    pages = torch.randn((n,) + page, generator=gen, device=dev,
                        dtype=torch.bfloat16)
    payload = torch.randn_like(pages)
    ids = torch.from_numpy(rng.permutation(n)).to(dev)
    out["ingest"] = case(
        f"ingest_pages {n} pages of 8 KiB", "ingest_pages", True, pages,
        payload, ids, lambda: pages.index_copy_(0, ids, payload))
    got = torch.empty_like(payload)
    out["page gather"] = case(
        f"gather_rows {n} pages of 8 KiB", "gather_rows", False, got, pages,
        ids, lambda: pages.index_select(0, ids))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
