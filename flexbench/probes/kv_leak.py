"""Probe: device memory that KV page migrations leave behind.

    python3 -m flexbench.probes.kv_leak --seed <n> --requests <r>

Sets up a prefill pod's staging `PagePool` and a decode pod's `PagePool`
for phi4-mini-3.8b's cache (32 layers, 8 KV heads of 128, bf16, pages of
16 tokens: 1 MiB a page a leaf) on a two-pod `verbs.Fabric`, fills the
staging pool with seeded bf16 values, then migrates prompts of 2,048 to
32,768 tokens (log-uniform, from the seed) one by one with
`KVTransferEngine.migrate_pages`, each onto the next pages of a seeded
order of the decode pool's pages. After each request it prints the bytes
landed so far, the growth of `torch.cuda.memory_allocated()` since
set-up, the bytes of WRITE sources that the decode QP's offload context
still holds in its DMA queue, and how many landed pages are not their
source page bit for bit. It stops at the first failure (an
out-of-memory error) or after `--requests`. `--device cpu` runs the
same at a size the CPU holds (a staging slot of 2,048 tokens, a decode
pool of 129 pages).
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from flexbench import run as harness

ARCH = "phi4-mini-3.8b"
PAGE_TOKENS = 16
SIZES = {"cuda": (32768, 8), "cpu": (2048, 1)}   # staging tokens, decode slots


def retained_bytes(torch, ctx) -> int:
    return sum(d.buf.numel() * d.buf.element_size()
               for d in ctx._dma_queue if isinstance(d.buf, torch.Tensor))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import numpy as np
    import torch

    from repro_torch import device as port_device
    from repro_torch import tree, verbs
    from repro_torch.configs.base import get_config
    from repro_torch.core.kvtransfer import KVTransferEngine
    from repro_torch.models.module import is_spec
    from repro_torch.models.registry import build_model
    from repro_torch.serve.paged import PagePool

    dev = torch.device(args.device)
    port_device.set_default(dev)
    tokens, slots = SIZES[dev.type]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mem = (lambda: torch.cuda.memory_allocated(dev)) if dev.type == "cuda" \
        else (lambda: 0)
    t0 = time.perf_counter()
    model = build_model(get_config(ARCH))
    specs = model.cache_specs(1, tokens)
    fabric = verbs.Fabric(pods=2)
    engine = KVTransferEngine(model, 1, tokens, fabric=fabric)
    staging = PagePool(model, fabric.node(fabric.gids[0]).pd, max_batch=1,
                       max_seq=tokens, page_tokens=PAGE_TOKENS)
    decode = PagePool(model, fabric.node(engine.decode_gid).pd,
                      max_batch=slots, max_seq=tokens,
                      page_tokens=PAGE_TOKENS)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)

    def seeded(spec):
        # finite bf16 bit patterns, so a copy compares bit for bit
        bits = torch.randint(-32768, 32767, tuple(spec.shape),
                             dtype=torch.int16, generator=g, device=dev)
        return (bits & -16385).view(torch.bfloat16)
    staging.fill(np.arange(1, 1 + tokens // PAGE_TOKENS),
                 tree.map(seeded, specs, is_leaf=is_spec))
    rng = np.random.default_rng(args.seed)
    n_free = decode.n_pages - 1                      # page 0 is null
    order = 1 + rng.permutation(n_free)
    lo, hi = np.log(2048), np.log(tokens)
    prompt = np.rint(np.exp(rng.uniform(lo, hi, args.requests))).astype(int)
    sync()
    base = mem()
    print(f"set-up {time.perf_counter() - t0:.1f} s, {base} B allocated, "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          flush=True)
    ctx = engine.ep.peer.qp.ctx
    src_pools = staging.regions()
    landed = off = 0
    for i, t in enumerate(prompt):
        k = -(-int(t) // PAGE_TOKENS)
        dst = order[(off + np.arange(k)) % n_free]
        src = np.arange(1, k + 1)
        t1 = time.perf_counter()
        try:
            engine.migrate_pages([(mr, src, rkey, ids) for mr, (rkey, ids)
                                  in zip(staging.mrs, decode.lease(dst))])
            sync()
        except Exception:       # noqa: BLE001 - the finding is the failure
            print(f"request {i}: "
                  f"{traceback.format_exc().splitlines()[-1]}", flush=True)
            break
        ms = (time.perf_counter() - t1) * 1e3
        off = (off + k) % n_free
        landed += k * len(src_pools) * src_pools[0][0].numel() * 2
        s, d = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
        differing = sum(int((a.index_select(0, s).view(torch.int16)
                             != b.index_select(0, d).view(torch.int16))
                            .flatten(1).any(dim=1).sum())
                        for a, b in zip(src_pools, decode.regions()))
        print(f"request {i}: {k} pages, {ms:.1f} ms; landed {landed} B; "
              f"allocated +{mem() - base} B; DMA queue "
              f"{len(ctx._dma_queue)} ops holding "
              f"{retained_bytes(torch, ctx)} B; pages differing {differing}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
