"""Serving CLI: batched requests through the FlexiNS stack — T3 ring
submission, bucketed prefill through the flash kernel, paged batched
decode — on the torch port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --reduced --device cpu            # on the CPU, at smoke size
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --reduced                         # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b          # full width, on the card

`--arch` takes every decoder family the port builds: the dense
decoders (gemma-2b, ...), the MoE decoders granite-moe-1b-a400m and
deepseek-v3-671b (MLA; paged, prompts at their exact lengths), the
hybrid recurrentgemma-2b and the SSM mamba2-780m (the dense engine:
their window, conv and recurrent-state caches are not paged);
`--reduced` shrinks any of them to smoke size. whisper-base (the
encoder-decoder) is refused: the engine, as the reference's, passes no
frame embeddings. `--layers N` cuts the
depth to N layers and keeps every width (deepseek-v3's 61 layers do not
fit one card; 4 do, its 3 dense layers and one MoE layer, plus the MTP
head), and prints the cut.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v3-671b --layers 4   # full width, on the card

The parameters are random, drawn from a `torch.Generator` seeded with
`--seed` on the run's device; the prompts come from a numpy generator
with the same seed. `--pd` routes the requests through `PDServer`:
prefill, the KV transfer as one verbs SEND, the paged ingest round
trip and greedy decode (`--quantize-kv`: int8 KV on the wire).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --reduced --pd [--quantize-kv] --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as tdevice
from repro_torch.configs.base import get_config, reduced as reduce_cfg
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.pd_disagg import PDServer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="gemma-2b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--max-new", type=int, default=12)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=96)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--layers", type=int, default=0,
                   help="cut the depth to this many layers (0: keep it)")
    p.add_argument("--pd", action="store_true",
                   help="prefill/decode disaggregation path")
    p.add_argument("--quantize-kv", action="store_true")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the serving engine passes no frame embeddings to "
            "an encoder-decoder's prefill, as the reference's does not "
            "(repro/serve/engine.py:260-264); train it with "
            "repro_torch.launch.train")
    dev = tdevice.resolve(args.device)
    tdevice.set_default(dev)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.layers and args.layers < cfg.n_layers:
        print(f"{cfg.name}: depth cut {cfg.n_layers} -> {args.layers} "
              f"layers, every width kept")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)

    if args.pd:
        server = PDServer(model, params, max_seq=args.max_seq,
                          page_tokens=8,
                          quantize_bits=8 if args.quantize_kv else 0)
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.requests, 8)).astype(np.int32)
        t0 = time.monotonic()
        toks, stats = server.serve(prompts, n_steps=args.max_new)
        dt = time.monotonic() - t0
        print(f"P/D served {args.requests} requests in {dt:.2f}s on {dev}; "
              f"KV payload {stats.payload_bytes/1e6:.2f}MB, "
              f"headers {stats.header_bytes}B "
              f"({stats.header_bytes/stats.payload_bytes:.2e} of payload)")
        for i, row in enumerate(toks):
            print(f"req {i}: {row.tolist()}")
        return toks, stats

    eng = ServeEngine(model, params, max_batch=args.max_batch,
                      max_seq=args.max_seq)
    t0 = time.monotonic()
    for _ in range(args.requests):
        plen = int(rng.integers(3, 10))
        eng.submit(rng.integers(0, cfg.vocab_size, plen).tolist(),
                   max_new_tokens=args.max_new)
    results = eng.run_until_done()
    dt = time.monotonic() - t0
    total_toks = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests / {total_toks} tokens "
          f"in {dt:.2f}s ({total_toks/dt:.1f} tok/s) on {dev}; "
          f"ring DMA writes={eng.ring.dma_writes} reads={eng.ring.dma_reads}")
    for rid, toks in results.items():
        print(f"req {rid}: {toks}")
    eng.close()
    return results


if __name__ == "__main__":
    main()
