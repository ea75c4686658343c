"""The card's latency floors (`latency.cu`), kept outside the package:
an empty launch and a bare dependent chase over float32 records'
`next` words. `chip_smoke.py` phase 2 times them beside the kernels
they bound (the device CQ ring's calls; `list_traverse`);
`tools/desc_ring/probe.py` uses its plain `cudaMemcpyAsync`."""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
SOURCE = Path(__file__).resolve().parent / "latency.cu"

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
SIG = {"empty_launch": [_P],
       "chase_next": [_P, _I64, _I64, _I64, _P, _P],
       "dma_copy": [_P, _P, _I64, _P]}


def lib():
    """The built library: `empty_launch(stream)`, `chase_next(recs, rec,
    head, hops, out, stream)` (out: two int64, the record it stops on and
    the hops taken), `dma_copy(dst, src, bytes, stream)`."""
    from repro_torch.kernels import _build
    return _build.load(SOURCE, SIG)
