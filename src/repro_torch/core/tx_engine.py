"""T1 — header-only offloading TX path.

In the reference, `transmit` moves a sharded tree across the mesh's
`pod` axis with the payload travelling exactly once over the fattest
direct path (striped, one collective permute, optional int8 wire
compression), and `transmit_staged` is the paper's naive baseline that
replicates the payload before the wire (Fig. 6a/12).

The port runs in one process with no sharding context, so there is no
pod axis to cross: both functions count their call on the reference's
registry paths (`tx_engine/transmits`, `tx_engine/staged_transmits`)
and return the tree unchanged — by reference, exactly as the reference
does when ``plan.axis`` is not a mesh axis. The `torch.distributed`
wire between processes comes with the parallelism slice (ROADMAP).

`_quantize` / `_dequantize` are the int8 wire codec (a scale per
trailing row), ported exactly: the tests hold them bit for bit against
the reference's functions.
"""
from __future__ import annotations

import torch

from repro_torch.core.descriptors import TransferPlan
from repro_torch.obs import metrics


def _quantize(x: torch.Tensor, bits: int):
    if bits != 8:
        raise ValueError(f"only 8-bit wire quantization exists, not {bits}")
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def transmit(tree, spec_tree, plan: TransferPlan):
    """FlexiNS path: stripe + direct permute (+ optional int8 wire); the
    identity in one process (no pod axis)."""
    # resolved at call time so per-test registry swaps see it
    metrics.get_registry().scope("tx_engine").counter("transmits").inc()
    return tree


def transmit_staged(tree, spec_tree, plan: TransferPlan):
    """Naive baseline: payload staged through a replicated buffer before
    the wire; the identity in one process (no pod axis)."""
    metrics.get_registry().scope("tx_engine") \
        .counter("staged_transmits").inc()
    return tree
