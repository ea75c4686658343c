"""T1 — header-only offloading TX path, over the mesh's pod axis.

`transmit` moves a tree across a mesh axis (pod -> pod) with the payload
travelling exactly once over the fattest direct path:

  1. stripe: each leaf is cut to its block under its activation spec
     (packet spraying: each link carries 1/prod(stripe) of the bytes);
  2. wire: one permute along the transfer axis (`_permute_leaf`, a
     `sharding.shard_map` of `sharding.ppermute` by `plan.shift`);
  3. optional int8 wire compression (a scale per trailing row), the
     codec `_quantize` / `_dequantize`, ported bit for bit.

`transmit_staged` is the paper's naive baseline (Fig. 6a/12): every
non-batch dim is replicated first (the staging buffer), permuted
redundantly, then landed back in the streaming layout: the same values,
~stripe-factor more wire bytes. With no mesh, or no `plan.axis` on it,
both are the identity (the tree comes back by reference) and still
count their call on the reference's registry paths
(`tx_engine/transmits`, `tx_engine/staged_transmits`).
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_util
from repro_torch.core.descriptors import TransferPlan
from repro_torch.models import module as mod
from repro_torch.obs import metrics
from repro_torch.parallel import sharding


def _quantize(x: torch.Tensor, bits: int):
    if bits != 8:
        raise ValueError(f"only 8-bit wire quantization exists, not {bits}")
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def _act_leaf_spec(spec: mod.Spec):
    return sharding.resolve_spec(spec.axes, spec.shape, "act")


def _permute_leaf(x, spec, axis: str, shift: int):
    """Every rank's block of x under `spec` moved `shift` places along
    `axis`."""
    return sharding.shard_map(
        lambda x_l: sharding.ppermute(x_l, axis, shift), (spec,), spec)(x)


def _on_axis(plan: TransferPlan) -> bool:
    ctx = sharding.current()
    return ctx is not None and plan.axis in sharding.axis_sizes(ctx.mesh)


def transmit(tree, spec_tree, plan: TransferPlan):
    """FlexiNS path: stripe + direct permute (+ optional int8 wire)."""
    # resolved at call time so per-test registry swaps see it
    metrics.get_registry().scope("tx_engine").counter("transmits").inc()
    if not _on_axis(plan):
        return tree     # no mesh / no pod axis: the transfer is identity

    def one(x, s: mod.Spec):
        spec = _act_leaf_spec(s)
        if plan.quantize_bits:
            q, scale = _quantize(x, plan.quantize_bits)
            q = _permute_leaf(q, spec, plan.axis, plan.shift)
            scale = _permute_leaf(scale, spec, plan.axis, plan.shift)
            return _dequantize(q, scale, x.dtype)
        return _permute_leaf(x, spec, plan.axis, plan.shift)
    return tree_util.map(one, tree, spec_tree)


def transmit_staged(tree, spec_tree, plan: TransferPlan):
    """Naive baseline: payload staged through a replicated buffer before
    the wire (the 'through Arm memory' path, paper Fig. 6a)."""
    metrics.get_registry().scope("tx_engine") \
        .counter("staged_transmits").inc()
    if not _on_axis(plan):
        return tree

    def one(x, s: mod.Spec):
        # stage: replicate over every axis except the batch axes
        spec_r = sharding.resolve_spec(
            tuple("batch" if a == "batch" else None for a in s.axes),
            s.shape, "act")
        x = _permute_leaf(x, spec_r, plan.axis, plan.shift)
        # land back in the streaming layout: a layout, no value change
        return sharding.constrain(x, *s.axes)
    return tree_util.map(one, tree, spec_tree)
