"""Roofline terms from the dry-run's counts (NVIDIA H100 SXM5 80GB).

The port of the reference's `repro.utils.roofline`:

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = wire_bytes_per_device / link_bw

The counts are per device already (the dry-run traces one rank's
program), so "/ chips" is implicit. MODEL_FLOPS uses 6·N_active·D
(train), 2·N_active·D (prefill), 2·N_active·B (decode) plus KV-read
terms for decode memory sanity.

`HW` is NVIDIA's datasheet row for the H100 SXM5 80GB HBM3 at 700 W,
the card the port runs on, not a measurement: 989.4e12 dense bf16
FLOP/s on the tensor cores, 3.35e12 B/s of HBM3. `link_bw` keeps the
reference's "1 link, conservative" rule: a 16-wide mesh line spans two
8-GPU NVLink nodes, so its slowest link is one 400 Gb/s NDR NIC per GPU,
50e9 B/s.
"""
from __future__ import annotations

from dataclasses import dataclass

HW = {
    "bf16_flops": 989.4e12,   # per card, dense bf16 (datasheet)
    "hbm_bw": 3.35e12,        # bytes/s (datasheet)
    "link_bw": 50e9,          # bytes/s per link (conservative: 1 NIC)
}


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        # perfect-overlap lower bound: step time = max of the three terms
        return max(self.compute_s, self.memory_s, self.collective_s)

    def asdict(self) -> dict:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant}


def roofline_terms(flops_dev: float, bytes_dev: float,
                   wire_bytes_dev: float) -> Roofline:
    return Roofline(flops_dev / HW["bf16_flops"],
                    bytes_dev / HW["hbm_bw"],
                    wire_bytes_dev / HW["link_bw"])


def model_flops(cfg, shape, n_active: int) -> float:
    """Useful-math FLOPs for the whole step (all chips)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * B * S
    if shape.kind == "prefill":
        return 2.0 * n_active * B * S
    # decode: one token per sequence + attention over the cache
    attn = 0.0
    if cfg.n_kv_heads and cfg.family not in ("ssm",):
        hd = cfg.resolved_head_dim
        attn = 4.0 * B * S * cfg.n_heads * hd * cfg.n_layers
    return 2.0 * n_active * B + attn


def mfu(model_flops_total: float, step_s: float, chips: int) -> float:
    return model_flops_total / (step_s * chips * HW["bf16_flops"])
