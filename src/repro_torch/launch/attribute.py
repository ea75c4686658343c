"""Collective-byte attribution for one cell — the dry-run "profiler":

    PYTHONPATH=src python -m repro_torch.launch.attribute --arch gemma-2b \\
        --shape train_4k [--multi] [--set seq_parallel=True]

The port of the reference's `repro.launch.attribute`: the cell is
traced as `launch.dryrun` traces it (rank 0 of a fake process group, on
fake tensors), and the wire bytes of its collectives are printed by
(collective, source), largest first. The source is the port function
that issued the collective (`utils.hlo_cost.source`), such as
`collectives._context_parallel_attention` or `moe._moe_a2a`, where the
reference prints the JAX op_name.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import dryrun
from repro_torch.utils import hlo_cost


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", default="train_4k")
    p.add_argument("--multi", action="store_true")
    p.add_argument("--set", action="append", default=[])
    args = p.parse_args(argv)
    flags = dryrun.parse_set(args.set)
    records: list = []
    try:
        rec = dryrun.lower_cell(args.arch, args.shape, args.multi, flags,
                                records=records)
    finally:
        dryrun._teardown()
    if rec["status"] != "ok":
        print(f"{rec['status']}: {rec.get('reason', '')}")
        return []
    rows = hlo_cost.attribute_collectives(records)
    for b, op, name in rows:
        print(f"{b/1e9:9.2f}GB {op:18s} {name}")
    return rows


if __name__ == "__main__":
    main()
