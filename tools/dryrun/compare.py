#!/usr/bin/env python3
"""Port ÷ reference, cell by cell, of two dry-run directories: the
port's (`python -m repro_torch.launch.dryrun --out P`) and the
reference's (`python -m repro.launch.dryrun --out R`), each a folder of
one JSON a cell (`<arch>__<shape>__<mesh>.json`):

    python3 tools/dryrun/compare.py P/baseline R/baseline [B/baseline]

Per rank: `flops_dev` (in a train cell less the port's flash recompute:
its backward recomputes one forward, `flash_recompute_flops` where the
record has it, else half the operator's count under remat, all of it
without), argument, temp and wire bytes, and the
bounds' verdict (FLOPs within 5 %, arguments within 1 %, temp within
2x in train and prefill). With a third folder (an earlier port's), its
ratios too, as "before". Prints a markdown table; exits 1 if a
block-program cell (`"view": "blocks"`) misses a bound. A global-view
cell (a family outside the block program; since the encoder-decoder
joined it, no registered config) would be printed and listed, not held:
the bounds are the block program's.
"""
import glob
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
from repro_torch.configs.base import get_config  # noqa: E402

FLOP_REL, ARG_REL, TEMP_X = 0.05, 0.01, 2.0


def ratios(port: dict, ref: dict, remat: bool) -> dict:
    flops = port["flops_dev"]
    if port["shape"].startswith("train"):
        flops -= port.get("flash_recompute_flops", port.get(
            "flash_flops", 0.0) / (2 if remat else 1))
    pm, rm = port["memory"], ref["memory"]
    return {"flops": flops / ref["flops_dev"],
            "args": pm["argument_bytes"] / rm["argument_bytes"],
            "temp": pm["temp_bytes"] / max(rm["temp_bytes"], 1),
            "wire": port["collectives"]["wire_bytes"]
            / max(ref["collectives"]["wire_bytes"], 1)}


def ok(r: dict, shape: str) -> bool:
    return (abs(r["flops"] - 1) <= FLOP_REL and abs(r["args"] - 1) <= ARG_REL
            and (shape.startswith("decode") or r["temp"] <= TEMP_X))


def main(argv) -> int:
    port_dir, ref_dir = argv[:2]
    before_dir = argv[2] if len(argv) > 2 else None
    cols = ["flops", "args", "temp", "wire"]
    head = "| cell | view | " + " | ".join(cols) + " |"
    if before_dir:
        head += " before: " + " / ".join(cols) + " |"
    print(head)
    print("|" + "---|" * (head.count("|") - 1))
    missed, held, unheld = [], 0, []
    for f in sorted(glob.glob(os.path.join(ref_dir, "*.json"))):
        name = os.path.basename(f)[:-5]
        path = os.path.join(port_dir, name + ".json")
        if not os.path.exists(path):
            continue
        ref, port = json.load(open(f)), json.load(open(path))
        if ref.get("status") != "ok" or port.get("status") != "ok":
            print(f"| {name} | {port.get('status')} | {port.get('error')} |")
            continue
        remat = get_config(port["arch"]).remat
        r = ratios(port, ref, remat)
        row = (f"| {name} | {port.get('view', 'global')} | "
               + " | ".join(f"{r[c]:.4f}" for c in cols) + " |")
        if before_dir:
            bp = os.path.join(before_dir, name + ".json")
            if os.path.exists(bp):
                b = ratios(json.load(open(bp)), ref, remat)
                row += " " + " / ".join(f"{b[c]:.4g}" for c in cols) + " |"
        print(row)
        if port.get("view") != "blocks":
            unheld.append(name)
        else:
            held += 1
            if not ok(r, port["shape"]):
                missed.append(name)
    print(f"\n{len(missed)} of {held} block-program cells miss a bound: "
          f"{missed}" if missed else
          f"\nevery cell within its bounds ({held} block-program cells)")
    if unheld:
        print(f"global view, not held: {unheld}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
