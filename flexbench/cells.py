"""Find a cell's files by the names in `BENCHMARK.json`.

A cell names a configuration and a traffic mix; the configuration
names its driver. Each lives in a file of its own:

    flexbench/configs/<config>.json        one deployment
    flexbench/traffic/<traffic>.json       one traffic mix
    flexbench/drivers/<driver>.py          sets up and drives a deployment
    flexbench/layer_metrics/<metric>.py    one per-layer metric's reader

so a later change adds a cell, a mix or a metric by adding files and
entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    driver_path: Path
    end_to_end: list            # the BENCHMARK.json entries this cell reports
    per_layer: list             # (entry, reader path)


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(name: str, bench: dict | None = None, here: Path = HERE) -> Cell:
    """The cell `name` with its configuration, mix, driver and readers;
    KeyError when BENCHMARK.json has no such cell, FileNotFoundError
    when a file it names is missing."""
    from flexbench import traffic
    bench = bench if bench is not None else benchmark(here.parent)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((here.parent / conf["file"]).read_text())
    mix = traffic.load(here / "traffic" / f"{w['traffic']}.json")
    driver = here / "drivers" / f"{config['driver']}.py"
    if not driver.exists():
        raise FileNotFoundError(driver)
    # a metric without a `workloads` list: every cell (per-layer: every
    # cell that reports the end-to-end metric it moves)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = []
    for m in bench["per_layer"]:
        if name not in m.get("workloads", [name]) or m["moves"] not in names:
            continue
        reader = here / "layer_metrics" / f"{m['name']}.py"
        if not reader.exists():
            raise FileNotFoundError(reader)
        layer.append((m, reader))
    return Cell(name=name, config=config, mix=mix, chips=int(w["chips"]),
                driver_path=driver, end_to_end=e2e, per_layer=layer)


def load_module(path: Path, name: str):
    """Import a file of its own by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
