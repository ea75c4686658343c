"""The control -- the reference in the program's place one precision
below what the configuration states -- fails the comparison."""
import json
import subprocess
import sys
import time

import pytest
import torch

from flexbench import cells, control
from flexbench import run as harness
from flexbench.tests.helpers import SOLAR_CPU


@pytest.mark.parametrize("cell", ["solar.randread.c128qd32",
                                  "solar.randread.c1qd32"])
def test_the_bf16_control_fails_a_solar_cell(cpu, cell):
    c = cells.resolve(cell)
    cfg = dict(c.config, **SOLAR_CPU)
    for seed in (1, 2, 3):
        drv = control.SolarControl(cfg, c.mix, seed, cpu)
        sync = harness._sync_fn(torch, cpu)
        first, _ = harness.warm_up(drv, sync)
        w = harness.drive(drv, 0.2, first, sync, time.perf_counter_ns,
                          harness.Reservoir(drv.sample_size, seed), False)
        got = drv.check(w.samples)
        lim = cfg["limits"]
        assert got["words_differing"] > lim["words_differing"]
        assert got["crc_gap"] > 3 * lim["crc_gap"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["solar.randread.c128qd32",
                                  "solar.randread.c1qd32"])
def test_the_control_fails_on_the_card_at_the_cells_size(card, cell):
    out = subprocess.run([sys.executable, "-m", "flexbench.control",
                          "--workload", cell, "--seeds", "11,12,13",
                          "--seconds", "3"], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr
    rows = [json.loads(x) for x in out.stdout.splitlines()]
    assert len(rows) == 3
    assert all(r["correct"] is False for r in rows)
