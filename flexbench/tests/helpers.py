"""Runs of the harness at a size the CPU holds."""
import json
import time

from flexbench import run

SOLAR_CPU = {"n_blocks": 4096}


def cpu_run(capsys, cell: str, *, trace: int = 0, seconds: float = 0.3,
            seed: int = 3_000_000_019):
    """(exit code, result line or None, standard error) of one run."""
    rc = run.main(["--workload", cell, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  device="cpu", config=SOLAR_CPU, t0=time.perf_counter())
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), out.err
