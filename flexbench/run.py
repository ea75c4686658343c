"""One run of one cell of the port's benchmark.

    python3 -m flexbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Each run is a fresh process: it sets up the
cell's deployment on the card (`setup_s` counts from process start to
the first timed request, warm-up included), drives a closed loop of the
cell's traffic for `--seconds`, checks a seeded sample of what the
timed requests returned against the plain reference under
`flexbench/reference/`, and prints one JSON line last on standard
output. With `--trace 0` its metrics are the cell's end-to-end metrics;
with `--trace 1` the window runs under the port's span tracer and
`torch.profiler`, and its metrics are the cell's per-layer metrics,
each read by `flexbench/layer_metrics/<metric>.py`.

Exit codes: 0 with a result line (whether or not `correct`); 2 without
one when there is no card or too few; 1 without one when the run could
not finish (a module of JAX or of the JAX package `repro` loaded, the
tracer dropped spans, the profiler saw no device time).
"""
import time

_T0 = time.perf_counter()       # process start, before the heavy imports

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_REQUESTS = 16              # the first, then WARM_S seconds more
WARM_S = 1.0


class RunError(RuntimeError):
    """The run cannot give a sound result line: it prints none."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (`repro_torch` is not `repro`)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def prepare_environment():
    """The port on the path, its caches at fixed paths in the checkout,
    and no JAX for any library that would load it by itself."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


@dataclass
class Window:
    """What the timed loop saw."""
    requests: int = 0
    failed: int = 0
    t_start: int = 0             # clock ns
    t_end: int = 0
    latencies_ns: list = field(default_factory=list)
    issue: list = field(default_factory=list)      # per request, clock ns
    ret: list = field(default_factory=list)
    done: list = field(default_factory=list)
    samples: list = field(default_factory=list)    # (index, handle)

    @property
    def seconds(self) -> float:
        return (self.t_end - self.t_start) / 1e9


@dataclass
class LayerContext:
    """What a per-layer metric's reader may read."""
    cell: str
    config: dict
    mix: dict
    requests: int
    latencies_s: list
    counters: dict               # the driver's counts (program counters,
                                 # LBAs) over the window
    port_spans: list             # (name, start_ns, duration_ns)
    device: object               # devtrace.Summary


class Reservoir:
    """A uniform sample of `k` of the window's requests, drawn from the
    seed (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: list = []
        self.seen = 0
        self._rng = random.Random(f"flexbench-sample-{seed}")

    def offer(self, item):
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _sync_fn(torch, device):
    if device.type != "cuda":
        return lambda: None
    ev = torch.cuda.Event()

    def sync():
        ev.record()
        ev.synchronize()
    return sync


def warm_up(driver, sync) -> tuple[int, float]:
    """Requests of the cell's own shapes: WARM_REQUESTS (which build and
    load the kernels), then more until WARM_S seconds have passed since
    them; returns (requests, the steady requests a second)."""
    i = 0
    while i < WARM_REQUESTS:
        driver.issue(i)
        sync()
        i += 1
    t0 = time.perf_counter()
    while i < 2 * WARM_REQUESTS or time.perf_counter() - t0 < WARM_S:
        driver.issue(i)
        sync()
        i += 1
    return i, (i - WARM_REQUESTS) / (time.perf_counter() - t0)


def drive(driver, seconds: float, first: int, sync, clock, sampler,
          keep_spans: bool) -> Window:
    """The closed loop: issue, wait for completion, next, until the
    window's time is up; the window ends at the last completion."""
    w = Window()
    lat = w.latencies_ns
    w.t_start = clock()
    deadline = w.t_start + int(seconds * 1e9)
    i = first
    t_done = w.t_start
    while True:
        t0 = clock()
        if t0 >= deadline:
            break
        try:
            h = driver.issue(i)
            t1 = clock()
            sync()
        except Exception:       # noqa: BLE001 - reported, ends the window
            w.failed += 1
            w.requests += 1
            log(traceback.format_exc())
            t_done = clock()
            break
        t_done = clock()
        lat.append(t_done - t0)
        if keep_spans:
            w.issue.append(t0)
            w.ret.append(t1)
            w.done.append(t_done)
        sampler.offer((i, h))
        i += 1
        w.requests += 1
    w.t_end = t_done
    w.samples = sampler.items
    return w


def harness_spans(w: Window) -> list:
    """The harness's own host spans: the entry call, the wait for the
    completion, and the client's time between requests."""
    out = []
    prev = w.t_start
    for a, b, c in zip(w.issue, w.ret, w.done):
        out += [("flexbench.client", prev, a - prev),
                ("flexbench.entry", a, b - a), ("flexbench.wait", b, c - b)]
        prev = c
    return out


def _counters_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> dict:
    """The last line of standard output: the result's keys, then the
    numbers compared with their limits under a key of their own, last."""
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def execute(cell, seed: int, seconds: float, traced: bool, device,
            t0: float) -> dict:
    """One run of `cell` on `device`; returns the result line."""
    import torch

    from flexbench import cells as cells_mod
    from flexbench import devtrace

    driver_mod = cells_mod.load_module(cell.driver_path,
                                       f"flexbench_driver_{cell.config['driver']}")
    cuda = device.type == "cuda"
    sync = _sync_fn(torch, device)
    driver = driver_mod.Driver(cell.config, cell.mix, seed, device)
    warm, rate = warm_up(driver, sync)
    tracer = None
    if traced:
        from repro_torch.obs import trace
        # events a request records, from two traced warm-up requests
        with trace.tracing(capacity=1 << 16, clock=time.time_ns) as probe:
            for i in range(warm, warm + 2):
                driver.issue(i)
                sync()
        warm += 2
        per_req = max(1, len(probe) // 2)
        capacity = max(1 << 16, int(4 * per_req * rate * seconds))
        tracer = trace.install(trace.Tracer(capacity, clock=time.time_ns))
    counters0 = driver.counters()
    sampler = Reservoir(driver.sample_size, seed)
    setup_s = time.perf_counter() - t0
    prof = devtrace.Window() if traced and cuda else None
    try:
        if prof is not None:
            prof.__enter__()
        try:
            w = drive(driver, seconds, warm, sync,
                      time.time_ns if traced else time.perf_counter_ns,
                      sampler, keep_spans=traced)
        finally:
            if prof is not None:
                t_stop = time.perf_counter()
                prof.__exit__(None, None, None)
                log(f"flexbench: profiler stopped in "
                    f"{time.perf_counter() - t_stop:.3f} s")
    finally:
        if tracer is not None:
            from repro_torch.obs import trace
            trace.uninstall()
    counters = _counters_delta(counters0, driver.counters())
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    log(f"flexbench: {cell.name} seed {seed}: set-up {setup_s:.3f} s "
        f"({warm} warm-up requests, {rate:.1f}/s), window {w.seconds:.3f} s, "
        f"{w.requests} requests, {w.failed} failed; counters {counters}")

    # the check: responses to the host, the program's state freed, then
    # the reference (not counted in setup_s, after the peak was read)
    t_check = time.perf_counter()
    host = [(i, driver.host(h)) for i, h in w.samples]
    w.samples = []
    e2e = driver.end_to_end(counters, w.seconds) if w.seconds > 0 else {}
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.check(host)
    log(f"flexbench: reference check of {len(host)} sampled requests "
        f"in {time.perf_counter() - t_check:.3f} s")
    limits = cell.config["limits"]
    if set(numbers) != set(limits):
        raise RunError(f"the check gives {sorted(numbers)}, the "
                       f"configuration limits {sorted(limits)}")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    checks["failed_requests"] = {"value": w.failed, "limit": 0}
    # a window that completed nothing has nothing to compare: not correct
    correct = bool(host) and all(c["value"] <= c["limit"]
                                 for c in checks.values())

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if not traced:
        values = dict(e2e, setup_s=setup_s)
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise RunError(f"{cell.name} reports no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        if tracer.dropped:
            raise RunError(f"the tracer dropped {tracer.dropped} events of "
                           f"{tracer.capacity}: a partial trace")
        t_read = time.perf_counter()
        port = [(e[1], e[2], e[3]) for e in tracer.events() if e[0] == "X"]
        if prof is None:
            raise RunError("no device profiler on "
                           f"{device.type}: no device time to read")
        ops = prof.device_ops(w.t_start, w.t_end)
        levels = [devtrace.Level(port), devtrace.Level(harness_spans(w))]
        summary = devtrace.reduce(ops, w.t_start, w.t_end, levels)
        if summary.busy_s <= 0:
            raise RunError("the profiler saw no device time in the window")
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        breakdown = {"device_ops": summary.device_ops,
                     "idle_gaps": summary.idle_gaps}
        ctx = LayerContext(
            cell=cell.name, config=cell.config, mix=cell.mix,
            requests=w.requests,
            latencies_s=[x / 1e9 for x in w.latencies_ns],
            counters=counters, port_spans=port, device=summary)
        metrics = {}
        for m, path in cell.per_layer:
            reader = cells_mod.load_module(
                path, "flexbench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        log(f"flexbench: traced window: {summary.ops} device ops, busy "
            f"{summary.busy_s:.6f} s of {summary.window_s:.6f} s; "
            f"{len(port)} port spans of {tracer.capacity}; read in "
            f"{time.perf_counter() - t_read:.3f} s")
    return result_line(correct=correct, attempted=w.requests,
                       failed=w.failed, metrics=metrics, device=dev,
                       checks=checks, breakdown=breakdown)


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m flexbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, config=None, bench=None,
         t0=None) -> int:
    """The command. `device`, `config` (keys that replace the
    configuration's) and `bench` (in place of BENCHMARK.json) are for
    the CPU tests, which skip the look for a card and run at a size the
    CPU holds; the command itself always looks for the card."""
    args = parse(argv)
    prepare_environment()
    from flexbench import cells
    cell = cells.resolve(args.workload, bench)
    if config:
        cell.config.update(config)
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"flexbench: {cell.name} needs {cell.chips} CUDA device(s); "
                f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                f"{torch.cuda.device_count()} found")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    from repro_torch import device as port_device
    port_device.set_default(device)
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace),
                         device, _T0 if t0 is None else t0)
    except RunError as e:
        log(f"flexbench: no result: {e}")
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"flexbench: no result: modules of {bad} are loaded")
        return 1
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
