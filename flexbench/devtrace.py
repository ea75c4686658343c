"""The traced window: device operations from `torch.profiler`, host spans
from the port's tracer and the harness, and what they reduce to.

Clocks: the profiler stamps its events in Unix nanoseconds, so the
traced run records the port's spans (`repro_torch.obs.trace`, whose
clock is injectable) and the harness's own spans with `time.time_ns`,
and all three lie on one time line.

`Window.device_ops` keeps the device's own activities (kernels, copies,
sets) that start inside the window. `reduce` gives the seconds the
device was busy (the union of those intervals), the summed seconds of
the operations, the operations that took most time by name, and the
idle time between them, split by the host span that was open: the
port's spans first (the innermost), then the harness's.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

TOP = 10                        # entries in each breakdown list


class Window:
    """`torch.profiler` over the traced window, device activity only."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def device_ops(self, t0_ns: int, t1_ns: int) -> list:
        """(name, start_ns, duration_ns) of every device activity that
        starts in [t0_ns, t1_ns), in start order."""
        from torch.autograd import DeviceType
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:                       # older kineto: microseconds
                s, d = e.start_us() * 1000, e.duration_us() * 1000
            if t0_ns <= s < t1_ns:
                out.append((e.name(), s, d))
        out.sort(key=lambda r: r[1])
        return out


@dataclass
class Summary:
    window_s: float
    busy_s: float                # union of device activity
    op_s: float                  # summed durations of device activity
    ops: int
    device_ops: list = field(default_factory=list)   # [name, seconds]
    idle_gaps: list = field(default_factory=list)    # [host span, seconds]


class Level:
    """Host spans of one level, which do not overlap one another."""

    def __init__(self, spans):
        spans = sorted(spans, key=lambda s: s[1])
        self.names = [s[0] for s in spans]
        self.starts = [s[1] for s in spans]
        self.ends = [s[1] + s[2] for s in spans]

    def overlaps(self, a: int, b: int):
        """(name, lo, hi) of each span's overlap with [a, b)."""
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        while i < len(self.starts) and self.starts[i] < b:
            lo, hi = max(a, self.starts[i]), min(b, self.ends[i])
            if hi > lo:
                yield self.names[i], lo, hi
            i += 1


def _name_idle(gaps, levels) -> dict:
    """Nanoseconds of idle time by the innermost host span open."""
    idle: dict = {}
    for level in levels:
        rest = []
        for a, b in gaps:
            at = a
            for name, lo, hi in level.overlaps(a, b):
                idle[name] = idle.get(name, 0) + hi - lo
                if lo > at:
                    rest.append((at, lo))
                at = max(at, hi)
            if b > at:
                rest.append((at, b))
        gaps = rest
    left = sum(b - a for a, b in gaps)
    if left:
        idle["(no span)"] = left
    return idle


def _merge(ops, t0: int, t1: int) -> list:
    """The busy intervals (clipped to the window) of sorted ops."""
    busy: list = []
    for _, s, d in ops:
        a, b = max(s, t0), min(s + d, t1)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    return busy


def reduce(ops, t0_ns: int, t1_ns: int, levels=()) -> Summary:
    """The window [t0_ns, t1_ns) read from its device ops; idle time is
    named by `levels` (innermost first), the rest "(no span)"."""
    by_name: dict = {}
    for name, _, d in ops:
        by_name[name] = by_name.get(name, 0) + d
    busy = _merge(ops, t0_ns, t1_ns)
    gaps, prev = [], t0_ns
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if t1_ns > prev:
        gaps.append((prev, t1_ns))
    idle = _name_idle(gaps, levels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(
        window_s=(t1_ns - t0_ns) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        op_s=sum(d for _, _, d in ops) / 1e9, ops=len(ops),
        device_ops=[[n, ns / 1e9] for n, ns in top],
        idle_gaps=[[n, ns / 1e9] for n, ns in gap_top])
