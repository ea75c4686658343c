"""What the per-layer readers share: the port's span names and the
statistics they take over a window."""
from __future__ import annotations

import numpy as np

# the port's verbs span chain (`repro_torch.obs.trace`): post_send ->
# doorbell (an instant) -> dispatch_run:<opcode> -> cqe_publish -> poll_cq
PORT_SPANS = ("post_send", "dispatch_run", "cqe_publish", "poll_cq")


def p95(values) -> float | None:
    """The 95th percentile (numpy's linear interpolation) of all values;
    None when there are none."""
    return float(np.percentile(values, 95)) if len(values) else None


def port_span_s(ctx) -> float:
    """Seconds in the port's verbs spans over the window."""
    return sum(d for name, _, d in ctx.port_spans
               if name.split(":", 1)[0] in PORT_SPANS) / 1e9


def per(total: float, count: int) -> float | None:
    return total / count if count else None


def idle_pct(ctx) -> float | None:
    dev = ctx.device
    if dev is None or dev.window_s <= 0 or dev.busy_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
