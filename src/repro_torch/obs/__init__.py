"""Telemetry for the verbs stack: metric registry + tracing.

A stdlib-only copy of the reference package's `obs`, with the same scope
and counter names, so a path such as ``qp3/doorbell_writes`` or
``fused/launches`` means the same event on both sides.

  * `repro_torch.obs.metrics` — hierarchical Counter/Gauge/Histogram
    registry (names like ``fabric0/qp3/desc_fetch_dmas``) with cheap
    snapshot/diff and attribute-compatible views so the stack's
    counters live in one place;
  * `repro_torch.obs.trace` — opt-in span tracer over the datapath
    (post_send -> doorbell -> dispatch run -> CQE publish -> poll_cq),
    fixed-ring buffered, exported as Chrome trace_event JSON for
    perfetto; disabled-case overhead is a single None check per batch
    operation.
"""
from repro_torch.obs import trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Probe,
                                     Registry, Scope, counter_attr,
                                     fresh_registry, gauge_attr,
                                     get_registry, instance_scope, scope_of,
                                     set_registry, weak_probe)
from repro_torch.obs.trace import Tracer, install, tracing, uninstall

__all__ = [
    "Counter", "Gauge", "Histogram", "Probe", "Registry", "Scope",
    "counter_attr", "gauge_attr", "fresh_registry", "get_registry",
    "instance_scope", "scope_of", "set_registry", "weak_probe",
    "Tracer", "install", "tracing", "uninstall", "trace",
]
