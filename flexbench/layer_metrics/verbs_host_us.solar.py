"""verbs_host_us.solar: host microseconds a block read spends in the
port's verbs spans (post_send, dispatch_run, cqe_publish, poll_cq;
`repro_torch.obs.trace`), summed over the window and divided by the
requests. Layer: verbs; moves `kiops`."""
from flexbench import readers


def read(ctx):
    v = readers.per(readers.port_span_s(ctx), ctx.requests)
    return None if v is None or not ctx.port_spans else v * 1e6
