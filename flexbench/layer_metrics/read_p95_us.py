"""read_p95_us: the 95th percentile of a block read's latency, from the
harness's host clock around each request (issue to completion), over
every request of the traced window. Layer: service
(`core.solar.SolarBlockStore.read_flexins`); moves `kiops`."""
from flexbench import readers


def read(ctx):
    v = readers.p95(ctx.latencies_s)
    return None if v is None else v * 1e6
