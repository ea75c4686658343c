"""launches_per_req.solar: launches of the port's hand-written kernels
(`kernels._build.LAUNCHES`, counted by the wrappers) a block read, over
the window. Layer: offload engine (`core.offload_engine.QPContext`
opcode dispatch); moves `kiops`."""
from flexbench import readers


def read(ctx):
    return readers.per(ctx.counters.get("launches", 0), ctx.requests)
