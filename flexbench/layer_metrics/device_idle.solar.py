"""device_idle.solar: the share of the traced window in which no
operation ran on the card (`torch.profiler`). Layer: device; moves
`kiops`."""
from flexbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
