"""blockread_roofline: the share of the device time of a block read's
operations that its bytes need at the HBM peak. The bytes are what the
requests need (`work.block_read_bytes`: blocks read and written once,
checksums, int64 LBAs); the time is every device operation of the
traced window (kernels, copies), which runs only the request path.
Layer: kernels (`csrc/wr_rows.cu` gather_rows and the checksum); moves
`kiops`."""
from flexbench import work


def read(ctx):
    if ctx.device is None or "lbas" not in ctx.counters:
        return None
    return work.roofline_pct(work.block_read_bytes(ctx.counters["lbas"]),
                             ctx.device.op_s)
