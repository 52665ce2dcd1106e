"""stream.k5_roofline_pct: K5's share of its roofline.  The least time of one
frame through every residual block and the shrink for all streams (int8, from the
shapes), times the traced dispatches, over the device time of
``stream_int8_kernel``."""

from perfbench import counts


def read(ctx):
    traced, cfg = ctx["traced"], ctx["config"]
    device_s = traced["trace"].device_s(lambda name: "stream_int8_kernel" in name)
    if device_s <= 0:
        return None
    b = traced["streams"]
    bound = counts.bound_s(counts.stream_blocks_ops(cfg, b),
                           counts.stream_blocks_bytes(cfg, b), "int8")
    return 100.0 * bound * traced["dispatches"] / device_s
