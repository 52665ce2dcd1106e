"""stream.blocks_host_ms: host ms per traced dispatch inside the program's
``vp3d.stream.blocks`` span: the residual blocks and the shrink, for the
``int8_fused`` engine the ring slots, the launch's operand checks and pointer
tables and the K5 launch."""

from perfbench import spans


def read(ctx):
    return spans.host_ms_per(ctx, "vp3d.stream.blocks", "dispatches")
