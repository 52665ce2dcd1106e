"""dst.attention_ms: device ms per traced step of the kernels and memsets
launched inside the program's ``vp3d.dst.attention.spatial`` and
``vp3d.dst.attention.temporal`` spans: the attention cores' forward and
backward."""

from perfbench import spans


def read(ctx):
    traced = ctx["traced"]
    s = spans.device_s(traced["trace"], "vp3d.dst.attention.")
    return None if s is None else s * 1e3 / traced["steps"]
