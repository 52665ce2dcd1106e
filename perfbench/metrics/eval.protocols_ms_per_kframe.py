"""eval.protocols_ms_per_kframe: host ms inside the program's
``vp3d.eval.protocols`` span (the four protocols on the host and the target's
preparation) per 1,000 evaluated frames of the traced stretch."""

from perfbench import spans


def read(ctx):
    traced = ctx["traced"]
    s = spans.host_s(traced["trace"], "vp3d.eval.protocols")
    return None if s is None else s * 1e3 / (traced["frames"] / 1000.0)
