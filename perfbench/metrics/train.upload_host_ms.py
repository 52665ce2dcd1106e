"""train.upload_host_ms: host ms per traced step inside the program's
``vp3d.train.upload`` span, the copy of the sampler's descriptors from host
memory to the card."""

from perfbench import spans


def read(ctx):
    return spans.host_ms_per(ctx, "vp3d.train.upload", "steps")
