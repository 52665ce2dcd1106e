"""train.step_host_ms: host ms per traced step inside the program's
``vp3d.train.step`` span, ``SupervisedTrainer.step`` from its call to its
return (no synchronise in it)."""

from perfbench import spans


def read(ctx):
    return spans.host_ms_per(ctx, "vp3d.train.step", "steps")
