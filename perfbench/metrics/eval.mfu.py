"""eval.mfu: the whole forward's share of the peak of the cell's compute dtype,
over the untraced window of the traced run: the model operations of every frame
computed (test-time augmentation and the batcher's padding included)."""

from perfbench import counts


def read(ctx):
    win = ctx["window"]
    dtype = ctx["traffic"]["compute_dtype"]
    return 100.0 * win["ops"] / win["seconds"] / counts.PEAKS["ops_per_s"][dtype]
