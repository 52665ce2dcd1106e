"""train.mfu: the whole training step's share of the card's peak, over the
untraced window of the traced run: the model operations of every step (every
convolution forward and backward, from the shapes) over the window's time."""

from perfbench import counts


def read(ctx):
    win, cfg = ctx["window"], ctx["config"]
    dtype = ctx["traffic"]["compute_dtype"]
    ops = counts.train_step_ops(cfg, win["batch"]) * win["steps"]
    return 100.0 * ops / win["seconds"] / counts.PEAKS["ops_per_s"][dtype]
