"""dst.mfu: the DSTformer training step's share of the card's float32 peak over
the untraced window of the traced run: the model operations of every step (3x
the forward's, every clip of the batch computed, ``counts_dstformer.py`` from
the shapes) over the window's time."""

from perfbench import counts, counts_dstformer


def read(ctx):
    win, cfg = ctx["window"], ctx["config"]
    ops = counts_dstformer.train_step_ops(cfg, win["batch"], cfg["maxlen"]) * win["steps"]
    return 100.0 * ops / win["seconds"] / counts.PEAKS["ops_per_s"][ctx["traffic"]["compute_dtype"]]
