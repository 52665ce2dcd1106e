"""semi.mfu: the whole semi-supervised step's share of the card's peak, over the
untraced window of the traced run: both networks' model operations on every
row of every step (``counts_semi.py``, from the shapes) over the window's
time."""

from perfbench import counts, counts_semi


def read(ctx):
    win, cfg = ctx["window"], ctx["config"]
    dtype = ctx["traffic"]["compute_dtype"]
    ops = counts_semi.semi_step_ops(cfg, win["rows"]) * win["steps"]
    return 100.0 * ops / win["seconds"] / counts.PEAKS["ops_per_s"][dtype]
