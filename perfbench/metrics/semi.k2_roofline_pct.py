"""semi.k2_roofline_pct: K2's share of its roofline in the semi-supervised step.
The least time of both networks' residual-block work, forward and backward, on
the concatenated rows of the traced steps (counted from the shapes) over the
device time of the operations launched inside the ``K2 forward`` /
``K2 backward`` ranges around ``FusedTrainBlock``."""

from perfbench import counts, counts_semi


def read(ctx):
    traced, cfg = ctx["traced"], ctx["config"]
    dtype = ctx["traffic"]["compute_dtype"]
    device_s = traced["trace"].device_s(range_prefix="K2 ")
    if device_s <= 0:
        return None
    rows = traced["rows"]
    bound = counts.bound_s(counts_semi.semi_block_ops(cfg, rows),
                           counts_semi.semi_block_bytes(cfg, rows, dtype), dtype)
    return 100.0 * bound * traced["steps"] / device_s
