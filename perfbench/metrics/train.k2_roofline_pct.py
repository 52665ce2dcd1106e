"""train.k2_roofline_pct: K2's share of its roofline.  The least time of the
residual blocks' forward and backward work of the traced steps (counted from the
shapes) over the device time of the operations launched inside the ``K2 forward``
/ ``K2 backward`` ranges around ``FusedTrainBlock``."""

from perfbench import counts


def read(ctx):
    traced, cfg = ctx["traced"], ctx["config"]
    dtype = ctx["traffic"]["compute_dtype"]
    device_s = traced["trace"].device_s(range_prefix="K2 ")
    if device_s <= 0:
        return None
    b = traced["batch"]
    bound = counts.bound_s(counts.train_block_ops(cfg, b),
                           counts.train_block_bytes(cfg, b, dtype), dtype)
    return 100.0 * bound * traced["steps"] / device_s
