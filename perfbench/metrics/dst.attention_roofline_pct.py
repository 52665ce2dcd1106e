"""dst.attention_roofline_pct: the attention cores' share of their roofline.  The
least time of every core's forward and backward in the traced steps (the larger
of the operations at the float32 peak and the bytes, Q, K, V, O and the
probabilities written and read once, at the memory's, ``counts_dstformer.py``)
over the device time launched inside ``vp3d.dst.attention.*``."""

from perfbench import counts, counts_dstformer, spans


def read(ctx):
    traced, cfg = ctx["traced"], ctx["config"]
    device_s = spans.device_s(traced["trace"], "vp3d.dst.attention.")
    if device_s is None:
        return None
    dtype = ctx["traffic"]["compute_dtype"]
    clips, frames = traced["batch"], cfg["maxlen"]
    bound = counts.bound_s(counts_dstformer.attention_core_ops(cfg, clips, frames),
                           counts_dstformer.attention_core_bytes(cfg, clips, frames, dtype),
                           dtype)
    return 100.0 * bound * traced["steps"] / device_s
