"""eval.k3_roofline_pct: K3's share of its roofline.  The least time of the traced
videos' forwards (expand block, mid blocks, shrink block: the operations and bytes
of each call, from its shape) over the device time of the ``k3_*`` kernels."""

from perfbench import counts


def read(ctx):
    traced, cfg = ctx["traced"], ctx["config"]
    dtype = ctx["traffic"]["compute_dtype"]
    device_s = traced["trace"].device_s(lambda name: "k3_" in name)
    if device_s <= 0:
        return None
    bound = sum(counts.bound_s(counts.dilated_forward_ops(cfg, rows, t_in),
                               counts.dilated_forward_bytes(cfg, rows, t_in, dtype), dtype)
                for rows, t_in in traced["calls"])
    return 100.0 * bound / device_s
