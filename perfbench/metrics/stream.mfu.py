"""stream.mfu: the whole dispatch's share of the int8 peak over the untraced
window of the traced run: the causal model's operations per pose times the poses
delivered."""

from perfbench import counts


def read(ctx):
    win = ctx["window"]
    ops = counts.ops_per_pose(ctx["config"]) * win["poses"]
    return 100.0 * ops / win["seconds"] / counts.PEAKS["ops_per_s"]["int8"]
