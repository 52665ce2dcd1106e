"""semi.traj_forward_ms: device ms per traced step of the kernels and memsets
launched inside the program's ``vp3d.train.traj`` span, the trajectory
network's forward."""

from perfbench import spans


def read(ctx):
    traced = ctx["traced"]
    s = spans.device_s(traced["trace"], "vp3d.train.traj")
    return None if s is None else s * 1e3 / traced["steps"]
