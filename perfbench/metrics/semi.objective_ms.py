"""semi.objective_ms: device ms per traced step of the kernels and memsets
launched inside the program's ``vp3d.train.project`` span (the back-projection
through the camera model and its MPJPE) and ``vp3d.train.bones`` span (the
bone-length term): the objective's forward beyond the two supervised losses."""

from perfbench import spans


def read(ctx):
    traced = ctx["traced"]
    found = [s for s in (spans.device_s(traced["trace"], name)
                         for name in ("vp3d.train.project", "vp3d.train.bones"))
             if s is not None]
    return sum(found) * 1e3 / traced["steps"] if found else None
