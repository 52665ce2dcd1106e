"""eval.h2d_ms_per_kframe: device ms of the host-to-device copies of the traced
stretch (the evaluator's input copies) per 1,000 evaluated frames."""


def read(ctx):
    traced = ctx["traced"]
    s = traced["trace"].device_s(lambda name: "HtoD" in name, cat="gpu_memcpy")
    if s <= 0:
        return None
    return s * 1e3 / (traced["frames"] / 1000.0)
