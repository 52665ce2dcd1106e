"""Readings of the program's own spans and counters (``videopose3d_torch.profiling``):
the ``vp3d.*`` ranges of the traced stretch's trace, and the counters the program
kept while the profiler recorded (the traced stretch: a run profiles one).  A
program that records neither reads None throughout, so its result line leaves
the metric out."""

from __future__ import annotations


def host_s(trace, name: str):
    """Host seconds inside the ranges named ``name``, on any thread, clipped to
    the traced window; None when the trace has no such range."""
    total, found = 0.0, False
    for ranges in trace.ranges.values():
        for a, b, n in ranges:
            if n == name:
                found = True
                total += max(0.0, min(b, trace.t1) - max(a, trace.t0))
    return total * 1e-6 if found else None


def host_ms_per(ctx, name: str, unit: str):
    """Host ms inside ``name`` per ``unit`` of the traced stretch (``steps``,
    ``dispatches``: what the cell's ``traced()`` returned)."""
    traced = ctx["traced"]
    s = host_s(traced["trace"], name)
    return None if s is None else s * 1e3 / traced[unit]


def device_s(trace, name: str):
    """Device seconds of the kernels and memsets launched inside a range named
    ``name`` (on the launching thread); None when there are none."""
    s = sum(trace.device_s(cat=cat, range_prefix=name) for cat in ("kernel", "gpu_memset"))
    return s if s > 0 else None


def counters() -> dict:
    """The program's counters, or {} where the program keeps none."""
    from videopose3d_torch import profiling
    read = getattr(profiling, "counters", None)
    return {} if read is None else read()
