"""Benchmark spans and the reduction of a ``torch.profiler`` trace.

A traced stretch runs inside :func:`profiled`, which writes the profiler's Chrome
trace into a temporary directory and reads it back as a :class:`Trace`.  The
benchmark's own spans (``bench.<driver>.<what>``) and ranges around calls into the
program (``K2 forward``, ...) are ``record_function`` ranges on the host; a device
operation belongs to the ranges that were open on the host thread that launched
it (the launch's correlation id ties the two together).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.traced"


def span(name):
    """A benchmark span: a profiler range on the host (free when no profiler
    runs)."""
    from torch.profiler import record_function
    return record_function(name)


@contextlib.contextmanager
def profiled(out: dict, device):
    """Profile the enclosed block on the host and the card; on exit
    ``out["trace"]`` holds the :class:`Trace` of the stretch, which runs inside
    a ``bench.traced`` span ended after a synchronise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities) as prof:
            with span(WINDOW_SPAN):
                yield
                sync()
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["trace"] = Trace(json.load(f)["traceEvents"])


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """The device operations and host ranges of one profiled stretch (times in
    microseconds, as the Chrome trace has them)."""

    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        windows = [e for e in xs if e.get("name") == WINDOW_SPAN
                   and e.get("cat") == "user_annotation"]
        if not windows:
            raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
        w = windows[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.ranges = defaultdict(list)  # host tid -> [(start, end, name)]
        launches = {}                    # correlation id -> (tid, ts)
        self.device = []                 # (start, end, name, cat, correlation)
        for e in xs:
            cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat == "user_annotation":
                self.ranges[e.get("tid")].append((ts, ts + dur, e["name"]))
            elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                launches[args["correlation"]] = (e.get("tid"), ts)
            elif cat in DEVICE_CATS:
                a, b = max(ts, self.t0), min(ts + dur, self.t1)
                if b > a:
                    self.device.append((a, b, e["name"], cat, args.get("correlation")))
        self._launches = launches

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        return _merge([(a, b) for a, b, *_ in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def open_ranges(self, tid, ts):
        return [name for a, b, name in self.ranges.get(tid, ()) if a <= ts <= b]

    def launch_ranges(self, correlation):
        """The host ranges open when the device operation of ``correlation`` was
        launched."""
        hit = self._launches.get(correlation)
        return [] if hit is None else self.open_ranges(*hit)

    def device_s(self, name_pred=None, cat="kernel", range_prefix=None) -> float:
        """Device seconds of the operations of ``cat`` whose name passes
        ``name_pred`` and, with ``range_prefix``, that were launched inside a
        host range whose name starts with it."""
        total = 0.0
        for a, b, name, c, corr in self.device:
            if c != cat or (name_pred is not None and not name_pred(name)):
                continue
            if range_prefix is not None and not any(
                    r.startswith(range_prefix) for r in self.launch_ranges(corr)):
                continue
            total += b - a
        return total * 1e-6

    def device_ops(self, top: int = 10):
        """The device operations that took most time: [[name, seconds], ...]."""
        by_name = defaultdict(float)
        for a, b, name, *_ in self.device:
            by_name[name] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, prefix: str = "bench.", top: int = 10):
        """Idle device time split by the innermost benchmark span open on the
        host meanwhile: [[span, seconds], ...], longest first."""
        spans = [(a, b, n) for rs in self.ranges.values() for a, b, n in rs
                 if n.startswith(prefix) and n != WINDOW_SPAN]
        cuts = sorted({t for a, b, _ in spans for t in (a, b)})
        by_span = defaultdict(float)
        edge = self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > edge:
                points = [edge] + [t for t in cuts if edge < t < a] + [a]
                for lo, hi in zip(points, points[1:]):
                    mid = (lo + hi) / 2
                    inner = [s for s in spans if s[0] <= mid <= s[1]]
                    name = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "(none)"
                    by_span[name] += (hi - lo) * 1e-6
            edge = max(edge, b)
        return [[n, s] for n, s in sorted(by_span.items(), key=lambda kv: -kv[1])[:top]]
