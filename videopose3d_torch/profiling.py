"""Profiling and observability helpers.

Counterpart of ``videopose3d_tpu/profiling.py``: a device trace of a block of
work (``torch.profiler`` here, written as a Chrome trace ``*.pt.trace.json``
that TensorBoard and Perfetto open), per-step wall-clock statistics and
structured per-epoch metric records (JSON lines).

The program's own spans and counters: :func:`span` marks a stretch of host
work (``vp3d.<layer>.<what>``) as a ``record_function`` range, so it lands in
the profiler's trace beside the card's kernels, on one clock; :func:`count`
adds to a named counter.  Both record only while a profiler runs, and cost a
flag check otherwise.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()
_COUNTERS: Dict[str, int] = {}
_COUNTERS_LOCK = threading.Lock()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records;
    otherwise one shared no-op context, with no range made.  It synchronises
    nothing and reads no device data."""
    if _profiler_enabled():
        return record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records; otherwise
    nothing moves, so a process's counts are those of its profiled stretches."""
    if _profiler_enabled():
        with _COUNTERS_LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counters."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _COUNTERS_LOCK:
        _COUNTERS.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device=None):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (``<host>_<pid>.<time>.pt.trace.json``): CPU activity, and the
    card's kernels and copies when ``device`` is a CUDA device (None: when a
    card is available).  The counters start from zero and are written beside
    the trace as ``counters.json``.  No-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    reset_counters()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)


class StepTimer:
    """Lightweight per-step wall-clock statistics for a training epoch.

    Measures the host's step cadence (a step returns before its kernels have
    run); combine with :func:`device_trace` for the device timeline.
    ``summary()`` returns mean/p50/p95/max milliseconds.
    """

    def __init__(self):
        self._times: List[float] = []
        self._last: Optional[float] = None

    def start(self):
        self._last = time.perf_counter()

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times) * 1e3
        return {
            "steps": int(arr.size),
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "max_ms": float(arr.max()),
        }

    def report(self, prefix: str = "steps") -> str:
        s = self.summary()
        if not s:
            return f"{prefix}: no steps recorded"
        return (f"{prefix}: {s['steps']} steps, mean {s['mean_ms']:.2f} ms, "
                f"p50 {s['p50_ms']:.2f} ms, p95 {s['p95_ms']:.2f} ms, "
                f"max {s['max_ms']:.2f} ms")

    def reset(self):
        self._times.clear()
        self._last = None


def _json_default(obj):
    """Coerce tensor and numpy scalars that reach a metric record (losses,
    checkpoint payload entries) into JSON numbers."""
    if hasattr(obj, "item"):
        return obj.item()
    raise TypeError(f"not JSON serializable: {type(obj)}")


def log_metrics_jsonl(path: str, record: Dict) -> None:
    """Append one JSON line of structured metrics (epoch losses, step stats)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, default=_json_default) + "\n")
