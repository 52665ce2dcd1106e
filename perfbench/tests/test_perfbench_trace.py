"""The reduction of a profiler trace: busy time, the window, device time by the
host range that launched it, and idle time by the benchmark span open."""

import pytest
from conftest import REPO  # noqa: F401  (puts the checkout on the path)

from perfbench.trace import Trace


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


EVENTS = [
    x("user_annotation", "bench.traced", 0, 100),
    x("user_annotation", "bench.train.step", 0, 100),
    x("user_annotation", "K2 backward", 5, 10, tid=2),
    x("user_annotation", "bench.eval.protocols", 60, 20),
    x("cuda_runtime", "cudaLaunchKernel", 6, 1, tid=2, correlation=11),
    x("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=12),
    x("kernel", "void k3_mma_kernel<bf16>(K3Gemm)", 10, 20, tid=7, correlation=11),
    x("kernel", "stream_int8_kernel<80>", 25, 15, tid=7, correlation=12),
    x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 90, 20, tid=8, correlation=13),
    x("kernel", "outside", 150, 10, tid=7, correlation=14),
]


def test_busy_and_window():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    # [10, 40) merged from two kernels, [90, 100) clipped to the window.
    assert t.busy_s == pytest.approx(40e-6)


def test_device_time_by_name_and_range():
    t = Trace(EVENTS)
    assert t.device_s(lambda n: "k3_" in n) == pytest.approx(20e-6)
    assert t.device_s(range_prefix="K2 ") == pytest.approx(20e-6)
    assert t.device_s(lambda n: "HtoD" in n, cat="gpu_memcpy") == pytest.approx(10e-6)
    assert t.device_ops()[0] == ["void k3_mma_kernel<bf16>(K3Gemm)", pytest.approx(20e-6)]


def test_idle_split_by_span():
    gaps = dict(Trace(EVENTS).idle_gaps())
    # Idle: [0, 10) and [40, 90); the protocols' span covers [60, 80).
    assert gaps["bench.eval.protocols"] == pytest.approx(20e-6)
    assert gaps["bench.train.step"] == pytest.approx(40e-6)


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(RuntimeError):
        Trace(EVENTS[1:])
