"""The readers of the program's spans and counters: on a synthetic trace (a
program span nested in a benchmark span, a device operation launched inside
``vp3d.train.optimizer`` on another thread than the step's), on a trace
without them (None), and in a tiny traced run of each cell."""

import pytest
from conftest import CELLS, run_tiny

from perfbench import spans
from perfbench.harness import Cell
from perfbench.trace import Trace

NEW = {"train-h36m243-pallas": ["train.step_host_ms", "train.upload_host_ms",
                                "train.optimizer_ms"],
       "eval-h36m243-bf16": ["eval.protocols_ms_per_kframe", "eval.useful_frame_pct"],
       "eval-h36m243-xla": ["eval.protocols_ms_per_kframe", "eval.useful_frame_pct"],
       "stream-h36m243c-int8-k1": ["stream.blocks_host_ms"]}
HOST_ONLY = {"train.optimizer_ms"}  # device time: none on the CPU


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


BENCH_ONLY = [
    x("user_annotation", "bench.traced", 0, 1000),
    x("user_annotation", "bench.train.step", 0, 500),
    x("user_annotation", "bench.train.step", 500, 500),
    x("user_annotation", "bench.eval.protocols", 600, 100),
    x("user_annotation", "bench.stream.step", 700, 100),
    x("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=1),
    x("kernel", "tap_gemm_kernel", 20, 200, tid=7, correlation=1),
    x("cuda_runtime", "cudaLaunchKernel", 420, 1, tid=2, correlation=2),
    x("kernel", "multi_tensor_apply_kernel", 430, 40, tid=7, correlation=2),
    x("cuda_runtime", "cudaMemsetAsync", 425, 1, tid=2, correlation=3),
    x("gpu_memset", "Memset (Device)", 480, 10, tid=7, correlation=3),
    x("cuda_runtime", "cudaLaunchKernel", 440, 1, correlation=4),
    x("kernel", "on_the_step_thread", 500, 30, tid=7, correlation=4),
]
PROGRAM = [
    # Step 1 (of 2): the step inside the benchmark's span, the upload and the
    # optimizer inside it; the optimizer's launches come from thread 2.
    x("user_annotation", "vp3d.train.step", 2, 480),
    x("user_annotation", "vp3d.train.upload", 4, 6),
    x("user_annotation", "vp3d.train.optimizer", 410, 70, tid=2),
    x("user_annotation", "vp3d.train.step", 502, 300),
    x("user_annotation", "vp3d.train.upload", 504, 10),
    x("user_annotation", "vp3d.eval.protocols", 610, 80),
    x("user_annotation", "vp3d.stream.blocks", 710, 30),
    x("user_annotation", "vp3d.stream.blocks", 990, 50),  # clipped to the window
]


def ctx(events, **traced):
    return {"traced": {"trace": Trace(events), **traced}}


def read(metric, c):
    return Cell(CELLS[0]).reader(metric).read(c)


def test_host_time_of_a_program_span_nested_in_a_benchmark_span():
    c = ctx(BENCH_ONLY + PROGRAM, steps=2)
    assert read("train.step_host_ms", c) == pytest.approx((480 + 300) * 1e-3 / 2)
    assert read("train.upload_host_ms", c) == pytest.approx((6 + 10) * 1e-3 / 2)


def test_device_time_launched_inside_the_optimizer_on_another_thread():
    # The kernel and the memset launched from thread 2 inside the span count;
    # the kernel launched meanwhile from the step's thread does not.
    c = ctx(BENCH_ONLY + PROGRAM, steps=2)
    assert read("train.optimizer_ms", c) == pytest.approx((40 + 10) * 1e-3 / 2)


def test_protocols_and_blocks():
    c = ctx(BENCH_ONLY + PROGRAM, frames=4000, dispatches=2)
    assert read("eval.protocols_ms_per_kframe", c) == pytest.approx(80e-3 / 4)
    assert read("stream.blocks_host_ms", c) == pytest.approx((30 + 10) * 1e-3 / 2)


@pytest.mark.parametrize("metric", sorted({m for ms in NEW.values() for m in ms}
                                          - {"eval.useful_frame_pct"}))
def test_absent_spans_read_none(metric):
    c = ctx(BENCH_ONLY, steps=2, frames=4000, dispatches=2)
    assert read(metric, c) is None


def test_useful_frames_from_the_counters(monkeypatch):
    from videopose3d_torch import profiling
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"eval.frames": 2250, "eval.frames_computed": 2304})
    assert read("eval.useful_frame_pct", ctx(BENCH_ONLY)) == pytest.approx(
        100 * 2250 / 2304)
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read("eval.useful_frame_pct", ctx(BENCH_ONLY)) is None
    monkeypatch.delattr(profiling, "counters")  # a program that keeps none
    assert spans.counters() == {}
    assert read("eval.useful_frame_pct", ctx(BENCH_ONLY)) is None


def test_program_spans_leave_the_benchmark_split_as_it_was():
    """The breakdown's idle split (innermost ``bench.`` span) and the benchmark's
    device time by range read the same with the program's spans in the trace."""
    plain, spanned = Trace(BENCH_ONLY), Trace(BENCH_ONLY + PROGRAM)
    assert spanned.idle_gaps() == plain.idle_gaps()
    assert spanned.busy_s == plain.busy_s
    assert spanned.device_ops() == plain.device_ops()


@pytest.mark.parametrize("name", CELLS)
def test_tiny_traced_run_reports_the_new_metrics(tiny_cell, name):
    from videopose3d_torch import profiling
    profiling.reset_counters()
    cell = tiny_cell(name)
    assert set(NEW[name]) <= {m["name"] for m in cell.per_layer}
    result = run_tiny(cell, trace=True)
    assert result["correct"] is True, result["compared"]
    got = result["metrics"]
    for metric in NEW[name]:
        if metric in HOST_ONLY:
            assert metric not in got  # no device operations on the CPU
        else:
            assert got[metric]["value"] > 0, metric
    if name.startswith("eval"):
        assert 0 < got["eval.useful_frame_pct"]["value"] <= 100
