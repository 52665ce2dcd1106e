"""Helpers of the benchmark's tests: cells cut to a size the CPU runs in
seconds (three blocks of 32 channels, a few short videos and streams)."""

import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CONFIG = {"filter_widths": [3, 3, 3], "channels": 32}
TINY_TRAFFIC = {
    "train": {"sequences": 6, "frames_per_sequence": 300, "batch_size": 64,
              "traced_steps": 2},
    "eval": {"subjects": 1, "actions": 3, "takes": 1, "cameras": 2, "min_frames": 60,
             "max_frames": 200, "bucket": 16, "traced_actions": 1},
    "stream": {"streams": 8, "track_frames": 64, "calibration_clips": 2,
               "calibration_frames": 40, "warmup_dispatches": 3, "checked_streams": 4,
               "traced_dispatches": 5, "control_dispatches": 50},
}
CELLS = ["train-h36m243-pallas", "eval-h36m243-bf16", "stream-h36m243c-int8-k1",
         "eval-h36m243-xla"]
SEED = 2 ** 31 + 12345  # more than 32 signed bits hold, as the driver's seeds


def tiny(cell):
    """``cell`` cut to the CPU's size in place; returns it."""
    cell.config = {**cell.config, **TINY_CONFIG}
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC[cell.traffic["driver"]]}
    return cell


def run_tiny(cell, seconds=0.3, trace=False, seed=SEED):
    from perfbench.harness import run
    return run(cell, seed, seconds, trace, "cpu", time.perf_counter(), time.perf_counter,
               log=lambda msg: None)


@pytest.fixture
def tiny_cell():
    from perfbench.harness import Cell
    return lambda name: tiny(Cell(name))
