"""Whole runs of each cell at the CPU's size, through the harness with the
look for a card skipped: the result line's shape, ``correct`` on sound runs, and
``correct`` false with the timed path broken underneath."""

import json
import math
import subprocess
import sys

import pytest
import torch
from conftest import CELLS, REPO, run_tiny

from perfbench.faults import BY_DRIVER
from perfbench.harness import Cell


def _driver_of(name):
    return Cell(name).traffic["driver"]

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run(tiny_cell, name, trace):
    cell = tiny_cell(name)
    result = run_tiny(cell, trace=trace)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in line["metrics"].values())


def test_run_exits_without_a_card():
    assert not torch.cuda.is_available()
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


# -- faults planted under the timed path ------------------------------------


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS
                                        for f in BY_DRIVER[_driver_of(n)]],
                         ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_fault_is_caught(tiny_cell, name, fault):
    cell = tiny_cell(name)
    with fault():
        result = run_tiny(cell)
    assert result["correct"] is False, result["compared"]
