"""The harness finds every cell, configuration and metric by name, and a cell or
a metric added as files alone is picked up with no edit."""

import json
import re
import shutil

import pytest
from conftest import CELLS, REPO, run_tiny, tiny

from perfbench.harness import Cell, load_module

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_names_the_four_cells():
    assert [w["name"] for w in BENCH["workloads"]] == CELLS
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = Cell(name)
    assert cell.driver_path.exists()
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                       if w["name"] == name)
    ends = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in ends and len(ends) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
        assert m["moves"] in ends
    driver = load_module(cell.driver_path, "driver")
    assert all(hasattr(driver.Driver, k) for k in
               ("setup", "window", "traced", "free", "check", "control"))
    assert cell.limits and all(v["limit"] > 0 for v in cell.limits.values())


def test_configs_and_metrics_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
    for m in BENCH["per_layer"]:
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").exists()


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and 0 < len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_and_a_metric_added_as_files_alone(tmp_path):
    """A new traffic file, limits file, metric reader and BENCHMARK.json entries:
    the harness runs the new cell and reads the new metric, no code edited."""
    root = tmp_path / "perfbench"
    shutil.copytree(REPO / "perfbench", root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    traffic = json.loads((root / "traffic" / "eval_h36m_test_xla.json").read_text())
    traffic["bucket"] = 64
    (root / "traffic" / "eval_new_mix.json").write_text(json.dumps(traffic))
    (root / "limits" / "eval-new.json").write_text(
        (root / "limits" / "eval-h36m243-xla.json").read_text())
    (root / "metrics" / "eval.videos_per_s.py").write_text(
        "def read(ctx):\n    w = ctx['window']\n    return w['attempted'] / w['seconds']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "eval-new", "config": "h36m-243f",
                               "traffic": "eval_new_mix", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "eval_frames_per_s":
            m["workloads"].append("eval-new")
    bench["per_layer"].append({"name": "eval.videos_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "evaluator", "moves": "eval_frames_per_s",
                               "workloads": ["eval-new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny(Cell("eval-new", bench_path=tmp_path / "BENCHMARK.json", root=root))
    assert cell.traffic["bucket"] == 16  # the tiny cut, over the new file's 64
    assert [m["name"] for m in cell.per_layer][-1] == "eval.videos_per_s"
    result = run_tiny(cell, trace=True)
    assert result["correct"]
    assert result["metrics"]["eval.videos_per_s"]["value"] > 0
