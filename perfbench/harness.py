"""One run of one cell: find the cell's configuration, traffic, driver, metrics and
limits by name, set it up, time its window, read the traced stretch, check what
the timed path produced against the plain reference, and make the result line.

Everything that belongs to one cell, configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model as it is run;
* ``traffic/<traffic>.json``: the driver kind (``drivers/<driver>.py``) and its
  parameters;
* ``metrics/<metric>.py``: one per per-layer metric, with ``read(ctx)``;
* ``limits/<cell>.json``: the limit of each number the cell compares.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "videopose3d_tpu")


def load_json(path):
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """A module of ``perfbench`` loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, bench_path: Path = REPO / "BENCHMARK.json",
                 root: Path = HERE):
        bench = load_json(bench_path)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {bench_path.name}: {sorted(cells)}")
        self.name = name
        self.root = root
        w = cells[name]
        self.chips = int(w["chips"])
        self.config = load_json(root / "configs" / f"{w['config']}.json")
        self.traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
        self.limits = load_json(root / "limits" / f"{name}.json")
        self.driver_path = root / "drivers" / f"{self.traffic['driver']}.py"

        def here(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if here(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def driver(self, seed: int, device):
        module = load_module(self.driver_path, self.traffic["driver"])
        return module.Driver(self.config, self.traffic, seed, device)

    def reader(self, metric: str):
        return load_module(self.root / "metrics" / f"{metric}.py", metric)


def banned_modules():
    """Top-level names of loaded modules that the benchmarked process must not
    hold (the JAX package and JAX itself), compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def device_info(device):
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        clock, log=print):
    """One run; returns the result dict (the last line's object).  ``clock`` is
    the host clock ``t_start`` was read from (process start)."""
    import torch

    device = torch.device(device)
    drv = cell.driver(seed, device)
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = clock() - t_start
    log(f"set-up {setup_s:.3f} s ({getattr(drv, 'stages', '')})")
    window = drv.window(seconds)
    window["setup_s"] = setup_s
    ctx = {"cell": cell, "config": cell.config, "traffic": drv.traffic,
           "window": window, "traced": None}
    breakdown = None
    if trace:
        from perfbench.trace import profiled
        found = {}
        with profiled(found, device):
            traced = drv.traced()
        traced["trace"] = found["trace"]
        ctx["traced"] = traced
        breakdown = {"device_ops": traced["trace"].device_ops(),
                     "idle_gaps": traced["trace"].idle_gaps()}
    dev = device_info(device)
    if trace:
        t = ctx["traced"]["trace"]
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
    banned = banned_modules()
    if banned:
        raise SystemExit(f"error: the process holds {banned} after the window")

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in window]
        if missing:
            raise RuntimeError(f"the {drv.traffic['driver']} driver measured no {missing}")
        metrics = {m["name"]: {"value": float(window[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}

    drv.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = drv.check()
    for key, value in numbers.items():
        if key not in cell.limits:
            log(f"reading {key} {value!r}")
    compared = {key: {"value": float(numbers[key]), "limit": float(lim["limit"])}
                for key, lim in cell.limits.items()}
    correct = bool(compared) and all(c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": int(window["attempted"]),
              "failed": int(window.get("failed", 0)), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result
