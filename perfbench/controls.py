"""Readings for the limits of ``correct``: the numbers a cell compares, from sound
runs of the program on many seeds and from the control (the plain reference put
in the program's place one precision down) on a few, in one process.

    python3 perfbench/controls.py --workload <name> --seeds 1,2,3 --seconds 3 \
        [--control-seeds 7,8,9]

Each program reading is a driver's set-up, a short window and the check, as in a
run; each control reading is a driver's set-up and its ``control`` at the cell's
own size.  One JSON line per reading.  Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/controls.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault", default=None,
                    help="a fault of faults.py planted under the program's readings")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import contextlib

    import torch
    from perfbench.faults import FAULTS
    from perfbench.harness import Cell

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    for kind, todo in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in todo:
            start = time.perf_counter()
            drv = cell.driver(seed, "cuda")
            planted = (FAULTS[args.fault]() if args.fault and kind == "program"
                       else contextlib.nullcontext())
            with planted:
                drv.setup()
                if kind == "program":
                    drv.window(args.seconds)
            if kind == "program":
                drv.free()
                torch.cuda.empty_cache()
                numbers = drv.check()
            else:
                drv.free()
                torch.cuda.empty_cache()
                extra = ([cell.traffic["control_dispatches"]]
                         if cell.traffic["driver"] == "stream" else [])
                numbers = drv.control(*extra)
            print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                              "fault": args.fault if kind == "program" else None,
                              "numbers": numbers,
                              "seconds": time.perf_counter() - start}), flush=True)
            del drv
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
