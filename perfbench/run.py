"""Run one cell of the benchmark once and print its result as the last line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, and prints no result, without a CUDA card (or with fewer cards
than the cell asks for), and when the process holds JAX or the JAX package once
the window has closed.  The numbers that decide ``correct`` are printed beside
their limits as the last lines of standard error and under ``compared`` in the
result.
"""

import time

START = time.perf_counter()  # process start, as near as Python gets to it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from perfbench.harness import Cell, run

    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: the {args.workload} cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", START,
                 time.perf_counter, log=log)
    for key, c in result["compared"].items():
        log(f"compared {key} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
