#!/usr/bin/env python3
"""A/B timing of the port's training kernels on one NVIDIA GPU: the window
gather (K1) and the train block's GEMMs (K2: the weight gradient ``dw_gemm`` and
the three-tap ``conv_stats`` and ``du_dtaps_res``) of this checkout against those
of another checkout (for example the parent commit, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists), in turns other, this,
this, other:

    python3 kernel_ab.py --other build/parent

Each turn runs in its own process with that checkout's ``videopose3d_torch``
first on ``sys.path``, so each builds and loads its own kernels.  Shapes are
those of ``chip_smoke.py`` phase 3 in float32: K1 gathers 1,024 windows of 243
rows of 34 columns from a 300,000- and a 3,000,000-row stream; the K2 kernels run
at n = 27,648 / 9,216 / 3,072 / 1,024 rows of 1,024 channels (3 taps, residual
tap 1).  Each is timed as the median device time of CUDA-graph replays
(``graph``) and as one call between CUDA events, its host enqueue included
(``call``); ``torch.matmul`` (TF32 off) of each K2 product and the indexing
gather ``flat[rows]`` are timed in every turn as yardsticks.  ``dw_gemm``'s
outputs must be bitwise equal in every turn (a SHA-256 of their bytes).  The
last line of standard output is a JSON object with every turn's times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

GATHER_ROWS = (300_000, 3_000_000)
BATCH, WINDOW, COLS = 1024, 243, 34
DW_ROWS = (27_648, 9_216, 3_072, 1_024)
CHANNELS = 1024
RUNS = 10


def worker(root: str) -> dict:
    """Times the kernels of the checkout at ``root``; returns {case: ms}."""
    sys.path.insert(0, root)
    import torch
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import train_block as trb

    def call_ms(fn):
        for _ in range(2):
            fn()
        times = []
        for _ in range(RUNS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def graph_ms(fn, reps=20):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        return call_ms(graph.replay) / reps

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    out = {}
    for rows in GATHER_ROWS:
        flat = torch.randn(rows, COLS, device=dev, generator=gen)
        row0 = torch.randint(0, rows - WINDOW + 1, (BATCH,), device=dev, generator=gen)
        idx = row0[:, None] + torch.arange(WINDOW, device=dev)
        kernel = lambda: gr.gather_windows(flat, row0, window=WINDOW)
        if not torch.equal(kernel(), flat[idx]):
            raise RuntimeError(f"{root}: gather_windows differs from flat[rows]")
        for name, fn in (("gather_windows", kernel), ("flat[rows]", lambda: flat[idx])):
            out[f"{name} rows={rows} graph"] = graph_ms(fn, reps=100)
            out[f"{name} rows={rows} call"] = call_ms(fn)
    a = torch.randn(DW_ROWS[0], CHANNELS, device=dev, generator=gen)
    b = torch.randn(DW_ROWS[0], CHANNELS, device=dev, generator=gen)
    x3 = torch.randn(DW_ROWS[0], 3, CHANNELS, device=dev, generator=gen)
    wa = torch.randn(3, CHANNELS, CHANNELS, device=dev, generator=gen)
    wa /= (3 * CHANNELS) ** 0.5
    shift = torch.randn(CHANNELS, device=dev, generator=gen) * 0.1
    coef = torch.rand(5, CHANNELS, device=dev, generator=gen) + 0.5
    wt = wa.permute(2, 0, 1).reshape(CHANNELS, 3 * CHANNELS).contiguous()
    digest = hashlib.sha256()
    for n in DW_ROWS:
        an, bn, xn = a[:n].contiguous(), b[:n].contiguous(), x3[:n].contiguous()
        cases = {
            "dw_gemm": (lambda: trb.dw_gemm(an, bn), lambda: torch.matmul(an.t(), bn),
                        lambda: trb.dw_gemm_plain(an, bn)),
            "conv_stats": (
                lambda: trb.conv_stats(xn, wa, shift, center=1),
                lambda: torch.matmul(xn.reshape(n, -1), wa.reshape(-1, CHANNELS)),
                lambda: trb.conv_stats_plain(xn, wa, shift, center=1)),
            "du_dtaps_res": (
                lambda: trb.du_dtaps_res(an, bn, an, coef, wa, center=1),
                lambda: torch.matmul(an, wt),
                lambda: trb.du_dtaps_res_plain(an, bn, an, coef, wa, center=1)),
        }
        for name, (kernel, library, plain) in cases.items():
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                if float((g - w).abs().max()) > 1e-4 * max(1.0, float(w.abs().max())):
                    raise RuntimeError(f"{root}: {name} n={n} differs from its plain "
                                       "version")
            if name == "dw_gemm":
                digest.update(got[0].cpu().numpy().tobytes())
            for label, fn in ((name, kernel), (f"{name} torch.matmul", library)):
                out[f"{label} n={n} graph"] = graph_ms(fn)
                out[f"{label} n={n} call"] = call_ms(fn)
    out["dw_gemm sha256"] = digest.hexdigest()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.worker))))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    this = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    turns = []
    for label, root in (("other", other), ("this", this), ("this", this), ("other", other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--other", other,
                              "--worker", root], capture_output=True, text=True, cwd=root)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    digests = {t.pop("dw_gemm sha256") for _, t in turns}
    print(f"dw_gemm outputs bitwise equal in every turn: {len(digests) == 1}")
    print(f"{'case':40s} " + " ".join(f"{label:>9s}" for label, _ in turns))
    for case in turns[0][1]:
        print(f"{case:40s} " + " ".join(f"{t[case]:9.4f}" for _, t in turns))
    print(json.dumps({"device": smi, "other": other, "dw_gemm_bitwise": len(digests) == 1,
                      "turns": [{"checkout": label, "ms": t} for label, t in turns]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
