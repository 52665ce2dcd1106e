#!/usr/bin/env python3
"""A/B timing of the port's GEMM kernels on one NVIDIA GPU: the fused evaluation
blocks (K3, float32 and bf16, its four stages), the fused int8 and
bf16 streaming steps (K5 at k = 1, K6 at k = 8), the window gather (K1) and the train
block's GEMMs (K2: the weight gradients, ``dw_gemm`` (dWb) and dWa, the
three-tap ``conv_stats`` and ``du_dtaps_res`` and the one-tap
``norm_drop_matmul_stats`` and ``dz_matmul_dd``) of this checkout against those
of another checkout (for
example the parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists), in turns other, this, this, other:

    python3 kernel_ab.py --other build/parent [--kernels k3 | int8 | k2ew]

(``--kernels k3``: K3 alone; ``--kernels int8``: the int8 evaluation stages, K4
in both tap modes (the accshift mode is K8), then K3; ``--kernels k2ew``: the
train block's two elementwise kernels alone, ``relu_mask_bn_sums`` and
``norm_drop_res``, at the four n in float32 and bfloat16 with a dropout mask,
each launched twice and held bitwise equal, gz and the residual output bitwise
equal to the plain version and across every turn, the sums within tolerance of
it.)  Each turn runs in its own process with that checkout's ``videopose3d_torch``
first on ``sys.path``, so each builds and loads its own kernels.  The two steps
run chip_smoke.py phase 6's causal model (four residual blocks of width 3, C =
1,024, seeded weights and rings) at B = 256 and 1,024 streams, k = 1 and 8, each
checked once against its plain version (int8: every ring bitwise).  K3 runs
chip_smoke.py phase 1's shapes (B = 2, 2,242 frames, C = 1,024, the expand stage at
d = 3, mid at 9 and 27, shrink at 81) on seeded weights, each stage checked against
its plain version.  The other shapes are those of
``chip_smoke.py`` phase 3 in float32: K1 gathers 1,024 windows of 243
rows of 34 columns from a 300,000- and a 3,000,000-row stream; the K2 kernels run
at n = 27,648 / 9,216 / 3,072 / 1,024 rows of 1,024 channels (3 taps, residual
tap 1); the dWa row, x3^T du of (n, 3,072) by (n, 1,024), times the checkout's own
route (``dw_gemm`` where it takes the (n, fw C) operand, else the float32 matmul
the block ran).  Each is timed as the median device time of CUDA-graph replays
(``graph``) and as one call between CUDA events, its host enqueue included
(``call``), K3 also by the host's time to enqueue one call (``host``);
``torch.matmul`` (TF32 off) of each K2 product and the indexing
gather ``flat[rows]`` are timed in every turn as yardsticks.  ``dw_gemm``'s
outputs must be bitwise equal in every turn (a SHA-256 of their bytes).  Each
turn also reports its build's ``-Xptxas -v`` lines of the tap GEMM kernels
(registers, spills).  The last line of standard output is a JSON object with
every turn's times.

    python3 kernel_ab.py --sweep

times the four tap GEMM kernels of this checkout at those n with the summed
dimension forced into 1, 2, 3, 4 and 8 slices (graph replay), beside the count
``tap_gemm_plan`` picks, to check its cost model, and ``dw_gemm`` at dWb's and
dWa's shapes with its rows forced into as many slices, beside ``dw_gemm_plan``'s;

    python3 kernel_ab.py --sweep stream_bf16

times the bf16 streaming step at those B and k with every plan (rows per CUDA
block, column slices per cluster) forced, beside the plan ``stream_bf16_plan``
picks, and prints how many clusters of each plan the card runs at once;
``--sweep stream_int8`` does the same for the int8 step and ``stream_int8_plan``;
``--sweep k3`` times each K3 stage with every GEMM of its chain forced into 1, 2, 3,
4, 6 and 8 slices beside the slices ``k3_plan`` picks, timed too; ``--sweep int8``
does the same for each int8 stage in both tap modes and ``int8_plan``; ``--sweep
k2ew`` times ``relu_mask_bn_sums`` at those n in float32 and bf16 with its
clusters forced to 1, 2, 4, 8 and 16 CUDA blocks (32 to 512 blocks of 128 threads
at C = 1,024) beside the size ``relu_sums_plan`` picks.  The int8
stages run
chip_smoke.py phase 5's shapes (a random full-width model quantized on the card,
B = 2, 2,242 frames), each checked against its plain version (mid blocks
bitwise).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

GATHER_ROWS = (300_000, 3_000_000)
BATCH, WINDOW, COLS = 1024, 243, 34
DW_ROWS = (27_648, 9_216, 3_072, 1_024)
CHANNELS = 1024
RUNS = 10


SWEEP_SLICES = (1, 2, 3, 4, 8)

# The fused streaming steps (K5 at k = 1, K6 at k = 8) of chip_smoke.py phase 6's
# causal model: four residual blocks of width 3 at dilations 3, 9, 27, 81.
STREAM_WIDTHS, STREAM_DILATIONS, STREAM_J3 = (3, 3, 3, 3), (3, 9, 27, 81), 51
STREAM_CASES = ((256, 1), (1024, 1), (256, 8), (1024, 8))
# Poses against the plain version: one bf16 step apart (chip_smoke.py TOL); int8,
# the shrink's float32 sums in another order (chip_smoke.py STREAM_POSE_TOL).
STREAM_TOL = {"bf16": 1.6e-2, "int8": 1e-4}

# K3 at chip_smoke.py phase 1's shapes, and its tolerance against the plain version
# (chip_smoke.py TOL).
K3_BATCH, K3_FRAMES, K3_DILATIONS, K3_J3 = 2, 2242, (3, 9, 27, 81), 51
K3_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
K3_SWEEP_SLICES = (1, 2, 3, 4, 6, 8)


def worker(root: str, sweep: str = "", kernels: str = "all") -> dict:
    """Times the kernels of the checkout at ``root`` (``kernels`` "k3": K3
    alone; "int8": the int8 stages, K7 and K3); returns {case: ms}.  With
    ``sweep``, the tap GEMM kernels at each
    forced slice count ("tap_gemm"), a streaming step at each forced plan
    ("stream_bf16", "stream_int8") or K3 at each forced slice count ("k3")
    instead."""
    sys.path.insert(0, root)
    import torch
    from videopose3d_torch.ops.kernels import build
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    from videopose3d_torch.ops.kernels import temporal_block as tb
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

    def host_ms(fn, calls=50):
        """The host's time to enqueue one call (no synchronisation inside)."""
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        seconds = time.perf_counter() - start
        torch.cuda.synchronize()
        return seconds / calls * 1e3

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    out = {}
    if sweep == "tap_gemm":
        return sweep_tap_gemms(torch, trb, dev, gen, graph_ms)
    if sweep in ("stream_bf16", "stream_int8"):
        return sweep_stream(torch, sf, dev, gen, graph_ms, sweep[7:])
    if sweep == "k3":
        return sweep_k3(torch, tb, dev, gen, graph_ms)
    if sweep == "int8":
        return sweep_int8(torch, tb, dev, graph_ms)
    if sweep == "k2ew":
        return sweep_relu_sums(torch, trb, dev, gen, graph_ms)
    if kernels == "k2ew":
        return k2_elementwise(torch, trb, build, dev, gen, graph_ms, call_ms)
    if kernels == "int8":
        for label, mode, v, kernel, plain in int8_stages(torch, dev):
            check_int8(torch, root, label, kernel(v, mode), plain(v, "slice"))
            out[f"K4 {label} {mode} graph"] = graph_ms(lambda: kernel(v, mode))
            out[f"K4 {label} {mode} call"] = call_ms(lambda: kernel(v, mode))
            out[f"K4 {label} {mode} host"] = host_ms(lambda: kernel(v, mode))
            out[f"K4 {label} {mode} plain graph"] = graph_ms(lambda: plain(v, mode), reps=5)
        # K7 at chip_smoke.py phase 6's aligned shape: a (1,024, 1,024) bf16 row.
        ring = torch.randn(163, 1024, 1024, device=dev, generator=gen).to(torch.bfloat16)
        row = torch.randn(1024, 1024, device=dev, generator=gen).to(torch.bfloat16)
        out["K7 ring_push (1024, 1024) bf16 graph"] = graph_ms(
            lambda: sf.ring_push(ring, 81, row), reps=100)
        del ring, row
    for dt in (torch.float32, torch.bfloat16):
        for label, v, vk, kernel, plain, width in k3_stages(torch, tb, dev, gen, dt):
            want, got = plain(v), kernel(vk)[..., :width]
            tol = K3_TOL[str(dt)[6:]] * max(1.0, float(want.float().abs().max()))
            if float((got.float() - want.float()).abs().max()) > tol:
                raise RuntimeError(f"{root}: K3 {label} {dt} differs from its plain version")
            out[f"K3 {str(dt)[6:]} {label} graph"] = graph_ms(lambda: kernel(vk))
            out[f"K3 {str(dt)[6:]} {label} call"] = call_ms(lambda: kernel(vk))
            out[f"K3 {str(dt)[6:]} {label} host"] = host_ms(lambda: kernel(vk))
            out[f"K3 {str(dt)[6:]} {label} plain graph"] = graph_ms(lambda: plain(v), reps=5)
    out["ptxas"] = ptxas_report(build.build_log, "k3_") + ptxas_report(
        build.build_log, "temporal_block_kernel")
    if kernels == "int8":
        out["ptxas"] += ptxas_report(build.build_log, "i8_mma_kernel") + ptxas_report(
            build.build_log, "int8_block_kernel")
    if kernels in ("k3", "int8"):
        return out
    for kind, make in (("int8", stream_int8_step), ("bf16", stream_bf16_step)):
        for b, k in STREAM_CASES:
            step = make(torch, sf, dev, gen, b, k)
            out[f"stream_{kind} B={b} k={k} graph"] = graph_ms(step, reps=10)
            out[f"stream_{kind} B={b} k={k} call"] = call_ms(step)
            del step
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
    wb = wa[0].contiguous()
    mask, gate = one_tap_operands(torch, dev, gen)
    dwa = dwa_route(torch, trb)
    digest = hashlib.sha256()
    for n in DW_ROWS:
        an, bn, xn = a[:n].contiguous(), b[:n].contiguous(), x3[:n].contiguous()
        mn, rows = mask[:n].contiguous(), x3[:n].reshape(n, -1)
        cases = {
            "dw_gemm": (lambda: trb.dw_gemm(an, bn), lambda: torch.matmul(an.t(), bn),
                        lambda: trb.dw_gemm_plain(an, bn)),
            "dWa": (lambda: dwa(rows, bn), lambda: torch.matmul(rows.t(), bn),
                    lambda: trb.dw_gemm_plain(rows, bn)),
            "conv_stats": (
                lambda: trb.conv_stats(xn, wa, shift, center=1),
                lambda: torch.matmul(xn.reshape(n, -1), wa.reshape(-1, CHANNELS)),
                lambda: trb.conv_stats_plain(xn, wa, shift, center=1)),
            "du_dtaps_res": (
                lambda: trb.du_dtaps_res(an, bn, an, coef, wa, center=1),
                lambda: torch.matmul(an, wt),
                lambda: trb.du_dtaps_res_plain(an, bn, an, coef, wa, center=1)),
            "norm_drop_matmul_stats": (
                lambda: trb.norm_drop_matmul_stats(an, mn, gate, wb, shift),
                lambda: torch.matmul(an, wb),
                lambda: trb.norm_drop_matmul_stats_plain(an, mn, gate, wb, shift)),
            "dz_matmul_dd": (
                lambda: trb.dz_matmul_dd(an, bn, coef, wb),
                lambda: torch.matmul(an, wb.t()),
                lambda: trb.dz_matmul_dd_plain(an, bn, coef, wb)),
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
    out["ptxas"] += ptxas_report(build.build_log, "tap_gemm") + ptxas_report(
        build.build_log, "dw_gemm")
    return out


# The elementwise kernels' tolerance against their plain versions (chip_smoke.py
# TOL): their float32 sums in another order.
K2EW_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}


def k2ew_operands(torch, dev, gen, dt):
    """Seeded operands of relu_mask_bn_sums and norm_drop_res at the largest n (C
    = 1,024, a dropout mask at rate 0.25): g, z, res, mask in ``dt``, stat
    float32, gate in ``dt``."""
    c, rows = CHANNELS, DW_ROWS[0]
    randn = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
    rand = lambda *shape: torch.rand(*shape, device=dev, generator=gen)
    g, z, res = randn(rows, c) * 1e-3, randn(rows, c), randn(rows, c)
    mask = (rand(rows, c) < 0.75) / 0.75
    stat = torch.stack([randn(c) * 0.1, rand(c) + 0.5])
    gate = torch.stack([randn(c) * 0.1, rand(c) + 0.5, randn(c) * 0.2])
    return [t.to(dt) for t in (g, z, res, mask)] + [stat, gate.to(dt)]


def check_elementwise(torch, label, got, want, dt):
    """The elementwise output (gz, out) bitwise equal to the plain version's, the
    sums (if any) within K2EW_TOL."""
    if not torch.equal(got[0], want[0]):
        raise RuntimeError(f"{label}: its output differs from plain")
    tol = K2EW_TOL[str(dt)[6:]]
    for a, w in zip(got[1:], want[1:]):
        if float((a - w).abs().max()) > tol * max(1.0, float(w.abs().max())):
            raise RuntimeError(f"{label}: its sums differ from plain")


def k2_elementwise(torch, trb, build, dev, gen, graph_ms, call_ms) -> dict:
    """relu_mask_bn_sums and norm_drop_res at the train step's four n (C =
    1,024, float32 and bfloat16, seeded operands): graph, one call and the plain
    version's graph time.  Each kernel is launched twice and must give bitwise
    equal outputs, and its elementwise output (gz, out) must equal the plain
    version's bit for bit; SHA-256 digests of those outputs (the same in every
    checkout) and of the float32 sums (this checkout's summation order) let the
    caller compare the turns."""
    digests = {key: hashlib.sha256() for key in ("elementwise", "sums")}
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt)[6:]
        g, z, res, mask, stat, gate = k2ew_operands(torch, dev, gen, dt)
        for n in DW_ROWS:
            gn, zn, rn, mn = (t[:n] for t in (g, z, res, mask))
            cases = {
                "relu_mask_bn_sums": (
                    lambda: trb.relu_mask_bn_sums(gn, zn, mn, stat, gate),
                    lambda: trb.relu_mask_bn_sums_plain(gn, zn, mn, stat, gate)),
                "norm_drop_res": (lambda: (trb.norm_drop_res(zn, mn, gate, rn),),
                                  lambda: (trb.norm_drop_res_plain(zn, mn, gate, rn),)),
            }
            for name, (kernel, plain) in cases.items():
                label = f"{name} {dname} n={n}"
                got, again = kernel(), kernel()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise RuntimeError(f"{label}: two launches differ")
                check_elementwise(torch, label, got, plain(), dt)
                digests["elementwise"].update(
                    got[0].view(torch.uint8).cpu().numpy().tobytes())
                for a in got[1:]:
                    digests["sums"].update(a.cpu().numpy().tobytes())
                out[f"{label} graph"] = graph_ms(kernel)
                out[f"{label} call"] = call_ms(kernel)
                out[f"{label} plain graph"] = graph_ms(plain, reps=5)
    out.update({f"{key} sha256": d.hexdigest() for key, d in digests.items()})
    out["ptxas"] = ptxas_report(build.build_log, "relu_mask_bn_sums") + ptxas_report(
        build.build_log, "norm_drop_kernel")
    return out


def sweep_relu_sums(torch, trb, dev, gen, graph_ms) -> dict:
    """relu_mask_bn_sums at the four n with its clusters forced to each size
    (the row slices of relu_sums_plan's shape), each run checked against the
    plain version; ``plan`` keys hold the size the plan picks."""
    from videopose3d_torch.ops.kernels.build import launch
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt)[6:]
        g, z, _, mask, stat, gate = k2ew_operands(torch, dev, gen, dt)
        for n in DW_ROWS:
            args = (g[:n], z[:n], mask[:n], stat, gate)
            want = trb.relu_mask_bn_sums_plain(*args)
            out[f"{dname} n={n} plan"] = len(trb.relu_sums_plan(n, CHANNELS,
                                                                g.element_size()))
            for k in (1, 2, 4, 8, 16):
                rows = -(-n // k)
                gz = torch.empty_like(args[0])
                sums = torch.empty((2, CHANNELS), dtype=torch.float32, device=dev)

                def run():
                    launch("vp3d_tb_relu_mask_bn_sums", dev, trb._DTYPE_CODE[dt], n,
                           CHANNELS, k, rows, *args, gz, sums)
                run()
                check_elementwise(torch, f"relu_mask_bn_sums {dname} n={n} k={k}",
                                  (gz, sums[0], sums[1]), want, dt)
                out[f"{dname} n={n} k={k}"] = graph_ms(run)
    return out


def k3_stages(torch, tb, dev, gen, dt):
    """(label, plain input, kernel input, kernel(v), plain(v), width) of K3's four
    stages in ``dt`` on seeded weights at K3_BATCH x K3_FRAMES, each fed the plain
    output of the stage before.  The kernels take whole 16-byte words, so their
    keypoint columns (34) and the shrink's outputs (51) are zero-padded here as the
    fused forward pads them (36 / 52 in float32, 40 / 56 in bf16); ``width`` is
    what their output is cut back to."""
    c = CHANNELS
    word = 16 // dt.itemsize
    whole = lambda n: -(-n // word) * word
    pad = torch.nn.functional.pad
    u = lambda *shape, s=1.0: (torch.rand(*shape, device=dev, generator=gen) * 2 - 1) * s
    bn = lambda: (u(c, s=0.5) + 1.0, u(c, s=0.2))
    w0, (s0, b0) = u(3, COLS, c, s=(3 * COLS) ** -0.5).to(dt), bn()
    ws, bs = u(c, K3_J3, s=c ** -0.5).to(dt), u(K3_J3, s=0.1)
    w0p = pad(w0, (0, 0, 0, whole(COLS) - COLS))
    wsp, bsp = pad(ws, (0, whole(K3_J3) - K3_J3)), pad(bs, (0, whole(K3_J3) - K3_J3))
    v, stages = u(K3_BATCH, K3_FRAMES, COLS), []
    for i, d in enumerate(K3_DILATIONS):
        blk = (u(3, c, c, s=(3 * c) ** -0.5).to(dt), *bn(), u(c, c, s=c ** -0.5).to(dt),
               *bn())
        vk, width = v, c
        if i == 0:
            label = "expand"
            vk = pad(v.to(dt), (0, whole(COLS) - COLS))
            kernel = lambda x, blk=blk, d=d: tb.fused_expand_block(x, w0p, s0, b0, *blk,
                                                                   dilation=d)
            plain = lambda x, blk=blk, d=d: tb.fused_expand_block_plain(
                x, w0, s0, b0, *blk, dilation=d)
        elif i == len(K3_DILATIONS) - 1:
            label, width = "shrink", K3_J3
            kernel = lambda x, blk=blk, d=d: tb.fused_shrink_block(x, *blk, wsp, bsp,
                                                                   dilation=d)
            plain = lambda x, blk=blk, d=d: tb.fused_shrink_block_plain(x, *blk, ws, bs,
                                                                        dilation=d)
        else:
            label = "mid"
            kernel = lambda x, blk=blk, d=d: tb.fused_dilated_block(x, *blk, dilation=d)
            plain = lambda x, blk=blk, d=d: tb.fused_dilated_block_plain(x, *blk,
                                                                         dilation=d)
        stages.append((f"{label} d={d}", v, vk, kernel, plain, width))
        v = plain(v)
    return stages


def sweep_k3(torch, tb, dev, gen, graph_ms) -> dict:
    """Graph time of each K3 stage with every GEMM of its chain forced into each of
    K3_SWEEP_SLICES slices (at most its 32-row slabs), and the slices ``k3_plan``
    picks for each GEMM ("plan") with the stage's time at them."""
    picked = tb.k3_plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def forced(want):
        def plan(m, k, n, *_):
            slabs = -(-k // 32)
            rows = -(-slabs // min(slabs, want)) * 32
            return tuple((a, min(k, a + rows)) for a in range(0, k, rows))
        return plan

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        for label, _, vk, kernel, _, _ in k3_stages(torch, tb, dev, gen, dt):
            shape = kernel(vk).shape
            gemms = tb.k3_gemms(label.split()[0].replace("mid", "dilated"), K3_BATCH,
                                vk.shape[1], shape[1], CHANNELS, k0=3,
                                x_cols=vk.shape[2], j3=shape[2])
            out[f"K3 {name} {label} plan"] = "/".join(
                str(len(picked(*g, sms, dt))) for g in gemms)
            out[f"K3 {name} {label} plan graph"] = graph_ms(lambda: kernel(vk))
            for want in K3_SWEEP_SLICES:
                # The launch takes each GEMM's rows per slice from k3_plan, once per
                # shape: swap the plan and forget the shapes' layouts.
                tb.k3_plan = forced(want)
                tb._layout.cache_clear()
                try:
                    out[f"K3 {name} {label} slices={want} graph"] = graph_ms(
                        lambda: kernel(vk))
                finally:
                    tb.k3_plan = picked
                    tb._layout.cache_clear()
    return out


def int8_stages(torch, dev):
    """(label, mode, input, kernel(v, mode), plain(v, mode)) of each int8 stage in
    both tap modes: a random full-width model (chip_smoke.py phase 5's shapes and
    seeds) quantized on the card by this checkout, each stage fed the plain output
    of the stage before."""
    import numpy as np
    from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig
    from videopose3d_torch.ops.kernels import temporal_block_int8 as tq
    torch.manual_seed(0)
    cfg = TemporalModelConfig(num_joints_in=17, in_features=2, num_joints_out=17,
                              filter_widths=(3, 3, 3, 3, 3), channels=CHANNELS)
    model = TemporalModel(cfg)
    rng = np.random.default_rng(0)
    for bn in [model.expand_bn, *model.layers_bn]:
        bn.running_var = torch.from_numpy(rng.uniform(0.5, 2.0, CHANNELS).astype(np.float32))
        bn.bias.data = torch.from_numpy(rng.uniform(-0.2, 0.2, CHANNELS).astype(np.float32))
    model = model.to(dev).eval()
    x_raw = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (K3_BATCH, K3_FRAMES, 17, 2)).astype(np.float32)).to(dev)
    q = tq.quantize_temporal_model(cfg, model, x_raw)
    flat = x_raw.reshape(K3_BATCH, K3_FRAMES, -1)
    t_e = K3_FRAMES - 2
    v = torch.cat([flat[:, j: j + t_e] for j in range(3)], -1).to(torch.bfloat16)
    w0 = q.expand_w.reshape(-1, CHANNELS)
    last, j3 = len(q.blocks) - 1, q.shrink_w.shape[1]
    # This checkout's shrink takes whole 16-byte words of outputs (shrink_operands);
    # the dp4a kernel before it took any J.
    shrink = (tq.shrink_operands(q) if hasattr(tq, "shrink_operands")
              else (q.shrink_w, q.shrink_b))
    stages = []
    for i, d in enumerate(K3_DILATIONS):
        geo = dict(dilation=d)
        if i == 0:
            label = "expand"
            kernel = lambda x, m, geo=geo: tq.int8_expand_block(
                x, w0, q.expand_scale, q.expand_shift, q.blocks[0], tap_mode=m, **geo)
            plain = lambda x, m, geo=geo: tq.int8_expand_block_plain(
                x, w0, q.expand_scale, q.expand_shift, q.blocks[0], tap_mode=m, **geo)
        elif i == last:
            label = "shrink"
            kernel = lambda x, m, geo=geo: tq.int8_shrink_block(
                x, q.blocks[last], *shrink, tap_mode=m, **geo)[..., :j3]
            plain = lambda x, m, geo=geo: tq.int8_shrink_block_plain(
                x, q.blocks[last], q.shrink_w, q.shrink_b, tap_mode=m, **geo)
        else:
            label = "mid"
            kernel = lambda x, m, i=i, geo=geo: tq.int8_dilated_block(
                x, q.blocks[i], tap_mode=m, **geo)
            plain = lambda x, m, i=i, geo=geo: tq.int8_dilated_block_plain(
                x, q.blocks[i], tap_mode=m, **geo)
        for mode in ("slice", "accshift"):
            stages.append((f"{label} d={d}", mode, v, kernel, plain))
        v = plain(v, "slice")
    return stages


def check_int8(torch, root, label, got, want):
    """An int8 stage's output against its plain version (chip_smoke.py's bounds): mid
    blocks bitwise, the expand within one step on <= 1e-3 of its elements, the
    shrink within 1e-4 of max(1, max |plain|)."""
    if got.dtype == torch.int8:
        diff = (got.int() - want.int()).abs()
        ok = (int(diff.max()) == 0 if label.startswith("mid")
              else int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3)
    else:
        ok = float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))
    if not ok:
        raise RuntimeError(f"{root}: int8 {label} differs from its plain version")


def sweep_int8(torch, tb, dev, graph_ms) -> dict:
    """Graph time of each int8 stage (both tap modes) with its tap GEMM forced into
    1-4 slices and its 1x1 into 1-3 (at most their K tiles; the projection keeps
    k3_plan's, the accshift taps' GEMM its tap-boundary slices), and the slices
    ``int8_plan`` picks for the two ("plan") with the stage's time at them."""
    from videopose3d_torch.ops.kernels import temporal_block_int8 as tq
    picked = tq.int8_plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def forced(tap, one):
        """An int8 plan that splits the tap GEMM in ``tap`` slices and the 1x1 in
        ``one`` (at most their K tiles)."""
        def plan(m, k, n, sms):
            want = tap if calls.pop(0) == "tap" else one
            slabs = -(-k // tq.INT8_SLAB)
            rows = -(-slabs // min(slabs, want)) * tq.INT8_SLAB
            return tuple((a, min(k, a + rows)) for a in range(0, k, rows))
        return plan

    out = {}
    for label, mode, v, kernel, _ in int8_stages(torch, dev):
        shape = kernel(v, mode).shape
        kind = {"expand": "int8_expand", "mid": "int8_dilated", "shrink": "int8_shrink"}[
            label.split()[0]]
        gemms = [g for g in tq.int8_gemms(kind, K3_BATCH, shape[1], CHANNELS,
                                          dilation=int(label.split("=")[1]),
                                          accshift=mode == "accshift", j3=56)
                 if g[3] == torch.int8][-2:]
        out[f"K4 {label} {mode} plan"] = "/".join(str(len(picked(*g[:3], sms)))
                                                   for g in gemms)
        out[f"K4 {label} {mode} plan graph"] = graph_ms(lambda: kernel(v, mode))
        for tap in K3_SWEEP_SLICES[:4]:
            for one in K3_SWEEP_SLICES[:3]:
                # The launch takes its rows per slice from int8_plan, once per
                # shape, for the tap GEMM and then the 1x1: swap the plan and forget
                # the shapes' layouts.
                calls = ["tap", "1x1"]
                tq.int8_plan = forced(tap, one)
                tq._layout.cache_clear()
                try:
                    out[f"K4 {label} {mode} slices={tap}/{one} graph"] = graph_ms(
                        lambda: kernel(v, mode))
                finally:
                    tq.int8_plan = picked
                    tq._layout.cache_clear()
    return out


def dwa_route(torch, trb):
    """The checkout's dWa = x3^T du, (n, fw C) by (n, C): ``dw_gemm`` where its
    plan takes an (m, C) output, else the float32 ``torch.matmul`` (TF32 off)
    that the checkout's block ran."""
    import inspect
    if "m" in inspect.signature(trb.dw_gemm_plan).parameters:
        return trb.dw_gemm
    return lambda rows, du: torch.matmul(rows.t(), du)


def ptxas_report(log: str, name: str) -> list:
    """The ``-Xptxas -v`` lines of the kernels whose symbol holds ``name``:
    registers, stack frame and spills."""
    lines, keep = [], False
    for line in log.splitlines():
        if "entry function" in line:
            keep = name in line
        if keep:
            lines.append(line.strip())
    return lines


def one_tap_operands(torch, dev, gen):
    """A (27,648, C) dropout mask at rate 0.25 and the (3, C) BatchNorm gate
    constants [mean, inv, bias] of norm_drop_matmul_stats."""
    mask = (torch.rand(DW_ROWS[0], CHANNELS, device=dev, generator=gen) < 0.75) / 0.75
    gate = torch.stack([torch.randn(CHANNELS, device=dev, generator=gen) * 0.1,
                        torch.rand(CHANNELS, device=dev, generator=gen) + 0.5,
                        torch.randn(CHANNELS, device=dev, generator=gen) * 0.2])
    return mask, gate


def stream_bf16_step(torch, sf, dev, gen, b, k):
    """One fused bf16 streaming step at B = ``b`` streams of ``k`` frames, C =
    1,024, on seeded weights and rings (doubled at k > 1), checked once against
    its plain version; returns the call.  Repeated calls push the same rows, so
    they are the same step."""
    c = CHANNELS
    bf = lambda *shape, scale=1.0: (torch.randn(shape, device=dev, generator=gen)
                                   * scale).to(torch.bfloat16)
    weights = {
        "w1": [bf(w, c, c, scale=(w * c) ** -0.5) for w in STREAM_WIDTHS],
        "w2": [bf(c, c, scale=c ** -0.5) for _ in STREAM_WIDTHS],
        "vecs": [torch.stack([torch.rand(c, device=dev, generator=gen) + 0.5,
                              torch.randn(c, device=dev, generator=gen) * 0.1] * 2)
                 for _ in STREAM_WIDTHS],
        "shrink_w": bf(c, STREAM_J3, scale=c ** -0.5),
        "shrink_b": torch.randn(STREAM_J3, device=dev, generator=gen) * 0.1,
    }
    lags, caps, idx = _stream_geometry(b, k)
    rings = [bf((2 if k > 1 else 1) * cap, b, c) for cap in caps]
    a0 = torch.rand(k, b, c, device=dev, generator=gen)
    if k == 1:
        run = lambda fn, r: fn(weights, r, a0[0], idx, widths=STREAM_WIDTHS)
        kern, plain = sf.fused_blocks_step_bf16, sf.fused_blocks_step_bf16_plain
    else:
        run = lambda fn, r: fn(weights, r, a0, idx, widths=STREAM_WIDTHS, lags=lags,
                               caps=caps, k=k)
        kern, plain = sf.fused_blocks_step_bf16_multi, sf.fused_blocks_step_bf16_multi_plain
    return _checked(torch, "bf16", b, k, run, kern, plain, rings)


def _stream_geometry(b, k):
    """Per block the older taps' lags, the ring capacities (k-aligned at k > 1)
    and the slots of a step that writes each ring's last k rows."""
    lags = [[(w - 1 - j) * d for j in range(w - 1)]
            for w, d in zip(STREAM_WIDTHS, STREAM_DILATIONS)]
    caps = [max(block) + 1 for block in lags]
    if k > 1:
        caps = [(-(-(cap - 1) // k) + 1) * k for cap in caps]
    idx = []
    for cap, block in zip(caps, lags):
        write = cap - k
        idx += [write] + [(write - lag) % cap for lag in block]
    return lags, caps, idx


def _checked(torch, kind, b, k, run, kern, plain, rings):
    """Runs the step once against its plain version from cloned rings (int8: the
    rings bitwise) and returns the kernel's call on ``rings``."""
    want_rings = [r.clone() for r in rings]
    want = run(plain, want_rings)[0]
    got = run(kern, rings)[0]
    err = float((got - want).abs().max())
    if not err <= STREAM_TOL[kind] * max(1.0, float(want.abs().max())):
        raise RuntimeError(f"stream_{kind} B={b} k={k} differs from its plain version "
                           f"by {err}")
    if kind == "int8" and not all(torch.equal(r, w) for r, w in zip(rings, want_rings)):
        raise RuntimeError(f"stream_int8 B={b} k={k}: a ring differs from the plain "
                           "version's")
    return lambda: run(kern, rings)


def stream_int8_step(torch, sf, dev, gen, b, k):
    """One fused int8 streaming step at B = ``b`` streams of ``k`` frames, C = 1,024,
    on seeded int8 weights, epilogue vectors and rings (doubled at k > 1), checked
    once against its plain version; returns the call.  Works on checkouts with
    and without the step's own weights object (``Int8StepWeights``)."""
    from videopose3d_torch.ops.kernels.temporal_block_int8 import Int8Block, QuantizedModel
    c = CHANNELS
    i8 = lambda *shape, lo=-127: torch.randint(lo, 128, shape, device=dev, generator=gen,
                                                dtype=torch.int8)
    vec = lambda scale, shift: ((torch.rand(c, device=dev, generator=gen) + 0.5) * scale
                                + shift * torch.randn(c, device=dev, generator=gen))
    blocks = [Int8Block(i8(w, c, c), i8(c, c), vec(1 / (127 * (w * c) ** 0.5), 0),
                        vec(0, 0.5), vec(1 / (127 * c ** 0.5), 0), vec(0, 0.5),
                        vec(0.5, 0)) for w in STREAM_WIDTHS]
    shrink_w = (torch.randn(c, STREAM_J3, device=dev, generator=gen) * c ** -0.5).to(
        torch.bfloat16)
    q = QuantizedModel(None, None, None, blocks, shrink_w,
                       torch.randn(STREAM_J3, device=dev, generator=gen) * 0.1)
    if hasattr(sf, "Int8StepWeights"):
        q = sf.Int8StepWeights.of(q)
    lags, caps, idx = _stream_geometry(b, k)
    rings = [i8((2 if k > 1 else 1) * cap, b, c, lo=0) for cap in caps]
    eq = i8(k, b, c, lo=0)
    if k == 1:
        run = lambda fn, r: fn(q, r, eq[0], idx, widths=STREAM_WIDTHS)
        kern, plain = sf.fused_blocks_step, sf.fused_blocks_step_plain
    else:
        run = lambda fn, r: fn(q, r, eq, idx, widths=STREAM_WIDTHS, lags=lags, caps=caps,
                               k=k)
        kern, plain = sf.fused_blocks_step_multi, sf.fused_blocks_step_multi_plain
    return _checked(torch, "int8", b, k, run, kern, plain, rings)


def sweep_stream(torch, sf, dev, gen, graph_ms, kind) -> dict:
    """Graph time of the ``kind`` ("bf16" or "int8") streaming step at each of
    STREAM_CASES with every plan (rows per CUDA block, column slices per cluster)
    the kernel takes forced, the plan its ``stream_<kind>_plan`` picks, and how
    many clusters of each plan the card runs at once.  A plan is forced by replacing
    ``stream_<kind>_plan``, which the step's launch reads."""
    from videopose3d_torch.ops.kernels.build import load_library
    lib = load_library()
    name = f"stream_{kind}_plan"
    picked = getattr(sf, name)
    smem = getattr(sf, f"{kind}_smem_bytes")
    make = stream_int8_step if kind == "int8" else stream_bf16_step
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = [(rows, slices) for rows in sf.TC_ROWS for slices in (1, 2, 4, 8)]
    out = {f"clusters rows={rows} slices={slices}":
           getattr(lib, f"vp3d_stream_{kind}_max_clusters")(rows, slices, CHANNELS)
           for rows, slices in plans}
    for b, k in STREAM_CASES:
        step = make(torch, sf, dev, gen, b, k)
        out[f"stream_{kind} B={b} k={k} plan"] = "x".join(
            map(str, picked(b, k, CHANNELS, sms)))
        for rows, slices in plans:
            if not sf._plan_valid(smem, rows, slices, k, CHANNELS):
                continue
            setattr(sf, name, lambda *_, plan=(rows, slices): plan)
            try:
                out[f"stream_{kind} B={b} k={k} rows={rows} slices={slices} graph"] = (
                    graph_ms(step, reps=10))
            finally:
                setattr(sf, name, picked)
        del step
    return out


def sweep_tap_gemms(torch, trb, dev, gen, graph_ms) -> dict:
    """Graph time of each tap GEMM kernel at each n with its summed dimension
    forced into each of SWEEP_SLICES slices (``tap_gemm_plan`` replaced), and
    the count ``tap_gemm_plan`` picks ("plan")."""
    picked = trb.tap_gemm_plan
    n_max = DW_ROWS[0]
    a = torch.randn(n_max, CHANNELS, device=dev, generator=gen)
    x3 = torch.randn(n_max, 3, CHANNELS, device=dev, generator=gen)
    wa = torch.randn(3, CHANNELS, CHANNELS, device=dev, generator=gen) / (3 * CHANNELS) ** 0.5
    wb = wa[0].contiguous()
    shift = torch.randn(CHANNELS, device=dev, generator=gen) * 0.1
    coef = torch.rand(5, CHANNELS, device=dev, generator=gen) + 0.5
    mask, gate = one_tap_operands(torch, dev, gen)
    out = {}
    for n in DW_ROWS:
        an, xn, mn = a[:n].contiguous(), x3[:n].contiguous(), mask[:n].contiguous()
        kernels = {
            "conv_stats": (lambda: trb.conv_stats(xn, wa, shift, center=1),
                           (n, 3 * CHANNELS, CHANNELS)),
            "du_dtaps_res": (lambda: trb.du_dtaps_res(an, an, an, coef, wa, center=1),
                             (n, CHANNELS, 3 * CHANNELS)),
            "norm_drop_matmul_stats": (
                lambda: trb.norm_drop_matmul_stats(an, mn, gate, wb, shift),
                (n, CHANNELS, CHANNELS)),
            "dz_matmul_dd": (lambda: trb.dz_matmul_dd(an, an, coef, wb),
                             (n, CHANNELS, CHANNELS)),
        }
        for name, (kernel, shape) in kernels.items():
            out[f"{name} n={n} plan"] = len(picked(*shape))
            k = shape[1]
            slabs = -(-k // trb.DW_ROWS)
            for want in SWEEP_SLICES:
                rows = -(-slabs // want) * trb.DW_ROWS
                plan = tuple((s, min(k, s + rows)) for s in range(0, k, rows))
                trb.tap_gemm_plan = lambda *_, plan=plan: plan
                try:
                    out[f"{name} n={n} slices={len(plan)} graph"] = graph_ms(kernel)
                finally:
                    trb.tap_gemm_plan = picked
        picked_dw = trb.dw_gemm_plan
        for name, m in (("dw_gemm dWb", CHANNELS), ("dw_gemm dWa", 3 * CHANNELS)):
            rows = x3[:n].reshape(n, -1)[:, :m].contiguous()
            out[f"{name} n={n} plan"] = len(picked_dw(n, m, CHANNELS))
            slabs = -(-n // trb.DW_ROWS)
            for want in SWEEP_SLICES:
                step = -(-slabs // want) * trb.DW_ROWS
                plan = [(s, min(n, s + step)) for s in range(0, n, step)]
                trb.dw_gemm_plan = lambda *_, plan=plan: plan
                try:
                    out[f"{name} n={n} slices={len(plan)} graph"] = graph_ms(
                        lambda: trb.dw_gemm(rows, an))
                finally:
                    trb.dw_gemm_plan = picked_dw
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", help="root of the other checkout")
    parser.add_argument("--sweep", nargs="?", const="tap_gemm",
                        choices=("tap_gemm", "stream_bf16", "stream_int8", "k3", "int8",
                                 "k2ew"),
                        help="time this checkout's tap GEMMs at forced slice counts "
                             "(default), a streaming step at forced plans, K3 or the "
                             "int8 stages at forced slice counts, or relu_mask_bn_sums "
                             "at forced cluster sizes")
    parser.add_argument("--kernels", choices=("all", "k3", "int8", "k2ew"), default="all",
                        help="the kernels of the A/B (k3: K3 alone; int8: the int8 "
                             "stages, then K3; k2ew: relu_mask_bn_sums and "
                             "norm_drop_res)")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.worker), args.sweep or "",
                                args.kernels)))
        return 0
    if not args.sweep and not args.other:
        parser.error("--other or --sweep is required")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    this = os.path.dirname(os.path.abspath(__file__))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    if args.sweep:
        sweep = worker(this, sweep=args.sweep)
        for case, value in sweep.items():
            print(f"{case:52s} {value:9.4f}" if isinstance(value, float)
                  else f"{case:52s} {value:>9}")
        print(json.dumps({"device": smi, "sweep": sweep}))
        return 0
    other = os.path.abspath(args.other)
    turns = []
    for label, root in (("other", other), ("this", this), ("this", this), ("other", other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                              "--kernels", args.kernels],
                             capture_output=True, text=True, cwd=root)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    for label, t in turns[:2]:
        for line in t["ptxas"]:
            print(f"{label} ptxas: {line}")
    for _, t in turns:
        t.pop("ptxas")
    # Output digests: dw_gemm's (all), the elementwise outputs' and the sums'
    # (k2ew), the sums in each checkout's own order.
    bitwise = {}
    for key in [k for k in turns[0][1] if k.endswith(" sha256")]:
        found = [(label, t.pop(key)) for label, t in turns]
        bitwise[key[:-7]] = {
            "every turn": len({d for _, d in found}) == 1,
            **{label: len({d for l, d in found if l == label}) == 1
               for label in ("other", "this")}}
        print(f"{key[:-7]} outputs bitwise equal: {bitwise[key[:-7]]}")
    print(f"{'case':40s} " + " ".join(f"{label:>9s}" for label, _ in turns))
    for case in turns[0][1]:
        print(f"{case:40s} " + " ".join(f"{t[case]:9.4f}" for _, t in turns))
    print(json.dumps({"device": smi, "other": other, "bitwise": bitwise,
                      "turns": [{"checkout": label, "ms": t} for label, t in turns]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
