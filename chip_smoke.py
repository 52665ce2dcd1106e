#!/usr/bin/env python3
"""Smoke test of videopose3d_torch on one NVIDIA GPU: the port's evaluation,
int8 serving, supervised training and streaming serving paths at the full width
of the README's model, through its hand-written CUDA kernels.

    python3 chip_smoke.py

Phase 0 builds the kernels from ``videopose3d_torch/ops/kernels/csrc`` with nvcc
for sm_90a.  Phase 1 holds each evaluation kernel (K3) against its plain PyTorch
version at the shapes the evaluation path gives it (B=2 TTA rows, a 2,000-frame
video plus 242 padding frames, 1024 channels), in float32 and bfloat16, and times
both.  Phase 2 writes synthetic Human3.6M archives and a random full-width
checkpoint (-arc 3,3,3,3,3, 1024 channels) and runs
``videopose3d_torch.runner.main --evaluate`` with the fused engine in float32 and
bfloat16 and with the plain float32 engine (each after a warm-up call), checking
the protocol numbers and that every kernel launched.  Phase 3 holds the training
kernels against their plain versions at the training path's shapes: the window
gather (K1) at 1,024 windows of 243 rows from a 300,000- and a 3,000,000-row
stream, bitwise, and each forward and backward kernel of the train block (K2) at
the four residual blocks' shapes (n = 27,648 / 9,216 / 3,072 / 1,024 rows of 1,024
channels) in float32 and bfloat16, plus the whole block with its backward in
float32; it times each kernel and plain version (K1, dw_gemm, conv_stats and
du_dtaps_res also from CUDA-graph replay, with a bitwise repeat of each K2 one),
and beside each K2 GEMM kernel one float32 torch.matmul of its product.  Phase 4
trains the full-width model for one epoch of batch 1,024 with ``runner.main``
from the random checkpoint, with the fused train engine twice and the plain one
once (dropout 0.25, the same seed), and checks the losses, the kernel launches,
determinism, and that the saved checkpoint evaluates; one more epoch per engine
is profiled (device time per kernel and the card's busy share over eight warm
steps).
Phase 5 quantizes the full-width model to w8a8 int8 on the card and holds each
int8 stage kernel (K4: expand + block 0 at d=3, mid blocks at d=9 and d=27, the
last block + shrink at d=81; in both tap modes, the accshift mode being K8)
against its plain version at the evaluation path's shapes, times both, checks
that accshift gives the bits of slice, and holds the int8 forward against the
float32 model.  Phase 2 then also evaluates with ``--serving-engine int8``
(twice, then once more with accshift on every block).  Phase 6 (streaming) holds,
on the causal full-width model quantized on the card and B = 1,024 streams, the
ring push (K7) bitwise, the fused streaming step per frame (K5) and at 8 frames
per step (K6), int8 with every ring bitwise at every step over a run in which
every ring wraps and bf16 per step from one shared state, and K6 against K5;
then it writes a synthetic custom archive of 256 videos of 500 frames and a
causal checkpoint and runs ``videopose3d_torch.streaming.main`` with every
engine, checking the streams against the offline causal model and each other,
and profiles one int8_fused run.

Each kernel's line in the final summary carries its time, its plain version's,
its bound (the larger of the bytes it must move over the card's memory rate and
its operations over the card's peak rate for their type, from NVIDIA's H100 SXM
data sheet) and, where one PyTorch call computes the same function, that call's
time.

Fails (non-zero exit, no result line) when no CUDA device is available or any
phase fails.  The last line of standard output is the run's JSON summary.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
BATCH = 2                  # the TTA batch: original and flipped rows
FRAMES = 2000 + 242        # a 2,000-frame video plus the receptive field's padding
CHANNELS = 1024
ARCH = (3, 3, 3, 3, 3)     # receptive field 243
JOINTS = 17
TIMED_RUNS = 10

# Kernel vs plain, max |kernel - plain| <= TOL * max(1, max |plain|).
# float32: both sum ~3,100 float32 products per output in different orders
# (TF32 off); the rounding differences are ~1e-6 of the output scale, and
# 1e-4 leaves two orders of magnitude.  bfloat16: the outputs are themselves
# rounded to bf16 (8 bits, 2^-8 relative spacing), so a different summation
# order may flip the last bit of an output or of an intermediate h / e;
# 1.6e-2 is four bf16 steps at the largest output.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}

# int8 stages (K4, K8) vs plain: the int8 streams of the mid blocks are equal bit
# for bit (exact int32 sums, the same float operations in the same order); the
# expand + block 0 stream within one step on at most 1e-3 of its elements (the
# expand dot is summed in float64 by both and rounded once, so its rounding can
# still differ where the exact sum lies within ~1e-16 of a float32 midpoint, and
# a moved e shifts block 0's per-row requantization); the shrink's float32 output
# within TOL[float32] (a float32 sum of 1024 bf16 products in another order).
INT8_EXPAND_FRAC = 1e-3
# int8 forward vs the float32 model: mean per-joint error < 0.06 * RMS(f32), the
# JAX package's bound (tests/test_int8_serving.py).
INT8_ACCURACY = 0.06
# int8 --evaluate vs xla float32, per protocol number, relative: the poses move by
# a few % of their RMS, the frame-averaged protocols far less.
INT8_AGREE = 0.1
INT8_SOURCE = "videopose3d_torch/ops/kernels/csrc/temporal_block_int8.cu"
INT8_TPU = "videopose3d_tpu/ops/pallas/temporal_block_int8.py"
K8_TPU = "tools/exp_realign.py:101"

# Fused engine vs the plain float32 engine, per protocol number, relative.
# float32: the same math summed in another order, ~1e-6 relative; bound 1e-4.
# bfloat16: five blocks of bf16 activations (2^-9 relative rounding each) shift
# the predicted poses by ~0.1-0.5 %; the frame-averaged protocols move less.
AGREE = {"float32": 1e-4, "bfloat16": 1e-2}

KERNELS = (
    # name, wrapper key, TPU kernel it replaces
    ("fused_expand_block", "expand", "videopose3d_tpu/ops/pallas/temporal_block.py:299"),
    ("fused_dilated_block", "dilated", "videopose3d_tpu/ops/pallas/temporal_block.py:170"),
    ("fused_shrink_block", "shrink", "videopose3d_tpu/ops/pallas/temporal_block.py:414"),
)
SOURCE = "videopose3d_torch/ops/kernels/csrc/temporal_block.cu"

# The training path.  K1 at the full-width batch: 1,024 windows of the receptive
# field's 243 rows of 17 x 2 keypoints, from a 300,000-row stream (40.8 MB, held
# in the 50 MB L2) and a 3,000,000-row one (408 MB, as a real Human3.6M epoch's
# ~3.1 M rows with their flipped copies, read from HBM).
GATHER = dict(batch=1024, window=243, cols=34)
GATHER_ROWS = (300_000, 3_000_000)
GATHER_SOURCE = "videopose3d_torch/ops/kernels/csrc/gather_rows.cu"
GATHER_REPLACES = "videopose3d_tpu/ops/pallas/gather_rows.py:103"
# K2 per residual block of the strided model at batch 1,024: input frames T
# (n = 1024 * T / 3 rows), filter width 3, residual tap 1.
TRAIN_BLOCK_FRAMES = (81, 27, 9, 3)
TRAIN_SOURCE = "videopose3d_torch/ops/kernels/csrc/train_block.cu"
TRAIN_KERNELS = (
    # wrapper key, TPU kernel body it replaces, FLOP per row / C^2 (0: elementwise)
    ("conv_stats", "videopose3d_tpu/ops/pallas/train_block.py:318", 6),
    ("norm_drop_matmul_stats", "videopose3d_tpu/ops/pallas/train_block.py:342", 2),
    ("norm_drop_res", "videopose3d_tpu/ops/pallas/train_block.py:369", 0),
    ("relu_mask_bn_sums", "videopose3d_tpu/ops/pallas/train_block.py:399", 0),
    ("dz_matmul_dd", "videopose3d_tpu/ops/pallas/train_block.py:436", 2),
    ("dw_gemm", "videopose3d_tpu/ops/pallas/train_block.py:436", 2),
    ("du_dtaps_res", "videopose3d_tpu/ops/pallas/train_block.py:459", 6),
)
# Whole train block, kernels vs plain chain: gradients within this relative norm
# error.  Across the full-width chain a few float32 pre-activations within ~2e-7
# of 0 (~5 of 28M at n = 27,648) fall on opposite sides of a ReLU gate under the
# two summation orders; each flip moves one cotangent entry by |g|, and the
# per-channel sums of zero-mean cotangents cancel to ~sqrt(n) |g|, so a flip
# shows at ~1e-4 of those sums and of the gradients built on them (measured
# 1.1e-4 to 7.6e-4 on an H100).  Each kernel is held per tensor at TOL on the
# same inputs; this bound checks the chaining, where a fault is O(1).
GRAD_NORM_TOL = 1e-2
# Training run: 1 epoch at batch 1,024 on half of each training video.
TRAIN_SUBSET = "0.5"
# First-step loss of the fused train engine vs the plain one (same weights, same
# dropout masks, TF32 off): float32 sums in other orders, ~1e-6 relative.
FIRST_STEP_AGREE = 1e-4
# Steps [8, 16) of the epoch's 24 are profiled, once per train engine: warm, and
# clear of the epoch's first and last batches.
PROFILE_STEPS = (8, 16)


# Peaks of an H100 SXM (NVIDIA's data sheet, dense, at 700 W): the bound of a kernel
# is the larger of its bytes over the memory rate and the sum, over the types its
# operations run in, of operations over that type's peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}

# Phase 6, streaming: B = 1,024 streams for the kernel checks, k = 8 frames per
# step for K6; the CLI serves 256 videos of 500 frames (past the 243-frame
# receptive field, so every ring wraps).
STREAM_B = 1024
STREAM_K = 8
STREAM_VIDEOS, STREAM_FRAMES = 256, 500
STREAM_SOURCE = "videopose3d_torch/ops/kernels/csrc/streaming_fused.cu"
STREAM_TPU = "videopose3d_tpu/ops/pallas/streaming_fused.py"
STREAM_KERNELS = {  # launch counter -> the TPU kernel it replaces
    "stream_int8": f"{STREAM_TPU}:201", "stream_bf16": f"{STREAM_TPU}:911",
    "stream_int8_multi": f"{STREAM_TPU}:520", "stream_bf16_multi": f"{STREAM_TPU}:760",
    "ring_push": "videopose3d_tpu/streaming.py:76"}
# int8 streaming poses, kernel vs plain and int8_fused vs int8: the int8 streams are
# equal bit for bit, and the shrink sums 1,024 bf16 products in float32 in another
# order (~1e-7 relative); 1e-4 of max(1, max |plain|) as TOL[float32].
STREAM_POSE_TOL = 1e-4
# int8 vs float32 streaming: mean per-joint error < 0.1 * RMS of the float32 poses,
# the JAX package's bound (tests/test_e2e_streaming.py).
INT8_STREAM_ACCURACY = 0.1


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs=TIMED_RUNS):
    """Median device time of ``fn`` in ms, CUDA events around each run."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(ops, n_bytes):
    """(bound_ms, bound_by) of a function doing ``ops`` ((type, count) pairs) and
    moving ``n_bytes``: the larger of the two times on an H100 SXM."""
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def graph_ms(fn, reps=100):
    """Device time of one call of ``fn`` in ms: ``reps`` calls captured in a CUDA
    graph and replayed between CUDA events, for work too small to time one call
    at a time (there the events would measure the host's enqueue)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay) / reps


def random_model(device, causal=False):
    """The full-width model with random weights and BN statistics, from SEED."""
    from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig
    torch.manual_seed(SEED)
    cfg = TemporalModelConfig(num_joints_in=JOINTS, in_features=2,
                              num_joints_out=JOINTS, filter_widths=ARCH,
                              channels=CHANNELS, causal=causal)
    model = TemporalModel(cfg)
    rng = np.random.default_rng(SEED)
    for bn in [model.expand_bn, *model.layers_bn]:
        c = bn.num_features
        bn.weight.data = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
        bn.bias.data = torch.from_numpy(rng.uniform(-0.2, 0.2, c).astype(np.float32))
        bn.running_mean = torch.from_numpy(rng.uniform(-0.1, 0.1, c).astype(np.float32))
        bn.running_var = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))
    return cfg, model.to(device).eval()


def phase1(cfg, model, device):
    """Each kernel against its plain version at the evaluation path's shapes."""
    from videopose3d_torch.models.temporal import _channels_last, _fold
    from videopose3d_torch.ops.kernels import temporal_block as tb

    rng = np.random.default_rng(SEED + 1)
    x_raw = torch.from_numpy(
        rng.uniform(-1, 1, (BATCH, FRAMES, JOINTS * 2)).astype(np.float32)).to(device)
    results = []
    saved = dict(tb.LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        def block(i):
            s1, b1 = _fold(model.layers_bn[2 * i])
            s2, b2 = _fold(model.layers_bn[2 * i + 1])
            return (_channels_last(model.layers_conv[2 * i], dt), s1, b1,
                    _channels_last(model.layers_conv[2 * i + 1], dt)[0], s2, b2)

        blk = [block(i) for i in range(len(ARCH) - 1)]
        geo = [dict(dilation=cfg.dilations[i + 1], causal_shift=0) for i in range(len(blk))]
        s0, b0 = _fold(model.expand_bn)
        w0 = _channels_last(model.expand_conv, dt)
        ws = _channels_last(model.shrink, dt)[0]
        bs = model.shrink.bias.detach().float()
        stages = [
            ("fused_expand_block", "d=3", (w0, s0, b0, *blk[0]),
             lambda x: tb.fused_expand_block(x, w0, s0, b0, *blk[0], **geo[0]),
             lambda x: tb.fused_expand_block_plain(x, w0, s0, b0, *blk[0], **geo[0])),
            ("fused_dilated_block", "d=9", blk[1],
             lambda x: tb.fused_dilated_block(x, *blk[1], **geo[1]),
             lambda x: tb.fused_dilated_block_plain(x, *blk[1], **geo[1])),
            ("fused_dilated_block", "d=27", blk[2],
             lambda x: tb.fused_dilated_block(x, *blk[2], **geo[2]),
             lambda x: tb.fused_dilated_block_plain(x, *blk[2], **geo[2])),
            ("fused_shrink_block", "d=81", (*blk[3], ws, bs),
             lambda x: tb.fused_shrink_block(x, *blk[3], ws, bs, **geo[3]),
             lambda x: tb.fused_shrink_block_plain(x, *blk[3], ws, bs, **geo[3])),
        ]
        x = x_raw
        for name, where, weights, kernel, plain in stages:
            got = kernel(x)
            want = plain(x)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name} {where} {dt}: {tuple(got.shape)} {got.dtype} vs plain "
                  f"{tuple(want.shape)} {want.dtype}")
            check(bool(torch.isfinite(got.float()).all()), f"{name} {where} {dt}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            scale = max(1.0, float(want.float().abs().max()))
            tol = TOL[dt] * scale
            ms = cuda_ms(lambda: kernel(x))
            plain_ms = cuda_ms(lambda: plain(x))
            print(f"phase1 {name:20s} {where:5s} {str(dt):15s} in {tuple(x.shape)} "
                  f"out {tuple(got.shape)}: max_abs_err {err:.3e} (tol {tol:.3e}, "
                  f"max|plain| {scale:.3f}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            check(err <= tol, f"{name} {where} {dt}: max abs error {err} > {tol}")
            # Per output row: 3 dilated taps and the 1x1 product, C x C each; the
            # expand's 3 taps of 34 -> C over its rows; the shrink's C -> 51.
            t_out = got.shape[1]
            ops = 2 * BATCH * t_out * 4 * CHANNELS ** 2
            if name == "fused_expand_block":
                ops += 2 * BATCH * (x.shape[1] - 2) * 3 * x.shape[2] * CHANNELS
            if name == "fused_shrink_block":
                ops += 2 * BATCH * t_out * CHANNELS * got.shape[2]
            bound_ms, bound_by = roofline([(str(dt)[6:], ops)], nbytes(x, got, *weights))
            results.append({"name": name, "where": where, "dtype": dt,
                            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
            x = want  # the next stage sees the same input in both versions
    tb.LAUNCHES.update(saved)  # comparison launches do not count
    return results


def write_dataset(root):
    """Synthetic H36M-format archives: training subjects S1 and S5, test subjects
    S9 and S11, 2 actions, 4 cameras, 1,500 frames each (random world-space mocap,
    uniform pixel keypoints)."""
    rng = np.random.default_rng(SEED + 2)
    subjects, actions, n = ("S9", "S11", "S1", "S5"), ("Walking 1", "Eating 2"), 1500
    p3 = {s: {a: (rng.standard_normal((n, 1, 3)) * 0.1
                  + rng.standard_normal((n, 32, 3)) * 0.2).astype(np.float32)
              for a in actions} for s in subjects}
    np.savez_compressed(os.path.join(root, "data_3d_h36m.npz"), positions_3d=p3)
    p2 = {s: {a: [rng.uniform(100, 900, (n, JOINTS, 2)).astype(np.float32)
                  for _ in range(4)] for a in actions} for s in subjects}
    meta = {"layout_name": "h36m", "num_joints": JOINTS,
            "keypoints_symmetry": [[4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]]}
    np.savez_compressed(os.path.join(root, "data_2d_h36m_gt.npz"),
                        positions_2d=p2, metadata=meta)


_ACTION = re.compile(r"^----([^-].*)----$")
_PROTO = re.compile(r"^(Protocol #\d Error \(\S+\)|Velocity Error \(MPJVE\)): (\S+) mm$")
_RATE = re.compile(r"^INFO: evaluated (\d+) frames in (\S+) s \((\S+) frames/s")


def run_cli(argv):
    """runner.main in-process; returns (per-action protocol numbers, frames/s,
    frames, captured output)."""
    from videopose3d_torch import runner
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runner.main(argv)
    torch.cuda.synchronize()
    out = buf.getvalue()
    numbers = protocol_lines(out)
    rate = next(((float(m.group(3)), int(m.group(1)))
                 for m in map(_RATE.match, out.splitlines()) if m), None)
    check(numbers and all(len(v) == 4 for v in numbers.values()),
          f"protocol lines missing from the output:\n{out}")
    check(all(math.isfinite(v) for vs in numbers.values() for v in vs),
          f"non-finite protocol numbers: {numbers}")
    check(rate is not None, f"no frames/s line in the output:\n{out}")
    return numbers, rate[0], rate[1], out


def reset_counts():
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    from videopose3d_torch.ops.kernels import temporal_block as tb
    from videopose3d_torch.ops.kernels import temporal_block_int8 as tq
    for counts in (tb.LAUNCHES, tq.LAUNCHES, sf.LAUNCHES):
        for k in counts:
            counts[k] = 0


def phase2(model, tmp):
    from videopose3d_torch.ops.kernels import temporal_block as tb
    from videopose3d_torch.ops.kernels import temporal_block_int8 as tq
    data = os.path.join(tmp, "data")
    ckpt = os.path.join(tmp, "checkpoint")
    os.makedirs(data)
    os.makedirs(ckpt)
    write_dataset(data)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": 0, "lr": 0.001, "model_pos": state, "model_traj": None,
                "optimizer": None}, os.path.join(ckpt, "random_full_width.bin"))
    base = ["-k", "gt", "-arc", ",".join(map(str, ARCH)), "-ch", str(CHANNELS),
            "-str", "S1", "-ste", "S9,S11", "--data-dir", data, "-c", ckpt,
            "--evaluate", "random_full_width.bin", "--device", "cuda"]
    runs, launches = {}, {}
    for engine, dtype in (("fused", "float32"), ("fused", "bfloat16"),
                          ("xla", "float32")):
        argv = base + ["--serving-engine", engine, "--compute-dtype", dtype]
        # A first call pays one-time setup (cuDNN's, for xla); the second is
        # the measured and counted run.
        warm, _, _, _ = run_cli(argv)
        reset_counts()
        numbers, fps, frames, _ = run_cli(argv)
        counts = dict(tb.LAUNCHES)
        check(not any(tq.LAUNCHES.values()), f"{engine} run launched int8 kernels")
        if engine == "fused":  # no atomics: the kernels are deterministic
            check(numbers == warm, f"fused {dtype}: two runs differ: {warm} vs {numbers}")
        runs[(engine, dtype)] = numbers
        launches[(engine, dtype)] = counts
        print(f"phase2 {engine:5s} {dtype:8s}: {frames} frames, {fps:.1f} frames/s, "
              f"kernel launches {counts}")
        for action, vals in numbers.items():
            print(f"phase2 {engine:5s} {dtype:8s} {action:8s} P1 {vals[0]:.6f} "
                  f"P2 {vals[1]:.6f} P3 {vals[2]:.6f} MPJVE {vals[3]:.6f} mm")
        if engine == "fused":
            check(all(v > 0 for v in counts.values()),
                  f"fused {dtype} run did not launch every kernel: {counts}")
        else:
            check(not any(counts.values()), f"xla run launched kernels: {counts}")
    ref = runs[("xla", "float32")]
    for dtype, bound in AGREE.items():
        got = runs[("fused", dtype)]
        check(got.keys() == ref.keys(), f"fused {dtype} actions {list(got)} vs {list(ref)}")
        worst = max(abs(g - r) / abs(r) for a in ref for g, r in zip(got[a], ref[a]))
        print(f"phase2 fused {dtype} vs xla float32: worst relative protocol "
              f"difference {worst:.3e} (bound {bound:.0e})")
        check(worst <= bound, f"fused {dtype} disagrees with xla: {worst} > {bound}")

    # int8: quantized on the first video; a warm-up, the measured run, then the
    # same with the accshift tap mode on every block.
    argv = base + ["--serving-engine", "int8"]
    warm, _, _, _ = run_cli(argv)
    for mode, min_d in (("slice", tq.ACCSHIFT_MIN_DILATION), ("accshift", 0)):
        saved_min_d = tq.ACCSHIFT_MIN_DILATION
        tq.ACCSHIFT_MIN_DILATION = min_d
        try:
            reset_counts()
            numbers, fps, frames, _ = run_cli(argv)
        finally:
            tq.ACCSHIFT_MIN_DILATION = saved_min_d
        counts = dict(tq.LAUNCHES)
        launches[("int8", mode)] = counts
        print(f"phase2 int8  {mode:8s}: {frames} frames, {fps:.1f} frames/s, "
              f"kernel launches {counts}")
        for action, vals in numbers.items():
            print(f"phase2 int8  {mode:8s} {action:8s} P1 {vals[0]:.6f} "
                  f"P2 {vals[1]:.6f} P3 {vals[2]:.6f} MPJVE {vals[3]:.6f} mm")
        ran = {k: v for k, v in counts.items()
               if k.endswith("_accshift") == (mode == "accshift")}
        check(all(v > 0 for v in ran.values()) and sum(counts.values()) == sum(ran.values())
              and not any(tb.LAUNCHES.values()),
              f"int8 {mode} run did not launch exactly its int8 kernels: {counts}")
        check(numbers == warm, f"int8 {mode}: differs from the first int8 run: "
                               f"{warm} vs {numbers}")
    worst = max(abs(g - r) / abs(r) for a in ref for g, r in zip(warm[a], ref[a]))
    print(f"phase2 int8 vs xla float32: worst relative protocol difference {worst:.3e} "
          f"(bound {INT8_AGREE}); the three int8 runs bitwise equal")
    check(warm.keys() == ref.keys() and worst <= INT8_AGREE,
          f"int8 disagrees with xla: {worst} > {INT8_AGREE}")
    return launches


def phase5(cfg, model, device):
    """The int8 stage kernels against their plain versions at the evaluation
    path's shapes, in both tap modes, and the int8 forward against float32."""
    from videopose3d_torch.evaluate import full_float32
    from videopose3d_torch.models.temporal import forward_dilated, forward_dilated_int8
    from videopose3d_torch.ops.kernels import temporal_block_int8 as tq

    rng = np.random.default_rng(SEED + 4)
    x_raw = torch.from_numpy(
        rng.uniform(-1, 1, (BATCH, FRAMES, JOINTS, 2)).astype(np.float32)).to(device)
    saved = dict(tq.LAUNCHES)
    start = time.perf_counter()
    q = tq.quantize_temporal_model(cfg, model, x_raw)
    torch.cuda.synchronize()
    print(f"phase5 quantized the model on {tuple(x_raw.shape)} in "
          f"{time.perf_counter() - start:.3f} s")
    k0, c_in, c = q.expand_w.shape
    t_e = FRAMES - (k0 - 1)
    flat = x_raw.reshape(BATCH, FRAMES, -1)
    x_taps = torch.cat([flat[:, j: j + t_e] for j in range(k0)], -1).to(torch.bfloat16)
    w0 = q.expand_w.reshape(k0 * c_in, c)
    geo = [dict(dilation=d, causal_shift=0) for d in cfg.dilations[1:]]
    last = len(ARCH) - 2
    stages = [
        ("int8_expand_block", "int8_expand", f"{INT8_TPU}:603", 0,
         lambda x, m: tq.int8_expand_block(x, w0, q.expand_scale, q.expand_shift,
                                           q.blocks[0], tap_mode=m, **geo[0]),
         lambda x, m: tq.int8_expand_block_plain(x, w0, q.expand_scale, q.expand_shift,
                                                 q.blocks[0], tap_mode=m, **geo[0])),
        *[("int8_dilated_block", "int8_dilated", f"{INT8_TPU}:492", i,
           lambda x, m, i=i: tq.int8_dilated_block(x, q.blocks[i], tap_mode=m, **geo[i]),
           lambda x, m, i=i: tq.int8_dilated_block_plain(x, q.blocks[i], tap_mode=m,
                                                         **geo[i]))
          for i in range(1, last)],
        ("int8_shrink_block", "int8_shrink", f"{INT8_TPU}:669", last,
         lambda x, m: tq.int8_shrink_block(x, q.blocks[last], q.shrink_w, q.shrink_b,
                                           tap_mode=m, **geo[last]),
         lambda x, m: tq.int8_shrink_block_plain(x, q.blocks[last], q.shrink_w,
                                                 q.shrink_b, tap_mode=m, **geo[last])),
    ]
    results = []
    x = x_taps
    for name, key, replaces, i, kernel, plain in stages:
        where = f"d={geo[i]['dilation']}"
        want = plain(x, "slice")
        got_slice = None
        for mode in ("slice", "accshift"):
            got = kernel(x, mode)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name} {where} {mode}: {tuple(got.shape)} {got.dtype} vs plain "
                  f"{tuple(want.shape)} {want.dtype}")
            if got.dtype == torch.int8:
                diff = (got.int() - want.int()).abs()
                err, frac = float(diff.max()), float((diff > 0).float().mean())
                bound = "bitwise" if key == "int8_dilated" else (
                    f"<= 1 step on <= {INT8_EXPAND_FRAC:.0e}")
                check(err == 0 if key == "int8_dilated" else
                      (err <= 1 and frac <= INT8_EXPAND_FRAC),
                      f"{name} {where} {mode}: max diff {err} on {frac:.3e} of elements")
                detail = f"max |diff| {err:.0f} step on {frac:.3e} of elements ({bound})"
            else:
                check(bool(torch.isfinite(got).all()), f"{name} {where}: non-finite output")
                err = float((got - want).abs().max())
                tol = TOL[torch.float32] * max(1.0, float(want.abs().max()))
                check(err <= tol, f"{name} {where} {mode}: max abs error {err} > {tol}")
                detail = f"max_abs_err {err:.3e} (tol {tol:.3e})"
            if mode == "slice":
                got_slice = got
            else:
                check(torch.equal(got, got_slice),
                      f"{name} {where}: accshift and slice kernels differ")
            ms = cuda_ms(lambda: kernel(x, mode))
            plain_ms = cuda_ms(lambda: plain(x, mode))
            print(f"phase5 {name:18s} {where:5s} {mode:8s} in {tuple(x.shape)} out "
                  f"{tuple(got.shape)} {str(got.dtype)[6:]}: {detail}; kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms")
            k8 = mode == "accshift" and key == "int8_dilated"
            # int8 products: 3 taps and the 1x1, C x C per output row; the expand's
            # bf16 dot over its rows and the shrink's bf16 C -> 51.
            blk = q.blocks[i]
            t_out = got.shape[1]
            ops = [("int8", 2 * BATCH * t_out * 4 * c * c)]
            weights = [blk.pa, blk.pb, blk.A1, blk.B1, blk.A2, blk.B2, blk.R]
            if key == "int8_expand":
                ops.append(("bfloat16", 2 * BATCH * x.shape[1] * x.shape[2] * c))
                weights += [w0, q.expand_scale, q.expand_shift]
            if key == "int8_shrink":
                ops.append(("bfloat16", 2 * BATCH * t_out * c * got.shape[2]))
                weights += [q.shrink_w, q.shrink_b]
            bound_ms, bound_by = roofline(ops, nbytes(x, got, *weights))
            results.append({"name": f"{name} ({mode}, {where}, C={CHANNELS})",
                            "key": (mode, key + ("_accshift" if mode == "accshift" else "")),
                            "route": "cuda", "source": INT8_SOURCE,
                            "replaces": K8_TPU if k8 else replaces,
                            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        print(f"phase5 {name:18s} {where:5s} accshift output equals slice bit for bit")
        x = want  # the next stage sees the same input in both versions
    with full_float32():
        want = forward_dilated(model, x_raw)
    got = forward_dilated_int8(cfg, q, x_raw)
    torch.cuda.synchronize()
    per_joint = float(torch.linalg.vector_norm(got - want, dim=-1).mean())
    rms = float(want.square().mean().sqrt())
    print(f"phase5 int8 forward vs float32 model on {tuple(x_raw.shape)}: mean per-joint "
          f"error {per_joint:.5f}, {per_joint / rms:.4f} of RMS {rms:.4f} (bound "
          f"{INT8_ACCURACY})")
    check(per_joint < INT8_ACCURACY * rms, f"int8 forward error {per_joint} >= "
                                           f"{INT8_ACCURACY} * {rms}")
    tq.LAUNCHES.update(saved)  # comparison launches do not count
    return results


def compare(name, got, want, dt):
    """max |got - want| against TOL[dt] * max(1, max |want|) for one tensor."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} vs plain {tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    check(err <= TOL[dt] * scale, f"{name}: max abs error {err} > {TOL[dt] * scale}")
    return err


def train_block_inputs(frames, dt, device):
    """Block inputs of the full-width training step: batch 1024, ``frames``
    input frames, 1024 channels, dropout masks at rate 0.25, from SEED."""
    rng = np.random.default_rng(SEED + frames)
    b, c, fw = 1024, CHANNELS, 3
    f = lambda a, d=dt: torch.from_numpy(np.asarray(a, np.float32)).to(device, d)
    bound = 1 / np.sqrt(fw * c)
    return dict(
        x=f(rng.standard_normal((b, frames, c))),
        wa=f(rng.uniform(-bound, bound, (fw, c, c))),
        wb=f(rng.uniform(-1, 1, (c, c)) / np.sqrt(c)),
        bn=[f(rng.uniform(lo, hi, c), torch.float32)
            for lo, hi in ((0.5, 1.5), (-0.2, 0.2), (0.5, 1.5), (-0.2, 0.2))],
        masks=[f((rng.uniform(size=(b, frames // fw, c)) < 0.75) / 0.75)
               for _ in range(2)],
        shifts=[f(rng.uniform(-0.1, 0.1, c), torch.float32) for _ in range(2)],
        g=f(rng.standard_normal((b, frames // fw, c)) * 1e-3))


def train_block_stages(p):
    """(kernel key, args, kwargs) for each K2 kernel, the inputs taken from the
    block's plain forward and backward chain so that they are what the step
    gives each kernel."""
    from videopose3d_torch.models.temporal import BN_EPS
    from videopose3d_torch.ops.kernels import train_block as trb
    b, t, c = p["x"].shape
    n = b * (t // 3)
    x3 = p["x"].reshape(n, 3, c)
    ma, mb = (m.reshape(n, c) for m in p["masks"])
    sa, ba, sb, bb = p["bn"]
    shift_a, shift_b = p["shifts"]
    u, res, s1, s2 = trb.conv_stats_plain(x3, p["wa"], shift_a, center=1)
    mean_a, var_a = trb._finalize_stats(s1, s2, n, shift_a)
    gate_a = trb._affine_consts(mean_a, var_a, sa, ba, x3.dtype)
    d, v, s1, s2 = trb.norm_drop_matmul_stats_plain(u, ma, gate_a, p["wb"], shift_b)
    mean_b, var_b = trb._finalize_stats(s1, s2, n, shift_b)
    gate_b = trb._affine_consts(mean_b, var_b, sb, bb, x3.dtype)
    g2 = p["g"].reshape(n, c)
    stat_b = torch.stack([mean_b, torch.rsqrt(var_b + BN_EPS)])
    stat_a = torch.stack([mean_a, torch.rsqrt(var_a + BN_EPS)])
    gz, s1, s2 = trb.relu_mask_bn_sums_plain(g2, v, mb, stat_b, gate_b)
    coef_b = trb._bwd_consts(mean_b, var_b, sb, s1, s2, n)
    dz, dd = trb.dz_matmul_dd_plain(gz, v, coef_b, p["wb"])
    ga, s1, s2 = trb.relu_mask_bn_sums_plain(dd, u, ma, stat_a, gate_a)
    coef_a = trb._bwd_consts(mean_a, var_a, sa, s1, s2, n)
    return [
        ("conv_stats", (x3, p["wa"], shift_a), {"center": 1}),
        ("norm_drop_matmul_stats", (u, ma, gate_a, p["wb"], shift_b), {}),
        ("norm_drop_res", (v, mb, gate_b, res), {}),
        ("relu_mask_bn_sums", (g2, v, mb, stat_b, gate_b), {}),
        ("dz_matmul_dd", (gz, v, coef_b, p["wb"]), {}),
        ("dw_gemm", (d, dz), {}),
        ("du_dtaps_res", (ga, u, g2, coef_a, p["wa"]), {"center": 1}),
    ]


# K2 kernels timed from CUDA-graph replay as well, and checked for a bitwise repeat.
GRAPH_TIMED = ("conv_stats", "dw_gemm", "du_dtaps_res")


def library_call(key, args):
    """One float32 torch.matmul (TF32 off) computing a K2 GEMM kernel's product
    alone, on the kernel's inputs, or None for the elementwise kernels."""
    if key == "conv_stats":
        x3, wa = args[0], args[1]
        a, b = x3.reshape(x3.shape[0], -1), wa.reshape(-1, wa.shape[-1])
    elif key == "du_dtaps_res":  # du has ga's shape; Wa^T laid out as the kernel's
        wa = args[4]
        a, b = args[0], wa.permute(2, 0, 1).reshape(wa.shape[-1], -1).contiguous()
    elif key == "norm_drop_matmul_stats":  # d has u's shape
        a, b = args[0], args[3]
    elif key == "dz_matmul_dd":  # dz has gz's shape
        a, b = args[0], args[3].t()
    elif key == "dw_gemm":
        a, b = args[0].t(), args[1]
    else:
        return None
    return lambda: torch.matmul(a, b)


def whole_train_block(p, plain):
    """The block's forward and backward in float32: out, stats, all gradients."""
    from videopose3d_torch.ops.kernels import train_block as trb
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (p["x"], p["wa"], p["wb"], *p["bn"])]
    outs = trb.fused_train_block(*leaves, *p["masks"], *p["shifts"], center=1, fw=3,
                                 plain=plain)
    return [o.detach() for o in outs] + list(torch.autograd.grad(outs[0], leaves, p["g"]))


def phase3(device):
    """The training kernels against their plain versions at the training path's
    shapes, and their times."""
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import train_block as trb
    saved = (dict(gr.LAUNCHES), dict(trb.LAUNCHES))
    results = []

    gen = torch.Generator().manual_seed(SEED + 3)
    window = GATHER["window"]
    for n_rows in GATHER_ROWS:
        flat = torch.randn(n_rows, GATHER["cols"], device=device,
                           generator=torch.Generator(device).manual_seed(SEED + n_rows))
        row0 = torch.randint(0, n_rows - window + 1, (GATHER["batch"],),
                             generator=gen).to(device)
        got = gr.gather_windows(flat, row0, window=window)
        want = gr.gather_windows_plain(flat, row0, window=window)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"gather_windows rows={n_rows}: kernel and plain version differ")
        # The library call: one advanced-indexing gather of the same rows (the
        # window starts are in range, so the clamp of the kernel's contract is the
        # identity).
        rows = row0[:, None] + torch.arange(window, device=device)
        check(torch.equal(flat[rows], want), "gather_windows: the indexing gather differs")
        fns = (lambda: gr.gather_windows(flat, row0, window=window),
               lambda: gr.gather_windows_plain(flat, row0, window=window),
               lambda: flat[rows])
        # Device time from CUDA-graph replay (a call's host enqueue, ~0.05 ms, is
        # longer than the copy); one call between CUDA events beside it.
        ms, plain_ms, library_ms = (graph_ms(fn) for fn in fns)
        one_call = [cuda_ms(fn) for fn in fns]
        gbps = 2 * got.numel() * 4 / (ms * 1e-3) / 1e9
        bound_ms, bound_by = roofline([], 2 * nbytes(got) + nbytes(row0))
        print(f"phase3 gather_windows float32 {GATHER} rows={n_rows}: bitwise equal; "
              f"graph-replayed kernel {ms:.4f} ms ({gbps:.0f} GB/s moved), plain "
              f"{plain_ms:.4f} ms, indexing gather {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); one call with its enqueue: kernel "
              f"{one_call[0]:.4f} ms, plain {one_call[1]:.4f} ms, indexing gather "
              f"{one_call[2]:.4f} ms")
        results.append({"name": f"gather_windows (float32, B={GATHER['batch']}, "
                                f"window={window}, C={GATHER['cols']}, rows={n_rows})",
                        "key": ("gather", "gather_windows"), "route": "cuda",
                        "source": GATHER_SOURCE, "replaces": GATHER_REPLACES,
                        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms})
        del flat, got, want, rows

    flops = {key: f for key, _, f in TRAIN_KERNELS}
    replaces = {key: r for key, r, _ in TRAIN_KERNELS}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).replace("torch.", "")
        for frames in TRAIN_BLOCK_FRAMES:
            p = train_block_inputs(frames, dt, device)
            n = 1024 * frames // 3
            for key, args, kwargs in train_block_stages(p):
                kernel, plain = getattr(trb, key), getattr(trb, key + "_plain")
                got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                err = max(compare(f"{key} {dname} n={n} output {i}", a, w, dt)
                          for i, (a, w) in enumerate(zip(got, want)))
                ms = cuda_ms(lambda: kernel(*args, **kwargs))
                plain_ms = cuda_ms(lambda: plain(*args, **kwargs))
                library = library_call(key, args) if dt == torch.float32 else None
                library_ms = None if library is None else cuda_ms(library)
                bound_ms, bound_by = roofline(
                    [(dname, flops[key] * n * CHANNELS ** 2)],
                    nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *got))
                tflops = (f"{flops[key] * n * CHANNELS ** 2 / (ms * 1e-3) / 1e12:.1f} "
                          "TFLOP/s" if flops[key] else "elementwise")
                lib = "" if library_ms is None else f", torch.matmul {library_ms:.3f} ms"
                print(f"phase3 {key:22s} {dname:8s} n={n:6d}: max_abs_err {err:.3e}; "
                      f"kernel {ms:.3f} ms ({tflops}), plain {plain_ms:.3f} ms{lib}, "
                      f"bound {bound_ms:.3f} ms ({bound_by})")
                if key in GRAPH_TIMED:
                    # Device time from CUDA-graph replay: at the smaller n the
                    # wrapper's host enqueue is a good part of one call's time.
                    again = kernel(*args, **kwargs)
                    torch.cuda.synchronize()
                    again = again if isinstance(again, tuple) else (again,)
                    check(all(torch.equal(a, b) for a, b in zip(again, got)),
                          f"{key} {dname} n={n}: two launches differ")
                    ms, plain_ms = (graph_ms(lambda f=f: f(*args, **kwargs), reps=20)
                                    for f in (kernel, plain))
                    if library is not None:
                        library_ms = graph_ms(library, reps=20)
                    lib = "" if library_ms is None else f", torch.matmul {library_ms:.4f} ms"
                    print(f"phase3 {key:22s} {dname:8s} n={n:6d}: bitwise-equal repeat; "
                          f"graph-replayed kernel {ms:.4f} ms "
                          f"({flops[key] * n * CHANNELS ** 2 / (ms * 1e-3) / 1e12:.1f} "
                          f"TFLOP/s), plain {plain_ms:.4f} ms{lib}")
                results.append({"name": f"{key} ({dname}, n={n}, C={CHANNELS})",
                                "key": ("train", key), "route": "cuda",
                                "source": TRAIN_SOURCE, "replaces": replaces[key],
                                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by,
                                "library_ms": library_ms})
            if dt == torch.float32:
                # The whole block, forward and backward, as the train step runs
                # it: outputs and statistics per tensor at TOL, gradients by
                # relative norm error (GRAD_NORM_TOL says why).
                got, want = whole_train_block(p, False), whole_train_block(p, True)
                names = ["out", "mean_a", "var_a", "mean_b", "var_b", "dx", "dwa", "dwb",
                         "dscale_a", "dbias_a", "dscale_b", "dbias_b"]
                for nm, a, w in zip(names[:5], got[:5], want[:5]):
                    compare(f"train block n={n} {nm}", a, w, dt)
                rel = {nm: float((a.double() - w.double()).norm() / w.double().norm())
                       for nm, a, w in zip(names[5:], got[5:], want[5:])}
                print(f"phase3 train block forward+backward float32 n={n:6d}: outputs "
                      f"and stats within tolerance; gradient relative norm errors "
                      + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
                check(all(v <= GRAD_NORM_TOL for v in rel.values()),
                      f"train block n={n}: gradients differ: {rel}")
            del p
    gr.LAUNCHES.update(saved[0])  # comparison launches do not count
    trb.LAUNCHES.update(saved[1])
    return results


_EPOCH = re.compile(r"^\[1\] time \S+ lr \S+ 3d_train (\S+) 3d_eval (\S+) 3d_valid (\S+)$")
_TRAINED = re.compile(r"^INFO: trained (\d+) steps in (\S+) s \((\S+) frames/s")


def train_cli(argv, profiled=None):
    """runner.main training in-process; returns (per-step losses, epoch line
    numbers, (steps, seconds, frames/s), final protocol numbers, launches).
    ``profiled``: a dict that receives a torch.profiler trace of steps
    PROFILE_STEPS and their wall time."""
    from torch.profiler import ProfilerActivity, profile
    from videopose3d_torch import runner, train
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import train_block as trb
    losses = []
    step = train.SupervisedTrainer.step

    def recording_step(self, *args, **kwargs):
        first, stop = PROFILE_STEPS
        if profiled is not None and len(losses) == first:
            torch.cuda.synchronize()
            profiled["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA])
            profiled["prof"].start()
            profiled["start"] = time.perf_counter()
        loss = step(self, *args, **kwargs)
        losses.append(loss)
        if profiled is not None and len(losses) == stop:
            torch.cuda.synchronize()
            profiled["wall"] = time.perf_counter() - profiled["start"]
            profiled["prof"].stop()
        return loss

    for counts in (gr.LAUNCHES, trb.LAUNCHES):
        for k in counts:
            counts[k] = 0
    buf = io.StringIO()
    train.SupervisedTrainer.step = recording_step
    try:
        with contextlib.redirect_stdout(buf):
            runner.main(argv)
    finally:
        train.SupervisedTrainer.step = step
    torch.cuda.synchronize()
    launches = {**gr.LAUNCHES, **trb.LAUNCHES}
    out = buf.getvalue()
    epoch = [m for m in map(_EPOCH.match, out.splitlines()) if m]
    trained = [m for m in map(_TRAINED.match, out.splitlines()) if m]
    check(len(epoch) == 1 and len(trained) == 1, f"no epoch or trained line:\n{out}")
    numbers = [float(v) for v in epoch[0].groups()]
    rate = (int(trained[0].group(1)), float(trained[0].group(2)), float(trained[0].group(3)))
    check(all(math.isfinite(v) for v in numbers), f"non-finite epoch losses: {numbers}")
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite step losses: {losses}")
    return losses, numbers, rate, out, launches


def phase4(tmp):
    """One full-width training epoch per engine through runner.main."""
    data = os.path.join(tmp, "data")
    init = os.path.join(tmp, "checkpoint", "random_full_width.bin")
    runs, profiles = {}, {}
    for name, engine in (("pallas", "pallas"), ("xla", "xla"), ("pallas again", "pallas"),
                         ("pallas profiled", "pallas"), ("xla profiled", "xla")):
        ckpt = os.path.join(tmp, "train_" + name.replace(" ", "_"))
        os.makedirs(ckpt)
        shutil.copy(init, ckpt)
        argv = ["-k", "gt", "-arc", ",".join(map(str, ARCH)), "-ch", str(CHANNELS),
                "-b", "1024", "-e", "1", "-drop", "0.25", "--seed", str(SEED),
                "-str", "S1,S5", "-ste", "S9,S11", "--subset", TRAIN_SUBSET,
                "--data-dir", data, "-c", ckpt, "-r", "random_full_width.bin",
                "--checkpoint-frequency", "1", "--device", "cuda",
                "--train-engine", engine]
        profiled = {} if name.endswith("profiled") else None
        losses, numbers, (steps, seconds, fps), out, launches = train_cli(argv, profiled)
        if profiled is not None:
            profiles[engine] = profiled
            continue
        runs[name] = (losses, launches, ckpt, out)
        print(f"phase4 train {name:12s}: {steps} steps of batch 1024 in {seconds:.3f} s, "
              f"{seconds / steps * 1e3:.2f} ms/step, {fps:.1f} training frames/s; "
              f"first-step loss {float(losses[0]):.6f}, epoch 3d_train/3d_eval/3d_valid "
              f"{numbers[0]:.4f}/{numbers[1]:.4f}/{numbers[2]:.4f} mm; launches {launches}")
    # Where the time of a train step goes: device time per kernel over the
    # profiled steps, per step, and the card's busy share of their wall time.
    # Only the device-side events count: an aten op's row repeats its kernels'.
    from torch.autograd import DeviceType
    n_steps = PROFILE_STEPS[1] - PROFILE_STEPS[0]
    for engine, profiled in profiles.items():
        device_us = {}
        for avg in profiled["prof"].key_averages():
            if avg.device_type == DeviceType.CUDA and avg.self_device_time_total > 0:
                device_us[avg.key] = device_us.get(avg.key, 0) + avg.self_device_time_total
        check(device_us, f"the {engine} profile holds no device time")
        total_ms = sum(device_us.values()) / 1e3 / n_steps
        wall_ms = profiled["wall"] * 1e3 / n_steps
        print(f"phase4 profile {engine}: steps {PROFILE_STEPS[0]}-{PROFILE_STEPS[1] - 1}, "
              f"{wall_ms:.3f} ms/step wall, {total_ms:.3f} ms/step device time, busy "
              f"{100 * total_ms / wall_ms:.1f} %")
        for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:10]:
            print(f"phase4 profile {engine}   {us / 1e3 / n_steps:8.3f} ms/step  {key[:90]}")
    first_p, first_x = float(runs["pallas"][0][0]), float(runs["xla"][0][0])
    rel = abs(first_p - first_x) / abs(first_x)
    print(f"phase4 first-step loss pallas {first_p!r} vs xla {first_x!r}: relative "
          f"difference {rel:.3e} (bound {FIRST_STEP_AGREE:.0e})")
    check(rel <= FIRST_STEP_AGREE, f"first-step losses differ: {first_p} vs {first_x}")
    for name in ("pallas", "pallas again"):
        launches = runs[name][1]
        check(all(v > 0 for v in launches.values()),
              f"{name} run did not launch every training kernel: {launches}")
    from videopose3d_torch.ops.kernels import train_block as trb
    check(not any(runs["xla"][1][k] for k in trb.LAUNCHES),
          f"xla run launched train-block kernels: {runs['xla'][1]}")
    check(torch.equal(runs["pallas"][0], runs["pallas again"][0]),
          "two pallas runs gave different losses")
    print("phase4 two pallas runs: bitwise-equal losses over "
          f"{runs['pallas'][0].numel()} steps")
    # The saved checkpoint evaluates to the numbers the run printed.
    trained = protocol_lines(runs["pallas"][3])
    evaluated, _, _, _ = run_cli(["-k", "gt", "-arc", ",".join(map(str, ARCH)), "-ch",
                                  str(CHANNELS), "-str", "S1", "-ste", "S9,S11",
                                  "--data-dir", data, "-c", runs["pallas"][2],
                                  "--evaluate", "epoch_1.bin", "--device", "cuda"])
    worst = max(abs(g - w) / abs(w) for a in trained for g, w in zip(evaluated[a], trained[a]))
    print(f"phase4 epoch_1.bin --evaluate vs the training run's final evaluation: "
          f"worst relative protocol difference {worst:.3e}")
    check(evaluated.keys() == trained.keys() and worst <= 1e-5,
          f"reloaded checkpoint evaluates differently: {evaluated} vs {trained}")
    return runs["pallas again"][1]


# ---------------------------------------------------------------------------
# Phase 6: streaming serving (K5, K6, K7)
# ---------------------------------------------------------------------------


def _clone_state(ss):
    return {"bufs": [r.clone() for r in ss["bufs"]], "ptr": list(ss["ptr"])}


def stream_cost(int8, widths, lags, b, c, k, j3, doubled):
    """(ops, bytes) of one fused streaming step: per block (width + 1) C x C
    products per row and the shrink's C -> J3; the rows each tap reads from its
    ring (min(lag, k) frames: the rest are the step's own frames), the pushes (both
    copies of a doubled ring), the block 0 input, the weights and the poses."""
    act = 1 if int8 else 2
    mac = sum(kw + 1 for kw in widths) * c * c * k * b
    ops = [("int8" if int8 else "bfloat16", 2 * mac), ("bfloat16", 2 * k * b * c * j3)]
    taps = sum(min(lag, k) for block in lags for lag in block) * b * c * act
    pushes = len(widths) * k * b * c * act * (2 if doubled else 1)
    weights = sum((kw + 1) * c * c * act + (5 if int8 else 4) * c * 4 for kw in widths)
    x_bytes = k * b * c * (1 if int8 else 4)
    return ops, taps + pushes + weights + c * j3 * 2 + j3 * 4 + x_bytes + k * b * j3 * 4


def phase6_kernels(cfg, model, q, device):
    """K7, K5 and K6 against their plain versions at B = 1,024 streams, through
    every ring's wrap, and their times."""
    from videopose3d_torch import streaming as st
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    saved = dict(sf.LAUNCHES)
    g = torch.Generator(device=device).manual_seed(SEED + 6)
    rand = lambda *shape: torch.rand(shape, generator=g, device=device) * 2 - 1
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    prepared = st.prepare_bf16_fused(bcfg, model)
    b, c, k = STREAM_B, CHANNELS, STREAM_K
    j3 = q.shrink_w.shape[1]
    widths = cfg.filter_widths[1:]
    caps = st._buffer_capacities(cfg)
    first = rand(b, JOINTS, 2)
    results = {}

    def record(key, where, err, ms, plain_ms, bound, library_ms=None):
        bound_ms, bound_by = bound
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        print(f"phase6 {key:18s} {where}: max_abs_err {err:.3e}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms ({bound_by})")
        results[key] = {"name": f"{key} ({where})", "route": "cuda", "source": STREAM_SOURCE,
                        "replaces": STREAM_KERNELS[key], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms}

    # K7: one (B, C) bf16 row into the largest block ring, bitwise.
    ring = rand(caps[-1], b, c).to(torch.bfloat16)
    row = rand(b, c).to(torch.bfloat16)
    slot = caps[-1] // 2
    got = sf.ring_push(ring.clone(), slot, row)
    want = sf.ring_push_plain(ring.clone(), slot, row)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "ring_push: kernel and plain version differ")
    del got, want
    index = torch.tensor([slot], device=device)
    host_ms = cuda_ms(lambda: sf.ring_push(ring, slot, row))
    record("ring_push", f"bf16 ring {tuple(ring.shape)}, bitwise, CUDA-graph timed", 0.0,
           graph_ms(lambda: sf.ring_push(ring, slot, row)),
           graph_ms(lambda: sf.ring_push_plain(ring, slot, row)),
           roofline([], 2 * nbytes(row)),
           graph_ms(lambda: ring.index_copy_(0, index, row[None])))
    print(f"phase6 ring_push one call between CUDA events (host enqueue included): "
          f"{host_ms:.4f} ms")
    del ring

    def pose_err(got, want, tol, what):
        err = float((got - want).abs().max())
        bound = tol * max(1.0, float(want.abs().max()))
        check(bool(torch.isfinite(got).all()) and err <= bound,
              f"{what}: pose error {err} > {bound}")
        return err

    # K5 and K6, int8: every ring bitwise at every step, poses at STREAM_POSE_TOL,
    # over max(cap) + 3 frames (per frame) or max(cap) + 3k frames (k per step).
    for key, multi in (("stream_int8", False), ("stream_int8_multi", True)):
        kk = k if multi else 1
        a = (st.init_stream_state_int8_multi(cfg, q, first, kk) if multi
             else st.init_stream_state_int8(cfg, q, first))
        p = _clone_state(a)
        scaps = [r.shape[0] // (2 if multi else 1) for r in a["bufs"]]
        steps = (max(scaps) + 3 * kk) // kk
        err = 0.0
        for t in range(steps):
            x = rand(b, kk, JOINTS, 2) if multi else rand(b, JOINTS, 2)
            fused = st.stream_step_int8_multi_fused if multi else st.stream_step_int8_fused
            plain = st.stream_step_int8_multi if multi else st.stream_step_int8
            got, a = fused(cfg, q, a, x)
            want, p = plain(cfg, q, p, x)
            check(all(torch.equal(r, s) for r, s in zip(a["bufs"], p["bufs"])),
                  f"{key}: an int8 ring differs from the plain version's at step {t}")
            err = max(err, pose_err(got, want, STREAM_POSE_TOL, f"{key} step {t}"))
        eq = torch.randint(0, 128, (kk, b, c), generator=g, device=device, dtype=torch.int8)
        idx, lags = st._slots(cfg, a["ptr"], scaps, multi=multi)
        if multi:
            run = lambda f, s: f(q, s["bufs"][1:], eq, idx, widths=widths, lags=lags,
                                 caps=scaps[1:], k=kk)
            kern, plain_fn = sf.fused_blocks_step_multi, sf.fused_blocks_step_multi_plain
        else:
            run = lambda f, s: f(q, s["bufs"][1:], eq[0], idx, widths=widths)
            kern, plain_fn = sf.fused_blocks_step, sf.fused_blocks_step_plain
        record(key, f"int8, B={b}, C={c}, k={kk}, {steps} steps, rings bitwise", err,
               cuda_ms(lambda: run(kern, a)), cuda_ms(lambda: run(plain_fn, p)),
               roofline(*stream_cost(True, widths, lags, b, c, kk, j3, multi)))
        del a, p

    # K5 and K6, bf16: each step from the plain version's state, poses and rings at
    # TOL[bfloat16] (one bf16 step: the rings hold bf16 values summed in float32 in
    # another order).
    for key, multi in (("stream_bf16", False), ("stream_bf16_multi", True)):
        kk = k if multi else 1
        p = (st.init_stream_state_multi(bcfg, model, first, kk) if multi
             else st.init_stream_state(bcfg, model, first))
        scaps = [r.shape[0] // (2 if multi else 1) for r in p["bufs"]]
        steps = (max(scaps) + 3 * kk) // kk
        err = 0.0
        for t in range(steps):
            x = rand(b, kk, JOINTS, 2) if multi else rand(b, JOINTS, 2)
            fused = st.stream_step_bf16_multi_fused if multi else st.stream_step_bf16_fused
            plain = st.stream_step_multi if multi else st.stream_step
            got, a = fused(bcfg, prepared, _clone_state(p), x)
            want, p = plain(bcfg, prepared, p, x)
            err = max(err, pose_err(got, want, TOL[torch.bfloat16], f"{key} step {t}"))
            for i, (r, s) in enumerate(zip(a["bufs"], p["bufs"])):
                compare(f"{key} step {t} ring {i}", r, s, torch.bfloat16)
            del a
        a0 = rand(kk, b, c).clamp_min(0)
        idx, lags = st._slots(bcfg, p["ptr"], scaps, multi=multi)
        a = _clone_state(p)
        if multi:
            run = lambda f, s: f(prepared, s["bufs"][1:], a0, idx, widths=widths, lags=lags,
                                 caps=scaps[1:], k=kk)
            kern, plain_fn = (sf.fused_blocks_step_bf16_multi,
                              sf.fused_blocks_step_bf16_multi_plain)
        else:
            run = lambda f, s: f(prepared, s["bufs"][1:], a0[0], idx, widths=widths)
            kern, plain_fn = sf.fused_blocks_step_bf16, sf.fused_blocks_step_bf16_plain
        record(key, f"bf16, B={b}, C={c}, k={kk}, {steps} steps from a shared state", err,
               cuda_ms(lambda: run(kern, a)), cuda_ms(lambda: run(plain_fn, p)),
               roofline(*stream_cost(False, widths, lags, b, c, kk, j3, multi)))
        del a, p

    # K6 against K5 over the same 64 frames: equal int8 history, poses at the bound.
    one = st.init_stream_state_int8(cfg, q, first)
    multi = st.init_stream_state_int8_multi(cfg, q, first, k)
    frames = rand(b, 64, JOINTS, 2)
    per_frame = []
    for t in range(64):
        pose, one = st.stream_step_int8_fused(cfg, q, one, frames[:, t])
        per_frame.append(pose)
    stepped = []
    for t in range(0, 64, k):
        pose, multi = st.stream_step_int8_multi_fused(cfg, q, multi, frames[:, t:t + k])
        stepped.append(pose)
    err = pose_err(torch.cat(stepped, 1), torch.stack(per_frame, 1), STREAM_POSE_TOL,
                   "K6 vs K5")
    for i, (r1, rk, cap) in enumerate(zip(one["bufs"], multi["bufs"], caps)):
        p1, pk, cap_k = one["ptr"][i], multi["ptr"][i], rk.shape[0] // 2
        lag = torch.arange(1, cap + 1, device=device)
        check(torch.equal(r1[(p1 - lag) % cap], rk[(pk - lag) % cap_k]),
              f"K6 vs K5: ring {i} holds another history")
    print(f"phase6 K6 (k={k}) vs K5 over 64 frames of {b} streams: int8 ring histories "
          f"equal, pose error {err:.3e}")
    sf.LAUNCHES.update(saved)  # comparison launches do not count
    return results


def write_custom_archive(root, name):
    """A synthetic custom-dataset archive (the format of data_2d_custom_<k>.npz):
    STREAM_VIDEOS videos of STREAM_FRAMES frames of 17 COCO keypoints in pixels of
    1920 x 1080 frames, each a random walk around its own centre, from SEED."""
    rng = np.random.default_rng(SEED + 7)
    n, t = STREAM_VIDEOS, STREAM_FRAMES
    centre = rng.uniform([400, 200], [1500, 900], (n, 1, 1, 2))
    pose = rng.normal(0, 80, (n, 1, JOINTS, 2))
    walk = np.cumsum(rng.normal(0, 3, (n, t, JOINTS, 2)), axis=1)
    kps = (centre + pose + walk).astype(np.float32)
    videos = [f"video_{i:03d}.mp4" for i in range(n)]
    metadata = {"layout_name": "coco", "num_joints": JOINTS,
                "keypoints_symmetry": [[1, 3, 5, 7, 9, 11, 13, 15],
                                       [2, 4, 6, 8, 10, 12, 14, 16]],
                "video_metadata": {v: {"w": 1920, "h": 1080} for v in videos}}
    np.savez(os.path.join(root, f"data_2d_custom_{name}.npz"),
             positions_2d={v: {"custom": [kps[i]]} for i, v in enumerate(videos)},
             metadata=metadata)
    return videos


_STREAMED = re.compile(r"^INFO: streamed (\d+) frames in (\S+) s \((\S+) poses/s")


def stream_cli(argv):
    """streaming.main in-process; returns (poses per video, poses/s, output)."""
    from videopose3d_torch import streaming as st
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st.main(argv)
    torch.cuda.synchronize()
    out = buf.getvalue()
    rate = next((m for m in map(_STREAMED.match, out.splitlines()) if m), None)
    check(rate is not None, f"no streamed line in the output:\n{out}")
    out_path = argv[argv.index("--output") + 1]
    with np.load(out_path) as data:
        poses = {v: data[v] for v in data.files}
    check(all(np.isfinite(p).all() and p.shape == (STREAM_FRAMES, JOINTS, 3)
              for p in poses.values()), "streamed poses: non-finite or misshapen")
    return poses, float(rate.group(3)), out


# Engine, compute dtype, frames per step, the kernel the run must launch.
STREAM_RUNS = (("bf16", "float32", 1, None), ("bf16", "bfloat16", 1, None),
               ("bf16_fused", "bfloat16", 1, "stream_bf16"), ("int8", "float32", 1, None),
               ("int8_fused", "float32", 1, "stream_int8"),
               ("bf16_fused", "bfloat16", STREAM_K, "stream_bf16_multi"),
               ("int8_fused", "float32", STREAM_K, "stream_int8_multi"))


def _stack(poses, videos):
    return np.stack([poses[v] for v in videos])


def phase6_cli(cfg, model, device, tmp):
    """The streaming CLI with every engine on the synthetic archive; returns the
    launches of each kernel in the run that drives it."""
    from videopose3d_torch import streaming as st
    from videopose3d_torch.evaluate import full_float32
    from videopose3d_torch.models.temporal import forward_dilated, receptive_field
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    data = os.path.join(tmp, "stream_data")
    os.makedirs(data)
    videos = write_custom_archive(data, "synthetic")
    ckpt = os.path.join(tmp, "causal_full_width.bin")
    torch.save({"epoch": 0, "lr": 0.001, "model_traj": None, "optimizer": None,
                "model_pos": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               ckpt)
    base = ["-k", "synthetic", "--data-dir", data, "--checkpoint", ckpt,
            "-arc", ",".join(map(str, ARCH)), "-ch", str(CHANNELS), "--device", str(device)]
    argv = lambda engine, dt, k, out: base + ["--engine", engine, "--compute-dtype", dt,
                                              "--frames-per-step", str(k), "--output",
                                              os.path.join(tmp, out)]
    # A first call on a few videos pays one-time setup (cuBLAS handles, the
    # allocator's pools) outside the measured runs.
    stream_cli(argv("bf16", "float32", 1, "warm.npz") + ["--videos", ",".join(videos[:8])])
    runs, launches = {}, {}
    for engine, dt, k, key in STREAM_RUNS:
        reset_counts()
        poses, rate, _ = stream_cli(argv(engine, dt, k, f"{engine}_{dt}_{k}.npz"))
        counts = dict(sf.LAUNCHES)
        check(all(v == 0 for name, v in counts.items() if name != key)
              and (key is None or counts[key] > 0),
              f"{engine} {dt} k={k}: launched {counts}, expected only {key}")
        if key is not None:
            launches[key] = counts[key]
        runs[(engine, dt, k)] = _stack(poses, videos)
        print(f"phase6 streaming CLI --engine {engine:10s} --compute-dtype {dt:8s} "
              f"--frames-per-step {k}: {STREAM_VIDEOS * STREAM_FRAMES} poses, "
              f"{rate:.0f} poses/s end-to-end; launches {counts}")

    # K7 on the main path: the per-layer bf16 engine with its block rings written by
    # the ring-push kernel, through the lifter and stream_archive.
    _, streams = st._load_wild_streams(data, "synthetic")
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    reset_counts()
    start = time.perf_counter()
    dma = np.stack(st.stream_archive(bcfg, st.StreamingCausalLifter(
        bcfg, model, engine="bf16", ring_impl="dma", device=device), streams))
    seconds = time.perf_counter() - start
    launches["ring_push"] = sf.LAUNCHES["ring_push"]
    check(launches["ring_push"] > 0 and np.array_equal(dma, runs[("bf16", "bfloat16", 1)]),
          "the ring-push (dma) stream differs from the plain-write stream or did not launch")
    print(f"phase6 lifter bf16 (bfloat16) with ring_impl='dma': "
          f"{STREAM_VIDEOS * STREAM_FRAMES / seconds:.0f} poses/s, bitwise equal to the "
          f"CLI's bf16 stream; ring_push launches {launches['ring_push']}")

    # The float32 stream against the offline causal model over each edge-padded video.
    pad = receptive_field(cfg) - 1
    x = torch.from_numpy(np.stack(streams)).to(device)
    x = torch.cat([x[:, :1].expand(-1, pad, -1, -1), x], dim=1)
    with full_float32():
        offline = forward_dilated(model, x).cpu().numpy()
    f32 = runs[("bf16", "float32", 1)]
    checks = [
        # float32 sums of the same products in another order (~1e-6 relative).
        ("float32 stream vs offline causal forward_dilated", f32, offline, 1e-4),
        ("int8_fused vs int8", runs[("int8_fused", "float32", 1)],
         runs[("int8", "float32", 1)], STREAM_POSE_TOL),
        # bf16 rings: a float32 sum in another order may round a ring value one bf16
        # step apart, and that value feeds later frames; each such step moves a pose
        # by ~2^-8 of a weighted activation.
        ("bf16_fused vs bf16 (bfloat16)", runs[("bf16_fused", "bfloat16", 1)],
         runs[("bf16", "bfloat16", 1)], TOL[torch.bfloat16]),
        (f"bf16_fused k={STREAM_K} vs k=1", runs[("bf16_fused", "bfloat16", STREAM_K)],
         runs[("bf16_fused", "bfloat16", 1)], TOL[torch.bfloat16]),
        (f"int8_fused k={STREAM_K} vs k=1", runs[("int8_fused", "float32", STREAM_K)],
         runs[("int8_fused", "float32", 1)], STREAM_POSE_TOL),
    ]
    for what, got, want, tol in checks:
        err = float(np.abs(got - want).max())
        bound = tol * max(1.0, float(np.abs(want).max()))
        print(f"phase6 {what}: max abs difference {err:.3e} (bound {bound:.3e})")
        check(err <= bound, f"{what}: {err} > {bound}")
    int8 = runs[("int8", "float32", 1)]
    per_joint = float(np.linalg.norm(int8 - f32, axis=-1).mean())
    rms = float(np.sqrt((f32 ** 2).mean()))
    print(f"phase6 int8 vs float32 stream: mean per-joint error {per_joint:.5f}, "
          f"{per_joint / rms:.4f} of RMS {rms:.4f} (bound {INT8_STREAM_ACCURACY})")
    check(per_joint < INT8_STREAM_ACCURACY * rms, "int8 stream too far from float32")

    # Where the time goes: one profiled int8_fused run (not counted).
    from torch.profiler import ProfilerActivity, profile
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, rate, _ = stream_cli(argv("int8_fused", "float32", 1, "profiled.npz"))
    wall = time.perf_counter() - start
    window = STREAM_VIDEOS * STREAM_FRAMES / rate
    device_us = {}
    for avg in prof.key_averages():
        us = getattr(avg, "self_device_time_total", getattr(avg, "self_cuda_time_total", 0))
        if us > 0:
            device_us[avg.key] = device_us.get(avg.key, 0) + us
    total = sum(device_us.values())
    kernel = sum(us for name, us in device_us.items() if "stream_int8_kernel" in name)
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    print(f"phase6 profile of one int8_fused CLI run: wall {wall:.3f} s, streaming "
          f"window {window:.3f} s, device time {total / 1e6:.3f} s, busy "
          f"{100 * total / 1e6 / wall:.1f} % of the wall and ~{100 * total / 1e6 / window:.1f} "
          f"% of the window, the K5 kernel {100 * kernel / max(total, 1):.1f} % of device "
          f"time ({kernel / 1e3 / STREAM_FRAMES:.3f} ms per launch at B={STREAM_VIDEOS})")
    for name, us in top:
        print(f"phase6 profile   {us / 1e3:9.3f} ms  {name[:90]}")
    return launches


def protocol_lines(out):
    numbers, action = {}, None
    for line in out.splitlines():
        if m := _ACTION.match(line):
            action = m.group(1)
            numbers[action] = []
        elif (m := _PROTO.match(line)) and action is not None:
            numbers[action].append(float(m.group(2)))
    return numbers


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this test runs on a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    from videopose3d_torch.ops.kernels import build

    print(gpu_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    start = time.perf_counter()
    build.load_library()
    print(f"phase0 kernels from {os.path.relpath(build.SRC_DIR)} "
          f"built for {build.ARCH} in {time.perf_counter() - start:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s): {build.library_path().name}")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("phase0 ptxas:", line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = random_model(device)
    kernel_results = phase1(cfg, model, device)
    train_kernel_results = phase3(device)
    int8_results = phase5(cfg, model, device)
    # Phase 6 serves the causal model, quantized on the card.
    from videopose3d_torch.models.temporal import receptive_field
    from videopose3d_torch.ops.kernels.temporal_block_int8 import quantize_temporal_model
    scfg, smodel = random_model(device, causal=True)
    calib = torch.rand(2, receptive_field(scfg) + 256, JOINTS, 2,
                       generator=torch.Generator().manual_seed(SEED + 5)).to(device) * 2 - 1
    stream_results = phase6_kernels(scfg, smodel, quantize_temporal_model(scfg, smodel, calib),
                                    device)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase2(model, tmp)
        train_launches = phase4(tmp)
        stream_launches = phase6_cli(scfg, smodel, device, tmp)

    keys = {name: (key, replaces) for name, key, replaces in KERNELS}
    dtypes = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    entries = []
    for r in kernel_results:
        key, replaces = keys[r["name"]]
        dname = dtypes[r["dtype"]]
        entries.append({
            "name": f"{r['name']} ({dname}, {r['where']}, C={CHANNELS})",
            "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[("fused", dname)][key],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}})
    for r in train_kernel_results:
        entries.append({**{k: v for k, v in r.items() if k != "key"},
                        "launches": train_launches[r["key"][1]]})
    for r in int8_results:
        mode, key = r["key"]
        entries.append({**{k: v for k, v in r.items() if k != "key"},
                        "launches": launches[("int8", mode)][key]})
    for key, r in stream_results.items():
        entries.append({**r, "launches": stream_launches[key]})
    check(all(e["launches"] > 0 for e in entries), "a kernel of the main path never launched")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
