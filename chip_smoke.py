#!/usr/bin/env python3
"""Smoke test of videopose3d_torch on one NVIDIA GPU: the port's evaluation,
int8 serving, supervised and semi-supervised training (strided and dilated
forms, Human3.6M and HumanEva), streaming serving, rendering and in-the-wild
paths at the full width of the README's model, through its hand-written CUDA
kernels.

    python3 chip_smoke.py

Phase 0 builds the kernels from ``videopose3d_torch/ops/kernels/csrc`` with nvcc
for sm_90a.  Phase 1 holds each evaluation kernel (K3) against its plain PyTorch
version at the shapes the evaluation path gives it (B=2 TTA rows, a 2,000-frame
video plus 242 padding frames, 1024 channels), in float32 and bfloat16, checks two
launches bitwise equal, times both by CUDA-graph replay beside one call, with the
stage's slice plan and a cuBLAS chain of its products as a yardstick, holds every
stage at 30, 1,000, 2,048 and 3,636 channels against its plain version too, and
prints the K3 kernels' ptxas lines and the HMMA counts of both dtypes' GEMM kernels.  Phase 2 writes synthetic Human3.6M archives and a random full-width
checkpoint (-arc 3,3,3,3,3, 1024 channels) and runs
``videopose3d_torch.runner.main --evaluate`` with the fused engine in float32 and
bfloat16 and with the plain float32 engine (each after a warm-up call), checking
the protocol numbers and that every kernel launched, and profiles one more fused
run per dtype (device time, busy share, the K3 kernels' share).  Phase 3 holds the training
kernels against their plain versions at the training path's shapes: the window
gather (K1) at 1,024 windows of 243 rows from a 300,000- and a 3,000,000-row
stream, bitwise, and each forward and backward kernel of the train block (K2) at
the four residual blocks' shapes (n = 27,648 / 9,216 / 3,072 / 1,024 rows of 1,024
channels) in float32 and bfloat16, plus the whole block with its backward in
float32; it times each kernel and plain version (K1 and every K2 kernel also
from CUDA-graph replay, with a bitwise repeat of each K2 one), and beside each K2
GEMM kernel one float32 torch.matmul of its product; it holds relu_mask_bn_sums
at ragged n and widths (4, 1,028, 3,636 channels) too, and two CUDA-graph replays
of it bitwise equal, and counts the K2 GEMM kernels' HMMA instructions (every
product on the tensor cores).  Phase 4
trains the full-width model for one epoch of batch 1,024 with ``runner.main``
from the random checkpoint, with the fused train engine twice and the plain one
once (dropout 0.25, the same seed), and checks the losses, the kernel launches,
determinism, and that the saved checkpoint evaluates; one more epoch per engine
is profiled (device time per kernel and the card's busy share over eight warm
steps).
Phase 5 quantizes the full-width model to w8a8 int8 on the card and holds each
int8 stage kernel chain (K4: expand + block 0 at d=3, mid blocks at d=9 and d=27,
the last block + shrink at d=81; in both tap modes, the accshift mode being K8)
against its plain version at the evaluation path's shapes, checks two launches
bitwise equal and accshift bitwise equal to slice, times both by CUDA-graph replay
beside one call and a torch._int_mm chain of the stage's products as a yardstick,
holds every stage at 30, 1,000, 1,952 and 3,636 channels too, holds the int8
forward against the float32 model, and prints the int8 kernels' ptxas lines and
the GEMM's IMMA count.  Phase 2 then also evaluates with ``--serving-engine int8``
(twice, then once more with accshift on every block).  Phase 6 (streaming) holds,
on the causal full-width model quantized on the card and B = 1,024 streams, the
ring push (K7) bitwise (also rows of 120 and 3,000 bytes, off the 16-byte word, at
any slot), the fused streaming step per frame (K5) and at 8 frames
per step (K6), int8 with every ring bitwise at every step over a run in which
every ring wraps (also at 1,000 channels, rows not 16-byte aligned) and bf16 per
step from one shared state; for both, two launches from one state bitwise equal,
timed by CUDA-graph replay beside one call, with the plan, the kernel's ptxas
lines, its tensor-core SASS count and a cuBLAS chain of the step's products
(torch._int_mm for int8) as a yardstick; and K6 against K5; the lifter's per-frame
int8_fused dispatch as one CUDA graph (the front kernel F, K5 on the ring positions
on the card, their advance) with poses and every ring bitwise equal to the eager
step's through two wraps of the largest ring, F against its plain version and bound,
and the graph dispatch's host enqueue, one replay and closed loop beside the eager
dispatch's; then it writes a
synthetic custom archive of 256 videos of 500 frames and a causal checkpoint and
runs ``videopose3d_torch.streaming.main`` with every engine, checking the streams
against the offline causal model and each other, and profiles one int8_fused and
one bf16_fused run.
Phase 7 (semi-supervised training) holds the train block (K2) at the row counts
that training gives it: the whole block with its backward against the plain
chain and each kernel against its plain version (a bitwise repeat too) at n =
64, 128, 384 and 55,296, and every kernel graph-timed at n = 55,296 / 18,432 /
6,144 / 2,048 (the -arc 3,3,3,3,3 -b 1024 model's blocks on the doubled batch)
and 384 / 128 (-arc 3,3,3 -b 64); then it trains with ``runner.main ... -sun
S5`` from phase 2's archives, (a) the README's recipe at full width (-arc 3,3,3
-b 64 on 10 % of S1) and (b) the main path's model (-arc 3,3,3,3,3 -b 1024), one
warmup epoch and one full epoch each, with the fused train engine twice and the
plain one once: finite epoch lines with a positive unlabeled 2D loss after
warmup, the two fused runs bitwise equal, the first full step's loss against the
plain engine's, K1 launched once per warmup step and twice per full step; for
(a) the saved trajectory model loads, the checkpoint evaluates, and -r
epoch_1.bin prints the uninterrupted run's epoch 2; (b) runs once more under
torch.profiler (device time per full step by part: K1, both models' K2
wrappers, each model's plain parts, the optimizer, the projection and losses;
the busy share).
Phase 8 (data parallelism): 8a runs phase 4's pallas command line under
``python -m torch.distributed.run --standalone --nproc_per_node 1`` (the rank
calls ``runner.main``, as ``python -m videopose3d_torch.run`` does, on NCCL at
world size 1) and checks that its epoch line, step losses and saved weights are
bitwise phase 4's and its K1/K2 launches phase 4's, then profiles one more such
epoch (the gradient all-reduce, the 18 BatchNorm-sum all-reduces and the
dropout-mask draws per step); 8b spawns two ranks that share the card over gloo
and drive the trainers (every model on the pallas engine) at the global batch
of 1,024, 512 rows each: the supervised and semi-supervised step-0 loss and every all-reduced gradient
against one process from the same state, the ranks' parameters and running
statistics bitwise equal after their steps, a DeviceEvalSet sharded over the
ranks against an unsharded one, K1 and K2 launched on each rank, ms per step
(two ranks on one card: not a scale-out number) and the dropout-mask draw at
the global and at a rank's shape.  Each rank runs under a timeout.
Phase 9 (dilated-form training and HumanEva): (a) trains the full-width model in
the dilated form (``--stride 2``: 512 chunks of 2 frames a step from 244-row
windows) with ``runner.main`` twice with K1 and once with ``--gather-impl xla``,
all three bitwise equal (epoch line, step losses, saved weights), with K1
bitwise against plain on the run's first windows, ms/step, training frames/s
and peak memory, one profiled run split into K1, the convolutions, BatchNorm,
the mask draws and the optimizer, and the saved checkpoint evaluated through the
fused blocks (K3) against the run's own evaluation; (b) trains ``-arc 3,3,3``
with ``--disable-optimizations`` and with ``--dense`` (kernels of 7 and 19
taps) and evaluates their checkpoints; (c) runs ``-sun`` with ``--stride 2`` at
phase 7's (a) shape; (d) writes a synthetic 15-joint HumanEva archive and runs
the README's recipe (``-arc 3,3,3 -b 128 --train-engine pallas``), holding K1
(30-column rows) and K2 (n = 384, 128) against plain on the run's own first
inputs, then ``--evaluate --by-subject`` with the fused engine against xla, K3
(a 45-column shrink) held against plain on its first inputs; (e) phase 8b's
ranks also take dilated supervised steps against one process.
Phase 10 (videos in the wild, rendering, instrumented training, host cores):
(a) writes Detectron-format detections of two 3,000-frame videos at 1,920 x
1,080 (COCO keypoints, frames without any detection), turns them into a custom
archive with ``python -m videopose3d_torch.data.prepare.custom_2d`` and runs
``runner.main -d custom --evaluate --render --viz-export`` with the xla, fused
float32 and bfloat16 and int8 (slice and accshift) engines: the exports against
xla's, K3 launched only by the fused runs and K4 only by the int8 ones, frames
per second of the prediction, and once more from a checkpoint with a
trajectory model, which moves every joint alike; (b) renders a Human3.6M video
through the fused engine, the export bitwise ``evaluate(...,
return_predictions=True)``; (c) trains phase 4's model for five short epochs
with ``--profile-dir``, ``--metrics-log`` and a checkpoint per epoch (written on
the asynchronous checkpointer's thread): one Chrome trace naming K1's kernel,
K2's kernels and the seven K2 wrappers' ranges, one JSON record per epoch with
the JAX package's keys, and a resume from epoch 2 whose later epoch lines and
last checkpoint are bitwise the uninterrupted run's; (d) shuffles the chunk
pairs of Human3.6M's training size (600 sequences of 2,600 frames) with the
native C++ core and with numpy, bitwise equal over two epochs, timed, and
times a checkpoint of the full-width model with AMSGrad state on the step path,
synchronous against the asynchronous checkpointer's blocked time, the two
files bitwise equal although the next step's in-place writes begin at once.
Phase 11 (the evaluation protocols) holds the protocol kernel (P) at the
evaluation path's shape (n = 2,242 frames read in place from 2,256 predicted, J =
17, about half the frames aligned by an improper rotation) against its plain
version on the card and on the CPU and against ``ops/losses.py``'s host
protocols on float64 copies, to 1e-9 relative, checks two calls bitwise equal,
and times it by CUDA-graph replay beside one call, one call of its plain version on
the card, and the float32 host NumPy protocols it replaced; phase 2 counts its launches in
every ``--evaluate`` run, one a video.

Each kernel's line in the final summary carries its time, its plain version's,
its launches on the main path (K1, K2 and the float32 K3 entries also in phase 9;
K1 to K4 also in phase 10),
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
import itertools
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
# Phase 11, the protocol kernel (P): one video of the evaluation path, its first n
# frames read in place from the predicted frames, against the plain version and the
# host protocols, every one float64: relative 1e-9 per protocol mean (the sums
# differ only in order, ~1e-15).
PROTOCOLS_SOURCE = "videopose3d_torch/ops/kernels/csrc/protocols.cu"
PROTOCOL_FRAMES = 2000 + 242
PROTOCOL_PREDICTED = PROTOCOL_FRAMES + 14
PROTOCOL_TOL = 1e-9
INT8_SOURCE = "videopose3d_torch/ops/kernels/csrc/temporal_block_int8.cu"
# K4 at other widths (phase 5), over a shorter video, each run as the forward runs it
# (padded to a multiple of 16 channels): 30 (to 32), 1,000 (to 1,008: a ragged last
# 128-column tile), and 1,952 and 3,636 (to 3,648), past the shared-memory ceiling
# of the first kernel, which held each stage's rows per channel.
INT8_WIDTHS = (30, 1000, 1952, 3636)
INT8_WIDTH_FRAMES = 400
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
# K3 at other widths (phase 1): off the 16-byte word (30; 3,636 in bf16), past the
# shared-memory ceilings of a design that holds rows per channel (2,048, 3,636) and
# a width of rows not 64-byte aligned (1,000), over a shorter video.
K3_WIDTHS = (30, 1000, 2048, 3636)
K3_WIDTH_FRAMES = 400

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
# operations run in, of operations over that type's peak (float32 on the TF32 tensor
# cores, 495 TFLOP/s: the float32 GEMMs run there in 3xTF32 and pass the 67 of the
# FP32 units; float64 on the tensor cores' DMMA: 67 TFLOP/s, twice the 34 of the
# FP64 units).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 495e12, "bfloat16": 989e12, "int8": 1979e12,
                  "float64": 67e12}

# Phase 6, streaming: B = 1,024 streams for the kernel checks, k = 8 frames per
# step for K6; the CLI serves 256 videos of 500 frames (past the 243-frame
# receptive field, so every ring wraps).
STREAM_B = 1024
STREAM_K = 8
STREAM_VIDEOS, STREAM_FRAMES = 256, 500
STREAM_SOURCE = "videopose3d_torch/ops/kernels/csrc/streaming_fused.cu"
STREAM_SOURCES = {"stream_int8": "videopose3d_torch/ops/kernels/csrc/stream_int8.cu",
                  "stream_bf16": "videopose3d_torch/ops/kernels/csrc/stream_bf16.cu",
                  "stream_front": "videopose3d_torch/ops/kernels/csrc/temporal_block_int8.cu"}
# The int8 step at a width whose rows are not 16-byte aligned (element-by-element
# loads, K and N tails), rings bitwise at every step, on the CLI's 256 streams.
STREAM_ODD_CHANNELS, STREAM_ODD_B = 1000, 256
STREAM_TPU = "videopose3d_tpu/ops/pallas/streaming_fused.py"
# K7 rows that are not whole 16-byte words: one stream of 30 float32 channels (120
# bytes) and three of 1,000 int8 channels (3,000 bytes).
K7_ODD_ROWS = ((torch.float32, 1, 30), (torch.int8, 3, 1000))
STREAM_KERNELS = {  # launch counter -> the TPU kernel it replaces
    "stream_int8": f"{STREAM_TPU}:201", "stream_bf16": f"{STREAM_TPU}:911",
    "stream_int8_multi": f"{STREAM_TPU}:520", "stream_bf16_multi": f"{STREAM_TPU}:760",
    "ring_push": "videopose3d_tpu/streaming.py:76",
    "stream_front": "none: videopose3d_tpu/streaming.py:535-540 leaves the raw ring and "
                    "the expand to XLA",
    "ring_advance": "none: videopose3d_tpu/streaming.py:133 advances the positions in "
                    "the step's XLA program"}
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


def host_enqueue_ms(fn, calls=50):
    """The host's time to enqueue one call of ``fn`` in ms (no synchronisation
    between calls): the wrapper's checks, allocations and launches."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e3


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


def random_model(device, causal=False, channels=CHANNELS):
    """The full-width model (or ``channels`` wide) with random weights and BN
    statistics, from SEED."""
    from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig
    torch.manual_seed(SEED)
    cfg = TemporalModelConfig(num_joints_in=JOINTS, in_features=2,
                              num_joints_out=JOINTS, filter_widths=ARCH,
                              channels=channels, causal=causal)
    model = TemporalModel(cfg)
    rng = np.random.default_rng(SEED)
    for bn in [model.expand_bn, *model.layers_bn]:
        c = bn.num_features
        bn.weight.data = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
        bn.bias.data = torch.from_numpy(rng.uniform(-0.2, 0.2, c).astype(np.float32))
        bn.running_mean = torch.from_numpy(rng.uniform(-0.1, 0.1, c).astype(np.float32))
        bn.running_var = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))
    return cfg, model.to(device).eval()


def k3_chain_ms(dt, gemms, device):
    """Graph time of a stage's products as cuBLAS matmuls (float32 with TF32 off, or
    bf16 on the tensor cores) on operands of their shapes ((m, k, n) each): a
    yardstick of the stage's GEMM work (no epilogues, no taps read in place); the
    port never calls it."""
    g = torch.Generator(device=device).manual_seed(SEED + 10)
    ops = [(torch.randn(m, k, generator=g, device=device).to(dt),
            torch.randn(k, n, generator=g, device=device).to(dt)) for m, k, n in gemms]
    return graph_ms(lambda: [torch.matmul(a, b) for a, b in ops], reps=20)


def k3_padded(tb, key, dt, v, w0, s0, b0, blk, ws, bs):
    """A stage's kernel input and operands at whole 16-byte words of ``dt``, padded
    as forward_dilated_fused pads them (channels, keypoint columns, the shrink's
    outputs), and the width its output is cut back to."""
    c = blk[0].shape[-1]
    cp = tb.whole_words(c, dt)
    blk = tb.padded_block(cp, *blk)
    if key == "expand":
        ci = tb.whole_words(v.shape[-1], dt)
        return tb.pad(v.to(dt), ci), (tb.pad(w0, ci, cp), tb.pad(s0, cp), tb.pad(b0, cp),
                                      *blk), c
    if key == "shrink":
        jp = tb.whole_words(bs.shape[0], dt)
        return tb.pad(v, cp), (*blk, tb.pad(ws, cp, jp), tb.pad(bs, jp)), bs.shape[0]
    return tb.pad(v, cp), blk, c


def k3_width_check(device):
    """Every stage at K3_WIDTHS channels (K3_WIDTH_FRAMES frames) in both dtypes,
    on seeded random weights padded as the fused forward pads them, against its
    plain version on the unpadded ones; two launches bitwise equal."""
    from videopose3d_torch.ops.kernels import temporal_block as tb
    for c in K3_WIDTHS:
        for dt in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=device).manual_seed(SEED + c)
            u = lambda *shape, s=1.0: (torch.rand(shape, generator=g, device=device) * 2
                                       - 1) * s
            bn = lambda: (u(c, s=0.5) + 1.0, u(c, s=0.2))
            bound = 1 / math.sqrt(3 * c)
            w0 = u(3, 2 * JOINTS, c, s=1 / math.sqrt(6 * JOINTS)).to(dt)
            blk = (u(3, c, c, s=bound).to(dt), *bn(), u(c, c, s=bound).to(dt), *bn())
            ws, bs = u(c, 3 * JOINTS, s=1 / math.sqrt(c)).to(dt), u(3 * JOINTS, s=0.1)
            s0, b0 = bn()
            stages = [
                ("expand", tb.fused_expand_block, lambda v: tb.fused_expand_block_plain(
                    v, w0, s0, b0, *blk, dilation=3), dict(dilation=3)),
                ("dilated", tb.fused_dilated_block, lambda v: tb.fused_dilated_block_plain(
                    v, *blk, dilation=9), dict(dilation=9)),
                ("shrink", tb.fused_shrink_block, lambda v: tb.fused_shrink_block_plain(
                    v, *blk, ws, bs, dilation=27), dict(dilation=27))]
            v, worst = u(BATCH, K3_WIDTH_FRAMES, 2 * JOINTS), 0.0
            for key, kernel, plain, geo in stages:
                xk, ops, width = k3_padded(tb, key, dt, v, w0, s0, b0, blk, ws, bs)
                got, again, want = kernel(xk, *ops, **geo), kernel(xk, *ops, **geo), plain(v)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"{key} C={c} {dt}: two launches differ")
                check(not got[..., width:].any(), f"{key} C={c} {dt}: a padded channel "
                                                  "is not 0")
                got = got[..., :width]
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"{key} C={c} {dt}: {tuple(got.shape)} vs plain {tuple(want.shape)}")
                err = float((got.float() - want.float()).abs().max())
                rel = err / max(1.0, float(want.float().abs().max()))
                check(rel <= TOL[dt], f"{key} C={c} {dt}: error {rel:.3e} of the scale "
                                      f"> {TOL[dt]}")
                worst = max(worst, rel)
                v = want
            print(f"phase1 widths C={c:5d} {str(dt):15s} expand, mid, shrink at "
                  f"{K3_WIDTH_FRAMES} frames: worst error {worst:.3e} of max(1, max|plain|) "
                  f"(tol {TOL[dt]}); two launches bitwise equal; padded channels 0")


def phase1(cfg, model, device):
    """Each K3 stage against its plain version at the evaluation path's shapes,
    timed by CUDA-graph replay beside one call, with its plan and a cuBLAS chain of
    its products; every stage at other widths; the kernels' ptxas lines."""
    from videopose3d_torch.models.temporal import _channels_last, _fold, _fused_operands
    from videopose3d_torch.ops.kernels import build
    from videopose3d_torch.ops.kernels import temporal_block as tb

    rng = np.random.default_rng(SEED + 1)
    x_raw = torch.from_numpy(
        rng.uniform(-1, 1, (BATCH, FRAMES, JOINTS * 2)).astype(np.float32)).to(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    results = []
    saved = dict(tb.LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        def block(i):
            s1, b1 = _fold(model.layers_bn[2 * i])
            s2, b2 = _fold(model.layers_bn[2 * i + 1])
            return (_channels_last(model.layers_conv[2 * i], dt), s1, b1,
                    _channels_last(model.layers_conv[2 * i + 1], dt)[0], s2, b2)

        # The kernels run on the operands the fused forward runs (padded to whole
        # 16-byte words: 34 keypoint columns to 36 / 40, 51 outputs to 52 / 56), the
        # plain versions on the model's own.
        c_in, expand, padded, shrink = _fused_operands(model, dt)
        blk = [block(i) for i in range(len(ARCH) - 1)]
        geo = [dict(dilation=cfg.dilations[i + 1], causal_shift=0) for i in range(len(blk))]
        s0, b0 = _fold(model.expand_bn)
        w0 = _channels_last(model.expand_conv, dt)
        ws = _channels_last(model.shrink, dt)[0]
        bs = model.shrink.bias.detach().float()
        j3 = bs.shape[0]
        stages = [
            ("fused_expand_block", "expand", "d=3", (*expand, *padded[0]),
             lambda x: tb.fused_expand_block(x, *expand, *padded[0], **geo[0]),
             lambda x: tb.fused_expand_block_plain(x, w0, s0, b0, *blk[0], **geo[0])),
            ("fused_dilated_block", "dilated", "d=9", padded[1],
             lambda x: tb.fused_dilated_block(x, *padded[1], **geo[1]),
             lambda x: tb.fused_dilated_block_plain(x, *blk[1], **geo[1])),
            ("fused_dilated_block", "dilated", "d=27", padded[2],
             lambda x: tb.fused_dilated_block(x, *padded[2], **geo[2]),
             lambda x: tb.fused_dilated_block_plain(x, *blk[2], **geo[2])),
            ("fused_shrink_block", "shrink", "d=81", (*padded[3], *shrink),
             lambda x: tb.fused_shrink_block(x, *padded[3], *shrink, **geo[3]),
             lambda x: tb.fused_shrink_block_plain(x, *blk[3], ws, bs, **geo[3])),
        ]
        x = x_raw
        for name, key, where, weights, kernel, plain in stages:
            xk = tb.pad(x.to(dt), c_in) if key == "expand" else x
            got = kernel(xk)
            again = kernel(xk)
            want = plain(x)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{name} {where} {dt}: two launches differ")
            got = got[..., :j3] if key == "shrink" else got
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name} {where} {dt}: {tuple(got.shape)} {got.dtype} vs plain "
                  f"{tuple(want.shape)} {want.dtype}")
            check(bool(torch.isfinite(got.float()).all()), f"{name} {where} {dt}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            scale = max(1.0, float(want.float().abs().max()))
            tol = TOL[dt] * scale
            check(err <= tol, f"{name} {where} {dt}: max abs error {err} > {tol}")
            ms = graph_ms(lambda: kernel(xk), reps=20)
            plain_ms = graph_ms(lambda: plain(x), reps=5)
            call_ms, plain_call_ms = cuda_ms(lambda: kernel(xk)), cuda_ms(lambda: plain(x))
            host_ms = host_enqueue_ms(lambda: kernel(xk))
            t_out = got.shape[1]
            gemms = tb.k3_gemms(key, BATCH, x.shape[1], t_out, CHANNELS, k0=ARCH[0],
                                x_cols=xk.shape[2], j3=shrink[1].shape[0])
            plan = [len(tb.k3_plan(*gemm, sms, dt)) for gemm in gemms]
            library_ms = k3_chain_ms(dt, tb.k3_gemms(
                key, BATCH, x.shape[1], t_out, CHANNELS, k0=ARCH[0], x_cols=x.shape[2],
                j3=j3), device)
            # Per output row: 3 dilated taps and the 1x1 product, C x C each; the
            # expand's 3 taps of 34 -> C over its rows; the shrink's C -> 51.
            ops = 2 * BATCH * t_out * 4 * CHANNELS ** 2
            if name == "fused_expand_block":
                ops += 2 * BATCH * (x.shape[1] - 2) * 3 * x.shape[2] * CHANNELS
            if name == "fused_shrink_block":
                ops += 2 * BATCH * t_out * CHANNELS * got.shape[2]
            bound_ms, bound_by = roofline([(str(dt)[6:], ops)], nbytes(x, got, *weights))
            print(f"phase1 {name:20s} {where:5s} {str(dt):15s} in {tuple(x.shape)} "
                  f"out {tuple(got.shape)}: max_abs_err {err:.3e} (tol {tol:.3e}, "
                  f"max|plain| {scale:.3f}); two launches bitwise equal; graph: kernel "
                  f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                  f"cuBLAS chain of its products {library_ms:.4f} ms (yardstick, not a "
                  f"port path), bound {bound_ms:.4f} ms ({bound_by}); one call: kernel "
                  f"{call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; host enqueue "
                  f"{host_ms:.4f} ms per call; GEMMs (m, k, n) "
                  f"{gemms}, slices {plan}")
            # No single PyTorch call computes a stage: the chain is printed above.
            results.append({"name": name, "where": where, "dtype": dt,
                            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": None})
            x = want  # the next stage sees the same input in both versions
    k3_width_check(device)
    for kernel in ("k3_sgemm_kernel", "k3_mma_kernel", "k3_reduce_kernel"):
        for line in ptxas_lines(build.build_log, kernel):
            print(f"phase1 {kernel} ptxas: {line}")
    for kernel in ("k3_mma_kernel", "k3_sgemm_kernel"):
        hmma = sass_count(build.library_path(), kernel, "HMMA")
        print(f"phase1 {kernel} SASS (cuobjdump -sass): "
              f"{'no cuobjdump' if hmma is None else f'{hmma} HMMA instructions'}")
        check(hmma != 0, f"{kernel} has no tensor-core (HMMA) instruction")
    tb.LAUNCHES.update(saved)  # comparison launches do not count
    return results


VIDEO_FRAMES = 1500  # every video of write_dataset's archives


def write_dataset(root):
    """Synthetic H36M-format archives: training subjects S1 and S5, test subjects
    S9 and S11, 2 actions, 4 cameras, 1,500 frames each (random world-space mocap,
    uniform pixel keypoints)."""
    rng = np.random.default_rng(SEED + 2)
    subjects, actions, n = ("S9", "S11", "S1", "S5"), ("Walking 1", "Eating 2"), VIDEO_FRAMES
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
    from videopose3d_torch.ops.kernels import protocols as pk
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    from videopose3d_torch.ops.kernels import temporal_block as tb
    from videopose3d_torch.ops.kernels import temporal_block_int8 as tq
    for counts in (tb.LAUNCHES, tq.LAUNCHES, sf.LAUNCHES, pk.LAUNCHES):
        for k in counts:
            counts[k] = 0


def phase2(model, tmp):
    """Writes the synthetic archives and the random full-width checkpoint the
    CLI phases share, then runs --evaluate with each engine; the launches by
    kernel, and the protocol kernel's by run under "protocols"."""
    from videopose3d_torch.ops.kernels import protocols as pk
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
    runs, launches = {}, {"protocols": {}}

    def protocol_launches(run, frames):
        got = pk.LAUNCHES["protocols"]
        check(got == frames // VIDEO_FRAMES, f"{run}: {got} protocol kernel launches for "
              f"{frames // VIDEO_FRAMES} videos")
        launches["protocols"][run] = got

    for engine, dtype in (("fused", "float32"), ("fused", "bfloat16"),
                          ("xla", "float32")):
        argv = base + ["--serving-engine", engine, "--compute-dtype", dtype]
        # A first call pays one-time setup (cuDNN's, for xla); the second is
        # the measured and counted run.
        warm, _, _, _ = run_cli(argv)
        reset_counts()
        numbers, fps, frames, _ = run_cli(argv)
        counts = dict(tb.LAUNCHES)
        protocol_launches(f"{engine} {dtype}", frames)
        check(not any(tq.LAUNCHES.values()), f"{engine} run launched int8 kernels")
        if engine == "fused":  # no atomics: the kernels are deterministic
            check(numbers == warm, f"fused {dtype}: two runs differ: {warm} vs {numbers}")
        runs[(engine, dtype)] = numbers
        launches[(engine, dtype)] = counts
        print(f"phase2 {engine:5s} {dtype:8s}: {frames} frames, {fps:.1f} frames/s, "
              f"kernel launches {counts}, protocol kernel {pk.LAUNCHES['protocols']}")
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
        protocol_launches(f"int8 {mode}", frames)
        print(f"phase2 int8  {mode:8s}: {frames} frames, {fps:.1f} frames/s, "
              f"kernel launches {counts}, protocol kernel {pk.LAUNCHES['protocols']}")
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
    # Where the evaluation's time goes: one profiled fused run per dtype (not
    # counted): device time, the card's busy share of the evaluation window (the
    # runner's "evaluated N frames in S s"), K3's share.  The profiler is started
    # once before, so that its start-up falls outside the windows.
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    for dtype in ("float32", "bfloat16"):
        argv = base + ["--serving-engine", "fused", "--compute-dtype", dtype]
        start = time.perf_counter()
        with profile(activities=activities) as prof:
            _, rate, frames, _ = run_cli(argv)
        wall, window = time.perf_counter() - start, frames / rate
        device_us = device_times(prof)
        check(device_us, f"the fused {dtype} evaluation profile holds no device time")
        total = sum(device_us.values())
        k3 = sum(us for name, us in device_us.items() if "k3_" in name)
        print(f"phase2 profile of one fused {dtype} --evaluate: wall {wall:.3f} s, "
              f"evaluation window {window:.3f} s, device time {total / 1e3:.3f} ms, busy "
              f"{100 * total / 1e6 / window:.1f} % of the window, the K3 kernels "
              f"{k3 / 1e3:.3f} ms ({100 * k3 / total:.1f} % of device time)")
        for name, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:6]:
            print(f"phase2 profile   {us / 1e3:9.3f} ms  {name[:90]}")
    return launches


# Ranges that the profiler shows on the device timeline beside the kernels: the
# wrappers' and parts' own (record_function) and torch's "Optimizer.step#...".
RANGE_PREFIXES = ("K1 ", "K2 ", "semi ", "DP ", "dilated ", "Optimizer.")


def is_range(event):
    """Whether a device-side profiler event (or average) is a range, whose time
    repeats its kernels', rather than a kernel or a copy."""
    return bool(getattr(event, "is_user_annotation", False)) or event.key.startswith(
        RANGE_PREFIXES)


def device_times(prof):
    """Device time in us per kernel (or copy) name of a torch.profiler run: only the
    device-side events, since an aten op's row repeats its kernels' time."""
    from torch.autograd import DeviceType
    device_us = {}
    for avg in prof.key_averages():
        if (avg.device_type == DeviceType.CUDA and avg.self_device_time_total > 0
                and not is_range(avg)):
            device_us[avg.key] = device_us.get(avg.key, 0) + avg.self_device_time_total
    return device_us


def int8_stages(cfg, q, x_raw, geo):
    """(name, wrapper key, TPU kernel, block, kernel(x, mode), plain(x, mode)) of each
    int8 stage of ``q`` on (B, T, J, 2) keypoints, and the expand's pre-tapped
    input."""
    from videopose3d_torch.ops.kernels import temporal_block_int8 as tq
    k0, c_in, c = q.expand_w.shape
    t_e = x_raw.shape[1] - (k0 - 1)
    flat = x_raw.reshape(x_raw.shape[0], x_raw.shape[1], -1)
    x_taps = torch.cat([flat[:, j: j + t_e] for j in range(k0)], -1).to(torch.bfloat16)
    w0 = q.expand_w.reshape(k0 * c_in, c)
    last, j3 = len(q.blocks) - 1, q.shrink_w.shape[1]
    return [
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
         lambda x, m: tq.int8_shrink_block(x, q.blocks[last], *tq.shrink_operands(q),
                                           tap_mode=m, **geo[last])[..., :j3],
         lambda x, m: tq.int8_shrink_block_plain(x, q.blocks[last], q.shrink_w,
                                                 q.shrink_b, tap_mode=m, **geo[last])),
    ], x_taps, w0


def int8_agrees(key, got, want):
    """(error, detail) of an int8 stage's output against its plain version, or a
    SmokeFailure: mid blocks bitwise, the expand within one step on at most
    INT8_EXPAND_FRAC of its elements, the shrink within TOL[float32]."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{key}: {tuple(got.shape)} {got.dtype} vs plain {tuple(want.shape)} {want.dtype}")
    if got.dtype == torch.int8:
        diff = (got.int() - want.int()).abs()
        err, frac = float(diff.max()), float((diff > 0).float().mean())
        bound = ("bitwise" if key == "int8_dilated"
                 else f"<= 1 step on <= {INT8_EXPAND_FRAC:.0e}")
        check(err == 0 if key == "int8_dilated" else (err <= 1 and frac <= INT8_EXPAND_FRAC),
              f"{key}: max diff {err} on {frac:.3e} of elements")
        return err, f"max |diff| {err:.0f} step on {frac:.3e} of elements ({bound})"
    check(bool(torch.isfinite(got).all()), f"{key}: non-finite output")
    err = float((got - want).abs().max())
    tol = TOL[torch.float32] * max(1.0, float(want.abs().max()))
    check(err <= tol, f"{key}: max abs error {err} > {tol}")
    return err, f"max_abs_err {err:.3e} (tol {tol:.3e})"


def int8_chain_yardstick_ms(gemms, device):
    """Graph time of a stage's products as one PyTorch call each on operands of their
    shapes ((m, k, n, dtype) each): cuBLASLt int8 (``torch._int_mm``, int32 sums) for
    the int8 products, a bf16 matmul for the others.  A yardstick of the stage's
    GEMM work (no epilogues, requantization or taps read in place); the port never
    calls it.  None where this torch build's ``_int_mm`` refuses the shapes."""
    g = torch.Generator(device=device).manual_seed(SEED + 11)
    ops = []
    for m, k, n, dt in gemms:
        if dt == torch.int8:
            ops.append((torch._int_mm, torch.randint(-127, 128, (m, k), generator=g,
                                                      device=device, dtype=torch.int8),
                        torch.randint(-127, 128, (k, n), generator=g, device=device,
                                      dtype=torch.int8)))
        else:
            ops.append((torch.matmul, torch.randn(m, k, generator=g, device=device).to(dt),
                        torch.randn(k, n, generator=g, device=device).to(dt)))
    chain = lambda: [fn(a, b) for fn, a, b in ops]
    try:
        chain()
    except RuntimeError as err:
        print(f"phase5 torch._int_mm chain not measured: {err}")
        return None
    return graph_ms(chain, reps=20)


def int8_width_check(device):
    """Every int8 stage at INT8_WIDTHS channels (INT8_WIDTH_FRAMES frames), on a
    random model quantized on the card and padded as the forward pads it, against
    its plain version on that model, in both tap modes; accshift bitwise equal to
    slice and two launches bitwise equal."""
    from videopose3d_torch.ops.kernels import temporal_block_int8 as tq
    for c in INT8_WIDTHS:
        cfg, model = random_model(device, channels=c)
        rng = np.random.default_rng(SEED + c)
        x_raw = torch.from_numpy(rng.uniform(-1, 1, (BATCH, INT8_WIDTH_FRAMES, JOINTS, 2))
                                 .astype(np.float32)).to(device)
        q = tq.channel_padded(tq.quantize_temporal_model(cfg, model, x_raw))
        geo = [dict(dilation=d, causal_shift=0) for d in cfg.dilations[1:]]
        stages, x, _ = int8_stages(cfg, q, x_raw, geo)
        details = []
        for name, key, _, i, kernel, plain in stages:
            want = plain(x, "slice")
            got = {m: kernel(x, m) for m in ("slice", "accshift")}
            again = kernel(x, "slice")
            torch.cuda.synchronize()
            where = f"{name} C={c} d={geo[i]['dilation']}"
            check(torch.equal(got["accshift"], got["slice"]),
                  f"{where}: accshift and slice differ")
            check(torch.equal(again, got["slice"]), f"{where}: two launches differ")
            _, detail = int8_agrees(key, got["slice"], want)
            details.append(f"{key[5:]} d={geo[i]['dilation']} {detail}")
            x = want
        print(f"phase5 widths C={c:5d} (run at {q.expand_scale.shape[0]}) at "
              f"{INT8_WIDTH_FRAMES} frames: {'; '.join(details)}; accshift = slice and "
              "two launches bitwise equal")
        del model, q


def phase5(cfg, model, device):
    """The int8 stage kernels against their plain versions at the evaluation
    path's shapes, in both tap modes, timed by CUDA-graph replay beside one call
    with a torch._int_mm chain of their products; every stage at other widths;
    the int8 forward against float32; the kernels' ptxas lines and IMMA count."""
    from videopose3d_torch.evaluate import full_float32
    from videopose3d_torch.models.temporal import forward_dilated, forward_dilated_int8
    from videopose3d_torch.ops.kernels import build
    from videopose3d_torch.ops.kernels import temporal_block as tb
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
    c = q.expand_w.shape[2]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    geo = [dict(dilation=d, causal_shift=0) for d in cfg.dilations[1:]]
    stages, x, w0 = int8_stages(cfg, q, x_raw, geo)
    results = []
    for name, key, replaces, i, kernel, plain in stages:
        where = f"d={geo[i]['dilation']}"
        want = plain(x, "slice")
        got_slice = None
        for mode in ("slice", "accshift"):
            got = kernel(x, mode)
            again = kernel(x, mode)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{name} {where} {mode}: two launches differ")
            err, detail = int8_agrees(key, got, want)
            if mode == "slice":
                got_slice = got
            else:
                check(torch.equal(got, got_slice),
                      f"{name} {where}: accshift and slice kernels differ")
            ms = graph_ms(lambda: kernel(x, mode), reps=20)
            plain_ms = graph_ms(lambda: plain(x, mode), reps=5)
            call_ms = cuda_ms(lambda: kernel(x, mode))
            host_ms = host_enqueue_ms(lambda: kernel(x, mode))
            blk = q.blocks[i]
            t_out = got.shape[1]
            j3 = got.shape[2] if key == "int8_shrink" else 0
            gemms = tq.int8_gemms(key, BATCH, t_out, c, dilation=geo[i]["dilation"],
                                  accshift=mode == "accshift",
                                  j3=tb.whole_words(j3, torch.bfloat16))
            # The accshift taps' GEMM is split at its tap boundaries, the others planned.
            shifted = len(gemms) - (3 if key == "int8_shrink" else 2)
            plan = [k // c for _, k, _, _ in gemms[:shifted]] + [
                len(tq.stage_plan(m, k, n, sms, dt)) for m, k, n, dt in gemms[shifted:]]
            # The yardstick: the slice mode's products, the expand's dot in bf16.
            chain = tq.int8_gemms(key, BATCH, t_out, c, j3=j3)
            if key == "int8_expand":
                chain.insert(0, (BATCH * x.shape[1], x.shape[2], c, torch.bfloat16))
            library_ms = int8_chain_yardstick_ms(chain, device)
            k8 = mode == "accshift" and key == "int8_dilated"
            # int8 products: 3 taps and the 1x1, C x C per output row; the expand's
            # bf16 dot over its rows and the shrink's bf16 C -> 51.
            ops = [("int8", 2 * BATCH * t_out * 4 * c * c)]
            weights = [blk.pa, blk.pb, blk.A1, blk.B1, blk.A2, blk.B2, blk.R]
            if key == "int8_expand":
                ops.append(("bfloat16", 2 * BATCH * x.shape[1] * x.shape[2] * c))
                weights += [w0, q.expand_scale, q.expand_shift]
            if key == "int8_shrink":
                ops.append(("bfloat16", 2 * BATCH * t_out * c * j3))
                weights += [q.shrink_w, q.shrink_b]
            bound_ms, bound_by = roofline(ops, nbytes(x, got, *weights))
            lib = "not measured" if library_ms is None else f"{library_ms:.4f} ms"
            print(f"phase5 {name:18s} {where:5s} {mode:8s} in {tuple(x.shape)} out "
                  f"{tuple(got.shape)} {str(got.dtype)[6:]}: {detail}; two launches "
                  f"bitwise equal; graph: kernel {ms:.4f} ms "
                  f"({ops[0][1] / ms / 1e9:.1f} int8 TOP/s), plain {plain_ms:.4f} ms, "
                  f"torch._int_mm chain of its products {lib} (yardstick, not a port "
                  f"path), bound {bound_ms:.4f} ms ({bound_by}); one call: kernel "
                  f"{call_ms:.4f} ms; host enqueue {host_ms:.4f} ms per call; GEMMs "
                  f"(m, k, n) {[g[:3] for g in gemms]}, slices {plan}")
            results.append({"name": f"{name} ({mode}, {where}, C={CHANNELS})",
                            "key": (mode, key + ("_accshift" if mode == "accshift" else "")),
                            "route": "cuda", "source": INT8_SOURCE,
                            "replaces": K8_TPU if k8 else replaces,
                            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": library_ms})
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
    del q
    int8_width_check(device)
    for kernel in ("i8_mma_kernel", "i8_reduce_kernel", "requant_kernel", "expand_kernel"):
        for line in ptxas_lines(build.build_log, kernel):
            print(f"phase5 {kernel} ptxas: {line}")
    imma = sass_count(build.library_path(), "i8_mma_kernel", "IMMA")
    print(f"phase5 i8_mma_kernel SASS (cuobjdump -sass): "
          f"{'no cuobjdump' if imma is None else f'{imma} IMMA instructions'}")
    check(imma != 0, "i8_mma_kernel has no int8 tensor-core (IMMA) instruction")
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
GRAPH_TIMED = ("conv_stats", "norm_drop_matmul_stats", "norm_drop_res",
               "relu_mask_bn_sums", "dz_matmul_dd", "dw_gemm", "du_dtaps_res")
# relu_mask_bn_sums beyond the step's shapes (dropout on, both dtypes): a ragged n
# (1,000 rows: no whole slice of slots; 27,649: a ragged last slice) at C = 1,024,
# and ragged column strips, C = 4, 1,028 and 3,636, at n = 3,072.
RELU_SUMS_CASES = ((1000, 1024), (27_649, 1024), (3072, 4), (3072, 1028), (3072, 3636))


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
                    rate = (f"{flops[key] * n * CHANNELS ** 2 / (ms * 1e-3) / 1e12:.1f} "
                            "TFLOP/s" if flops[key] else
                            f"{bound_ms / ms * 100:.1f} % of the {bound_by} bound")
                    print(f"phase3 {key:22s} {dname:8s} n={n:6d}: bitwise-equal repeat; "
                          f"graph-replayed kernel {ms:.4f} ms ({rate}), plain "
                          f"{plain_ms:.4f} ms{lib}")
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
    relu_sums_checks(device)
    # Every GEMM of K2 runs on the tensor cores: float32 in 3xTF32, bf16 in one pass.
    from videopose3d_torch.ops.kernels import build
    for kernel in ("tap_gemm_kernel", "dw_gemm_kernel"):
        hmma = sass_count(build.library_path(), kernel, "HMMA")
        print(f"phase3 {kernel} SASS (cuobjdump -sass): "
              f"{'no cuobjdump' if hmma is None else f'{hmma} HMMA instructions'}")
        check(hmma != 0, f"{kernel} has no tensor-core (HMMA) instruction")
    gr.LAUNCHES.update(saved[0])  # comparison launches do not count
    trb.LAUNCHES.update(saved[1])
    return results


def relu_sums_args(n, c, dt, device):
    """Seeded (g, z, mask, stat, gate) of relu_mask_bn_sums at (n, c): a dropout
    mask at rate 0.25 and BatchNorm constants that open about half the gate."""
    gen = torch.Generator(device).manual_seed(SEED + n + c)
    rand = lambda *shape: torch.rand(*shape, device=device, generator=gen)
    randn = lambda *shape: torch.randn(*shape, device=device, generator=gen)
    mask = ((rand(n, c) < 0.75) / 0.75).to(dt)
    stat = torch.stack([randn(c) * 0.1, rand(c) + 0.5])
    gate = torch.stack([randn(c) * 0.1, rand(c) + 0.5, randn(c) * 0.2]).to(dt)
    return (randn(n, c) * 1e-3).to(dt), randn(n, c).to(dt), mask, stat, gate


def relu_sums_checks(device):
    """relu_mask_bn_sums against its plain version off the step's shapes
    (RELU_SUMS_CASES), and two CUDA-graph replays of one captured launch bitwise
    equal to each other and to an eager launch, at the first block's shape."""
    from videopose3d_torch.ops.kernels import train_block as trb
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).replace("torch.", "")
        for n, c in RELU_SUMS_CASES:
            args = relu_sums_args(n, c, dt, device)
            got, want = trb.relu_mask_bn_sums(*args), trb.relu_mask_bn_sums_plain(*args)
            again = trb.relu_mask_bn_sums(*args)
            torch.cuda.synchronize()
            err = max(compare(f"relu_mask_bn_sums {dname} n={n} C={c} output {i}", a, w,
                              dt) for i, (a, w) in enumerate(zip(got, want)))
            check(torch.equal(got[0], want[0]),
                  f"relu_mask_bn_sums {dname} n={n} C={c}: gz differs from plain")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"relu_mask_bn_sums {dname} n={n} C={c}: two launches differ")
            print(f"phase3 relu_mask_bn_sums {dname:8s} n={n:6d} C={c:4d} (plan "
                  f"{len(trb.relu_sums_plan(n, c, args[0].element_size()))} slices): gz "
                  f"bitwise, max_abs_err {err:.3e}, two launches bitwise")
    args = relu_sums_args(1024 * TRAIN_BLOCK_FRAMES[0] // 3, CHANNELS, torch.float32, device)
    eager = trb.relu_mask_bn_sums(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        trb.relu_mask_bn_sums(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = trb.relu_mask_bn_sums(*args)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in out])
    check(all(torch.equal(a, b) and torch.equal(a, e)
              for a, b, e in zip(*replays, eager)),
          "relu_mask_bn_sums: two graph replays or the eager launch differ")
    print(f"phase3 relu_mask_bn_sums float32 n={args[0].shape[0]}: two CUDA-graph "
          "replays bitwise equal to each other and to an eager launch")


_EPOCH = re.compile(r"^\[1\] time \S+ lr \S+ 3d_train (\S+) 3d_eval (\S+) 3d_valid (\S+)$")
_TRAINED = re.compile(r"^INFO: trained (\d+) steps in (\S+) s \((\S+) frames/s")


@contextlib.contextmanager
def k2_ranges(on=True):
    """While on, each K2 wrapper call runs inside a ``K2 <key>`` profiler range,
    which a trace shows on the device timeline around the kernels it launched."""
    from torch.profiler import record_function
    from videopose3d_torch.ops.kernels import train_block as trb
    wrappers = dict(trb._KERNELS)

    def annotated(key, fn):
        def run(*args, **kwargs):
            with record_function(f"K2 {key}"):
                return fn(*args, **kwargs)
        return run

    if on:
        trb._KERNELS.update({k: annotated(k, fn) for k, fn in wrappers.items()})
    try:
        yield
    finally:
        trb._KERNELS.update(wrappers)


def train_cli(argv, profiled=None, window=PROFILE_STEPS):
    """runner.main training in-process; returns (per-step losses, epoch line
    numbers, (steps, seconds, frames/s, ms per step over the warm steps
    ``window``), captured output, launches).
    ``profiled``: a dict that receives a torch.profiler trace of the steps of
    ``window`` and their wall time; each K2 wrapper call then runs inside a
    ``K2 <key>`` profiler range, so that the trace splits the device time of
    kernels the wrappers share (the tap GEMM) by wrapper."""
    from torch.profiler import ProfilerActivity, profile
    from videopose3d_torch import runner, train
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import train_block as trb
    losses, timed = [], {}
    step = train.SupervisedTrainer.step

    def recording_step(self, *args, **kwargs):
        first, stop = window
        if len(losses) == first:
            torch.cuda.synchronize()
            if profiled is not None:
                profiled["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA])
                profiled["prof"].start()
            timed["start"] = time.perf_counter()
        loss = step(self, *args, **kwargs)
        losses.append(loss)
        if len(losses) == stop:
            torch.cuda.synchronize()
            timed["wall"] = time.perf_counter() - timed["start"]
            if profiled is not None:
                profiled["wall"] = timed["wall"]
                profiled["prof"].stop()
        return loss

    for counts in (gr.LAUNCHES, trb.LAUNCHES):
        for k in counts:
            counts[k] = 0
    buf = io.StringIO()
    train.SupervisedTrainer.step = recording_step
    try:
        with k2_ranges(profiled is not None), contextlib.redirect_stdout(buf):
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
    check("wall" in timed, f"fewer than {window[1]} steps:\n{out}")
    rate = (int(trained[0].group(1)), float(trained[0].group(2)), float(trained[0].group(3)),
            timed["wall"] * 1e3 / (window[1] - window[0]))
    check(all(math.isfinite(v) for v in numbers), f"non-finite epoch losses: {numbers}")
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite step losses: {losses}")
    return losses, numbers, rate, out, launches


def train_argv(tmp, name, engine, subset=TRAIN_SUBSET, extra=()):
    """Phase 4's training command line (one full-width epoch of batch 1,024 from
    the random checkpoint, dropout 0.25) in a fresh checkpoint directory named
    after the run: (directory, argv).  Phase 9 cuts the training videos to
    ``subset`` and adds ``extra`` flags."""
    ckpt = os.path.join(tmp, "train_" + name.replace(" ", "_"))
    os.makedirs(ckpt)
    shutil.copy(os.path.join(tmp, "checkpoint", "random_full_width.bin"), ckpt)
    return ckpt, ["-k", "gt", "-arc", ",".join(map(str, ARCH)), "-ch", str(CHANNELS),
                  "-b", "1024", "-e", "1", "-drop", "0.25", "--seed", str(SEED),
                  "-str", "S1,S5", "-ste", "S9,S11", "--subset", subset,
                  "--data-dir", os.path.join(tmp, "data"), "-c", ckpt,
                  "-r", "random_full_width.bin", "--checkpoint-frequency", "1",
                  "--device", "cuda", "--train-engine", engine, *extra]


def phase4(tmp):
    """One full-width training epoch per engine through runner.main.  Returns
    the runs: name -> (losses, launches, checkpoint directory, output, rate)."""
    runs, profiles = {}, {}
    for name, engine in (("pallas", "pallas"), ("xla", "xla"), ("pallas again", "pallas"),
                         ("pallas profiled", "pallas"), ("xla profiled", "xla")):
        ckpt, argv = train_argv(tmp, name, engine)
        profiled = {} if name.endswith("profiled") else None
        losses, numbers, rate, out, launches = train_cli(argv, profiled)
        steps, seconds, fps, steady_ms = rate
        if profiled is not None:
            profiles[engine] = profiled
            continue
        runs[name] = (losses, launches, ckpt, out, rate)
        print(f"phase4 train {name:12s}: {steps} steps of batch 1024 in {seconds:.3f} s, "
              f"{seconds / steps * 1e3:.2f} ms/step ({steady_ms:.2f} over steps "
              f"{PROFILE_STEPS[0]}-{PROFILE_STEPS[1] - 1}), {fps:.1f} training frames/s; "
              f"first-step loss {float(losses[0]):.6f}, epoch 3d_train/3d_eval/3d_valid "
              f"{numbers[0]:.4f}/{numbers[1]:.4f}/{numbers[2]:.4f} mm; launches {launches}")
    # Where the time of a train step goes: device time per kernel over the
    # profiled steps, per step, and the card's busy share of their wall time.
    # Only the device-side events count: an aten op's row repeats its kernels'.
    from torch.autograd import DeviceType
    n_steps = PROFILE_STEPS[1] - PROFILE_STEPS[0]
    for engine, profiled in profiles.items():
        device_us, ranges = {}, []
        for avg in profiled["prof"].key_averages():
            if avg.device_type != DeviceType.CUDA or avg.self_device_time_total <= 0:
                continue
            if avg.key.startswith("K2 "):  # a wrapper's range on the device timeline
                ranges.append(avg)
            elif not is_range(avg):  # torch's optimizer range repeats its kernels
                device_us[avg.key] = device_us.get(avg.key, 0) + avg.self_device_time_total
        check(device_us, f"the {engine} profile holds no device time")
        total_ms = sum(device_us.values()) / 1e3 / n_steps
        wall_ms = profiled["wall"] * 1e3 / n_steps
        print(f"phase4 profile {engine}: steps {PROFILE_STEPS[0]}-{PROFILE_STEPS[1] - 1}, "
              f"{wall_ms:.3f} ms/step wall, {total_ms:.3f} ms/step device time, busy "
              f"{100 * total_ms / wall_ms:.1f} %")
        for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:10]:
            print(f"phase4 profile {engine}   {us / 1e3 / n_steps:8.3f} ms/step  {key[:90]}")
        # Each K2 wrapper's span on the device: the kernels it launched.
        for avg in sorted(ranges, key=lambda a: -a.self_device_time_total):
            print(f"phase4 profile {engine}   {avg.self_device_time_total / 1e3 / n_steps:8.3f} "
                  f"ms/step  {avg.key} ({avg.count // n_steps} calls/step)")
    first_p, first_x = float(runs["pallas"][0][0]), float(runs["xla"][0][0])
    rel = abs(first_p - first_x) / abs(first_x)
    print(f"phase4 first-step loss pallas {first_p!r} vs xla {first_x!r}: relative "
          f"difference {rel:.3e} (bound {FIRST_STEP_AGREE:.0e})")
    # The gap step by step, as phase 7 prints it for its semi-supervised runs.
    gap = ((runs["pallas"][0].double() - runs["xla"][0].double()).abs()
           / runs["xla"][0].double().abs()).tolist()
    print("phase4 loss pallas vs xla, relative gap per step: "
          + " ".join(f"{g:.1e}" for g in gap))
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
                                  "--data-dir", os.path.join(tmp, "data"),
                                  "-c", runs["pallas"][2],
                                  "--evaluate", "epoch_1.bin", "--device", "cuda"])
    worst = max(abs(g - w) / abs(w) for a in trained for g, w in zip(evaluated[a], trained[a]))
    print(f"phase4 epoch_1.bin --evaluate vs the training run's final evaluation: "
          f"worst relative protocol difference {worst:.3e}")
    check(evaluated.keys() == trained.keys() and worst <= 1e-5,
          f"reloaded checkpoint evaluates differently: {evaluated} vs {trained}")
    return runs


# ---------------------------------------------------------------------------
# Phase 7: semi-supervised training (K1 on both streams, K2 on the doubled batch)
# ---------------------------------------------------------------------------

# K2 at the row counts of semi-supervised training (C = 1,024, float32), each n as
# the (batch, input frames) of its block: -arc 3,3,3 -b 64 gives n = 192 and 64 in
# warmup and, on the concatenated labeled + unlabeled batch, 384 and 128 after it;
# -arc 3,3,3,3,3 -b 1024 gives 55,296 / 18,432 / 6,144 / 2,048 after warmup.  At
# every n the whole block and each kernel are held against the plain versions.
SEMI_BLOCKS = {64: (64, 3), 128: (128, 3), 192: (64, 9), 384: (128, 9),
               2048: (2048, 3), 6144: (2048, 9), 18_432: (2048, 27), 55_296: (2048, 81)}
SEMI_TIMED = (55_296, 18_432, 6144, 2048, 384, 128)  # every K2 kernel graph-timed
SEMI_LISTED = (55_296, 128)  # the K2 rows of the summary line: (b)'s first block, (a)'s last
# (a) the README's semi recipe at full width: -arc 3,3,3 -b 64 on 10 % of S1
# against all of S5 (38 steps of 64 per epoch).  (b) the main path's model:
# -arc 3,3,3,3,3 -b 1024 on half of S1 (12 steps per epoch).  Both: one warmup
# epoch, then one full epoch.
SEMI_RECIPE = dict(arch="3,3,3", batch=64, subset="0.1")
SEMI_MAIN = dict(arch=",".join(map(str, ARCH)), batch=1024, subset="0.5")
# Steps [2, 10) of (b)'s full epoch are profiled: warm, on the doubled batch.
SEMI_PROFILE = (2, 10)
SEMI_LINE = re.compile(r"^\[(\d+)\] time \S+ (lr \S+ 3d_train .* 2d_valid \S+)$")


def semi_block_inputs(n, device):
    """train_block_inputs for a block of n rows, drawn on the card (n = 55,296
    is 170 M input elements), from SEED."""
    b, frames = SEMI_BLOCKS[n]
    gen = torch.Generator(device).manual_seed(SEED + n)
    c, fw = CHANNELS, 3
    rand = lambda *shape: torch.rand(*shape, device=device, generator=gen)
    uni = lambda lo, hi, *shape: rand(*shape) * (hi - lo) + lo
    bound = 1 / math.sqrt(fw * c)
    return dict(
        x=torch.randn(b, frames, c, device=device, generator=gen),
        wa=uni(-bound, bound, fw, c, c),
        wb=uni(-1, 1, c, c) / math.sqrt(c),
        bn=[uni(lo, hi, c) for lo, hi in ((0.5, 1.5), (-0.2, 0.2), (0.5, 1.5), (-0.2, 0.2))],
        masks=[(rand(b, frames // fw, c) < 0.75) / 0.75 for _ in range(2)],
        shifts=[uni(-0.1, 0.1, c) for _ in range(2)],
        g=torch.randn(b, frames // fw, c, device=device, generator=gen) * 1e-3)


def compare_to_scale(name, got, want):
    """max |got - want| against TOL[float32] * max |want| for one float32 tensor,
    and for each tap of an (n, taps, C) one: unlike compare's floor of 1, this
    holds outputs far below 1 in size (the backward kernels' cotangents at
    |g| ~ 1e-3) to their own scale, so that a zeroed or mis-scaled one fails."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} vs plain {tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    parts = [(got, want)] + ([(got[:, j], want[:, j]) for j in range(got.shape[1])]
                             if got.dim() == 3 else [])
    worst = 0.0
    for a, w in parts:
        err, scale = float((a - w).abs().max()), float(w.abs().max())
        check(err <= TOL[torch.float32] * scale,
              f"{name}: max abs error {err} > {TOL[torch.float32]} * max |plain| {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    return float((got - want).abs().max()), worst


def phase7_kernels(device):
    """K2 at every row count of semi-supervised training (SEMI_BLOCKS): the whole
    block and each kernel against the plain versions, each kernel to its
    outputs' own scale and repeated bitwise; every kernel graph-timed beside its
    plain version and one float32 torch.matmul of its product (SEMI_TIMED)."""
    from videopose3d_torch.ops.kernels import train_block as trb
    saved = dict(trb.LAUNCHES)
    flops = {key: f for key, _, f in TRAIN_KERNELS}
    replaces = {key: r for key, r, _ in TRAIN_KERNELS}
    results = []
    for n in sorted(SEMI_BLOCKS, reverse=True):
        p = semi_block_inputs(n, device)
        got, want = whole_train_block(p, False), whole_train_block(p, True)
        for nm, a, w in zip(("out", "mean_a", "var_a", "mean_b", "var_b"), got, want):
            compare(f"semi train block n={n} {nm}", a, w, torch.float32)
        rel = {nm: float((a.double() - w.double()).norm() / w.double().norm())
               for nm, a, w in zip(("dx", "dwa", "dwb", "dscale_a", "dbias_a",
                                    "dscale_b", "dbias_b"), got[5:], want[5:])}
        print(f"phase7 train block forward+backward float32 n={n:6d}: outputs and "
              f"stats within tolerance; gradient relative norm errors "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
        check(all(v <= GRAD_NORM_TOL for v in rel.values()),
              f"semi train block n={n}: gradients differ: {rel}")
        del got, want
        for key, args, kwargs in train_block_stages(p):
            kernel, plain = getattr(trb, key), getattr(trb, key + "_plain")
            got, again = kernel(*args, **kwargs), kernel(*args, **kwargs)
            want = plain(*args, **kwargs)
            torch.cuda.synchronize()
            got, again, want = ((t if isinstance(t, tuple) else (t,))
                                for t in (got, again, want))
            errs = [compare_to_scale(f"semi {key} n={n} output {i}", a, w)
                    for i, (a, w) in enumerate(zip(got, want))]
            err, scaled = max(e for e, _ in errs), max(r for _, r in errs)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"semi {key} n={n}: two launches differ")
            del got, again, want
            checked = (f"max_abs_err {err:.3e} ({scaled:.1e} of max |plain|), "
                       "bitwise-equal repeat")
            if n not in SEMI_TIMED:
                print(f"phase7 {key:22s} float32 n={n:6d}: {checked}")
                continue
            reps = 10 if n > 20_000 else 20
            library = library_call(key, args)
            ms, plain_ms = (graph_ms(lambda f=f: f(*args, **kwargs), reps=reps)
                            for f in (kernel, plain))
            library_ms = None if library is None else graph_ms(library, reps=reps)
            outs = kernel(*args, **kwargs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            ops = flops[key] * n * CHANNELS ** 2
            bound_ms, bound_by = roofline(
                [("float32", ops)],
                nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *outs))
            del outs
            rate = (f"{ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s" if ops else
                    f"{bound_ms / ms * 100:.1f} % of the {bound_by} bound")
            lib = "" if library_ms is None else f", torch.matmul {library_ms:.4f} ms"
            print(f"phase7 {key:22s} float32 n={n:6d}: {checked}; graph-replayed kernel "
                  f"{ms:.4f} ms ({rate}), plain {plain_ms:.4f} ms{lib}, bound "
                  f"{bound_ms:.4f} ms ({bound_by})")
            if n in SEMI_LISTED:
                results.append({"name": f"{key} (float32, n={n}, C={CHANNELS}, semi)",
                                "key": ("semi_b" if n > 20_000 else "semi_a", key),
                                "route": "cuda", "source": TRAIN_SOURCE,
                                "replaces": replaces[key], "max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": library_ms})
        del p
        torch.cuda.empty_cache()
    trb.LAUNCHES.update(saved)  # comparison launches do not count
    return results


class SemiProfile:
    """torch.profiler over steps ``[start, stop)`` of a semi-supervised run's full
    epochs, with profiler ranges around the step's parts, so that its device time
    splits into K1, both models' K2 wrappers, the rest of the pose model, the
    rest of the trajectory model, the optimizer and the batch assembly; what none of
    them holds is the projection and the losses.  The autograd engine runs the
    nodes recorded last first, so the backward runs the losses, then the whole
    trajectory model, then the whole pose model: the trajectory model's range
    opens at its output's gradient, and at its first weight's gradient gives way
    to the pose model's, which closes at the pose model's first weight's."""

    DEVICE = "CUDA"  # the profiler's device type of the events split

    def __init__(self, start, stop):
        self.start, self.stop = start, stop
        self.prof = None
        self.wall = None
        self.open = {}

    def active(self):
        return self.prof is not None and self.wall is None

    def range_enter(self, name):
        from torch.profiler import record_function
        if self.active() and name not in self.open:
            self.open[name] = record_function(name)
            self.open[name].__enter__()

    def range_exit(self, name):
        if name in self.open:
            self.open.pop(name).__exit__(None, None, None)

    def begin(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def end(self, steps):
        torch.cuda.synchronize()
        self.wall = (time.perf_counter() - self.t0) / steps
        self.prof.stop()

    def split(self):
        """Device ms per step by part, the total and the busy share."""
        from torch.autograd import DeviceType
        events = [e for e in self.prof.events()
                  if e.device_type == getattr(DeviceType, self.DEVICE)]
        spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
                 if is_range(e)]
        parts = {}
        for e in events:
            if is_range(e):
                continue
            t = e.time_range.start
            inside = {name for name, a, b in spans if a <= t < b}
            if any(n.startswith("K1 ") for n in inside):
                part = "K1 gather_windows"
            elif any(n.startswith("K2 ") for n in inside):
                part = "K2 wrappers (both models)"
            elif any(n.startswith("Optimizer.step") for n in inside):
                part = "optimizer"
            elif "semi assemble" in inside:
                part = "batch assembly (indexing)"
            elif inside & {"semi traj forward", "semi traj backward"}:
                part = "trajectory model, plain parts"
            elif inside & {"semi pose forward", "semi pose backward"}:
                part = "pose model, plain parts"
            else:
                part = "projection + losses"
            parts[part] = parts.get(part, 0.0) + e.time_range.elapsed_us() / 1e3
        steps = self.stop - self.start
        parts = {k: v / steps for k, v in parts.items()}
        total = sum(parts.values())
        ranges = {}
        for name, a, b in spans:
            count, ms = ranges.get(name, (0, 0.0))
            ranges[name] = (count + 1, ms + (b - a) / 1e3)
        return parts, total, total / (self.wall * 1e3), ranges


def semi_cli(argv, profile=None, epochs=(1, 2)):
    """A semi-supervised runner.main in-process; returns (per-step (losses, K1
    launches, warmup) records, the step losses (steps, 4), the epoch lines'
    numbers by epoch, the full steps' time per step, captured output,
    launches, K1's first (stream, row0, keywords) per stream in call order:
    the labeled one, then the unlabeled one).  The full steps' time runs from the end of the first full step
    to the end of the last, between CUDA events recorded after each step (no
    synchronisation).  ``profile``: a SemiProfile of the full steps."""
    from videopose3d_torch import runner, train
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import train_block as trb
    records, events = [], []
    step, forward, assemble = (train.SemiSupervisedTrainer.step, train.forward_strided,
                               train.assemble_chunked_batch_contiguous)
    gather, wrappers = gr.gather_windows, dict(trb._KERNELS)
    current, k1_calls = {}, {}

    def with_range(name, fn, *args, **kwargs):
        from torch.profiler import record_function
        if profile is None or not profile.active():
            return fn(*args, **kwargs)
        with record_function(name):
            return fn(*args, **kwargs)

    def hook(trainer):
        """The ends of both models' backward ranges (torch's optimizer marks its
        own step as ``Optimizer.step#...``)."""
        def traj_done(grad):
            profile.range_exit("semi traj backward")
            profile.range_enter("semi pose backward")
        trainer.traj_model.expand_conv.weight.register_hook(traj_done)
        trainer.pos_model.expand_conv.weight.register_hook(
            lambda grad: profile.range_exit("semi pose backward"))

    def recording_step(self, *args, **kwargs):
        skip = args[7]
        full = sum(1 for r in records if not r[2])  # full steps so far
        if profile is not None and "pos" not in current:
            hook(self)
        current["pos"] = self.pos_model
        if profile is not None and not skip and full == profile.start:
            profile.begin()
        k1 = gr.LAUNCHES["gather_windows"]
        out = step(self, *args, **kwargs)
        records.append((out, gr.LAUNCHES["gather_windows"] - k1, skip))
        if not skip:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        if profile is not None and not skip and full + 1 == profile.stop:
            profile.end(profile.stop - profile.start)
        return out

    def recorded_gather(flat, row0, **kwargs):
        k1_calls.setdefault(flat.data_ptr(), (flat, row0.clone(), kwargs))
        return with_range("K1 gather_windows", gather, flat, row0, **kwargs)

    def annotated_forward(model, x, **kwargs):
        name = "pose" if model is current.get("pos") else "traj"
        out = with_range(f"semi {name} forward", forward, model, x, **kwargs)
        if name == "traj" and profile.active():
            out.register_hook(lambda grad: profile.range_enter("semi traj backward"))
        return out

    for counts in (gr.LAUNCHES, trb.LAUNCHES):
        for k in counts:
            counts[k] = 0
    buf = io.StringIO()
    train.SemiSupervisedTrainer.step = recording_step
    gr.gather_windows = recorded_gather
    if profile is not None:
        train.forward_strided = annotated_forward
        train.assemble_chunked_batch_contiguous = (
            lambda *a, **k: with_range("semi assemble", assemble, *a, **k))
        trb._KERNELS.update({key: (lambda *a, fn=fn, key=key, **k:
                                   with_range(f"K2 {key}", fn, *a, **k))
                             for key, fn in wrappers.items()})
    try:
        with contextlib.redirect_stdout(buf):
            runner.main(argv)
    finally:
        train.SemiSupervisedTrainer.step = step
        train.forward_strided, train.assemble_chunked_batch_contiguous = forward, assemble
        gr.gather_windows = gather
        trb._KERNELS.update(wrappers)
    torch.cuda.synchronize()
    launches = {**gr.LAUNCHES, **trb.LAUNCHES}
    out = buf.getvalue()
    lines = {int(m.group(1)): m.group(2) for m in map(SEMI_LINE.match, out.splitlines())
             if m}
    check(tuple(sorted(lines)) == tuple(epochs), f"semi-supervised epoch lines missing:\n{out}")
    for epoch, line in lines.items():
        check(all(math.isfinite(float(v)) for v in line.split()[1::2]),
              f"non-finite numbers in epoch {epoch}: {line}")
    losses = torch.stack([torch.stack(r[0]) for r in records]).cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite step losses: {losses}")
    check(len(events) > 1, "fewer than two full steps")
    step_ms = events[0].elapsed_time(events[-1]) / (len(events) - 1)
    return records, losses, lines, step_ms, out, launches, list(k1_calls.values())


def _semi_argv(tmp, cfg, engine, ckpt, epochs=2, resume=None):
    argv = ["-k", "gt", "-arc", cfg["arch"], "-ch", str(CHANNELS), "-b", str(cfg["batch"]),
            "-e", str(epochs), "--warmup", "1", "-drop", "0.25", "--seed", str(SEED),
            "-str", "S1", "-sun", "S5", "-ste", "S9,S11", "--subset", cfg["subset"],
            "--data-dir", os.path.join(tmp, "data"), "-c", ckpt,
            "--checkpoint-frequency", "1", "--device", "cuda", "--train-engine", engine]
    return argv + (["-r", resume] if resume else [])


def phase7(tmp):
    """Semi-supervised training through runner.main: (a) the README's recipe at
    full width, (b) the main path's model.  Each: the fused engine twice and the
    plain one once from the same seed (the runs' first steps against each other,
    the two fused runs bitwise, K1 on both streams), then both engines resumed
    from the fused run's warmup checkpoint, so that their first full step starts
    from the same state (the uninterrupted runs drift apart over the warmup
    epoch's steps, as float32 sums in other orders do); the resumed fused run
    prints the uninterrupted one's epoch 2.  (a)'s trajectory model loads and its
    checkpoint evaluates; (b) runs once more under the profiler.  Returns the
    launches of (a)'s and (b)'s first pallas runs."""
    from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import train_block as trb
    runs = {}

    def k1_bitwise(cell, k1_calls):
        """K1 against its plain version, bitwise, on the first window gather of
        each stream of the run: its rows, descriptors and window."""
        check(len(k1_calls) == 2, f"({cell}) K1 gathered from {len(k1_calls)} streams, not 2")
        saved = dict(gr.LAUNCHES)
        for stream, (flat, row0, kwargs) in zip(("labeled", "unlabeled"), k1_calls):
            got = gr.gather_windows(flat, row0, **kwargs)
            want = gr.gather_windows_plain(flat, row0, **kwargs)
            check(torch.equal(got, want), f"({cell}) K1 differs from plain on the {stream} "
                                          f"stream")
            print(f"phase7 ({cell}) K1 gather_windows, {stream} stream of "
                  f"{flat.shape[0]} rows: {tuple(got.shape)} windows bitwise equal to plain")
        gr.LAUNCHES.update(saved)  # comparison launches do not count

    def run(cell, cfg, name, engine, resume=None, profile=None):
        ckpt = os.path.join(tmp, f"semi_{cell}_" + name.replace(" ", "_"))
        os.makedirs(ckpt)
        if resume:
            shutil.copy(resume, ckpt)
            resume = os.path.basename(resume)
        records, losses, lines, step_ms, out, launches, k1_calls = semi_cli(
            _semi_argv(tmp, cfg, engine, ckpt, resume=resume), profile,
            epochs=(2,) if resume else (1, 2))
        if name == "pallas":
            k1_bitwise(cell, k1_calls)
        runs[cell, name] = r = dict(records=records, losses=losses, lines=lines, out=out,
                                    ckpt=ckpt, launches=launches, profile=profile)
        r["warm"] = warm = sum(1 for rec in records if rec[2])
        print(f"phase7 ({cell}) {name:15s} -arc {cfg['arch']} -b {cfg['batch']}: "
              f"{warm} warmup + {len(records) - warm} full steps, full steps "
              f"{step_ms:.3f} ms/step; first full step losses (pos, traj, recon, "
              f"total) {[round(v, 6) for v in losses[warm].tolist()]}; launches "
              f"{launches}")
        for epoch, line in sorted(lines.items()):
            print(f"phase7 ({cell}) {name:15s} [{epoch}] {line}")
        k1 = [rec[1] for rec in records]
        check(k1 == [1] * warm + [2] * (len(k1) - warm),
              f"({cell}) {name}: K1 launches per step are not 1 in warmup and 2 after: {k1}")
        if engine == "pallas":
            check(all(v > 0 for v in launches.values()),
                  f"({cell}) {name} did not launch every training kernel: {launches}")
        else:
            check(not any(launches[k] for k in trb.LAUNCHES),
                  f"({cell}) {name} launched train-block kernels")
        return r

    def agree(cell, what, got, want):
        rel = abs(got - want) / abs(want)
        print(f"phase7 ({cell}) {what} total loss pallas {got!r} vs xla {want!r}: relative "
              f"difference {rel:.3e}")
        return rel

    for cell, cfg in (("a", SEMI_RECIPE), ("b", SEMI_MAIN)):
        pallas = run(cell, cfg, "pallas", "pallas")
        xla = run(cell, cfg, "xla", "xla")
        again = run(cell, cfg, "pallas again", "pallas")
        check(float(pallas["lines"][2].split("2d_train_unsup ")[1].split()[0]) > 0,
              f"({cell}) 2d_train_unsup is not positive after warmup: {pallas['lines'][2]}")
        check(again["lines"] == pallas["lines"]
              and torch.equal(again["losses"], pallas["losses"]),
              f"({cell}) two pallas runs differ")
        warm = pallas["warm"]
        # The uninterrupted runs' gap, step by step: float32 sums in other orders
        # at step 0, then carried on by the updates.
        gap = ((pallas["losses"][:, 3].double() - xla["losses"][:, 3].double()).abs()
               / xla["losses"][:, 3].double().abs()).tolist()
        for what, steps in (("warmup", gap[:warm]), ("full", gap[warm:])):
            print(f"phase7 ({cell}) total loss pallas vs xla, relative gap per {what} step: "
                  + " ".join(f"{g:.1e}" for g in steps))
        first = agree(cell, "first (warmup) step", float(pallas["losses"][0, 3]),
                      float(xla["losses"][0, 3]))
        agree(cell, f"uninterrupted runs' first full step (after {warm} warmup steps)",
              float(pallas["losses"][warm, 3]), float(xla["losses"][warm, 3]))
        warmup_ckpt = os.path.join(pallas["ckpt"], "epoch_1.bin")
        resumed = run(cell, cfg, "pallas resumed", "pallas", resume=warmup_ckpt)
        resumed_x = run(cell, cfg, "xla resumed", "xla", resume=warmup_ckpt)
        full = agree(cell, "first full step from the warmup checkpoint",
                     float(resumed["losses"][0, 3]), float(resumed_x["losses"][0, 3]))
        print(f"phase7 ({cell}) bounds {FIRST_STEP_AGREE:.0e}; two pallas runs bitwise "
              f"equal over {len(pallas['records'])} steps; -r epoch_1.bin prints the "
              f"uninterrupted run's epoch 2: {resumed['lines'][2] == pallas['lines'][2]}")
        check(first <= FIRST_STEP_AGREE and full <= FIRST_STEP_AGREE,
              f"({cell}) pallas and xla losses differ: {first:.3e}, {full:.3e}")
        check(resumed["lines"][2] == pallas["lines"][2],
              f"({cell}) -r epoch_1.bin epoch 2 differs: {resumed['lines'][2]} vs "
              f"{pallas['lines'][2]}")
        if cell == "b":
            run(cell, cfg, "pallas profiled", "pallas", profile=SemiProfile(*SEMI_PROFILE))

    # (b)'s profile: device time per full step by part.
    profile = runs["b", "pallas profiled"]["profile"]
    parts, total, busy, ranges = profile.split()
    check(total > 0, "the semi-supervised profile holds no device time")
    print("phase7 (b) profile ranges on the device (count, summed span ms): "
          + ", ".join(f"{k} {c} {ms:.3f}" for k, (c, ms) in sorted(ranges.items())))
    print(f"phase7 (b) profile: full steps {SEMI_PROFILE[0]}-{SEMI_PROFILE[1] - 1}, "
          f"{profile.wall * 1e3:.3f} ms/step wall, {total:.3f} ms/step device time, busy "
          f"{100 * busy:.1f} %")
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"phase7 (b) profile   {ms:8.3f} ms/step  {part}")

    # (a): the checkpoint's trajectory model loads, and the checkpoint evaluates to
    # the run's final numbers.
    pallas = runs["a", "pallas"]
    chk = torch.load(os.path.join(pallas["ckpt"], "epoch_2.bin"), map_location="cpu",
                     weights_only=False)
    TemporalModel(TemporalModelConfig(
        num_joints_in=JOINTS, in_features=2, num_joints_out=1,
        filter_widths=tuple(int(w) for w in SEMI_RECIPE["arch"].split(",")),
        channels=CHANNELS)).load_state_dict(chk["model_traj"], strict=True)
    check(chk["stream_rng_semi"] is not None, "no unlabeled stream state in the checkpoint")
    evaluated, _, _, _ = run_cli(["-k", "gt", "-arc", SEMI_RECIPE["arch"], "-ch",
                                  str(CHANNELS), "-str", "S1", "-ste", "S9,S11",
                                  "--data-dir", os.path.join(tmp, "data"), "-c",
                                  pallas["ckpt"], "--evaluate", "epoch_2.bin",
                                  "--device", "cuda"])
    trained = protocol_lines(pallas["out"])
    worst = max(abs(g - w) / abs(w) for a in trained for g, w in zip(evaluated[a], trained[a]))
    print(f"phase7 (a) epoch_2.bin: model_traj loads; --evaluate vs the run's final "
          f"evaluation: worst relative protocol difference {worst:.3e}")
    check(evaluated.keys() == trained.keys() and worst <= 1e-5,
          f"(a) epoch_2.bin evaluates differently: {evaluated} vs {trained}")
    return runs["a", "pallas"]["launches"], runs["b", "pallas"]["launches"]


# ---------------------------------------------------------------------------
# Phase 8: data parallelism (NCCL at world size 1; two gloo ranks on one card)
# ---------------------------------------------------------------------------

# A rank that has not finished in this time fails the phase: a hung rendezvous
# or collective ends as a failure, not as a hung run.
RANK_TIMEOUT_S = 420
# 8b against one process from the same state: the step-0 loss within
# DP_LOSS_AGREE relative (the ranks' float32 partial sums add up in another
# order than one process's, ~1e-7 relative); each all-reduced gradient tensor
# within GRAD_NORM_TOL of the single process's in relative norm, phase 3's bound
# for the same cause: a few pre-activations within ~1e-7 of 0 fall on the other
# side of a ReLU gate under the other summation order, and each flip moves the
# gradients built on it.  Entry by entry those flips reach ~1e-2 of a tensor's
# largest gradient, as far as one process's own two engines (pallas against
# xla) lie apart on the same step, so that figure is printed beside the
# engines' own, not bounded.  The sharded per-epoch losses within DP_EVAL_AGREE relative (float32
# per-rank sums).
DP_LOSS_AGREE = 1e-5
DP_EVAL_AGREE = 1e-6
# 8b: supervised steps after which the ranks' weights must be bitwise equal,
# full semi-supervised steps, and supervised steps timed after those.
DP_STEPS, DP_SEMI_STEPS, DP_TIMED_STEPS = 8, 2, 6
# Phase 9 (e): dilated-form supervised steps on the two ranks.
DP_DILATED_STEPS = 2
# 8b's training set: eight videos of 750 frames (S1's two actions from four
# cameras at --subset 0.5, as phase 4), 12,000 windows with the flipped copies:
# 11 steps of 1,024 and one of 736.  The sharded evaluation set: six videos of
# 1,000 frames.
DP_VIDEOS, DP_FRAMES, DP_EVAL_VIDEOS, DP_EVAL_FRAMES = 8, 750, 6, 1000
DP_BATCH = 1024
KPS_LEFT, KPS_RIGHT = [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]
# The Human3.6M skeleton's parents after the 32 -> 17 joint cut.
PARENTS_17 = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15])
# Profiler ranges of the profiled 8a epoch (dp_ranges).
DP_RANGES = ("DP grad all-reduce", "DP BN all-reduce", "DP mask draw")


@contextlib.contextmanager
def dp_ranges():
    """Each gradient all-reduce, BatchNorm-sum all-reduce and dropout-mask draw of
    the training path inside a profiler range of DP_RANGES."""
    from torch.profiler import record_function
    from videopose3d_torch.models import temporal
    from videopose3d_torch.parallel import mesh
    grads, reduce_, masks = (mesh.all_reduce_gradients, mesh.all_reduce_,
                             temporal.dropout_mask)
    in_grads = []

    def ranged_grads(*args, **kwargs):
        in_grads.append(True)
        try:
            with record_function(DP_RANGES[0]):
                return grads(*args, **kwargs)
        finally:
            in_grads.pop()

    def ranged_reduce(t, group=None):
        if in_grads:
            return reduce_(t, group)
        with record_function(DP_RANGES[1]):
            return reduce_(t, group)

    def ranged_masks(*args, **kwargs):
        with record_function(DP_RANGES[2]):
            return masks(*args, **kwargs)

    mesh.all_reduce_gradients, mesh.all_reduce_ = ranged_grads, ranged_reduce
    temporal.dropout_mask = ranged_masks
    try:
        yield
    finally:
        mesh.all_reduce_gradients, mesh.all_reduce_ = grads, reduce_
        temporal.dropout_mask = masks


def dp_profile_split(profiled):
    """ms per step of the profiled steps: wall, device time, and each DP range's
    device and host time."""
    from torch.autograd import DeviceType
    n_steps = PROFILE_STEPS[1] - PROFILE_STEPS[0]
    split = {"wall_ms": profiled["wall"] * 1e3 / n_steps,
             "device_ms": sum(device_times(profiled["prof"]).values()) / 1e3 / n_steps}
    for name in DP_RANGES:
        split[name] = {"device_ms": 0.0, "host_ms": 0.0, "calls": 0}
    for avg in profiled["prof"].key_averages():
        if avg.key in DP_RANGES:
            part = split[avg.key]
            if avg.device_type == DeviceType.CUDA:
                part["device_ms"] += avg.self_device_time_total / 1e3 / n_steps
            else:
                part["host_ms"] += avg.cpu_time_total / 1e3 / n_steps
                part["calls"] += avg.count // n_steps
    split["top"] = sorted(((us / 1e3 / n_steps, key[:90]) for key, us in
                           device_times(profiled["prof"]).items()), reverse=True)[:8]
    return split


def phase8a_rank(out_json, profiled, argv):
    """One rank of 8a under torch.distributed.run: the runner's main (what
    ``python -m videopose3d_torch.run`` calls) through train_cli, its results
    written to ``out_json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile = {} if profiled else None
    with dp_ranges() if profiled else contextlib.nullcontext():
        losses, numbers, rate, out, launches = train_cli(argv, profile)
    result = {"losses": losses.tolist(), "numbers": numbers, "rate": rate, "out": out,
              "launches": launches}
    if profiled:
        result["profile"] = dp_profile_split(profile)
    with open(out_json, "w") as f:
        json.dump(result, f)


def epoch_line(out):
    """The text of the epoch line after its time."""
    lines = [m.group(1) for m in map(re.compile(r"^\[1\] time \S+ (lr .*)$").match,
                                     out.splitlines()) if m]
    check(len(lines) == 1, f"no single epoch line:\n{out}")
    return lines[0]


def launch_8a(tmp, name, profiled, launcher=True):
    """One 8a rank through ``python -m torch.distributed.run --standalone
    --nproc_per_node 1`` (or, without ``launcher``, the same program in a plain
    process) on phase 4's pallas command line: (checkpoint directory, the rank's
    results)."""
    ckpt, argv = train_argv(tmp, name, "pallas")
    out_json = os.path.join(tmp, name.replace(" ", "_") + ".json")
    run = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1"] if launcher else [sys.executable])
    cmd = [*run, os.path.abspath(__file__), "--dp-rank", out_json,
           "--profiled" if profiled else "--unprofiled", "--", *argv]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"8a {name}: no result in {RANK_TIMEOUT_S} s") from e
    check(done.returncode == 0 and os.path.exists(out_json),
          f"8a {name} failed ({done.returncode}):\n{done.stdout[-4000:]}\n"
          f"{done.stderr[-4000:]}")
    with open(out_json) as f:
        return ckpt, json.load(f)


def phase8a(tmp, runs4):
    """World size 1 on NCCL: the launcher's run of phase 4's pallas command line,
    bitwise phase 4's (epoch line, per-step losses, saved weights, K1/K2
    launches), its ms/step beside phase 4's and beside the same program's in a
    fresh process without the launcher, and one profiled epoch.  Returns the
    launches."""
    from videopose3d_torch.checkpoint import load_any_checkpoint
    losses4, launches4, ckpt4, out4, rate4 = runs4["pallas"]
    ckpt, r = launch_8a(tmp, "dp nccl", False)
    _, alone = launch_8a(tmp, "dp alone", False, launcher=False)
    check(alone["losses"] == losses4.tolist() and "Data-parallel" not in alone["out"],
          "8a: the program without the launcher differs from phase 4")
    steps, seconds, _, steady_ms = r["rate"]
    print(f"phase8a NCCL world size 1: {steps} steps in {seconds:.3f} s, "
          f"{seconds / steps * 1e3:.2f} ms/step ({steady_ms:.2f} over steps "
          f"{PROFILE_STEPS[0]}-{PROFILE_STEPS[1] - 1}); the same fresh process without "
          f"the launcher {alone['rate'][1] / steps * 1e3:.2f} ({alone['rate'][3]:.2f}); "
          f"phase 4 pallas {rate4[1] / rate4[0] * 1e3:.2f} ({rate4[3]:.2f}), pallas "
          f"again ({runs4['pallas again'][4][3]:.2f})")
    check("INFO: Data-parallel over 1 processes" in r["out"].splitlines(),
          f"8a did not join a process group:\n{r['out'][:3000]}")
    check(epoch_line(r["out"]) == epoch_line(out4),
          f"8a epoch line {epoch_line(r['out'])!r} differs from phase 4's "
          f"{epoch_line(out4)!r}")
    check(r["losses"] == losses4.tolist(), "8a per-step losses differ from phase 4's")
    mine = load_any_checkpoint(os.path.join(ckpt, "epoch_1.bin"))["model_pos"]
    theirs = load_any_checkpoint(os.path.join(ckpt4, "epoch_1.bin"))["model_pos"]
    check(mine.keys() == theirs.keys() and all(
        torch.equal(torch.as_tensor(np.asarray(mine[k])), torch.as_tensor(np.asarray(theirs[k])))
        for k in mine), "8a saved weights differ from phase 4's")
    check(r["launches"] == launches4,
          f"8a launches {r['launches']} differ from phase 4's {launches4}")
    print(f"phase8a epoch line, {len(r['losses'])} step losses and the saved weights "
          f"bitwise phase 4's; launches {r['launches']} (phase 4's)")
    _, p = launch_8a(tmp, "dp nccl profiled", True)
    prof = p["profile"]
    print(f"phase8a profile: steps {PROFILE_STEPS[0]}-{PROFILE_STEPS[1] - 1}, "
          f"{prof['wall_ms']:.3f} ms/step wall, {prof['device_ms']:.3f} ms/step device "
          f"time, busy {100 * prof['device_ms'] / prof['wall_ms']:.1f} %")
    for name in DP_RANGES:
        part = prof[name]
        print(f"phase8a profile   {name}: {part['device_ms']:.4f} ms/step device, "
              f"{part['host_ms']:.4f} ms/step host, {part['calls']} calls/step")
    for ms, key in prof["top"]:
        print(f"phase8a profile   {ms:8.3f} ms/step  {key}")
    check(prof[DP_RANGES[0]]["calls"] == 1 and prof[DP_RANGES[1]]["calls"] == 18,
          f"8a profile: expected 1 gradient and 18 BatchNorm all-reduces a step: {prof}")
    return r["launches"]


def dp_videos(seed, n, frames, labeled=True):
    """Synthetic normalized keypoints, 3D poses with their roots 3-5 m in front
    of the camera, and intrinsics near Human3.6M's."""
    rng = np.random.default_rng(seed)
    p2, p3, cams = [], [], []
    for _ in range(n):
        x2d = rng.uniform(-0.8, 0.8, (frames, JOINTS, 2)).astype(np.float32)
        pose = np.concatenate([0.5 * x2d, 0.3 * np.sin(2 * x2d[..., :1])], axis=-1)
        pose[:, 0] = np.stack([rng.uniform(-0.5, 0.5, frames), rng.uniform(-0.5, 0.5, frames),
                               rng.uniform(3.0, 5.0, frames)], axis=-1)
        p2.append(x2d)
        p3.append(pose.astype(np.float32))
        cams.append(np.concatenate([rng.uniform(2.2, 2.4, 2), rng.uniform(-0.02, 0.02, 2),
                                    rng.uniform(-0.2, 0.2, 3), rng.uniform(-0.003, 0.003, 2)]
                                   ).astype(np.float32))
    return p2, (p3 if labeled else None), cams


def dp_models(device, semi):
    """The full-width pose model and, with ``semi``, the trajectory model, both
    on the pallas train engine as the runner builds them, random from SEED,
    dropout 0.25."""
    from videopose3d_torch.models.temporal import TemporalModel
    cfg, pos = random_model(device)
    models = []
    for joints_out in (JOINTS, 1)[:1 + semi]:
        torch.manual_seed(SEED + joints_out)
        m = TemporalModel(dataclasses.replace(cfg, num_joints_out=joints_out,
                                              train_engine="pallas", dropout=0.25))
        if joints_out == JOINTS:
            m.load_state_dict(pos.state_dict())
        models.append(m.to(device).train())
    return models


def state_digest(models):
    """sha256 of every parameter's and buffer's bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for m in models:
        for t in itertools.chain(m.parameters(), m.buffers()):
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def grad_errors(models, ref_models):
    """Over every parameter: the largest relative norm of (gradient - reference
    gradient), and the largest |gradient - reference| over the tensor's largest
    |reference gradient|."""
    norm = entry = 0.0
    for a, b in zip(models, ref_models):
        for p, q in zip(a.parameters(), b.parameters()):
            d = p.grad - q.grad
            norm = max(norm, float(d.norm() / q.grad.norm().clamp_min(1e-30)))
            entry = max(entry, float(d.abs().max() / q.grad.abs().max().clamp_min(1e-30)))
    return norm, entry


def phase8b_checks(rank, world, device):
    """The body of one 8b rank: the supervised and semi-supervised trainers on
    this rank's half of each full-width global batch against one process from
    the same state (rank 0), the ranks' weights compared by digest, a sharded
    DeviceEvalSet against an unsharded one, K1/K2 launches, ms/step and the
    dropout-mask draw at the global and at the local shape.  Rank 0 also takes
    the first step in one process with the models on the plain blocks
    (``xla``): how far one process's own engines lie apart."""
    import copy
    from videopose3d_torch import train
    from videopose3d_torch.data import generators as gen
    from videopose3d_torch.evaluate import DeviceEvalSet, Evaluator, full_float32
    from videopose3d_torch.models.temporal import dropout_mask
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import train_block as trb
    from videopose3d_torch.parallel import mesh
    dp = mesh.DataParallel.from_group()
    pad = (receptive_field_of(ARCH) - 1) // 2
    perm = np.arange(JOINTS)
    perm[KPS_LEFT], perm[KPS_RIGHT] = KPS_RIGHT, KPS_LEFT
    margins = gen.FlatSequenceDataset.training_margins(pad, 0, 1)

    def dataset(seed, labeled=True):
        p2, p3, cams = dp_videos(seed, DP_VIDEOS, DP_FRAMES, labeled)
        flat = gen.FlatSequenceDataset(p2, p3, cams, margins=margins, flip_perms=(perm, perm))
        return flat.to_device(device), [len(v) for v in p2]

    counters = (gr.LAUNCHES, trb.LAUNCHES)
    for counts in counters:
        for k in counts:
            counts[k] = 0

    @contextlib.contextmanager
    def uncounted():
        saved = [dict(c) for c in counters]
        yield
        for c, s in zip(counters, saved):
            c.update(s)

    loop = train.TrainLoopConfig(batch_size=DP_BATCH, chunk_length=1, pad=pad, causal_shift=0)
    result = {"rank": rank}
    dev, lengths = dataset(SEED + 81)
    sampler = gen.ChunkedPairSampler(lengths, loop.batch_size, 1, augment=True)

    def endless(s):
        while True:
            yield from s.next_epoch()

    batches = endless(sampler)
    for name, semi in (("supervised", False), ("semi", True)):
        models = dp_models(device, semi)
        for m in models:
            mesh.broadcast_module(m)
        refs = [copy.deepcopy(m) for m in models] if rank == 0 else None
        plains = [copy.deepcopy(m) for m in models] if rank == 0 else None
        for p in plains or ():
            p.config = dataclasses.replace(p.config, train_engine="xla")

        def trainer(ms, use_dp):
            opt = train.make_optimizer(ms, loop.learning_rate)
            if semi:
                return train.SemiSupervisedTrainer(*ms, loop, opt, PARENTS_17,
                                                   dp=dp if use_dp else None)
            return train.SupervisedTrainer(ms[0], loop, opt, dp=dp if use_dp else None)

        mine = trainer(models, True)
        ref = trainer(refs, False) if rank == 0 else None
        gens = [torch.Generator(device=device).manual_seed(SEED + 8) for _ in range(3)]
        if semi:
            dev_u, lengths_u = dataset(SEED + 82, labeled=False)
            unlabeled = endless(gen.ChunkedPairSampler(lengths_u, loop.batch_size, 1,
                                                       random_seed=4321, augment=True))
            steps = [(*next(batches), *next(unlabeled)) for _ in range(DP_SEMI_STEPS)]
            run = lambda t, s, g: t.step(dev, dev_u, s[0], s[1], s[2], s[3], 0.1, False, g)[3]
        else:
            steps = [next(batches) for _ in range(DP_STEPS)]
            run = lambda t, s, g: t.step(dev, s[0], s[1], 0.1, g)
        got, want = [], []
        with full_float32():
            for i, s in enumerate(steps):
                if rank == 0:
                    with uncounted():
                        want.append(float(run(ref, s, gens[1])))
                share = run(mine, s, gens[0])
                got.append(float(mesh.all_reduce_(share.detach().reshape(1).clone())))
                if i == 0 and rank == 0:
                    with uncounted():
                        run(trainer(plains, False), s, gens[2])
                    result[name + " grad"] = grad_errors(models, refs)
                    result[name + " engines"] = grad_errors(plains, refs)
        result[name] = {"losses": got, "single": want, "digest": state_digest(models)}
        if not semi:
            # ms per supervised step of the two ranks together, after a barrier.
            dist_barrier(device)
            start = time.perf_counter()
            with full_float32():
                for _ in range(DP_TIMED_STEPS):
                    share = run(mine, next(batches), gens[0])
            float(share)
            dist_barrier(device)
            result["ms_per_step"] = (time.perf_counter() - start) * 1e3 / DP_TIMED_STEPS
            # One gradient all-reduce alone: the flat bucket of the pose model.
            flat = torch.cat([p.grad.reshape(-1) for p in models[0].parameters()])
            dist_barrier(device)
            start = time.perf_counter()
            mesh.all_reduce_(flat)
            dist_barrier(device)
            result["grad_all_reduce_ms"] = (time.perf_counter() - start) * 1e3
            result["grad_mb"] = flat.numel() * 4 / 1e6
        else:
            pos, traj = models
    result.update(dp_dilated_steps(rank, dp, device, perm, uncounted))
    result["launches"] = {**gr.LAUNCHES, **trb.LAUNCHES}

    p2, p3, cams = dp_videos(SEED + 83, DP_EVAL_VIDEOS, DP_EVAL_FRAMES)
    batcher = lambda: gen.UnchunkedBatcher(cams, p3, p2, pad=pad, causal_shift=0,
                                           kps_flip_perm=perm, joints_flip_perm=perm)
    evaluators = (Evaluator(pos.config, joints_flip_perm=perm, device=device), pos,
                  Evaluator(traj.config, device=device), traj)
    result["eval sharded"] = DeviceEvalSet(batcher(), pad=pad, device=device, with_traj=True,
                                           shard=(rank, world)).losses(*evaluators)
    if rank == 0:
        result["eval single"] = DeviceEvalSet(batcher(), pad=pad, device=device,
                                              with_traj=True).losses(*evaluators)
        # The dropout masks of one pose-model forward (the expand's and two per
        # block), at the global batch and at a rank's half of it.
        t = receptive_field_of(ARCH) // ARCH[0]
        frames = [t]
        for fw in ARCH[1:]:
            t //= fw
            frames += [t, t]
        g = torch.Generator(device=device).manual_seed(SEED)
        result["mask_ms"] = {b: cuda_ms(lambda b=b: [
            dropout_mask(0.25, (b, t, CHANNELS), torch.float32, g) for t in frames])
            for b in (DP_BATCH, DP_BATCH // 2)}
    dist_barrier(device)
    return result



def dp_dilated_steps(rank, dp, device, perm, uncounted):
    """Phase 9 (e), inside an 8b rank: DP_DILATED_STEPS supervised steps of the
    dilated form (-arc 3,3,3 at full width, chunks of 2 frames, a global batch of
    512: -b 1024 --stride 2) on this rank's rows against one process from the
    same state (rank 0): the step-0 loss and gradients, the weights' digest."""
    import copy
    from videopose3d_torch import train
    from videopose3d_torch.data import generators as gen
    from videopose3d_torch.evaluate import full_float32
    from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig
    from videopose3d_torch.parallel import mesh
    arch = (3, 3, 3)
    pad = (receptive_field_of(arch) - 1) // 2
    p2, p3, cams = dp_videos(SEED + 84, DP_VIDEOS, DP_FRAMES)
    dev = gen.FlatSequenceDataset(
        p2, p3, cams, margins=gen.FlatSequenceDataset.training_margins(pad, 0, 2),
        flip_perms=(perm, perm)).to_device(device)
    loop = train.TrainLoopConfig(batch_size=DP_BATCH // 2, chunk_length=2, pad=pad,
                                 causal_shift=0, use_strided=False)
    steps = list(itertools.islice(gen.ChunkedPairSampler(
        [len(v) for v in p2], loop.batch_size, 2, augment=True).next_epoch(),
        DP_DILATED_STEPS))
    torch.manual_seed(SEED + 9)
    model = TemporalModel(TemporalModelConfig(JOINTS, 2, JOINTS, arch, dropout=0.25,
                                              channels=CHANNELS, train_engine="pallas"))
    model = model.to(device).train()
    mesh.broadcast_module(model)
    ref = copy.deepcopy(model) if rank == 0 else None
    mine = train.SupervisedTrainer(model, loop, train.make_optimizer(model, 1e-3), dp=dp)
    single = (train.SupervisedTrainer(ref, loop, train.make_optimizer(ref, 1e-3))
              if rank == 0 else None)
    gens = [torch.Generator(device=device).manual_seed(SEED + 9) for _ in range(2)]
    got, want, result = [], [], {}
    with full_float32():
        for i, (meta, n_valid) in enumerate(steps):
            if rank == 0:
                with uncounted():
                    want.append(float(single.step(dev, meta, n_valid, 0.1, gens[1])))
            share = mine.step(dev, meta, n_valid, 0.1, gens[0])
            got.append(float(mesh.all_reduce_(share.detach().reshape(1).clone())))
            if i == 0 and rank == 0:
                result["dilated grad"] = grad_errors([model], [ref])
    result["dilated"] = {"losses": got, "single": want, "digest": state_digest([model])}
    return result


def receptive_field_of(arch):
    from videopose3d_torch.models.temporal import TemporalModelConfig, receptive_field
    return receptive_field(TemporalModelConfig(JOINTS, 2, JOINTS, tuple(arch)))


def dist_barrier(device):
    """All ranks here, with the card's queued work done."""
    import torch.distributed as dist
    torch.cuda.synchronize(device)
    dist.barrier()


def phase8b_rank(rank, world, rdv, out_json):
    """One 8b rank: joins a gloo group of ``world`` ranks on card 0 through the
    ``file://`` rendezvous ``rdv`` and writes phase8b_checks' results (or the
    traceback) to ``out_json``."""
    import traceback
    import torch.distributed as dist
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                                world_size=world)
        result = phase8b_checks(rank, world, device)
    except BaseException:
        result = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_json, "w") as f:
        json.dump(result, f)


def phase8b(tmp):
    """Two ranks sharing the card over gloo, spawned with torch.multiprocessing:
    the checks of phase8b_checks.  Returns the ranks' launches."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    outs = [os.path.join(tmp, f"dp_gloo_rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=phase8b_rank, args=(r, 2, os.path.join(tmp, "dp_gloo_rdv"),
                                                    outs[r])) for r in range(2)]
    start = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(0.0, RANK_TIMEOUT_S - (time.perf_counter() - start)))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(not hung, f"8b ranks {hung} did not finish in {RANK_TIMEOUT_S} s")
    results = []
    for r, path in enumerate(outs):
        check(os.path.exists(path), f"8b rank {r} wrote no result (exit {procs[r].exitcode})")
        with open(path) as f:
            results.append(json.load(f))
        check("error" not in results[r], f"8b rank {r} failed:\n{results[r].get('error')}")
    r0 = results[0]
    print(f"phase8b two gloo ranks sharing one card, {DP_BATCH // 2} rows each of a global "
          f"batch of {DP_BATCH}: {r0['ms_per_step']:.2f} ms per supervised step (rank 1 "
          f"{results[1]['ms_per_step']:.2f}; not a scale-out number); one gloo all-reduce "
          f"of the {r0['grad_mb']:.1f} MB gradient alone {r0['grad_all_reduce_ms']:.2f} ms")
    for name in ("supervised", "semi"):
        got, want = r0[name]["losses"], r0[name]["single"]
        gaps = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        (norm, entry), (e_norm, e_entry) = r0[name + " grad"], r0[name + " engines"]
        print(f"phase8b {name}: step-0 loss {got[0]!r} vs one process {want[0]!r}, "
              f"relative {gaps[0]:.3e} (bound {DP_LOSS_AGREE:.0e}); gradients, worst "
              f"tensor: relative norm {norm:.3e} (bound {GRAD_NORM_TOL:.0e}), largest "
              f"entry {entry:.3e} of the tensor's max; one process's xla engine against "
              f"its pallas: {e_norm:.3e}, {e_entry:.3e}; loss gap per step: "
              + " ".join(f"{g:.1e}" for g in gaps))
        check(gaps[0] <= DP_LOSS_AGREE, f"8b {name} step-0 loss {got[0]} vs {want[0]}")
        check(norm <= GRAD_NORM_TOL, f"8b {name} gradients differ: {r0[name + ' grad']}")
        check(all(r[name]["losses"] == got for r in results),
              f"8b {name}: the ranks' all-reduced losses differ")
        check(len({r[name]["digest"] for r in results}) == 1,
              f"8b {name}: the ranks' weights and statistics differ after {len(got)} steps")
        print(f"phase8b {name}: parameters and running statistics bitwise equal on both "
              f"ranks after {len(got)} steps")
    got, want = r0["dilated"]["losses"], r0["dilated"]["single"]
    gaps = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    norm, entry = r0["dilated grad"]
    print(f"phase9 (e) dilated form -arc 3,3,3 -b 1024 --stride 2 on two gloo ranks: step-0 "
          f"loss {got[0]!r} vs one process {want[0]!r}, relative {gaps[0]:.3e} (bound "
          f"{DP_LOSS_AGREE:.0e}); gradients, worst tensor: relative norm {norm:.3e} (bound "
          f"{GRAD_NORM_TOL:.0e}), largest entry {entry:.3e} of the tensor's max; loss gap "
          f"per step: " + " ".join(f"{g:.1e}" for g in gaps))
    check(gaps[0] <= DP_LOSS_AGREE and norm <= GRAD_NORM_TOL,
          f"(e) dilated: step-0 loss {got[0]} vs {want[0]}, gradients {r0['dilated grad']}")
    check(all(r["dilated"]["losses"] == got for r in results)
          and len({r["dilated"]["digest"] for r in results}) == 1,
          "(e) dilated: the ranks' losses or weights differ")
    print(f"phase9 (e) parameters and running statistics bitwise equal on both ranks after "
          f"{len(got)} dilated steps")
    rel = max(abs(a - b) / max(abs(b), 1e-30) for r in results
              for a, b in zip(r["eval sharded"][:3], r0["eval single"][:3]))
    print(f"phase8b DeviceEvalSet over {DP_EVAL_VIDEOS} videos sharded over two ranks vs "
          f"one: worst relative difference {rel:.3e} (bound {DP_EVAL_AGREE:.0e})")
    check(rel <= DP_EVAL_AGREE and all(r["eval sharded"][3] == r0["eval single"][3]
                                       for r in results), "8b sharded evaluation differs")
    masks = r0["mask_ms"]
    print(f"phase8b dropout masks of one pose forward: {masks[str(DP_BATCH)]:.3f} ms at the "
          f"global shape ({DP_BATCH} rows), {masks[str(DP_BATCH // 2)]:.3f} ms at a rank's "
          f"{DP_BATCH // 2}")
    for r in results:
        check(all(v > 0 for v in r["launches"].values()),
              f"8b rank {r['rank']} did not launch every K1/K2 kernel: {r['launches']}")
    print("phase8b launches per rank: " + "; ".join(
        f"rank {r['rank']} {r['launches']}" for r in results))
    return [r["launches"] for r in results]


# ---------------------------------------------------------------------------
# Phase 9: dilated-form training (--stride > 1, --dense, --disable-optimizations)
# and HumanEva (K1 at the dilated windows; K1, K2 and K3 on 15 joints)
# ---------------------------------------------------------------------------

# (a) The main path's model in the dilated form: -b 1024 --stride 2 trains 512
# chunks of 2 frames a step from windows of 244 rows; --subset 0.25 of S1 and S5
# gives 12 steps (11 of 512 chunks, one of 384).  Steps [3, 11) are timed and
# profiled: warm, and all full batches.
DIL_SUBSET = "0.25"
DIL_WINDOW = (3, 11)
DIL_STEPS = 12
# (b) --disable-optimizations and --dense at -arc 3,3,3, batch 1,024, on 10 % of
# S1 and S5: 5 steps each (dense kernels of 7 and 19 taps).
DIL_SMALL_ARCH, DIL_SMALL_SUBSET, DIL_SMALL_WINDOW = "3,3,3", "0.1", (1, 4)
# (d) HumanEva: Train/ and Validate/ splits of three subjects, three actions and
# three cameras of HE_FRAMES frames, 15 joints; the README recipe -arc 3,3,3
# -b 128 (2,700 windows with their flips: 22 steps of 128, K2 at n = 384 and 128).
HE_SPLIT_SUBJECTS = ("S1", "S2", "S3")
HE_ACTIONS = ("Walking 1 chunk0", "Jog 1 chunk0", "Box 1 chunk0")
HE_FRAMES, HE_JOINTS = 50, 15
HE_KPS_SYMMETRY = [[2, 3, 4, 8, 9, 10], [5, 6, 7, 11, 12, 13]]
HE_WINDOW = (4, 20)
# A device kernel of a matrix product (cuBLAS / CUTLASS names), for the split of
# the dilated step's profile: the 1x1 products' backward runs outside any range.
_GEMM_KERNEL = re.compile(r"gemm|xmma|cutlass", re.I)


@contextlib.contextmanager
def first_calls(module, names, key=lambda args, kwargs: None):
    """Each function ``names`` of ``module`` records its arguments at its first
    call for each ``key(args, kwargs)`` into the yielded dict (name -> key ->
    (args, kwargs)); the calls run as before."""
    record = {name: {} for name in names}
    saved = {name: getattr(module, name) for name in names}

    def recording(name, fn):
        def run(*args, **kwargs):
            record[name].setdefault(key(args, kwargs), (args, kwargs))
            return fn(*args, **kwargs)
        return run

    for name, fn in saved.items():
        setattr(module, name, recording(name, fn))
    try:
        yield record
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def dilated_ranges():
    """The dilated form's parts inside profiler ranges: K1, each tap conv's
    forward ("dilated conv") and backward ("dilated conv backward"), the 1x1
    products' forward, each BatchNorm's forward and each dropout-mask draw."""
    from torch.profiler import record_function
    from videopose3d_torch.models import temporal
    from videopose3d_torch.ops.kernels import gather_rows as gr
    saved = (temporal._conv_train, temporal.batchnorm_train, temporal.dropout_mask,
             temporal._DilatedConv.backward, gr.gather_windows)

    def ranged(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    temporal._conv_train = ranged("dilated conv", saved[0])
    temporal.batchnorm_train = ranged("dilated batchnorm", saved[1])
    temporal.dropout_mask = ranged("dilated mask draw", saved[2])
    temporal._DilatedConv.backward = staticmethod(ranged("dilated conv backward", saved[3]))
    gr.gather_windows = ranged("K1 gather_windows", saved[4])
    try:
        yield
    finally:
        (temporal._conv_train, temporal.batchnorm_train, temporal.dropout_mask) = saved[:3]
        temporal._DilatedConv.backward = staticmethod(saved[3])
        gr.gather_windows = saved[4]


def dilated_split(profiled, steps):
    """Device ms per step by part of a profiled dilated run (dilated_ranges), the
    total and the busy share of the steps' wall time."""
    from torch.autograd import DeviceType
    events = [e for e in profiled["prof"].events() if e.device_type == DeviceType.CUDA]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events if is_range(e)]
    parts = {}
    for e in events:
        if is_range(e):
            continue
        t = e.time_range.start
        inside = {name for name, a, b in spans if a <= t < b}
        if "K1 gather_windows" in inside:
            part = "K1 gather_windows"
        elif any(name.startswith("Optimizer.") for name in inside):
            part = "optimizer"
        elif "dilated mask draw" in inside:
            part = "dropout mask draws"
        elif inside & {"dilated conv", "dilated conv backward"} or _GEMM_KERNEL.search(e.name):
            part = "convolutions (products and tap copies, forward and backward)"
        elif "dilated batchnorm" in inside:
            part = "BatchNorm forward"
        else:
            part = "the rest: backward elementwise (BatchNorm, ReLU, dropout), losses"
        parts[part] = parts.get(part, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    total = sum(parts.values())
    return parts, total, total / (profiled["wall"] * 1e3 / steps)


def dilated_flops(arch, batch, chunk, c_in, channels, j3):
    """Forward FLOP of one dilated train step: every conv's products over its
    output frames (the backward is twice this)."""
    from videopose3d_torch.models.temporal import TemporalModelConfig, receptive_field
    cfg = TemporalModelConfig(c_in // 2, 2, j3 // 3, tuple(arch), channels=channels)
    t = chunk + receptive_field(cfg) - 1 - (arch[0] - 1)  # after the expand conv
    flops = 2 * batch * t * arch[0] * c_in * channels
    for i, fw in enumerate(arch[1:]):
        t -= 2 * cfg.pads[i + 1]
        flops += 2 * batch * t * (fw + 1) * channels ** 2
    return flops + 2 * batch * t * channels * j3


def k1_against_plain(what, calls):
    """K1 bitwise against its plain version on each recorded (flat, row0,
    keywords) gather (uncounted)."""
    from videopose3d_torch.ops.kernels import gather_rows as gr
    saved = dict(gr.LAUNCHES)
    for flat, row0, kwargs in calls:
        got = gr.gather_windows(flat, row0, **kwargs)
        want = gr.gather_windows_plain(flat, row0, **kwargs)
        check(torch.equal(got, want), f"{what}: K1 differs from plain")
        print(f"phase9 {what}: K1 gather_windows from {flat.shape[0]} rows of "
              f"{flat.shape[1]} float32 ({flat.shape[1] * 4} bytes): {tuple(got.shape)} "
              f"windows bitwise equal to plain")
    gr.LAUNCHES.update(saved)


def phase9a(tmp):
    """(a) The main path's model trained in the dilated form (--stride 2) through
    runner.main: K1 twice, then with --gather-impl xla, all three bitwise equal
    (epoch line, step losses, saved weights); ms/step, frames/s, peak memory;
    one profiled run split by part.  Returns the first run's launches."""
    from videopose3d_torch.checkpoint import load_any_checkpoint
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import train_block as trb
    runs = {}
    for name, extra in (("dilated", ()), ("dilated again", ()),
                        ("dilated xla gather", ("--gather-impl", "xla")),
                        ("dilated profiled", ())):
        ckpt, argv = train_argv(tmp, name, "pallas", DIL_SUBSET, ("--stride", "2", *extra))
        profiled = {} if name.endswith("profiled") else None
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with (dilated_ranges() if profiled is not None else contextlib.nullcontext()), \
                first_calls(gr, ["gather_windows"]) as k1:
            losses, numbers, rate, out, launches = train_cli(argv, profiled, DIL_WINDOW)
        peak = torch.cuda.max_memory_allocated()
        steps, seconds, fps, steady_ms = rate
        check("INFO: Training the dilated form on chunks of 2 frames (plain blocks)" in out
              and "frames/s, dilated form, device cuda" in out,
              f"{name}: no dilated-form lines:\n{out[-3000:]}")
        check(steps == DIL_STEPS, f"{name}: {steps} steps, expected {DIL_STEPS}")
        check(not any(launches[k] for k in trb.LAUNCHES), f"{name} launched K2: {launches}")
        k1_runs = launches["gather_windows"]
        check(k1_runs == (0 if "xla" in name else steps),
              f"{name}: K1 launched {k1_runs} times in {steps} steps")
        if profiled is not None:
            parts, total, busy = dilated_split(profiled, DIL_WINDOW[1] - DIL_WINDOW[0])
            check(total > 0, "the dilated profile holds no device time")
            print(f"phase9 (a) profile: steps {DIL_WINDOW[0]}-{DIL_WINDOW[1] - 1}, "
                  f"{profiled['wall'] * 1e3 / (DIL_WINDOW[1] - DIL_WINDOW[0]):.3f} ms/step "
                  f"wall, {total:.3f} ms/step device time, busy {100 * busy:.1f} %")
            for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
                print(f"phase9 (a) profile   {ms:8.3f} ms/step  {part}")
            continue
        if name == "dilated":
            k1_against_plain("(a) --stride 2", [(*a[:2], k) for a, k in
                                                k1["gather_windows"].values()])
        runs[name] = (losses, launches, ckpt, out)
        flops = 3 * dilated_flops(ARCH, 512, 2, 2 * JOINTS, CHANNELS, 3 * JOINTS)
        print(f"phase9 (a) {name:18s} -b 1024 --stride 2: {steps} steps of 512 chunks of 2 "
              f"frames in {seconds:.3f} s, {steady_ms:.2f} ms/step over steps "
              f"{DIL_WINDOW[0]}-{DIL_WINDOW[1] - 1} ({1024 / steady_ms * 1e3:.0f} training "
              f"frames/s there, {fps:.1f} over the epoch; {flops / 1e12:.2f} TFLOP a step, "
              f"{flops / (steady_ms * 1e-3) / 1e12:.1f} TFLOP/s); peak memory "
              f"{peak / 2 ** 30:.2f} GiB ({(peak - held) / 2 ** 30:.2f} GiB over the "
              f"{held / 2 ** 30:.2f} held before the run); first-step loss "
              f"{float(losses[0]):.6f}; epoch 3d_train/3d_eval/3d_valid "
              f"{numbers[0]:.4f}/{numbers[1]:.4f}/{numbers[2]:.4f} mm; launches {launches}")
    first = runs["dilated"]
    weights = lambda ckpt: load_any_checkpoint(os.path.join(ckpt, "epoch_1.bin"))["model_pos"]
    mine = weights(first[2])
    for name in ("dilated again", "dilated xla gather"):
        losses, _, ckpt, out = runs[name]
        other = weights(ckpt)
        check(epoch_line(out) == epoch_line(first[3]), f"(a) {name}: epoch line differs")
        check(torch.equal(losses, first[0]), f"(a) {name}: step losses differ")
        check(other.keys() == mine.keys() and all(
            np.array_equal(np.asarray(other[k]), np.asarray(mine[k])) for k in mine),
            f"(a) {name}: saved weights differ")
    print(f"phase9 (a) the two K1 runs and the --gather-impl xla run: epoch line, "
          f"{first[0].numel()} step losses and saved weights bitwise equal")
    # The dilated-trained checkpoint through the fused evaluation blocks (K3)
    # against the run's own final (xla) evaluation.
    from videopose3d_torch.ops.kernels import temporal_block as tb
    reset_counts()
    evaluated, fps, frames, _ = run_cli(
        ["-k", "gt", "-arc", ",".join(map(str, ARCH)), "-ch", str(CHANNELS), "-str", "S1",
         "-ste", "S9,S11", "--data-dir", os.path.join(tmp, "data"), "-c", first[2],
         "--evaluate", "epoch_1.bin", "--serving-engine", "fused", "--device", "cuda"])
    k3 = dict(tb.LAUNCHES)
    trained = protocol_lines(first[3])
    worst = max(abs(g - w) / abs(w) for a in trained for g, w in zip(evaluated[a], trained[a]))
    print(f"phase9 (a) epoch_1.bin --evaluate --serving-engine fused ({frames} frames, "
          f"{fps:.1f} frames/s) vs the run's final xla evaluation: worst relative protocol "
          f"difference {worst:.3e} (bound {AGREE['float32']:.0e}); K3 launches {k3}")
    check(evaluated.keys() == trained.keys() and worst <= AGREE["float32"]
          and all(v > 0 for v in k3.values()), f"(a) fused evaluation: {worst}, {k3}")
    return first[1], k3


def phase9b(tmp):
    """(b) --disable-optimizations and --dense at -arc 3,3,3, full width: a few
    steps each, K1 and no K2, and the saved checkpoint (dense kernels of 7 and 19
    taps) evaluates to the run's final numbers.  Returns the runs' launches."""
    from videopose3d_torch.ops.kernels import train_block as trb
    launches_all = []
    for flag in ("--disable-optimizations", "--dense"):
        ckpt = os.path.join(tmp, "train_dilated" + flag.replace("-", "_"))
        os.makedirs(ckpt)
        base = ["-k", "gt", "-arc", DIL_SMALL_ARCH, "-ch", str(CHANNELS), "-str", "S1,S5",
                "-ste", "S9,S11", "--data-dir", os.path.join(tmp, "data"), "-c", ckpt,
                "--device", "cuda", flag]
        argv = base + ["-b", "1024", "-e", "1", "-drop", "0.25", "--seed", str(SEED),
                       "--subset", DIL_SMALL_SUBSET, "--checkpoint-frequency", "1",
                       "--train-engine", "pallas"]
        losses, numbers, rate, out, launches = train_cli(argv, window=DIL_SMALL_WINDOW)
        steps, seconds, _, steady_ms = rate
        check("INFO: Training the dilated form on chunks of 1 frames (plain blocks)" in out,
              f"{flag}: no dilated-form line")
        check(launches["gather_windows"] == steps and not any(
            launches[k] for k in trb.LAUNCHES), f"{flag}: launches {launches}")
        evaluated, _, _, _ = run_cli(base + ["--evaluate", "epoch_1.bin"])
        trained = protocol_lines(out)
        worst = max(abs(g - w) / abs(w) for a in trained
                    for g, w in zip(evaluated[a], trained[a]))
        check(evaluated.keys() == trained.keys() and worst <= 1e-5,
              f"{flag}: epoch_1.bin evaluates differently: {evaluated} vs {trained}")
        print(f"phase9 (b) -arc {DIL_SMALL_ARCH} {flag}: {steps} steps of batch 1024 in "
              f"{seconds:.3f} s, {steady_ms:.2f} ms/step over steps {DIL_SMALL_WINDOW[0]}-"
              f"{DIL_SMALL_WINDOW[1] - 1}; losses {[round(v, 4) for v in losses.tolist()]}; "
              f"epoch_1.bin --evaluate vs the run's final evaluation: worst relative "
              f"protocol difference {worst:.3e}; launches {launches}")
        launches_all.append(launches)
    return launches_all


def phase9c(tmp):
    """(c) -sun with --stride 2 at phase 7's (a) shape: a warmup and a full epoch
    in the dilated form, K1 once a warmup step and twice a full one, bitwise
    against plain on both streams.  Returns the run's launches."""
    from videopose3d_torch.ops.kernels import train_block as trb
    ckpt = os.path.join(tmp, "semi_dilated")
    os.makedirs(ckpt)
    records, losses, lines, step_ms, out, launches, k1 = semi_cli(
        _semi_argv(tmp, SEMI_RECIPE, "pallas", ckpt) + ["--stride", "2"])
    warm = sum(1 for r in records if r[2])
    check("INFO: Training the dilated form on chunks of 2 frames (plain blocks)" in out,
          "(c): no dilated-form line")
    check([r[1] for r in records] == [1] * warm + [2] * (len(records) - warm),
          "(c): K1 launches per step are not 1 in warmup and 2 after")
    check(not any(launches[k] for k in trb.LAUNCHES), f"(c) launched K2: {launches}")
    check(float(lines[2].split("2d_train_unsup ")[1].split()[0]) > 0,
          f"(c) 2d_train_unsup is not positive after warmup: {lines[2]}")
    check(len(k1) == 2, "(c): K1 did not gather from both streams")
    k1_against_plain("(c) -sun --stride 2", k1)
    print(f"phase9 (c) -sun -arc {SEMI_RECIPE['arch']} -b {SEMI_RECIPE['batch']} --stride 2: "
          f"{warm} warmup + {len(records) - warm} full steps, full steps {step_ms:.3f} "
          f"ms/step; launches {launches}")
    for epoch, line in sorted(lines.items()):
        print(f"phase9 (c) [{epoch}] {line}")
    return launches


def write_humaneva(root):
    """Synthetic HumanEva-format archives (15 joints, the Train/ and Validate/
    prefixes of the preparation CLI), from SEED."""
    rng = np.random.default_rng(SEED + 9)
    subjects = [f"{split}/{s}" for split in ("Train", "Validate") for s in HE_SPLIT_SUBJECTS]
    p3 = {s: {a: (rng.standard_normal((HE_FRAMES, HE_JOINTS, 3)) * 0.2).astype(np.float32)
              for a in HE_ACTIONS} for s in subjects}
    np.savez_compressed(os.path.join(root, "data_3d_humaneva15.npz"), positions_3d=p3)
    p2 = {s: {a: [rng.uniform(50, 600, (HE_FRAMES, HE_JOINTS, 2)).astype(np.float32)
                  for _ in range(3)] for a in HE_ACTIONS} for s in subjects}
    meta = {"layout_name": "humaneva15", "num_joints": HE_JOINTS,
            "keypoints_symmetry": HE_KPS_SYMMETRY}
    np.savez_compressed(os.path.join(root, "data_2d_humaneva15_gt.npz"), positions_2d=p2,
                        metadata=meta)


def by_subject(out):
    """{subject: {action: [P1, P2, P3, MPJVE]}} of a --by-subject evaluation."""
    parts = re.split(r"^Evaluating on subject (\S+)$", out, flags=re.M)
    return {parts[i]: protocol_lines(parts[i + 1]) for i in range(1, len(parts), 2)}


def phase9d(tmp):
    """(d) HumanEva's README recipe at full width through runner.main: one epoch
    with the fused train engine (K1 on 30-column rows and K2 at n = 384 / 128,
    each held against plain on the run's own first inputs), then --evaluate
    --by-subject with the fused engine (K3 with a 45-column shrink, held against
    plain on its first inputs) against xla.  Returns the launches of the
    training and of the fused evaluation."""
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import temporal_block as tb
    from videopose3d_torch.ops.kernels import train_block as trb
    data, ckpt = os.path.join(tmp, "humaneva"), os.path.join(tmp, "train_humaneva")
    os.makedirs(data)
    os.makedirs(ckpt)
    write_humaneva(data)
    split = lambda prefix: ",".join(f"{prefix}/{s}" for s in HE_SPLIT_SUBJECTS)
    base = ["-d", "humaneva15", "-k", "gt", "--data-dir", data, "-c", ckpt, "-arc", "3,3,3",
            "-ch", str(CHANNELS), "-str", split("Train"), "-ste", split("Validate"),
            "-a", "Walk,Jog,Box", "--by-subject", "--device", "cuda"]
    with first_calls(gr, ["gather_windows"]) as k1, \
            first_calls(trb, ["fused_train_block"], key=lambda a, k: tuple(a[0].shape)) as k2:
        losses, numbers, rate, out, launches = train_cli(
            base + ["-b", "128", "-e", "1", "--seed", str(SEED), "--checkpoint-frequency",
                    "1", "--train-engine", "pallas"], window=HE_WINDOW)
    steps, seconds, _, steady_ms = rate
    check(all(v > 0 for v in launches.values()), f"(d) did not launch K1 and K2: {launches}")
    print(f"phase9 (d) HumanEva -arc 3,3,3 -b 128: {steps} steps in {seconds:.3f} s, "
          f"{steady_ms:.3f} ms/step over steps {HE_WINDOW[0]}-{HE_WINDOW[1] - 1}; epoch "
          f"3d_train/3d_eval/3d_valid {numbers[0]:.4f}/{numbers[1]:.4f}/{numbers[2]:.4f} mm; "
          f"launches {launches}")
    k1_against_plain("(d) HumanEva", [(*a[:2], k) for a, k in k1["gather_windows"].values()])
    saved = dict(trb.LAUNCHES)
    g = torch.Generator("cuda").manual_seed(SEED + 10)
    for shape, (args, kwargs) in sorted(k2["fused_train_block"].items(), reverse=True):
        leaves = [t.detach().clone() for t in args[:7]]
        rest = [None if t is None else t.detach() for t in args[7:]]
        cot = None
        results = []
        for plain in (False, True):
            ls = [t.clone().requires_grad_(True) for t in leaves]
            outs = trb.fused_train_block(*ls, *rest, **{**kwargs, "plain": plain})
            if cot is None:
                cot = torch.randn(outs[0].shape, device="cuda", generator=g) * 1e-3
            results.append([o.detach() for o in outs] + list(torch.autograd.grad(outs[0], ls, cot)))
        got, want = results
        n = shape[0] * shape[1] // kwargs["fw"]
        for nm, a, w in zip(("out", "mean_a", "var_a", "mean_b", "var_b"), got, want):
            compare(f"(d) K2 train block n={n} {nm}", a, w, torch.float32)
        rel = max(float((a.double() - w.double()).norm() / w.double().norm())
                  for a, w in zip(got[5:], want[5:]))
        check(rel <= GRAD_NORM_TOL, f"(d) K2 n={n}: gradients differ ({rel})")
        print(f"phase9 (d) K2 fused_train_block on the run's first block input {shape} "
              f"(n={n}, C={shape[2]}): outputs and statistics within tolerance of plain, "
              f"gradients within {rel:.2e} relative norm")
    trb.LAUNCHES.update(saved)

    evals = {}
    for engine in ("xla", "fused"):
        argv = base + ["--evaluate", "epoch_1.bin", "--serving-engine", engine]
        reset_counts()
        with first_calls(tb, ["fused_expand_block", "fused_dilated_block",
                              "fused_shrink_block"]) as k3:
            _, fps, frames, eval_out = run_cli(argv)
        evals[engine] = (by_subject(eval_out), dict(tb.LAUNCHES), k3, fps, frames)
    ref, xla_launches, _, _, _ = evals["xla"]
    got, k3_launches, k3, fps, frames = evals["fused"]
    # -arc 3,3,3 has two blocks: the expand stage and the shrink stage, no mid one.
    check(not any(xla_launches.values()) and k3_launches["expand"] > 0
          and k3_launches["shrink"] > 0 and not k3_launches["dilated"],
          f"(d) K3 launches: xla {xla_launches}, fused {k3_launches}")
    check(list(got) == list(ref) == [f"Validate/{s}" for s in HE_SPLIT_SUBJECTS]
          and all(list(got[s]) == list(ref[s]) == ["Walking", "Jog", "Box"] for s in ref),
          f"(d) --by-subject reports: {got} vs {ref}")
    worst = max(abs(a - b) / abs(b) for s in ref for act in ref[s]
                for a, b in zip(got[s][act], ref[s][act]))
    print(f"phase9 (d) --evaluate --by-subject fused float32 vs xla over {frames} frames "
          f"({fps:.1f} frames/s): worst relative protocol difference {worst:.3e} (bound "
          f"{AGREE['float32']:.0e}); K3 launches {k3_launches}")
    check(worst <= AGREE["float32"], f"(d) fused disagrees with xla: {worst}")
    saved = dict(tb.LAUNCHES)
    for name, calls in k3.items():
        if not calls:
            continue
        (args, kwargs), = calls.values()
        got_k, want_k = getattr(tb, name)(*args, **kwargs), getattr(tb, name + "_plain")(
            *args, **kwargs)
        torch.cuda.synchronize()
        err = float((got_k.float() - want_k.float()).abs().max())
        bound = TOL[torch.float32] * max(1.0, float(want_k.float().abs().max()))
        check(got_k.shape == want_k.shape and err <= bound,
              f"(d) {name}: {tuple(got_k.shape)} vs {tuple(want_k.shape)}, {err} > {bound}")
        print(f"phase9 (d) K3 {name} on its first input {tuple(args[0].shape)} -> "
              f"{tuple(got_k.shape)}: max_abs_err {err:.3e} (bound {bound:.3e})")
    tb.LAUNCHES.update(saved)
    return launches, k3_launches


def phase9(tmp):
    """Dilated-form training and HumanEva: (a)-(d) above ((e) runs in phase 8b).
    Returns the launches of each K1, K2 and K3 wrapper over phase 9's counted
    runs."""
    launches = {}
    parts = [*zip(("a", "a fused"), phase9a(tmp)), *(("b", l) for l in phase9b(tmp)),
             ("c", phase9c(tmp)), *zip(("d train", "d fused"), phase9d(tmp))]
    for _, counts in parts:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    print("phase9 launches per part: " + "; ".join(f"({p}) {c}" for p, c in parts))
    return launches


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


def ptxas_lines(log, name):
    """The ``-Xptxas -v`` lines (entry, registers, spills) of the kernels whose
    symbol holds ``name``."""
    out, keep = [], False
    for line in log.splitlines():
        if "entry function" in line:
            keep = name in line
        if keep and any(w in line for w in ("entry function", "registers", "spill")):
            out.append(line.strip())
    return out


def sass_count(lib_path, name, op):
    """How many SASS instructions ``op`` (e.g. HMMA, the tensor-core mma) the
    kernels of the built library whose symbol holds ``name`` have
    (``cuobjdump -sass``), or None where the toolkit has no cuobjdump."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    exe = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True, timeout=600).stdout
    count, keep, word = 0, False, re.compile(rf"\b{op}\b")
    for line in out.splitlines():
        if "Function :" in line:
            keep = name in line
        elif keep and word.search(line):
            count += 1
    return count


def int8_chain_ms(q, rows):
    """Graph time of the int8 step's products as cuBLASLt int8 matmuls
    (``torch._int_mm``, int32 sums) on ``rows`` rows: per residual block (rows,
    width * C) @ (width * C, C) and (rows, C) @ (C, C), then the bf16 shrink.  A
    yardstick of the step's tensor-core work (no epilogues, requantization, rings
    or exchange); the port never calls it.  A string where this torch build's
    ``_int_mm`` refuses the shapes."""
    g = torch.Generator(device=q.shrink_w.device).manual_seed(SEED + 9)
    wa = [b.wq_a.reshape(-1, b.wq_a.shape[-1]) for b in q.blocks]
    taps = [torch.randint(0, 128, (rows, w.shape[0]), generator=g, device=g.device,
                          dtype=torch.int8) for w in wa]
    h = taps[0][:, :wa[0].shape[1]].contiguous()
    hb = h.to(torch.bfloat16)

    def chain():
        for t, w, blk in zip(taps, wa, q.blocks):
            torch._int_mm(t, w)
            torch._int_mm(h, blk.wq_b)
        torch.matmul(hb, q.shrink_w)
    try:
        chain()
    except RuntimeError as err:
        return f"not measured (torch._int_mm: {err})"
    return f"{graph_ms(chain, reps=20):.4f} ms graph"


def bf16_chain_ms(prepared, rows):
    """Graph time of the bf16 step's products as cuBLAS bf16 tensor-core matmuls
    on ``rows`` rows: per residual block (rows, width * C) @ (width * C, C) and
    (rows, C) @ (C, C), then the shrink.  A yardstick of the step's tensor-core
    work (no epilogues, rings or exchange); the port never calls it."""
    g = torch.Generator(device=prepared["shrink_w"].device).manual_seed(SEED + 8)
    w1 = [w.reshape(-1, w.shape[-1]) for w in prepared["w1"]]
    taps = torch.randn(rows, max(w.shape[0] for w in w1), generator=g,
                       device=g.device).to(torch.bfloat16)
    h = torch.randn(rows, w1[0].shape[1], generator=g, device=g.device).to(torch.bfloat16)

    def chain():
        for wa, wb in zip(w1, prepared["w2"]):
            torch.matmul(taps[:, :wa.shape[0]], wa)
            torch.matmul(h, wb)
        torch.matmul(h, prepared["shrink_w"])
    return graph_ms(chain, reps=20)


def phase6_kernels(cfg, model, q, device):
    """K7, K5 and K6 against their plain versions at B = 1,024 streams, through
    every ring's wrap, and their times."""
    from videopose3d_torch import streaming as st
    from videopose3d_torch.ops.kernels import build
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    saved = dict(sf.LAUNCHES)
    fq = st.prepare_int8_fused(q)
    g = torch.Generator(device=device).manual_seed(SEED + 6)
    rand = lambda *shape: torch.rand(shape, generator=g, device=device) * 2 - 1
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    prepared = st.prepare_bf16_fused(bcfg, model)
    b, c, k = STREAM_B, CHANNELS, STREAM_K
    j3 = q.shrink_w.shape[1]
    widths = cfg.filter_widths[1:]
    caps = st._buffer_capacities(cfg)
    first = rand(b, JOINTS, 2)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    results = {}

    def record(key, where, err, ms, plain_ms, bound, library_ms=None):
        bound_ms, bound_by = bound
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        print(f"phase6 {key:18s} {where}: max_abs_err {err:.3e}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms ({bound_by})")
        source = STREAM_SOURCES.get(key.replace("_multi", ""), STREAM_SOURCE)
        results[key] = {"name": f"{key} ({where})", "route": "cuda", "source": source,
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
    # K7 at rows off the 16-byte word (120 and 3,000 bytes): any slot offset, bitwise.
    for dt, rb, rc in K7_ODD_ROWS:
        ring = (rand(19, rb, rc) * 100).to(dt)
        row = (rand(rb, rc) * 100).to(dt)
        for slot in (0, 7, 18):
            got = sf.ring_push(ring.clone(), slot, row)
            want = sf.ring_push_plain(ring.clone(), slot, row)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"ring_push ({rb}, {rc}) {dt} slot {slot}: "
                                          "kernel and plain version differ")
        print(f"phase6 ring_push ({rb}, {rc}) {str(dt)[6:]} rows of "
              f"{nbytes(row)} bytes at slots 0, 7, 18 of 19: bitwise equal to plain")
    del ring, row

    def pose_err(got, want, tol, what):
        err = float((got - want).abs().max())
        bound = tol * max(1.0, float(want.abs().max()))
        check(bool(torch.isfinite(got).all()) and err <= bound,
              f"{what}: pose error {err} > {bound}")
        return err

    def int8_rings_bitwise(key, scfg, sw, first_frames, kk):
        """Steps the fused int8 engine (on the prepared weights ``sw``) and the
        per-layer plain one (on ``sw.q``) from one state
        over max(cap) + 3 frames (per frame) or max(cap) + 3k frames (k per step):
        every ring bitwise at every step, poses at STREAM_POSE_TOL.  Returns (the
        plain state, the ring capacities, the steps, the largest pose error)."""
        multi = kk > 1
        a = (st.init_stream_state_int8_multi(scfg, sw.q, first_frames, kk) if multi
             else st.init_stream_state_int8(scfg, sw.q, first_frames))
        p = _clone_state(a)
        scaps = [r.shape[0] // (2 if multi else 1) for r in a["bufs"]]
        steps = (max(scaps) + 3 * kk) // kk
        err = 0.0
        n = first_frames.shape[0]
        for t in range(steps):
            x = rand(n, kk, JOINTS, 2) if multi else rand(n, JOINTS, 2)
            fused = st.stream_step_int8_multi_fused if multi else st.stream_step_int8_fused
            plain = st.stream_step_int8_multi if multi else st.stream_step_int8
            got, a = fused(scfg, sw, a, x)
            want, p = plain(scfg, sw.q, p, x)
            check(all(torch.equal(r, s) for r, s in zip(a["bufs"], p["bufs"])),
                  f"{key}: an int8 ring differs from the plain version's at step {t}")
            err = max(err, pose_err(got, want, STREAM_POSE_TOL, f"{key} step {t}"))
        return p, scaps, steps, err

    # K5 and K6, int8: every ring bitwise at every step; then from one state two
    # launches bitwise equal, timed by CUDA-graph replay beside one call, with the
    # plan and a cuBLASLt int8 chain of the step's products as a yardstick.
    for key, multi in (("stream_int8", False), ("stream_int8_multi", True)):
        kk = k if multi else 1
        p, scaps, steps, err = int8_rings_bitwise(key, cfg, fq, first, kk)
        eq = torch.randint(0, 128, (kk, b, c), generator=g, device=device, dtype=torch.int8)
        idx, lags = st._slots(cfg, p["ptr"], scaps, multi=multi)
        a = _clone_state(p)
        if multi:
            run = lambda f, s: f(fq, s["bufs"][1:], eq, idx, widths=widths, lags=lags,
                                 caps=scaps[1:], k=kk)
            kern, plain_fn = sf.fused_blocks_step_multi, sf.fused_blocks_step_multi_plain
        else:
            run = lambda f, s: f(fq, s["bufs"][1:], eq[0], idx, widths=widths)
            kern, plain_fn = sf.fused_blocks_step, sf.fused_blocks_step_plain
        # Two launches from one state give equal poses and rings (no atomics; the
        # cluster's slices meet in a fixed order).
        twice = [(run(kern, s)[0], s) for s in (_clone_state(p), _clone_state(p))]
        torch.cuda.synchronize()
        check(torch.equal(twice[0][0], twice[1][0])
              and all(torch.equal(r, s) for r, s in zip(twice[0][1]["bufs"],
                                                         twice[1][1]["bufs"])),
              f"{key}: two launches from one state differ")
        del twice
        ms, plain_ms = graph_ms(lambda: run(kern, a), reps=20), graph_ms(
            lambda: run(plain_fn, p), reps=20)
        record(key, f"int8, B={b}, C={c}, k={kk}, {steps} steps, rings bitwise, repeat "
               "bitwise, CUDA-graph timed", err, ms, plain_ms,
               roofline(*stream_cost(True, widths, lags, b, c, kk, j3, multi)))
        print(f"phase6 {key} one call between CUDA events (host enqueue included): "
              f"kernel {cuda_ms(lambda: run(kern, a)):.4f} ms, plain "
              f"{cuda_ms(lambda: run(plain_fn, p)):.4f} ms; plan (rows, column slices) "
              f"{sf.stream_int8_plan(b, kk, c, sms)}; cuBLASLt int8 chain of the step's "
              f"products (torch._int_mm; yardstick, not a port path) "
              f"{int8_chain_ms(q, kk * b)}")
        del a, p

    phase6_graph(cfg, q, fq, device, first, rand, record)

    # The int8 step at C % 16 != 0: every ring bitwise through every wrap.
    ocfg, omodel = random_model(device, causal=True, channels=STREAM_ODD_CHANNELS)
    from videopose3d_torch.models.temporal import receptive_field
    from videopose3d_torch.ops.kernels.temporal_block_int8 import quantize_temporal_model
    calib = rand(2, receptive_field(ocfg) + 64, JOINTS, 2)
    oq = st.prepare_int8_fused(quantize_temporal_model(ocfg, omodel, calib))
    _, _, steps, err = int8_rings_bitwise("stream_int8 (odd width)", ocfg, oq,
                                          rand(STREAM_ODD_B, JOINTS, 2), 1)
    print(f"phase6 stream_int8 at C={STREAM_ODD_CHANNELS} (rows not 16-byte aligned), "
          f"B={STREAM_ODD_B}, {steps} steps: every ring bitwise, pose error {err:.3e}; plan "
          f"{sf.stream_int8_plan(STREAM_ODD_B, 1, STREAM_ODD_CHANNELS, sms)}")
    del ocfg, omodel, oq
    for line in ptxas_lines(build.build_log, "stream_int8_kernel"):
        print(f"phase6 stream_int8_kernel ptxas: {line}")
    imma = sass_count(build.library_path(), "stream_int8_kernel", "IMMA")
    print(f"phase6 stream_int8_kernel SASS (cuobjdump -sass): "
          f"{'no cuobjdump' if imma is None else f'{imma} IMMA instructions'}")
    check(imma != 0, "stream_int8_kernel has no int8 tensor-core (IMMA) instruction")

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
        # Two launches from one state give equal bits (no atomics; the cluster's
        # column slices meet in a fixed order).
        twice = [run(kern, _clone_state(p))[0] for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(*twice), f"{key}: two launches from one state differ")
        del twice
        # Device time by CUDA-graph replay (one call's host enqueue, ~0.1 ms of
        # checks and ctypes, is as long as the kernel); one call printed beside it.
        ms, plain_ms = graph_ms(lambda: run(kern, a), reps=20), graph_ms(
            lambda: run(plain_fn, p), reps=20)
        record(key, f"bf16, B={b}, C={c}, k={kk}, {steps} steps from a shared state, "
               "repeat bitwise, CUDA-graph timed", err, ms, plain_ms,
               roofline(*stream_cost(False, widths, lags, b, c, kk, j3, multi)))
        print(f"phase6 {key} one call between CUDA events (host enqueue included): "
              f"kernel {cuda_ms(lambda: run(kern, a)):.4f} ms, plain "
              f"{cuda_ms(lambda: run(plain_fn, p)):.4f} ms; plan (rows, column slices) "
              f"{sf.stream_bf16_plan(b, kk, c, sms)}; cuBLAS bf16 chain of the step's "
              f"products (yardstick, not a port path) {bf16_chain_ms(prepared, kk * b):.4f} "
              "ms graph")
        del a, p

    for line in ptxas_lines(build.build_log, "stream_bf16_kernel"):
        print(f"phase6 stream_bf16_kernel ptxas: {line}")
    hmma = sass_count(build.library_path(), "stream_bf16_kernel", "HMMA")
    print(f"phase6 stream_bf16_kernel SASS (cuobjdump -sass): "
          f"{'no cuobjdump' if hmma is None else f'{hmma} HMMA instructions'}")
    check(hmma != 0, "stream_bf16_kernel has no tensor-core (HMMA) instruction")

    # K6 against K5 over the same 64 frames: equal int8 history, poses at the bound.
    one = st.init_stream_state_int8(cfg, q, first)
    multi = st.init_stream_state_int8_multi(cfg, q, first, k)
    frames = rand(b, 64, JOINTS, 2)
    per_frame = []
    for t in range(64):
        pose, one = st.stream_step_int8_fused(cfg, fq, one, frames[:, t])
        per_frame.append(pose)
    stepped = []
    for t in range(0, 64, k):
        pose, multi = st.stream_step_int8_multi_fused(cfg, fq, multi, frames[:, t:t + k])
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


def phase6_graph(cfg, q, fq, device, first, rand, record):
    """The lifter's per-frame int8_fused dispatch as one CUDA graph (the front F,
    K5 on the ring positions on the card, their advance): poses and every ring
    bitwise against the eager step over two wraps of the largest ring, the positions
    on the card equal to the host's after each; F and the advance kernel alone
    against their plain versions and their bounds (``record``ed as phase 6's
    kernels); the graph dispatch's host enqueue, one replay and the closed loop
    (poses to the host) beside the eager dispatch's."""
    from videopose3d_torch import streaming as st
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    b, c = first.shape[0], CHANNELS
    caps = st._buffer_capacities(cfg)
    lifter = st.StreamingCausalLifter(cfg, engine="int8_fused", quantized=q, device=device)
    lifter.reset(first)
    check(lifter._graph is not None, "the int8_fused lifter made no CUDA graph")
    eager = _clone_state(lifter._stream_state)
    steps = 2 * max(caps) + 3
    for t in range(steps):
        x = rand(b, JOINTS, 2)
        got = lifter.step(x.cpu().numpy() if t % 2 else x)
        want, eager = st.stream_step_int8_fused(cfg, fq, eager, x)
        check(torch.equal(got, want) and lifter._stream_state["ptr"] == eager["ptr"]
              and all(torch.equal(r, e) for r, e in zip(lifter._stream_state["bufs"],
                                                         eager["bufs"])),
              f"graph dispatch {t}: the poses or a ring differ from the eager step's")
        check(lifter._graph.pos.tolist() == eager["ptr"],
              f"graph dispatch {t}: positions on the card {lifter._graph.pos.tolist()}, "
              f"on the host {eager['ptr']}")
    print(f"phase6 graph dispatch: {steps} dispatches of B={b}, C={c} (host and card frames "
          f"in turn), poses and every ring bitwise equal to stream_step_int8_fused, the "
          f"positions on the card equal to the host's")

    # The advance kernel alone at the main path's capacities, through two wraps of the
    # largest ring: bitwise against its plain version at every step.
    pos = torch.zeros(len(caps), dtype=torch.int32, device=device)
    want_pos = pos.clone()
    caps_on_card = torch.tensor(caps, dtype=torch.int32, device=device)  # a graph copies none
    for t in range(steps):
        sf.ring_advance(pos, caps)
        sf.ring_advance_plain(want_pos, caps)
        check(torch.equal(pos, want_pos),
              f"ring_advance step {t}: kernel {pos.tolist()}, plain {want_pos.tolist()}")
    # Each position read and written once (int32).
    record("ring_advance", f"positions of rings of {tuple(caps)} rows, {steps} steps, "
           "bitwise, CUDA-graph timed", 0.0, graph_ms(lambda: sf.ring_advance(pos, caps)),
           graph_ms(lambda: sf.ring_advance_plain(want_pos, caps_on_card)),
           roofline([], 2 * nbytes(pos)))

    # F alone: eq and the raw ring bitwise, then graph-timed beside its plain version.
    k0, c_in, _ = q.expand_w.shape
    w0 = q.expand_w.reshape(k0 * c_in, c).contiguous()
    rows = rand(b, JOINTS * 2)
    raw, want_raw = eager["bufs"][0].clone(), eager["bufs"][0].clone()
    pos = torch.tensor(eager["ptr"], dtype=torch.int32, device=device)
    eq = torch.empty(b, c, dtype=torch.int8, device=device)
    front = lambda: sf.stream_front(rows, raw, pos, w0, q.expand_scale, q.expand_shift, eq)
    front()
    want = sf.stream_front_plain(rows, want_raw, eager["ptr"][0], w0, q.expand_scale,
                                 q.expand_shift)
    torch.cuda.synchronize()
    check(torch.equal(eq, want) and torch.equal(raw, want_raw),
          "stream_front: kernel and plain version differ")
    plain = lambda: sf.stream_front_plain(rows, raw, eager["ptr"][0], w0, q.expand_scale,
                                          q.expand_shift)
    # The frame read once, the ring's k0 - 1 older rows read and one written (bf16),
    # the weights, the affine and eq written.
    n_bytes = nbytes(rows, w0, q.expand_scale, q.expand_shift, eq) + k0 * b * c_in * 2
    record("stream_front", f"int8 expand of B={b} from the raw ring at a position on the "
           f"card, C={c}, bitwise, CUDA-graph timed", 0.0, graph_ms(front), graph_ms(plain),
           roofline([("float64", 2 * b * k0 * c_in * c)], n_bytes))

    # The host's time in one dispatch called on an idle card (the stream cell's
    # stream.enqueue_ms: back to back, the single staging tensor holds the host to the
    # card's pace), one replay between CUDA events, and the closed loop of the stream
    # cell (each dispatch's poses to the host before the next), for the graph and for
    # the eager dispatch it replaces.
    host = rand(b, JOINTS, 2).cpu().numpy()
    eager_step = lambda: st.stream_step_int8_fused(cfg, fq, eager, torch.from_numpy(host)
                                                   .to(device))

    def idle_enqueue_ms(fn, n=200):
        seconds = 0.0
        for _ in range(n):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            seconds += time.perf_counter() - start
        torch.cuda.synchronize()
        return seconds / n * 1e3

    def closed_loop_ms(fn, n=200):
        fn().cpu()
        start = time.perf_counter()
        for _ in range(n):
            fn().cpu()
        return (time.perf_counter() - start) / n * 1e3

    graph_host = idle_enqueue_ms(lambda: lifter.step(host))
    replay = cuda_ms(lifter._graph.graph.replay, runs=50)
    graph_loop = closed_loop_ms(lambda: lifter.step(host))
    eager_host = idle_enqueue_ms(lambda: eager_step()[0], n=50)
    eager_one = cuda_ms(eager_step, runs=20)
    eager_loop = closed_loop_ms(lambda: eager_step()[0])
    print(f"phase6 graph dispatch of B={b}: host enqueue {graph_host:.4f} ms, one replay "
          f"{replay:.4f} ms (CUDA events), closed loop {graph_loop:.4f} ms; eager dispatch: "
          f"host enqueue {eager_host:.4f} ms, one call {eager_one:.4f} ms, closed loop "
          f"{eager_loop:.4f} ms")


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


# Engine, compute dtype, frames per step, the kernels the run must launch (int8_fused
# per frame: the lifter's CUDA graph, F, K5 and the positions' advance a replay).
STREAM_RUNS = (("bf16", "float32", 1, ()), ("bf16", "bfloat16", 1, ()),
               ("bf16_fused", "bfloat16", 1, ("stream_bf16",)), ("int8", "float32", 1, ()),
               ("int8_fused", "float32", 1, ("stream_int8", "stream_front", "ring_advance")),
               ("bf16_fused", "bfloat16", STREAM_K, ("stream_bf16_multi",)),
               ("int8_fused", "float32", STREAM_K, ("stream_int8_multi",)))


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
    runs, launches, rates_k1 = {}, {}, {}
    for engine, dt, k, keys in STREAM_RUNS:
        reset_counts()
        poses, rate, _ = stream_cli(argv(engine, dt, k, f"{engine}_{dt}_{k}.npz"))
        if k == 1:
            rates_k1[(engine, dt)] = rate
        counts = dict(sf.LAUNCHES)
        check(all(v == 0 for name, v in counts.items() if name not in keys)
              and all(counts[key] > 0 for key in keys),
              f"{engine} {dt} k={k}: launched {counts}, expected only {keys}")
        launches.update({key: counts[key] for key in keys})
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

    print(f"phase6 streaming CLI at k=1: bf16_fused {rates_k1[('bf16_fused', 'bfloat16')]:.0f} "
          f"poses/s against the per-layer bf16 (bfloat16) engine's "
          f"{rates_k1[('bf16', 'bfloat16')]:.0f} in the same run")

    # Where the time goes: one profiled run of each fused engine at k = 1 (not
    # counted).
    from torch.profiler import ProfilerActivity, profile
    for engine, dt, kernel_name in (("int8_fused", "float32", "stream_int8_kernel"),
                                    ("bf16_fused", "bfloat16", "stream_bf16_kernel")):
        start = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, rate, _ = stream_cli(argv(engine, dt, 1, "profiled.npz"))
        wall = time.perf_counter() - start
        window = STREAM_VIDEOS * STREAM_FRAMES / rate
        device_us = device_times(prof)
        check(device_us, f"the {engine} profile holds no device time")
        total = sum(device_us.values())
        kernel = sum(us for name, us in device_us.items() if kernel_name in name)
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
        print(f"phase6 profile of one {engine} CLI run: wall {wall:.3f} s, streaming "
              f"window {window:.3f} s, device time {total / 1e6:.3f} s, busy "
              f"{100 * total / 1e6 / wall:.1f} % of the wall and "
              f"~{100 * total / 1e6 / window:.1f} % of the window, the K5 kernel "
              f"{100 * kernel / max(total, 1):.1f} % of device time "
              f"({kernel / 1e3 / STREAM_FRAMES:.4f} ms per launch at B={STREAM_VIDEOS})")
        for name, us in top:
            print(f"phase6 profile   {us / 1e3:9.3f} ms  {name[:90]}")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: videos in the wild, rendering, instrumented training, host cores
# ---------------------------------------------------------------------------

WILD_VIDEOS = ("wild_0.mp4", "wild_1.mp4")
WILD_FRAMES = 3000
WILD_GAPS = 12  # frames of each video without any detection
# Exports against xla's, in units of its max |pose| (the evaluation's protocol bounds).
WILD_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
WILD_INT8_REL = 0.1  # int8: mean per-joint error below this share of xla's RMS
# matplotlib is not among the card environment's Python packages (PIL is), so
# this phase renders no GIF and no training curve: the GIFs and the curves'
# PNGs are held byte for byte against the JAX package's on the CPU
# (tests/test_torch_render.py, tests/test_torch_profiling.py).
INSTRUMENTED = dict(subset="0.1", epochs=5, resume_from=2)
# Human3.6M's training size, as tools/make_scale_archives.py writes it: 5 subjects
# x 30 actions x 4 cameras = 600 sequences of 2,600 frames (1.56 M frames).
SAMPLER_SEQS, SAMPLER_FRAMES = 600, 2600
CKPT_REPS = 3
EPOCH_LINE = re.compile(r"^\[(\d+)\] time \S+ (lr \S+ 3d_train \S+ 3d_eval \S+ 3d_valid \S+)$")
METRIC_KEYS = {"epoch", "lr", "bn_momentum", "loss_3d_train", "step_steps", "step_mean_ms",
               "step_p50_ms", "step_p95_ms", "step_max_ms"}
# The kernels of train_block.cu that every full-width training step launches.
K2_CUDA_KERNELS = ("tap_gemm_kernel", "norm_drop_kernel", "relu_mask_bn_sums_kernel",
                   "bn_grad_kernel", "dw_gemm_kernel")


def write_detections(root):
    """Detectron-format .npz files (what inference/infer_video*.py writes) for
    WILD_VIDEOS at 1,920 x 1,080: two people per frame in the COCO layout, the
    best-scored one walking, and WILD_GAPS frames with no detection."""
    rng = np.random.default_rng(SEED + 11)
    n = WILD_FRAMES
    for name in WILD_VIDEOS:
        boxes, keypoints = np.empty((n, 2), object), np.empty((n, 2), object)
        walk = (rng.uniform([500, 300], [1400, 800]) + rng.normal(0, 80, (JOINTS, 2))
                + np.cumsum(rng.normal(0, 3, (n, JOINTS, 2)), axis=0))
        gaps = set(rng.choice(np.arange(1, n - 1), WILD_GAPS, replace=False).tolist())
        for i in range(n):
            boxes[i, 0], keypoints[i, 0] = [], []
            if i in gaps:
                boxes[i, 1] = np.zeros((0, 5), np.float32)
                keypoints[i, 1] = np.zeros((0, 4, JOINTS), np.float32)
                continue
            people = rng.uniform(0, 1, (2, 4, JOINTS)).astype(np.float32)
            people[0, :2] = walk[i].T
            people[1, :2] = rng.uniform(0, 1080, (2, JOINTS))
            bbs = rng.uniform(0, 1000, (2, 5)).astype(np.float32)
            bbs[:, 4] = [0.95, 0.4]
            boxes[i, 1], keypoints[i, 1] = bbs, people
        np.savez(os.path.join(root, name + ".npz"), boxes=boxes, keypoints=keypoints,
                 segments=np.array([None] * n, dtype=object),
                 metadata={"w": 1920, "h": 1080})


def count_launches():
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    from videopose3d_torch.ops.kernels import temporal_block as tb
    from videopose3d_torch.ops.kernels import temporal_block_int8 as tq
    from videopose3d_torch.ops.kernels import train_block as trb
    return {name: dict(m.LAUNCHES) for name, m in (("K1", gr), ("K2", trb), ("K3", tb),
                                                     ("K4", tq), ("K5-K7", sf))}


def reset_all_counts():
    from videopose3d_torch.ops.kernels import gather_rows as gr
    from videopose3d_torch.ops.kernels import train_block as trb
    reset_counts()
    for counts in (gr.LAUNCHES, trb.LAUNCHES):
        for k in counts:
            counts[k] = 0


def render_cli(argv):
    """runner.main --render in-process; returns (the --viz-export poses, the
    seconds of its evaluate() calls, launches by kernel group, output)."""
    from videopose3d_torch import runner
    evaluate, spent = runner.evaluate, []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = evaluate(*args, **kwargs)
        spent.append(time.perf_counter() - start)  # returns host numpy: synchronised
        return out

    reset_all_counts()
    buf = io.StringIO()
    runner.evaluate = timed
    try:
        with contextlib.redirect_stdout(buf):
            runner.main(argv)
    finally:
        runner.evaluate = evaluate
    torch.cuda.synchronize()
    poses = np.load(argv[argv.index("--viz-export") + 1])
    check(np.isfinite(poses).all(), "render export: non-finite poses")
    return poses, sum(spent), count_launches(), buf.getvalue()


def phase10a(tmp, model):
    """The in-the-wild flow through the port's CLIs: Detectron detections ->
    data.prepare.custom_2d -> -d custom --evaluate --render --viz-export with
    each engine; the fused exports against xla's, the launches per engine, and
    the trajectory model added from a checkpoint that has one."""
    from videopose3d_torch.data.prepare import custom_2d
    from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig
    from videopose3d_torch.ops.kernels import temporal_block_int8 as tq
    dets, data = os.path.join(tmp, "wild_dets"), os.path.join(tmp, "wild_data")
    ckpt = os.path.join(tmp, "checkpoint")
    os.makedirs(dets)
    write_detections(dets)
    with contextlib.redirect_stdout(io.StringIO()):
        custom_2d.main(["-i", dets, "-o", "wild", "--data-dir", data])
    torch.manual_seed(SEED + 12)
    traj = TemporalModel(TemporalModelConfig(JOINTS, 2, 1, ARCH, channels=CHANNELS))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": 0, "lr": 0.001, "model_pos": state, "optimizer": None,
                "model_traj": {k: v.detach() for k, v in traj.state_dict().items()}},
               os.path.join(ckpt, "random_with_traj.bin"))

    def argv(engine, dtype="float32", checkpoint="random_full_width.bin",
             video=WILD_VIDEOS[0]):
        return ["-d", "custom", "-k", "wild", "--data-dir", data, "-c", ckpt,
                "-arc", ",".join(map(str, ARCH)), "-ch", str(CHANNELS),
                "--evaluate", checkpoint, "--serving-engine", engine,
                "--compute-dtype", dtype, "--render", "--viz-subject", video,
                "--viz-action", "custom", "--viz-camera", "0", "--viz-export",
                os.path.join(tmp, f"wild_{engine}_{dtype}_{checkpoint}.npy"),
                "--device", "cuda"]

    poses, launches = {}, {}
    for run, (engine, dtype) in (("xla", ("xla", "float32")),
                                 ("fused float32", ("fused", "float32")),
                                 ("fused bfloat16", ("fused", "bfloat16")),
                                 ("int8 slice", ("int8", "float32")),
                                 ("int8 accshift", ("int8", "float32"))):
        saved_min_d = tq.ACCSHIFT_MIN_DILATION
        if run == "int8 accshift":
            tq.ACCSHIFT_MIN_DILATION = 0  # every block in the accshift tap mode
        try:
            # A first call pays the engine's one-time setup (cuDNN's, the
            # kernel modules'); the second is the measured and counted run.
            warm, _, _, _ = render_cli(argv(engine, dtype))
            pose, seconds, counts, out = render_cli(argv(engine, dtype))
        finally:
            tq.ACCSHIFT_MIN_DILATION = saved_min_d
        check(engine == "xla" or np.array_equal(warm, pose), f"{run}: two runs differ")
        check(pose.shape == (WILD_FRAMES, JOINTS, 3), f"{run}: export shape {pose.shape}")
        check("this action is unlabeled" in out, f"{run}: no unlabeled note:\n{out}")
        ran = {g: sum(c.values()) for g, c in counts.items()}
        expect = {"xla": set(), "fused float32": {"K3"}, "fused bfloat16": {"K3"},
                  "int8 slice": {"K4"}, "int8 accshift": {"K4"}}[run]
        check({g for g, n in ran.items() if n} == expect,
              f"{run} launched {ran}, expected only {expect}")
        poses[run], launches[run] = pose, counts
        print(f"phase10 (a) wild {run:14s}: {WILD_FRAMES} frames predicted in "
              f"{seconds * 1e3:.1f} ms ({WILD_FRAMES / seconds:.1f} frames/s with TTA, the "
              f"model's operands prepared in the call; the kernels' runs bitwise equal), "
              f"launches {counts[next(iter(expect))] if expect else 0}")
    ref = poses["xla"]
    scale = float(np.abs(ref).max())
    for dtype, bound in WILD_TOL.items():
        err = float(np.abs(poses[f"fused {dtype}"] - ref).max())
        print(f"phase10 (a) fused {dtype} vs xla: max |diff| {err:.3e} = "
              f"{err / scale:.3e} of max |pose| {scale:.4f} (bound {bound:.1e})")
        check(err <= bound * scale, f"fused {dtype} export disagrees with xla: {err}")
    rms = float(np.sqrt(np.mean(ref ** 2)))
    for mode in ("slice", "accshift"):
        mpjpe = float(np.linalg.norm(poses[f"int8 {mode}"] - ref, axis=-1).mean())
        print(f"phase10 (a) int8 {mode} vs xla: mean per-joint error {mpjpe:.4e} "
              f"= {mpjpe / rms:.3e} of the RMS {rms:.4f} (bound {WILD_INT8_REL})")
        check(mpjpe < WILD_INT8_REL * rms, f"int8 {mode} export disagrees with xla")
    check(np.array_equal(poses["int8 slice"], poses["int8 accshift"]),
          "int8 accshift export differs from slice")
    # A checkpoint with a trajectory model: the unlabeled video's poses move by
    # the predicted root trajectory, alike for every joint.
    with_traj, _, counts, _ = render_cli(argv("fused", checkpoint="random_with_traj.bin"))
    shift = with_traj - poses["fused float32"]
    spread = float(np.abs(shift - shift[:, :1]).max())
    print(f"phase10 (a) trajectory added: max |shift| {np.abs(shift).max():.4f}, "
          f"spread across joints {spread:.2e}, launches {counts['K3']}")
    check(np.abs(shift).max() > 1e-3 and spread <= 1e-5 * max(1.0, scale),
          "the trajectory model's prediction was not added to every joint")
    return {("fused", "float32"): launches["fused float32"]["K3"],
            ("fused", "bfloat16"): launches["fused bfloat16"]["K3"],
            ("int8", "slice"): launches["int8 slice"]["K4"],
            ("int8", "accshift"): launches["int8 accshift"]["K4"]}


def phase10b(tmp, cfg, model):
    """--evaluate --render of a labeled Human3.6M video through the fused
    engine: the export equals evaluate(..., return_predictions=True) called
    directly on the same video."""
    from videopose3d_torch import runner
    from videopose3d_torch.arguments import parse_args
    from videopose3d_torch.data.generators import UnchunkedBatcher
    from videopose3d_torch.evaluate import Evaluator, evaluate
    export = os.path.join(tmp, "h36m_render.npy")
    argv = ["-k", "gt", "-arc", ",".join(map(str, ARCH)), "-ch", str(CHANNELS),
            "--data-dir", os.path.join(tmp, "data"), "-c", os.path.join(tmp, "checkpoint"),
            "--evaluate", "random_full_width.bin", "--serving-engine", "fused", "--render",
            "--viz-subject", "S9", "--viz-action", "Walking 1", "--viz-camera", "0",
            "--viz-export", export, "--device", "cuda"]
    got, seconds, counts, out = render_cli(argv)
    check("Rendering..." in out and "this action is unlabeled" not in out,
          f"the Human3.6M rendering did not run with ground truth:\n{out}")
    args = parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        dataset = runner.load_dataset(args)
        runner.prepare_dataset_3d(dataset)
        keypoints, _, kps_left, kps_right = runner.load_2d_detections(args, dataset)
    skeleton = dataset.skeleton()
    kps_perm = runner._flip_perm_from_lists(JOINTS, kps_left, kps_right)
    joints_perm = runner._flip_perm_from_lists(skeleton.num_joints(), skeleton.joints_left(),
                                               skeleton.joints_right())
    pad = (receptive_field_of(ARCH) - 1) // 2
    batcher = UnchunkedBatcher(None, None, [keypoints["S9"]["Walking 1"][0]], pad=pad,
                               augment=True, kps_flip_perm=kps_perm,
                               joints_flip_perm=joints_perm)
    want = evaluate(Evaluator(cfg, joints_flip_perm=joints_perm, engine="fused",
                              device=next(model.parameters()).device),
                    model, batcher, return_predictions=True)
    check(got.shape == want.shape == (1500, JOINTS, 3) and np.array_equal(got, want),
          f"the render export differs from evaluate(return_predictions=True): "
          f"{got.shape} vs {want.shape}, max |diff| {np.abs(got - want).max()}")
    print(f"phase10 (b) Human3.6M render S9 'Walking 1' camera 0, fused: export "
          f"{got.shape} bitwise equal to evaluate(return_predictions=True); predicted in "
          f"{seconds * 1e3:.1f} ms, K3 launches {counts['K3']}")


def phase10c(tmp):
    """Instrumented training: phase 4's model and data for INSTRUMENTED epochs
    with --profile-dir, --metrics-log and a checkpoint per epoch (written by
    the asynchronous checkpointer); the trace, the records, and a resume from
    epoch 2 whose epoch 3 equals the uninterrupted run's.  Returns the K1/K2
    launches."""
    from videopose3d_torch import runner
    epochs, first = INSTRUMENTED["epochs"], INSTRUMENTED["resume_from"]
    trace_dir, metrics = os.path.join(tmp, "trace"), os.path.join(tmp, "metrics.jsonl")
    ckpt, argv = train_argv(tmp, "instrumented", "pallas", subset=INSTRUMENTED["subset"])
    argv[argv.index("-e") + 1] = str(epochs)
    reset_all_counts()
    buf = io.StringIO()
    start = time.perf_counter()
    with k2_ranges(), contextlib.redirect_stdout(buf):
        runner.main(argv + ["--profile-dir", trace_dir, "--metrics-log", metrics])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = count_launches()
    launches = {**counts["K1"], **counts["K2"]}
    check(all(v > 0 for v in launches.values()), f"instrumented run launches {launches}")
    check(not any(counts["K3"].values()) and not any(counts["K4"].values()),
          f"instrumented training launched evaluation kernels: {counts}")
    out = buf.getvalue()
    lines = {int(m.group(1)): m.group(2) for m in map(EPOCH_LINE.match, out.splitlines())
             if m}
    check(sorted(lines) == list(range(1, epochs + 1)), f"epoch lines:\n{out}")
    # The trace of the first epoch: one Chrome trace that names K1's kernel, the
    # kernels of K2 and the K2 wrappers' ranges on the device timeline.
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    check(len(traces) == 1, f"trace files {os.listdir(trace_dir)}")
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    ranges = {e["name"] for e in events if e.get("cat") == "gpu_user_annotation"}
    from videopose3d_torch.ops.kernels import train_block as trb
    missing = ([k for k in ("window_kernel",) + K2_CUDA_KERNELS
                if not any(k in name for name in kernels)]
               + [f"K2 {k}" for k in trb.LAUNCHES if f"K2 {k}" not in ranges])
    size_mb = os.path.getsize(os.path.join(trace_dir, traces[0])) / 1e6
    print(f"phase10 (c) trace {traces[0]} ({size_mb:.1f} MB): {len(events)} events, "
          f"{sum(kernels.values())} kernel launches of {len(kernels)} kernels, K2 ranges "
          f"{sorted(r for r in ranges if r.startswith('K2 '))}")
    for name, n in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"phase10 (c) trace kernel {n:6d} x {name[:100]}")
    check(not missing, f"the trace lacks {missing}")
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    check([r["epoch"] for r in records] == list(range(1, epochs + 1))
          and all(set(r) == METRIC_KEYS for r in records),
          f"metrics records {records}")
    for r in records:
        print(f"phase10 (c) metrics epoch {r['epoch']}: lr {r['lr']:.6f} bn_momentum "
              f"{r['bn_momentum']:.6f} loss_3d_train {r['loss_3d_train']:.6f} m, "
              f"{r['step_steps']} steps, host ms/step mean {r['step_mean_ms']:.3f} p50 "
              f"{r['step_p50_ms']:.3f} p95 {r['step_p95_ms']:.3f} max {r['step_max_ms']:.3f}")
    print(f"phase10 (c) {epochs} epochs with the trace, the records and "
          f"{epochs} asynchronous checkpoints in {wall:.1f} s; launches {launches}")
    # Resume from epoch 2 in a fresh directory (the same -e: the BatchNorm
    # momentum schedule spans it): every later epoch's line and the last
    # checkpoint equal the uninterrupted run's (a torn checkpoint would not).
    resumed_dir = os.path.join(tmp, "train_instrumented_resumed")
    os.makedirs(resumed_dir)
    shutil.copy(os.path.join(ckpt, f"epoch_{first}.bin"), resumed_dir)
    again = list(argv)
    again[again.index("-c") + 1] = resumed_dir
    again[again.index("-r") + 1] = f"epoch_{first}.bin"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runner.main(again)
    resumed = {int(m.group(1)): m.group(2)
               for m in map(EPOCH_LINE.match, buf.getvalue().splitlines()) if m}
    later = {e: line for e, line in lines.items() if e > first}
    check(resumed == later, f"resumed epochs {resumed} vs {later}")
    a = torch.load(os.path.join(ckpt, f"epoch_{epochs}.bin"), weights_only=False)
    b = torch.load(os.path.join(resumed_dir, f"epoch_{epochs}.bin"), weights_only=False)
    same = (all(torch.equal(a["model_pos"][k], b["model_pos"][k]) for k in a["model_pos"])
            and all(torch.equal(v, b["optimizer"]["state"][i][k])
                    for i, s in a["optimizer"]["state"].items() for k, v in s.items()))
    check(same, f"epoch_{epochs}.bin of the resumed run differs from the uninterrupted")
    print(f"phase10 (c) resumed epoch_{first}.bin: epochs {first + 1}-{epochs}' lines "
          f"bitwise the uninterrupted run's (epoch {first + 1}: {lines[first + 1]}), "
          f"epoch_{epochs}.bin's weights and AMSGrad moments bitwise equal")
    return launches


def phase10d(tmp, cfg, device):
    """Host cores at Human3.6M's training size: the native and the numpy
    shuffle of 1.56 M frames' chunk pairs, bitwise, timed; and a checkpoint of
    the full-width model with AMSGrad state, synchronous against the
    asynchronous checkpointer's blocked time, the files equal."""
    from videopose3d_torch import native
    from videopose3d_torch.checkpoint import (AsyncCheckpointer, model_state_dict,
                                              save_checkpoint)
    from videopose3d_torch.data.generators import ChunkedPairSampler
    from videopose3d_torch.models.temporal import TemporalModel
    from videopose3d_torch.train import make_optimizer
    check(native.available(), "the native sampler core did not build (g++)")
    lengths = [SAMPLER_FRAMES] * SAMPLER_SEQS
    samplers = {p: ChunkedPairSampler(lengths, 1024, 1, augment=True, use_native=p == "native")
                for p in ("native", "numpy")}
    ms = {p: [] for p in samplers}
    for epoch in range(2):
        perms = {}
        for p, s in samplers.items():
            start = time.perf_counter()
            perms[p] = s._draw()
            ms[p].append((time.perf_counter() - start) * 1e3)
        check(np.array_equal(perms["native"], perms["numpy"]),
              f"native and numpy shuffles differ in epoch {epoch + 1}")
    states = [s.random_state() for s in samplers.values()]
    check(np.array_equal(states[0][1], states[1][1]) and states[0][2] == states[1][2],
          "native and numpy RNG states differ after two epochs")
    n_pairs = len(samplers["native"].pairs)
    print(f"phase10 (d) shuffle of {n_pairs} chunk pairs ({SAMPLER_SEQS} x {SAMPLER_FRAMES} "
          f"frames, flipped too): native {ms['native'][0]:.1f} / {ms['native'][1]:.1f} ms, "
          f"numpy {ms['numpy'][0]:.1f} / {ms['numpy'][1]:.1f} ms per shuffle; permutations "
          "and RNG states bitwise equal over two epochs")
    # The README model's checkpoint, AMSGrad moments populated by one step.
    torch.manual_seed(SEED + 13)
    model = TemporalModel(cfg).to(device)
    optimizer = make_optimizer(model, 1e-3)
    for p in model.parameters():
        p.grad = torch.randn_like(p) * 1e-3
    optimizer.step()
    sampler_state = samplers["numpy"].random_state()

    def payload(copy):
        return {"epoch": 1, "lr": 1e-3, "random_state": sampler_state,
                "optimizer": optimizer.state_dict(),
                "model_pos": model_state_dict(model, copy=copy), "model_traj": None}

    sync_ms, blocked_ms, written_ms = [], [], []
    checkpointer = AsyncCheckpointer()
    for rep in range(CKPT_REPS):
        sync_path = os.path.join(tmp, f"sync_{rep}.bin")
        async_path = os.path.join(tmp, f"async_{rep}.bin")
        torch.cuda.synchronize()
        start = time.perf_counter()
        save_checkpoint(sync_path, payload(copy=True))  # what the step path did
        sync_ms.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
        start = time.perf_counter()
        checkpointer.save(async_path, payload(copy=False))
        blocked_ms.append((time.perf_counter() - start) * 1e3)
        # The next step writes weights and moments in place at once.
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
            for s in optimizer.state.values():
                s["exp_avg"].mul_(2.0)
        checkpointer.wait()
        written_ms.append((time.perf_counter() - start) * 1e3)
        a = torch.load(sync_path, weights_only=False)
        b = torch.load(async_path, weights_only=False)
        check(all(torch.equal(a["model_pos"][k], b["model_pos"][k]) for k in a["model_pos"])
              and all(torch.equal(v.cpu(), b["optimizer"]["state"][i][k].cpu())
                      for i, s in a["optimizer"]["state"].items() for k, v in s.items()),
              f"rep {rep}: the asynchronous checkpoint differs from the synchronous one")
    size_mb = os.path.getsize(async_path) / 1e6
    print(f"phase10 (d) checkpoint of the README model with AMSGrad state ({size_mb:.1f} MB): "
          f"step path blocked {statistics.median(sync_ms):.1f} ms synchronous "
          f"({', '.join(f'{v:.1f}' for v in sync_ms)}) vs {statistics.median(blocked_ms):.2f} ms "
          f"asynchronous ({', '.join(f'{v:.2f}' for v in blocked_ms)}; written after "
          f"{statistics.median(written_ms):.1f} ms); files bitwise equal although the next "
          "step's in-place writes began at once")
    return {"shuffle_ms": ms, "sync_ms": sync_ms, "blocked_ms": blocked_ms}


def phase10(tmp, cfg, model, device):
    """Runs (a)-(d); returns the launches of (a) and (c) by kernel."""
    start = time.perf_counter()
    eval_launches = phase10a(tmp, model)
    phase10b(tmp, cfg, model)
    train_launches = phase10c(tmp)
    phase10d(tmp, cfg, device)
    print(f"phase10 done in {time.perf_counter() - start:.1f} s")
    return eval_launches, train_launches


def protocol_ops(n, joints):
    """Float64 operations of ``csrc/protocols.cu`` on one video (an add, multiply,
    divide or square root each): per frame and joint 124 (MPJPE 10, the sums and
    means 18, the centred products, N-MPJPE and the covariance 46, P-MPJPE 34, MPJVE
    16); per frame 1,727, of which the Jacobi SVD's 8 sweeps of 3 rotations of 67
    take 1,608."""
    return n * (124 * joints + 1727)


def phase11(device):
    """The protocol kernel (P) at the evaluation path's shape against its plain
    version on the card and on the CPU and the host protocols on float64 copies;
    two calls bitwise equal; timed beside its plain version and the host NumPy
    protocols it replaced.  Returns its entry of the kernels line."""
    from videopose3d_torch.ops import losses
    from videopose3d_torch.ops.kernels import build
    from videopose3d_torch.ops.kernels import protocols as pk

    n, joints = PROTOCOL_FRAMES, JOINTS
    g = torch.Generator().manual_seed(SEED + 11)
    target = torch.randn(n, joints, 3, generator=g, dtype=torch.float64) * 0.25
    # Random rotations, every other one mirrored (an improper alignment).
    rot, _ = torch.linalg.qr(torch.randn(n, 3, 3, generator=g, dtype=torch.float64))
    rot = rot * torch.where(torch.linalg.det(rot) > 0, 1.0, -1.0)[:, None, None]
    rot[::2, 0] *= -1.0
    pred = (target @ rot * (0.7 + 0.6 * torch.rand(n, 1, 1, generator=g, dtype=torch.float64))
            + 0.1 * torch.randn(n, 1, 3, generator=g, dtype=torch.float64)
            + 0.03 * torch.randn(n, joints, 3, generator=g, dtype=torch.float64))
    tail = 1e4 * torch.randn(PROTOCOL_PREDICTED - n, joints, 3, generator=g,
                             dtype=torch.float64)
    pred, target = torch.cat([pred, tail]).float(), target.float()
    improper = int((torch.linalg.det(rot) < 0).sum())
    p, t = pred.to(device), target.to(device)
    saved = dict(pk.LAUNCHES)

    got = pk.video_protocols(p, t, n)
    again = pk.video_protocols(p, t, n)
    plain_card = pk.video_protocols_plain(p, t, n)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"protocols: two calls differ: {got} vs {again}")
    p64, t64 = pred[:n].double().numpy(), target.double().numpy().copy()
    t64[:, 0] = 0.0
    host = torch.tensor([losses.mpjpe_np(p64, t64), float(losses.p_mpjpe(p64, t64)),
                         losses.n_mpjpe_np(p64[None], t64[None]),
                         float(losses.mean_velocity_error(p64, t64))], dtype=torch.float64)
    wants = {"plain on the card": plain_card.cpu(),
             "plain on the CPU": pk.video_protocols_plain(pred, target, n),
             "host protocols (float64)": host}
    got = got.cpu()
    check(bool(torch.isfinite(got).all()), f"protocols: non-finite means {got}")
    errs = {}
    for what, want in wants.items():
        rel = float(((got - want).abs() / want.abs()).max())
        errs[what] = rel
        check(rel <= PROTOCOL_TOL, f"protocols vs {what}: relative {rel} > {PROTOCOL_TOL} "
                                   f"({got.tolist()} vs {want.tolist()})")
    max_abs = max(float((got - want).abs().max()) for want in wants.values())

    call = lambda: pk.video_protocols(p, t, n)  # noqa: E731
    ms = graph_ms(call)
    call_ms = cuda_ms(call)
    host_ms = host_enqueue_ms(call)
    plain_ms = cuda_ms(lambda: pk.video_protocols_plain(p, t, n))  # ~1,000 launches
    p32, t32 = pred[:n].numpy(), target.numpy().copy()
    t32[:, 0] = 0.0
    numpy_ms = []
    for _ in range(3):
        start = time.perf_counter()
        losses.mpjpe_np(p32, t32)
        losses.p_mpjpe(p32, t32)
        losses.n_mpjpe_np(p32[None], t32[None])
        losses.mean_velocity_error(p32, t32)
        numpy_ms.append((time.perf_counter() - start) * 1e3)
    ops = protocol_ops(n, joints)
    bound_ms, bound_by = roofline([("float64", ops)], nbytes(p[:n], t) + 32)
    pk.LAUNCHES.clear()
    pk.LAUNCHES.update(saved)  # comparison launches do not count
    name = (f"video_protocols (n={n} of {PROTOCOL_PREDICTED} frames, J={joints}, "
            f"{improper} improper, float64, repeat bitwise, CUDA-graph timed)")
    rel = ", ".join(f"{v:.3e} vs {k}" for k, v in errs.items())
    print(f"phase11 {name}: relative error {rel} (tol {PROTOCOL_TOL:.0e}), means "
          f"{[f'{v:.9f}' for v in got.tolist()]} m; graph: kernel {ms:.4f} ms; one call: "
          f"kernel {call_ms:.4f} ms, plain on the card {plain_ms:.4f} ms; host enqueue {host_ms:.4f} ms; host NumPy float32 (the path it replaced) "
          f"{statistics.median(numpy_ms):.2f} ms; bound {bound_ms:.5f} ms ({bound_by}: "
          f"{ops / 1e6:.2f} MFLOP float64, {nbytes(p[:n], t) / 1e6:.3f} MB)")
    for line in ptxas_lines(build.build_log, "protocols"):
        print(f"phase11 ptxas: {line}")
    return {"name": name, "route": "cuda", "source": PROTOCOLS_SOURCE,
            "replaces": "videopose3d_tpu/ops/losses.py (host NumPy, no TPU kernel)",
            "max_abs_err": max_abs, "max_rel_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "one_call_ms": call_ms, "host_enqueue_ms": host_ms,
            "host_numpy_ms": statistics.median(numpy_ms), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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
        if any(w in line for w in ("entry function", "registers", "spill", "smem")):
            print("phase0 ptxas:", line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = random_model(device)
    kernel_results = phase1(cfg, model, device)
    train_kernel_results = phase3(device)
    semi_kernel_results = phase7_kernels(device)
    int8_results = phase5(cfg, model, device)
    # Phase 6 serves the causal model, quantized on the card.
    from videopose3d_torch.models.temporal import receptive_field
    from videopose3d_torch.ops.kernels.temporal_block_int8 import quantize_temporal_model
    scfg, smodel = random_model(device, causal=True)
    calib = torch.rand(2, receptive_field(scfg) + 256, JOINTS, 2,
                       generator=torch.Generator().manual_seed(SEED + 5)).to(device) * 2 - 1
    stream_results = phase6_kernels(scfg, smodel, quantize_temporal_model(scfg, smodel, calib),
                                    device)
    protocol_result = phase11(device)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase2(model, tmp)
        train_runs = phase4(tmp)
        train_launches = train_runs["pallas again"][1]
        stream_launches = phase6_cli(scfg, smodel, device, tmp)
        semi_launches = phase7(tmp)
        dp_launches = phase8a(tmp, train_runs)
        gloo_launches = phase8b(tmp)
        launches9 = phase9(tmp)
        launches10_eval, launches10_train = phase10(tmp, cfg, model, device)

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
            # Phase 9 evaluates in float32 only.
            **({"launches_phase9": launches9[key]} if dname == "float32" else {}),
            "launches_phase10": launches10_eval[("fused", dname)][key],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}})
    for r in train_kernel_results:
        key = r["key"][1]
        entries.append({**{k: v for k, v in r.items() if k != "key"},
                        "launches": train_launches[key],
                        "launches_phase8": {"8a": dp_launches[key],
                                            "8b": [g[key] for g in gloo_launches]},
                        "launches_phase9": launches9[key],
                        "launches_phase10": launches10_train[key]})
    for r in semi_kernel_results:  # K2 at (b)'s first block and (a)'s last
        cell, key = r["key"]
        entries.append({**{k: v for k, v in r.items() if k != "key"},
                        "launches": semi_launches[cell == "semi_b"][key],
                        "launches_phase9": launches9[key],
                        "launches_phase10": launches10_train[key]})
    for r in int8_results:
        mode, key = r["key"]
        entries.append({**{k: v for k, v in r.items() if k != "key"},
                        "launches": launches[("int8", mode)][key],
                        "launches_phase10": launches10_eval[("int8", mode)][key]})
    for key, r in stream_results.items():
        entries.append({**r, "launches": stream_launches[key]})
    entries.append({**protocol_result, "launches": launches["protocols"]["fused float32"],
                    "launches_by_run": launches["protocols"]})
    check(all(e["launches"] > 0 for e in entries), "a kernel of the main path never launched")
    check(all(e["launches_phase9"] > 0 for e in entries if "launches_phase9" in e),
          "a K1, K2 or K3 kernel never launched in phase 9")
    check(all(e["launches_phase10"] > 0 for e in entries if "launches_phase10" in e),
          "a K1, K2, K3 or K4 kernel never launched in phase 10")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # one rank of phase 8a (launch_8a)
        phase8a_rank(sys.argv[2], sys.argv[3] == "--profiled", sys.argv[5:])
        sys.exit(0)
    sys.exit(main())
