"""The operation and byte counts against hand counts at the configurations'
shapes (C = 1,024 channels, 17 joints, -arc 3,3,3,3,3)."""

import json

import pytest
from conftest import REPO

from perfbench import counts

CFG = json.loads((REPO / "perfbench" / "configs" / "h36m-243f.json").read_text())
C = 1024


def test_receptive_field():
    assert counts.receptive_field(CFG) == 243


def test_train_step_about_1_07_tflop():
    # Blocks: rows 1,024 x (27, 9, 3, 1); each row 2 x (3 + 1) x C^2 forward, 3x with
    # the backward.  Expand: 1,024 x 81 rows x 2 x 102 x C, forward and weight
    # gradient.  Shrink: 2 x C x 51 per row, 3x.
    blocks = 3 * 8 * C * C * 1024 * (27 + 9 + 3 + 1)
    expand = 2 * (2 * 1024 * 81 * 102 * C)
    shrink = 3 * 2 * 1024 * C * 51
    assert counts.train_block_ops(CFG, 1024) == blocks
    assert counts.train_step_ops(CFG, 1024) == blocks + expand + shrink
    assert counts.train_step_ops(CFG, 1024) == pytest.approx(1.066e12, rel=1e-3)
    # K2's bound at 495 TFLOP/s: 2.08 ms, bound by operations.
    bound = counts.bound_s(blocks, counts.train_block_bytes(CFG, 1024), "float32")
    assert bound == pytest.approx(blocks / 495e12) and bound == pytest.approx(2.083e-3, rel=1e-3)


def test_dilated_forward_about_33_9_mflop_a_frame():
    per_frame = 2 * 3 * 34 * C + 4 * 2 * (3 + 1) * C * C + 2 * C * 51
    assert counts.ops_per_pose(CFG) == per_frame == 33_867_776
    # A long video: the padding's extra frames of each layer are a small share.
    t = 100_000
    assert counts.dilated_forward_ops(CFG, 1, t + 242) == pytest.approx(t * per_frame,
                                                                         rel=3e-3)
    # Exactly: expand t + 240 frames, blocks t + 234, + 216, + 162, + 0.
    exact = (2 * (t + 240) * 102 * C + 8 * C * C * ((t + 234) + (t + 216) + (t + 162) + t)
             + 2 * t * C * 51)
    assert counts.dilated_forward_ops(CFG, 1, t + 242) == exact


def test_k3_bound_as_the_kernel_table():
    # PERF.md's K3 table (B = 2, 2,242 frames, bf16): expand block 0.039 ms, mid
    # blocks 0.038 / 0.037, shrink block 0.034, bound by operations at 989 TFLOP/s.
    ops = counts.dilated_forward_ops(CFG, 2, 2242)
    bound = counts.bound_s(ops, counts.dilated_forward_bytes(CFG, 2, 2242, "bfloat16"),
                           "bfloat16")
    assert bound * 1e3 == pytest.approx(0.039 + 0.038 + 0.037 + 0.034, rel=0.03)


def test_k5_bound_as_the_kernel_table():
    # K5 int8 at B = 1,024: 0.0175 ms, bound by operations at 1,979 TOP/s.
    ops = counts.stream_blocks_ops(CFG, 1024)
    assert ops == 1024 * (4 * 2 * 4 * C * C + 2 * C * 51)
    bound = counts.bound_s(ops, counts.stream_blocks_bytes(CFG, 1024), "int8")
    assert bound * 1e3 == pytest.approx(0.0175, rel=0.02)


def test_peaks():
    assert counts.PEAKS["ops_per_s"] == {"float32": 495e12, "bfloat16": 989e12,
                                         "int8": 1979e12}
    assert counts.PEAKS["hbm_bytes_per_s"] == 3.35e12
