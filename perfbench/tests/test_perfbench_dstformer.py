"""The DSTformer training cell and the int8 evaluation cell at the CPU's size,
through the harness: the result line, ``correct`` on sound runs and false with
the timed path broken underneath; the DSTformer's counts against the shapes."""

import json
from unittest import mock

import pytest
import torch
from conftest import REPO, SEED, TINY_TRAFFIC, run_tiny

from perfbench import counts_dstformer
from perfbench.harness import Cell

DST, INT8 = "train-h36m243-dstformer-xla", "eval-h36m243-int8"
CONFIG = json.loads((REPO / "perfbench/configs/h36m-dstformer-243f.json").read_text())


def tiny(name):
    cell = Cell(name)
    if name == DST:
        cell.config = {**cell.config, "dim_feat": 32, "dim_rep": 32, "depth": 2,
                       "num_heads": 2, "maxlen": 27}
        cell.traffic = {**cell.traffic, "sequences": 6, "frames_per_sequence": 300,
                        "batch_size": 4, "traced_steps": 2}
    else:
        cell.config = {**cell.config, "filter_widths": [3, 3, 3], "channels": 32}
        cell.traffic = {**cell.traffic, **TINY_TRAFFIC["eval"], "calibration_videos": 2,
                        "calibration_frames": 40}
    return cell


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", [DST, INT8])
def test_sound_run(name, trace):
    cell = tiny(name)
    line = json.loads(json.dumps(run_tiny(cell, trace=trace)))
    assert line["correct"] is True, line["compared"]
    assert set(line["compared"]) == set(cell.limits)
    if trace:
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    if name == DST and trace:
        assert line["metrics"]["dst.mfu"]["value"] > 0


def test_a_frozen_adamw_is_caught():
    with mock.patch.object(torch.optim.AdamW, "step", lambda self, closure=None: None):
        assert run_tiny(tiny(DST))["correct"] is False


def test_altered_int8_poses_are_caught():
    from videopose3d_torch.evaluate import Evaluator
    infer = Evaluator.infer

    def altered(self, model, x):
        out = infer(self, model, x).clone()
        out[:, 3] += 0.05
        return out

    with mock.patch.object(Evaluator, "infer", altered):
        assert run_tiny(tiny(INT8))["correct"] is False


def test_int4_control_fails_its_limit():
    cell = tiny(INT8)
    drv = cell.driver(SEED, "cpu")
    drv.setup()
    drv.free()
    assert drv.control()["pose_gap"] > cell.limits["pose_gap"]["limit"]


def test_counts_of_the_published_model():
    # 89.7 MFLOP a token forward (41.9 M multiply-adds of the linears and 0.3 M of the
    # head and gates, 2.66 M of the attention cores), 371 GFLOP a clip.
    assert counts_dstformer.linear_macs_per_token(CONFIG) == 42_218_496
    assert counts_dstformer.forward_ops(CONFIG, 1, 243) == 370_805_962_752
    assert counts_dstformer.train_step_ops(CONFIG, 16, 243) == 3 * 16 * 370_805_962_752
