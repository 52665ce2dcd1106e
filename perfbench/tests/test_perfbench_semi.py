"""The two training cells beside the supervised K2 one: ``train-h36m243-xla`` (the
``train`` driver on the plain engine) and ``train-h36m243-semi-pallas`` (the
``semi`` driver: pose and trajectory networks under the semi-supervised
objective).  Whole tiny runs through the harness, ``correct`` false under
faults planted in the timed path, the semi cell's metric readers, and its
reference's camera model against the program's."""

import contextlib
import json
import math
from unittest import mock

import numpy as np
import pytest
import torch
from conftest import REPO, SEED, TINY_CONFIG, TINY_TRAFFIC, run_tiny

from perfbench import counts, counts_semi, semi_data
from perfbench.faults import BY_DRIVER
from perfbench.harness import Cell
from perfbench.reference import semi as rs
from perfbench.trace import Trace

NEW_CELLS = ["train-h36m243-xla", "train-h36m243-semi-pallas"]
TINY_SEMI = {"labeled_sequences": 2, "unlabeled_sequences": 4, "frames_per_sequence": 300,
             "batch_size": 64, "traced_steps": 2}
SEMI_METRICS = ["semi.mfu", "semi.k2_roofline_pct", "semi.traj_forward_ms",
                "semi.objective_ms", "semi.unlabeled_row_pct"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny(name):
    cell = Cell(name)
    cell.config = {**cell.config, **TINY_CONFIG}
    kind = cell.traffic["driver"]
    cell.traffic = {**cell.traffic, **(TINY_SEMI if kind == "semi" else TINY_TRAFFIC[kind])}
    return cell


def test_the_cells_are_listed_after_the_first_four():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert [w["name"] for w in bench["workloads"]][4:] == NEW_CELLS
    assert all(w["chips"] == 1 for w in bench["workloads"])
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    assert "train-h36m243-xla" in per_layer["train.mfu"]["workloads"]
    assert "train-h36m243-xla" not in per_layer["train.k2_roofline_pct"]["workloads"]
    for name in SEMI_METRICS:
        assert per_layer[name]["workloads"] == ["train-h36m243-semi-pallas"]


@pytest.mark.parametrize("name", NEW_CELLS)
def test_cell_finds_its_files(name):
    cell = Cell(name)
    assert cell.driver_path.exists()
    assert {m["name"] for m in cell.end_to_end} == {"train_frames_per_s", "setup_s"}
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    assert cell.limits and all(v["limit"] > 0 for v in cell.limits.values())
    assert cell.traffic["engine"] == ("xla" if name.endswith("xla") else "pallas")


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", NEW_CELLS)
def test_sound_run(name, trace):
    cell = tiny(name)
    line = json.loads(json.dumps(run_tiny(cell, trace=trace)))
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    if trace:
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
        if name.endswith("semi-pallas"):
            # The host's metrics; the device-trace ones read a card's kernels
            # (test_semi_readers_on_a_synthetic_trace).
            assert {"semi.mfu", "semi.unlabeled_row_pct"} <= set(line["metrics"])
            assert line["metrics"]["semi.unlabeled_row_pct"]["value"] == 50.0
    else:
        assert set(line["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in line["metrics"].values())


# -- faults planted under the timed path ------------------------------------


@contextlib.contextmanager
def no_bone_term():
    """The bone-length term left out of the total."""
    from videopose3d_torch.train import SemiSupervisedTrainer
    with mock.patch.object(SemiSupervisedTrainer, "_bone_term",
                           lambda self, pred_pos, *args: pred_pos.sum() * 0.0):
        yield


@contextlib.contextmanager
def pinhole_projection():
    """The pinhole projection in place of the distorting one."""
    from videopose3d_torch import train
    with mock.patch.object(train, "project_to_2d", train.project_to_2d_linear):
        yield


@contextlib.contextmanager
def unweighted_trajectory():
    """The trajectory term without its inverse-depth weights."""
    from videopose3d_torch import train
    with mock.patch.object(train, "_trajectory_per_sample",
                           lambda pred, root: train._mpjpe_per_sample(pred, root)):
        yield


SEMI_FAULTS = [no_bone_term, pinhole_projection, unweighted_trajectory,
               *BY_DRIVER["train"]]


@pytest.mark.parametrize("name,fault",
                         [("train-h36m243-xla", f) for f in BY_DRIVER["train"]]
                         + [("train-h36m243-semi-pallas", f) for f in SEMI_FAULTS],
                         ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_fault_is_caught(name, fault):
    cell = tiny(name)
    with fault():
        result = run_tiny(cell)
    assert result["correct"] is False, result["compared"]


# -- the semi cell's readers ---------------------------------------------------


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def semi_trace(program_spans=True):
    events = [x("user_annotation", "bench.traced", 0, 1000),
              x("user_annotation", "K2 forward", 100, 50),
              x("cuda_runtime", "cudaLaunchKernel", 110, 1, correlation=1),
              x("kernel", "tap_gemm_kernel", 120, 400, tid=7, correlation=1),
              x("cuda_runtime", "cudaLaunchKernel", 300, 1, correlation=2),
              x("kernel", "elementwise_kernel", 600, 30, tid=7, correlation=2),
              x("cuda_runtime", "cudaLaunchKernel", 400, 1, correlation=3),
              x("kernel", "norm_kernel", 700, 20, tid=7, correlation=3)]
    if program_spans:
        events += [x("user_annotation", "vp3d.train.traj", 90, 100),
                   x("user_annotation", "vp3d.train.project", 290, 20),
                   x("user_annotation", "vp3d.train.bones", 390, 20)]
    return Trace(events)


def test_semi_readers_on_a_synthetic_trace():
    cell = Cell("train-h36m243-semi-pallas")
    traced = {"trace": semi_trace(), "steps": 2, "batch": 1024, "rows": 2048}
    ctx = {"traced": traced, "config": cell.config, "traffic": cell.traffic}
    read = lambda m, c: cell.reader(m).read(c)
    assert read("semi.traj_forward_ms", ctx) == pytest.approx(0.4 / 2)
    assert read("semi.objective_ms", ctx) == pytest.approx(0.05 / 2)
    bound = counts.bound_s(counts_semi.semi_block_ops(cell.config, 2048),
                           counts_semi.semi_block_bytes(cell.config, 2048), "float32")
    assert read("semi.k2_roofline_pct", ctx) == pytest.approx(100 * bound * 2 / 400e-6)
    # A program without the spans and counters reads None.
    ctx["traced"] = {**traced, "trace": semi_trace(program_spans=False)}
    assert read("semi.traj_forward_ms", ctx) is None
    assert read("semi.objective_ms", ctx) is None
    with mock.patch("perfbench.spans.counters", lambda: {}):
        assert read("semi.unlabeled_row_pct", ctx) is None


def test_semi_counts_are_both_networks():
    cfg = Cell("train-h36m243-semi-pallas").config
    traj = {**cfg, "num_joints_out": 1}
    assert counts_semi.semi_step_ops(cfg, 2048) == (counts.train_step_ops(cfg, 2048)
                                                    + counts.train_step_ops(traj, 2048))
    # The trajectory network's blocks do the pose network's work: the shrink alone differs.
    assert counts_semi.semi_block_ops(cfg, 2048) == 2 * counts.train_block_ops(cfg, 2048)
    # About 4.3 TFLOP a step at 1,024 + 1,024 rows: twice the rows of the
    # supervised step and two networks.
    assert 4.0e12 < counts_semi.semi_step_ops(cfg, 2048) < 4.5e12


# -- the reference's camera model and data --------------------------------------


@pytest.mark.parametrize("distortion", [True, False])
def test_reference_projection_is_the_programs(distortion):
    from videopose3d_torch.ops.camera import project_to_2d, project_to_2d_linear
    gen = torch.Generator().manual_seed(3)
    points = torch.rand(8, 1, 17, 3, generator=gen, dtype=torch.float64) - 0.5
    points[..., 2] += 4.5
    points[0, 0, 0, 0] = 6.0  # one coordinate clamped
    cams = torch.as_tensor(semi_data.CAMERAS, dtype=torch.float64)[torch.arange(8) % 4]
    want = (project_to_2d if distortion else project_to_2d_linear)(points, cams)
    np.testing.assert_allclose(rs.project(points, cams, distortion), want, rtol=1e-13,
                               atol=1e-13)


def test_cameras_and_skeleton_are_human36m():
    from videopose3d_torch.datasets.h36m import H36M_STATIC_JOINTS, _build_camera, h36m_skeleton
    want = np.stack([_build_camera(i, None)["intrinsic"] for i in range(4)])
    # The loader divides the centre in float32 before the shift: ~6e-8 apart.
    np.testing.assert_allclose(semi_data.CAMERAS, want, rtol=0, atol=1e-7)
    skeleton = h36m_skeleton()
    skeleton.remove_joints(H36M_STATIC_JOINTS)
    skeleton.reparent(11, 8)
    skeleton.reparent(14, 8)
    assert Cell("train-h36m243-semi-pallas").config["skeleton_parents"] == \
        [int(p) for p in skeleton.parents()]


def test_labeled_roots_and_trajectory_depth_in_range():
    cell = tiny("train-h36m243-semi-pallas")
    _, p3 = semi_data.labeled_set(cell.traffic, SEED, "cpu")
    roots = np.concatenate([p[:, 0] for p in p3])
    assert 3.5 <= roots[:, 2].min() and roots[:, 2].max() <= 6.5
    w = semi_data.trajectory_weights(cell.config, SEED, "cpu")
    assert w["shrink.bias"].shape == (3,) and 4.0 <= float(w["shrink.bias"][2]) <= 6.0
