"""HumanEva-I in videopose3d_torch (``-d humaneva15``) against the JAX package: the
dataset (15-joint skeleton, the camera table under every split prefix) and the
CLI on ``tests/test_e2e_more.py``'s synthetic archives: training with the
per-epoch evaluation and the ``--by-subject`` protocols, ``-a`` selecting actions
by prefix, and ``--evaluate`` of the port's checkpoint with the fused engine.

Tolerances: the dataset bitwise (the same numpy constants); the CLI's epoch and
protocol numbers within 1e-4 relative, as ``tests/test_torch_cli.py`` (float32
models summed in other orders)."""

import re
import shutil

import numpy as np
import pytest
import torch

from videopose3d_tpu import runner as jax_runner
from videopose3d_tpu.datasets.humaneva import HumanEvaDataset as JHumanEva
from videopose3d_torch import runner
from videopose3d_torch.checkpoint import model_state_dict
from videopose3d_torch.datasets.humaneva import HumanEvaDataset
from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig

from torch_port_helpers import protocol_numbers

SUBJECTS = ["Train/S1", "Train/S2", "Validate/S1", "Validate/S2"]
# "Box" is in the archives and left out by -a Walk,Jog.
ACTIONS = ["Walking 1 chunk0", "Jog 1 chunk0", "Box 1 chunk0"]
KPS_SYMMETRY = [[2, 3, 4, 8, 9, 10], [5, 6, 7, 11, 12, 13]]


def _write_archives(root, n_frames=40, seed=0):
    rng = np.random.default_rng(seed)
    p3 = {s: {a: (rng.standard_normal((n_frames, 15, 3)) * 0.2).astype(np.float32)
              for a in ACTIONS} for s in SUBJECTS}
    np.savez_compressed(root / "data_3d_humaneva15.npz", positions_3d=p3)
    p2 = {s: {a: [rng.uniform(50, 600, (n_frames, 15, 2)).astype(np.float32)
                  for _ in range(3)] for a in ACTIONS} for s in SUBJECTS}
    meta = {"layout_name": "humaneva15", "num_joints": 15,
            "keypoints_symmetry": KPS_SYMMETRY}
    np.savez_compressed(root / "data_2d_humaneva15_gt.npz", positions_2d=p2, metadata=meta)


def test_humaneva_dataset_matches_jax(tmp_path):
    _write_archives(tmp_path, n_frames=10)
    ours = HumanEvaDataset(str(tmp_path / "data_3d_humaneva15.npz"))
    theirs = JHumanEva(str(tmp_path / "data_3d_humaneva15.npz"))
    assert ours.fps() == theirs.fps() == 60
    assert not ours.supports_semi_supervised() and not theirs.supports_semi_supervised()
    sk, jsk = ours.skeleton(), theirs.skeleton()
    assert sk.num_joints() == jsk.num_joints() == 15
    assert np.array_equal(sk.parents(), jsk.parents())
    assert sk.joints_left() == jsk.joints_left() and sk.joints_right() == jsk.joints_right()
    assert sorted(ours.cameras()) == sorted(theirs.cameras())
    assert {"Train/S1", "Validate/S3", "Unlabeled/Train/S2", "Unlabeled/S4"} <= set(
        ours.cameras())
    for subject, cams in theirs.cameras().items():
        assert len(ours.cameras()[subject]) == len(cams) == 3
        for got, want in zip(ours.cameras()[subject], cams):
            assert sorted(got) == sorted(want)
            for key, value in want.items():
                assert np.array_equal(got[key], value), (subject, key)
                assert np.asarray(got[key]).dtype == np.asarray(value).dtype
    assert list(ours.subjects()) == list(theirs.subjects()) == SUBJECTS
    for subject in SUBJECTS:
        assert list(ours[subject]) == list(theirs[subject]) == ACTIONS
        for action in ACTIONS:
            assert np.array_equal(ours[subject][action]["positions"],
                                  theirs[subject][action]["positions"])


_EPOCH = re.compile(r"^\[(\d+)\] time \S+ lr (\S+) 3d_train (\S+) 3d_eval (\S+) "
                    r"3d_valid (\S+)$")


def _epoch_lines(out):
    return [(int(m.group(1)), m.group(2), [float(v) for v in m.group(3, 4, 5)])
            for m in map(_EPOCH.match, out.splitlines()) if m]


def _by_subject(out):
    """{subject: {action: [P1, P2, P3, MPJVE]}} from the --by-subject reports."""
    parts = re.split(r"^Evaluating on subject (\S+)$", out, flags=re.M)
    return {parts[i]: protocol_numbers(parts[i + 1]) for i in range(1, len(parts), 2)}


def _assert_by_subject_close(got, want):
    assert list(got) == list(want) == ["Validate/S1", "Validate/S2"]
    for subject in want:
        assert list(got[subject]) == list(want[subject]) == ["Walking", "Jog"]
        for action, numbers in want[subject].items():
            assert len(numbers) == 4
            np.testing.assert_allclose(got[subject][action], numbers, rtol=1e-4,
                                       err_msg=f"{subject} {action}")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("humaneva_cli")
    (root / "data").mkdir()
    _write_archives(root / "data")
    torch.manual_seed(5)
    model = TemporalModel(TemporalModelConfig(15, 2, 15, (3, 3), channels=16))
    for name in ("jax", "port"):
        (root / name).mkdir()
        torch.save({"epoch": 0, "lr": 0.001, "optimizer": None, "model_traj": None,
                    "model_pos": model_state_dict(model)}, root / name / "init.bin")
    return root


def _args(root, ckpt, *extra):
    return ["-d", "humaneva15", "-k", "gt", "--data-dir", str(root / "data"),
            "-c", str(root / ckpt), "-arc", "3,3", "-ch", "16", "-b", "32",
            "-str", "Train/S1,Train/S2", "-ste", "Validate/S1,Validate/S2",
            "-a", "Walk,Jog", "--eval-bucket", "16", "--by-subject", *extra]


def test_humaneva_cli_matches_jax(workdir, capsys):
    """Two epochs from one initial checkpoint at -drop 0, then the final
    per-subject protocols; then --evaluate of the port's checkpoint, the port's
    fused engine (a 45-column shrink) against the JAX CLI's xla."""
    root = workdir
    train = ("-e", "2", "-drop", "0", "-r", "init.bin", "--checkpoint-frequency", "1")
    jax_runner.main(_args(root, "jax", *train, "--rng-impl", "threefry2x32"))
    want = capsys.readouterr().out
    runner.main(_args(root, "port", *train, "--device", "cpu", "--train-engine", "pallas"))
    got = capsys.readouterr().out

    assert "Selected actions: ['Walk', 'Jog']" in got and "----Box----" not in got
    got_e, want_e = _epoch_lines(got), _epoch_lines(want)
    assert [e[:2] for e in got_e] == [e[:2] for e in want_e] == [(1, "0.001000"),
                                                                 (2, "0.000950")]
    for (_, _, g), (_, _, w) in zip(got_e, want_e):
        np.testing.assert_allclose(g, w, rtol=1e-4)
    assert re.search(r"^INFO: trained \d+ steps in \S+ s \(\S+ frames/s, engine pallas, "
                     r"device cpu\)$", got, re.M)
    _assert_by_subject_close(_by_subject(got), _by_subject(want))

    shutil.copy(root / "port" / "epoch_2.bin", root / "jax" / "port_epoch_2.bin")
    runner.main(_args(root, "port", "--evaluate", "epoch_2.bin", "--serving-engine", "fused",
                      "--device", "cpu"))
    fused = capsys.readouterr().out
    assert "This model was trained for 2 epochs" in fused
    jax_runner.main(_args(root, "jax", "--evaluate", "port_epoch_2.bin", "--rng-impl",
                          "threefry2x32"))
    _assert_by_subject_close(_by_subject(fused), _by_subject(capsys.readouterr().out))
    _assert_by_subject_close(_by_subject(fused), _by_subject(got))


def test_humaneva_refuses_semi_supervised_training_as_jax(workdir):
    """HumanEva's cameras carry no intrinsics: -sun raises the JAX CLI's error."""
    argv = _args(workdir, "port", "-e", "1", "-sun", "Train/S2")
    with pytest.raises(RuntimeError) as theirs:
        jax_runner.main(argv)
    with pytest.raises(RuntimeError) as ours:
        runner.main([*argv, "--device", "cpu"])
    assert str(ours.value) == str(theirs.value) == (
        "Semi-supervised training is not implemented for this dataset")
