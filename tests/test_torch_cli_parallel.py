"""The data-parallel slice as a whole against the JAX package: ``python -m
torch.distributed.run --nproc_per_node 2 -m videopose3d_torch.run --device cpu``
(two gloo ranks) trains supervised and semi-supervised (``-sun``) from one
initial checkpoint written by the JAX package, at dropout 0, and each rank
prints the epoch lines and protocol numbers of the JAX CLI, which runs in this
process on conftest's 8-device data-parallel mesh.

Tolerances: the epoch lines and protocol numbers within 1e-4 relative, as
``tests/test_torch_cli.py`` holds the single-process port (float32 sums in other
orders, carried over 2 epochs); a single-process ``--evaluate`` of the saved
checkpoint within 1e-6 relative of the training run's final evaluation (the same
operations, on as many threads as the process has).
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from videopose3d_tpu import runner as jax_runner
from videopose3d_tpu.checkpoint import save_checkpoint
from videopose3d_tpu.models.convert import params_to_torch_state_dict
from videopose3d_tpu.models.temporal import TemporalModelConfig as JConfig
from videopose3d_tpu.models.temporal import init_temporal_model
from videopose3d_torch import runner

from torch_port_helpers import protocol_numbers, write_h36m_archives

REPO = pathlib.Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT_S = 420


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Archives with a labeled (S1), an unlabeled (S5) and two test subjects, and
    an initial checkpoint of both models saved by the JAX package."""
    root = tmp_path_factory.mktemp("cli_parallel")
    (root / "data").mkdir()
    write_h36m_archives(str(root / "data"), subjects=("S1", "S5", "S9", "S11"),
                        n_frames=60)
    models = []
    for joints_out, seed in ((17, 11), (1, 12)):
        params, state = init_temporal_model(
            JConfig(num_joints_in=17, in_features=2, num_joints_out=joints_out,
                    filter_widths=(3, 3), channels=32), jax.random.PRNGKey(seed))
        models.append(params_to_torch_state_dict(*jax.tree_util.tree_map(
            np.asarray, (params, state))))
    save_checkpoint(str(root / "init.bin"), {"epoch": 0, "lr": 0.001, "optimizer": None,
                                             "model_pos": models[0],
                                             "model_traj": models[1]})
    return root


def _args(root, ckpt, semi):
    (root / ckpt).mkdir()
    (root / ckpt / "init.bin").write_bytes((root / "init.bin").read_bytes())
    extra = ["-sun", "S5", "--warmup", "1", "--subset", "0.5"] if semi else []
    return ["-k", "gt", "-arc", "3,3", "-ch", "32", "-b", "64", "-e", "2", "-drop", "0",
            "-str", "S1", "-ste", "S9,S11", "--data-dir", str(root / "data"),
            "-c", str(root / ckpt), "-r", "init.bin", "--eval-bucket", "16",
            "--checkpoint-frequency", "1", *extra]


def _launch(root, argv, name):
    """Each rank's standard output of the two-rank launch."""
    logs = root / f"logs_{name}"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "--log-dir", str(logs), "--redirects", "3",
         "-m", "videopose3d_torch.run", *argv, "--device", "cpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S)
    outs = [sorted(logs.glob(f"*/attempt_0/{rank}/stdout.log")) for rank in (0, 1)]
    assert all(len(o) == 1 for o in outs), (done.stdout, done.stderr)
    errs = [p.parent / "stderr.log" for o in outs for p in o]
    assert done.returncode == 0, [e.read_text()[-3000:] for e in errs]
    return [o[0].read_text() for o in outs]


def _epoch_numbers(out):
    """[(epoch, lr text, [losses])] of the printed epoch lines."""
    rows = []
    for line in out.splitlines():
        if line.startswith("[") and " lr " in line:
            words = line.split()
            rows.append((words[0], words[4], [float(v) for v in words[6::2]]))
    return rows


@pytest.mark.parametrize("semi", [False, True], ids=["supervised", "semi"])
def test_two_rank_cli_matches_the_jax_cli(workdir, semi, capsys):
    root = workdir
    name = "semi" if semi else "supervised"
    jax_runner.main(_args(root, f"jax_{name}", semi) + ["--rng-impl", "threefry2x32"])
    want = capsys.readouterr().out
    ranks = _launch(root, _args(root, f"port_{name}", semi), name)

    want_epochs, want_p = _epoch_numbers(want), protocol_numbers(want)
    assert len(want_epochs) == 2 and list(want_p) == ["Walking", "Eating"]
    for rank, out in enumerate(ranks):
        assert "INFO: Data-parallel over 2 processes" in out.splitlines()
        epochs = _epoch_numbers(out)
        assert [e[:2] for e in epochs] == [e[:2] for e in want_epochs]
        for (_, _, got), (_, _, ref) in zip(epochs, want_epochs):
            assert len(got) == len(ref) == (8 if semi else 3)
            np.testing.assert_allclose(got, ref, rtol=1e-4)
        got_p = protocol_numbers(out)
        assert list(got_p) == list(want_p)
        for action in want_p:
            np.testing.assert_allclose(got_p[action], want_p[action], rtol=1e-4)
        # Only rank 0 writes checkpoints.
        assert ("Saving checkpoint to" in out) == (rank == 0)
    assert (root / f"port_{name}" / "epoch_2.bin").exists()

    # One process evaluates the saved checkpoint to the run's final numbers.
    runner.main(["-k", "gt", "-arc", "3,3", "-ch", "32", "-str", "S1", "-ste", "S9,S11",
                 "--data-dir", str(root / "data"), "-c", str(root / f"port_{name}"),
                 "--evaluate", "epoch_2.bin", "--eval-bucket", "16", "--device", "cpu"])
    evaluated = protocol_numbers(capsys.readouterr().out)
    trained = protocol_numbers(ranks[0])
    assert list(evaluated) == list(trained)
    for action in trained:
        np.testing.assert_allclose(evaluated[action], trained[action], rtol=1e-6)
