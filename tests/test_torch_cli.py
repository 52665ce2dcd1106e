"""The slices as a whole: ``videopose3d_torch.runner.main`` against
``videopose3d_tpu.runner.main`` on the same synthetic H36M archives.

``--evaluate`` of one JAX-CLI checkpoint with the fused and xla serving engines:
per-action protocol numbers agree to relative 1e-4 (float32 models summed in
other orders) and the action-wise average lines are equal.  Supervised training
from one initial checkpoint with dropout 0: the epoch lines and the final
protocol numbers agree to relative 1e-4, and the JAX CLI evaluates the port's
checkpoint to the port's own numbers."""

import ast
import pathlib
import re
import shutil

import numpy as np
import pytest
import torch

from videopose3d_tpu import runner as jax_runner
from videopose3d_tpu.checkpoint import save_checkpoint
from videopose3d_tpu.models.convert import params_to_torch_state_dict
from videopose3d_torch import runner
from videopose3d_torch.checkpoint import (OpaqueObject, load_any_checkpoint,
                                          model_state_dict)
from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig

from torch_port_helpers import (average_lines, jax_model, protocol_numbers,
                                write_h36m_archives)

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = (3, 3, 3)
CHANNELS = 32


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """DATA/ archives and a JAX-CLI pickle checkpoint, optimizer state included."""
    import optax
    root = tmp_path_factory.mktemp("cli")
    (root / "data").mkdir()
    (root / "ckpt").mkdir()
    write_h36m_archives(str(root / "data"), n_frames=60)
    kwargs = dict(num_joints_in=17, in_features=2, num_joints_out=17,
                  filter_widths=ARCH, channels=CHANNELS)
    _, params, state, _, _ = jax_model(kwargs, seed=2)
    save_checkpoint(str(root / "ckpt" / "epoch_3.bin"), {
        "epoch": 3, "lr": 0.00085,
        "optimizer": optax.adam(1e-3).init(params),
        "model_pos": params_to_torch_state_dict(params, state),
        "model_traj": None, "random_state": np.random.RandomState(1234).get_state(),
    })
    return root


def _args(root, engine, checkpoint="epoch_3.bin", extra=()):
    return ["-k", "gt", "-arc", ",".join(map(str, ARCH)), "-ch", str(CHANNELS),
            "-str", "S1", "-ste", "S9,S11", "--data-dir", str(root / "data"),
            "-c", str(root / "ckpt"), "--evaluate", checkpoint,
            "--serving-engine", engine, "--eval-bucket", "16", *extra]


def _compare(got_out, want_out):
    got, want = protocol_numbers(got_out), protocol_numbers(want_out)
    assert list(got) == list(want) == ["Walking", "Eating"]
    for action in want:
        assert len(got[action]) == 4
        np.testing.assert_allclose(got[action], want[action], rtol=1e-4,
                                   err_msg=action)
    assert average_lines(got_out) == average_lines(want_out)
    assert len(average_lines(got_out)) == 4


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_evaluate_cli_matches_jax(workdir, engine, capsys):
    jax_runner.main(_args(workdir, engine, extra=["--rng-impl", "threefry2x32"]))
    want_out = capsys.readouterr().out
    runner.main(_args(workdir, engine, extra=["--device", "cpu"]))
    got_out = capsys.readouterr().out
    _compare(got_out, want_out)
    assert "This model was trained for 3 epochs" in got_out
    assert "INFO: Receptive field: 27 frames" in got_out
    assert f"engine {engine}, device cpu" in got_out


def test_evaluate_int8_cli_matches_jax(workdir, capsys):
    """--serving-engine int8: both CLIs quantize on the first evaluated video and
    print protocol lines that agree to relative 1e-4 (measured 3e-8).  Not
    bitwise: XLA on the CPU contracts the int8 epilogues' ``a * s + b`` into
    fused multiply-adds where torch rounds twice, and the two calibration
    forwards sum in other orders; either flips an int8 rounding only at a tie,
    which moves a few poses and the frame-averaged protocols far less."""
    jax_runner.main(_args(workdir, "int8", extra=["--rng-impl", "threefry2x32"]))
    want_out = capsys.readouterr().out
    runner.main(_args(workdir, "int8", extra=["--device", "cpu"]))
    got_out = capsys.readouterr().out
    got, want = protocol_numbers(got_out), protocol_numbers(want_out)
    assert list(got) == list(want) == ["Walking", "Eating"]
    for action in want:
        assert len(got[action]) == 4
        np.testing.assert_allclose(got[action], want[action], rtol=1e-4, err_msg=action)
    assert len(average_lines(got_out)) == 4
    assert re.search(r"^INFO: evaluated \d+ frames in \S+ s \(\S+ frames/s, engine int8, "
                     r"device cpu\)$", got_out, re.M)


def test_torch_bin_checkpoint_evaluates_like_the_pickle(workdir, capsys):
    """A reference torch .bin payload (what pretrained models ship as) loads
    through the torch path and gives the pickle's numbers exactly."""
    chk = load_any_checkpoint(str(workdir / "ckpt" / "epoch_3.bin"))
    # The optax optimizer state unpickles as placeholders, without JAX.
    assert any(isinstance(o, OpaqueObject) for o in chk["optimizer"])
    torch.save({"epoch": 3, "lr": chk["lr"], "optimizer": None, "model_traj": None,
                "model_pos": {k: torch.from_numpy(np.array(v))
                              for k, v in chk["model_pos"].items()}},
               workdir / "ckpt" / "ref.bin")
    runner.main(_args(workdir, "xla", extra=["--device", "cpu", "--by-subject"]))
    want = capsys.readouterr().out
    runner.main(_args(workdir, "xla", checkpoint="ref.bin",
                      extra=["--device", "cpu", "--by-subject"]))
    got = capsys.readouterr().out
    assert "Evaluating on subject S11" in got
    strip = lambda out: [l for l in out.splitlines()
                         if not l.startswith(("Namespace", "Loading checkpoint",
                                              "INFO: evaluated"))]
    assert strip(got) == strip(want)


def test_resume_from_a_jax_checkpoint_with_optax_state(workdir, capsys):
    """-r of a JAX CLI pickle whose optimizer is optax state (opaque without JAX):
    training goes on from its epoch with a fresh optimizer and sampler RNG, as
    the JAX CLI goes on from the port's torch optimizer state."""
    ckpt = workdir / "ckpt_resume"
    ckpt.mkdir()
    shutil.copy(workdir / "ckpt" / "epoch_3.bin", ckpt / "epoch_3.bin")
    runner.main(["-k", "gt", "-arc", ",".join(map(str, ARCH)), "-ch", str(CHANNELS),
                 "-b", "64", "-e", "4", "-str", "S9", "-ste", "S11", "--data-dir",
                 str(workdir / "data"), "-c", str(ckpt), "-r", "epoch_3.bin",
                 "--eval-bucket", "16", "--checkpoint-frequency", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "This model was trained for 3 epochs" in out
    assert ("WARNING: this checkpoint does not contain an optimizer state. The optimizer "
            "will be reinitialized.") in out
    assert [e[:2] for e in _epoch_lines(out)] == [(4, "0.000850")]
    assert (ckpt / "epoch_4.bin").exists()


@pytest.mark.parametrize("c,engine,limit", [
    (1030, ["--train-engine", "pallas"], "multiple of 4"),
    (3636, ["--train-engine", "pallas"], "at most 3632 channels"),
    (1030, ["--evaluate", "epoch_3.bin", "--serving-engine", "fused"], "multiple of 4"),
    (3636, ["--evaluate", "epoch_3.bin", "--serving-engine", "fused"], "shared memory"),
])
def test_unsupported_kernel_widths_are_refused_before_loading(tmp_path, c, engine, limit):
    """With --device cuda, a -ch the hand-written kernels cannot take ends the
    run before any data loads (the data directory does not even exist), with a
    message that names the limit and the xla engine."""
    argv = ["-k", "gt", "-arc", "3,3,3", "-ch", str(c), "--data-dir",
            str(tmp_path / "missing"), "-c", str(tmp_path / "ckpt"), "--device", "cuda",
            *engine]
    with pytest.raises(SystemExit, match=limit) as refused:
        runner.main(argv)
    assert "engine xla" in str(refused.value)
    assert not (tmp_path / "ckpt").exists()


def test_device_cuda_raises_without_a_card(workdir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(_args(workdir, "fused"))


@pytest.mark.parametrize("extra", [["-sun", "S11"], ["--render"]])
def test_unported_modes_raise(workdir, extra):
    argv = _args(workdir, "xla", extra=["--device", "cpu", *extra])
    if "-sun" in extra:  # semi-supervised training
        argv = [a for a in argv if a not in ("--evaluate", "epoch_3.bin")]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runner.main(argv)


_EPOCH = re.compile(r"^\[(\d+)\] time \S+ lr (\S+) 3d_train (\S+) 3d_eval (\S+) "
                    r"3d_valid (\S+)$")


def _epoch_lines(out):
    """[(epoch, lr text, [3d_train, 3d_eval, 3d_valid])] from the printed lines."""
    return [(int(m.group(1)), m.group(2), [float(v) for v in m.group(3, 4, 5)])
            for m in map(_EPOCH.match, out.splitlines()) if m]


@pytest.fixture(scope="module")
def train_workdir(tmp_path_factory):
    """Archives with a training subject and one random initial checkpoint
    (``epoch: 0``, no optimizer state), copied into one checkpoint directory per
    package."""
    root = tmp_path_factory.mktemp("train_cli")
    (root / "data").mkdir()
    write_h36m_archives(str(root / "data"), subjects=("S1", "S9", "S11"), n_frames=60)
    torch.manual_seed(3)
    model = TemporalModel(TemporalModelConfig(17, 2, 17, (3, 3), channels=32))
    for name in ("jax", "port"):
        (root / name).mkdir()
        torch.save({"epoch": 0, "lr": 0.001, "optimizer": None, "model_traj": None,
                    "model_pos": model_state_dict(model)}, root / name / "init.bin")
    return root


def _train_args(root, ckpt):
    return ["-k", "gt", "-arc", "3,3", "-ch", "32", "-b", "64", "-e", "2", "-drop", "0",
            "-str", "S1", "-ste", "S9,S11", "--data-dir", str(root / "data"),
            "-c", str(root / ckpt), "-r", "init.bin", "--eval-bucket", "16",
            "--checkpoint-frequency", "1"]


def test_training_cli_matches_jax(train_workdir, capsys):
    root = train_workdir
    jax_runner.main(_train_args(root, "jax") + ["--rng-impl", "threefry2x32"])
    want = capsys.readouterr().out
    runner.main(_train_args(root, "port") + ["--device", "cpu", "--train-engine",
                                              "pallas"])
    got = capsys.readouterr().out

    assert "WARNING: this checkpoint does not contain an optimizer state" in got
    got_epochs, want_epochs = _epoch_lines(got), _epoch_lines(want)
    assert [e[:2] for e in got_epochs] == [e[:2] for e in want_epochs] == [
        (1, "0.001000"), (2, "0.000950")]
    for (_, _, g), (_, _, w) in zip(got_epochs, want_epochs):
        np.testing.assert_allclose(g, w, rtol=1e-4)
    assert re.search(r"^INFO: trained 30 steps in \S+ s \(\S+ frames/s, engine pallas, "
                     r"device cpu\)$", got, re.M)
    got_p, want_p = protocol_numbers(got), protocol_numbers(want)
    assert list(got_p) == list(want_p) == ["Walking", "Eating"]
    for action in want_p:
        np.testing.assert_allclose(got_p[action], want_p[action], rtol=1e-4)
    assert len(average_lines(got)) == 4

    # The JAX CLI reads the port's checkpoint and gives the port's numbers.
    for name in ("epoch_1.bin", "epoch_2.bin"):
        assert (root / "port" / name).exists()
    shutil.copy(root / "port" / "epoch_2.bin", root / "jax" / "port_epoch_2.bin")
    jax_runner.main(["-k", "gt", "-arc", "3,3", "-ch", "32", "-str", "S1", "-ste",
                     "S9,S11", "--data-dir", str(root / "data"), "-c", str(root / "jax"),
                     "--evaluate", "port_epoch_2.bin", "--eval-bucket", "16",
                     "--rng-impl", "threefry2x32"])
    evaluated = capsys.readouterr().out
    assert "This model was trained for 2 epochs" in evaluated
    for action, numbers in protocol_numbers(evaluated).items():
        np.testing.assert_allclose(numbers, got_p[action], rtol=1e-4)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "videopose3d_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for module in ("streaming.py", "ops/kernels/streaming_fused.py", "datasets/custom.py",
                   "ops/kernels/temporal_block_int8.py", "models/convert.py"):
        assert REPO / "videopose3d_torch" / module in files, module
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "videopose3d_tpu"), (
                f"{path.relative_to(REPO)} imports {mod}")


_EPOCH_NO_EVAL = re.compile(r"^\[(\d+)\] time \S+ lr (\S+) 3d_train (\S+)$")


def _fresh_dir(root, name):
    (root / name).mkdir()
    shutil.copy(root / "jax" / "init.bin", root / name / "init.bin")
    return name


def test_training_flags_match_jax(train_workdir, capsys):
    """--no-eval, -no-da, --subset, -lr and -lrd as the JAX CLI applies them
    (a resumed checkpoint's lr takes the place of -lr in both)."""
    root = train_workdir
    extra = ["--no-eval", "-no-da", "--subset", "0.5", "-lr", "0.002", "-lrd", "0.9"]
    jax_runner.main(_train_args(root, _fresh_dir(root, "jax_flags")) + extra
                    + ["--rng-impl", "threefry2x32"])
    want = capsys.readouterr().out
    runner.main(_train_args(root, _fresh_dir(root, "port_flags")) + extra
                + ["--device", "cpu"])
    got = capsys.readouterr().out
    training = [line for line in got.splitlines() if line.startswith("INFO: Training on")]
    assert training == ["INFO: Training on 240 frames"]  # half of S1's 480
    assert training[0] in want.splitlines()
    epochs = [[m.groups() for m in map(_EPOCH_NO_EVAL.match, out.splitlines()) if m]
              for out in (got, want)]
    assert [e[:2] for e in epochs[0]] == [e[:2] for e in epochs[1]] == [
        ("1", "0.001000"), ("2", "0.000900")]
    np.testing.assert_allclose([float(e[2]) for e in epochs[0]],
                               [float(e[2]) for e in epochs[1]], rtol=1e-4)
    got_p, want_p = protocol_numbers(got), protocol_numbers(want)
    for action in want_p:
        np.testing.assert_allclose(got_p[action], want_p[action], rtol=1e-4)


def test_resume_continues_bit_exactly(train_workdir, capsys):
    """Two epochs in one run equal one epoch, a checkpoint and a resumed epoch,
    with dropout on: the optimizer state, the sampler's RNG and the dropout
    generator's state all travel in the checkpoint."""
    root = train_workdir

    def run(ckpt, epochs, resume):
        argv = _train_args(root, ckpt)
        argv[argv.index("-e") + 1] = str(epochs)
        argv[argv.index("-drop") + 1] = "0.25"
        argv[argv.index("-r") + 1] = resume
        runner.main(argv + ["--device", "cpu"])
        return capsys.readouterr().out

    straight = run(_fresh_dir(root, "straight"), 2, "init.bin")
    split = _fresh_dir(root, "split")
    run(split, 1, "init.bin")
    resumed = run(split, 2, "epoch_1.bin")
    assert "This model was trained for 1 epochs" in resumed
    assert "WARNING" not in resumed
    assert _epoch_lines(resumed)[0][0] == 2
    assert _epoch_lines(resumed)[0][1:] == _epoch_lines(straight)[1][1:]
    assert protocol_numbers(resumed) == protocol_numbers(straight)
