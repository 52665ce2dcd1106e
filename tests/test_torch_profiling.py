"""The port's observability against videopose3d_tpu: ``profiling.py``
(``StepTimer``, ``log_metrics_jsonl``, ``device_trace``), the CLI's
``--metrics-log``, ``--profile-dir`` and ``--export-training-curves``, and the
two argument parsers' flags."""

import argparse
import glob
import json
import shutil
import time

import numpy as np
import pytest
import torch

from videopose3d_tpu import profiling as jprof
from videopose3d_tpu import runner as jax_runner
from videopose3d_torch import profiling, runner
from videopose3d_torch.checkpoint import model_state_dict
from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig

from torch_port_helpers import write_h36m_archives

EPOCHS = 4  # the curves start after epoch 3


def test_step_timer_matches_jax(monkeypatch):
    ticks = iter([10.0, 10.012, 10.015, 10.040, 10.041, 10.0655] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    timers = [profiling.StepTimer(), jprof.StepTimer()]
    for t in timers:
        assert t.summary() == {} and t.report() == "steps: no steps recorded"
        t.start()
        for _ in range(5):
            t.tick()
    got, want = (t.summary() for t in timers)
    assert got == want
    assert got["steps"] == 5 and got["max_ms"] == pytest.approx(25.0)
    assert timers[0].report("epoch 1") == timers[1].report("epoch 1")
    timers[0].reset()
    assert timers[0].summary() == {}


def test_log_metrics_jsonl_matches_jax(tmp_path):
    record = {"epoch": np.int64(3), "lr": np.float32(0.5), "loss": torch.tensor(0.25),
              "steps": 7, "name": "x"}
    profiling.log_metrics_jsonl(str(tmp_path / "sub" / "port.jsonl"), record)
    jprof.log_metrics_jsonl(str(tmp_path / "sub" / "jax.jsonl"), record)
    got = (tmp_path / "sub" / "port.jsonl").read_text()
    assert got == (tmp_path / "sub" / "jax.jsonl").read_text()
    assert json.loads(got) == {"epoch": 3, "lr": 0.5, "loss": 0.25, "steps": 7, "name": "x"}


def test_device_trace_none_is_a_no_op(tmp_path):
    with profiling.device_trace(None):
        torch.ones(3).sum()
    assert not any(tmp_path.iterdir())


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    a = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path / "trace"), "cpu"):
        (a @ a).sum()
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def _flag_set(parse_args, monkeypatch):
    parsers = []
    parse = argparse.ArgumentParser.parse_args

    def spy(self, *args, **kwargs):
        parsers.append(self)
        return parse(self, *args, **kwargs)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    parse_args([])
    return set(parsers[-1]._option_string_actions)


def test_the_parsers_take_the_same_flags(monkeypatch):
    from videopose3d_torch.arguments import parse_args
    from videopose3d_tpu.arguments import parse_args as jax_parse_args
    # The port's own flags: --device, and --model (the DSTformer, which the JAX
    # package does not have).
    assert _flag_set(parse_args, monkeypatch) == (
        _flag_set(jax_parse_args, monkeypatch) | {"--device", "--model"})
    args = parse_args(["--profile-dir", "p", "--metrics-log", "m.jsonl"])
    assert (args.profile_dir, args.metrics_log) == ("p", "m.jsonl")
    assert parse_args([]).profile_dir is None and parse_args([]).metrics_log is None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four epochs through both CLIs from one initial checkpoint, supervised and
    semi-supervised (``-sun``), with --metrics-log and
    --export-training-curves; the port's supervised run also with
    --profile-dir.  Returns the root: ``<package>_<mode>/`` per run."""
    root = tmp_path_factory.mktemp("observability")
    (root / "data").mkdir()
    write_h36m_archives(str(root / "data"), subjects=("S1", "S5", "S9", "S11"),
                        n_frames=60)
    torch.manual_seed(7)
    pos = TemporalModel(TemporalModelConfig(17, 2, 17, (3, 3), channels=16))
    traj = TemporalModel(TemporalModelConfig(17, 2, 1, (3, 3), channels=16))
    torch.save({"epoch": 0, "lr": 0.001, "optimizer": None,
                "model_pos": model_state_dict(pos), "model_traj": model_state_dict(traj)},
               root / "init.bin")
    for mode in ("sup", "semi"):
        for package, main, extra in (("jax", jax_runner.main, ["--rng-impl", "threefry2x32"]),
                                     ("port", runner.main, ["--device", "cpu"])):
            ckpt = root / f"{package}_{mode}"
            ckpt.mkdir()
            shutil.copy(root / "init.bin", ckpt / "init.bin")
            argv = ["-k", "gt", "-arc", "3,3", "-ch", "16", "-b", "64", "-e", str(EPOCHS),
                    "-drop", "0", "-str", "S1", "-ste", "S9", "--subset", "0.5",
                    "--data-dir", str(root / "data"), "-c", str(ckpt), "-r", "init.bin",
                    "--eval-bucket", "16", "--checkpoint-frequency", "100",
                    "--export-training-curves", "--metrics-log", str(ckpt / "m.jsonl"),
                    *extra]
            if mode == "semi":
                argv += ["-sun", "S5", "--warmup", "1"]
            if package == "port" and mode == "sup":
                argv += ["--profile-dir", str(ckpt / "trace")]
            main(argv)
    return root


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# Epochs whose loss_3d_train is held to 1e-5 relative.  Semi-supervised runs of
# the two packages drift apart from the first semi-supervised epoch on (ReLU-gate
# and bone-length sign flips under AMSGrad's per-parameter scaling): on this
# input 1e-6 after epoch 2, 7e-6 after epoch 3, 3e-4 after epoch 4, and the same
# growth, one epoch later, with --no-bone-length.  test_torch_cli.py holds the
# semi epoch lines over two epochs as well.
HELD_EPOCHS = {"sup": EPOCHS, "semi": 3}


@pytest.mark.parametrize("mode", ["sup", "semi"])
def test_metrics_log_matches_jax(runs, mode):
    got, want = (_records(runs / f"{p}_{mode}" / "m.jsonl") for p in ("port", "jax"))
    assert len(got) == len(want) == EPOCHS
    for epoch, (g, w) in enumerate(zip(got, want), 1):
        assert set(g) == set(w) == {"epoch", "lr", "bn_momentum", "loss_3d_train",
                                    "step_steps", "step_mean_ms", "step_p50_ms",
                                    "step_p95_ms", "step_max_ms"}
        assert g["epoch"] == w["epoch"] == epoch
        assert (g["lr"], g["bn_momentum"]) == (w["lr"], w["bn_momentum"])
        if epoch <= HELD_EPOCHS[mode]:
            assert g["loss_3d_train"] == pytest.approx(w["loss_3d_train"], rel=1e-5)
        assert g["step_steps"] > 1 and g["step_p95_ms"] <= g["step_max_ms"]


@pytest.mark.parametrize("mode", ["sup", "semi"])
def test_training_curves_are_jax_files(runs, mode):
    pngs = {"sup": ["loss_3d.png"], "semi": ["loss_2d.png", "loss_3d.png", "loss_traj.png"]}
    for package in ("port", "jax"):
        found = sorted(p.name for p in (runs / f"{package}_{mode}").glob("*.png"))
        assert found == pngs[mode], package


def test_export_training_curves_writes_jax_bytes(tmp_path):
    rng = np.random.default_rng(1)
    lists = [list(rng.uniform(0.05, 0.5, 7)) for _ in range(10)]
    for name, fn in (("port", runner._export_training_curves),
                     ("jax", jax_runner._export_training_curves)):
        (tmp_path / name).mkdir()
        fn(argparse.Namespace(checkpoint=str(tmp_path / name)), 7, True, *lists)
    for png in ("loss_3d.png", "loss_traj.png", "loss_2d.png"):
        assert (tmp_path / "port" / png).read_bytes() == (tmp_path / "jax" / png).read_bytes()


def test_profile_dir_traces_the_first_epoch(runs):
    files = glob.glob(str(runs / "port_sup" / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names or "aten::mm" in names
