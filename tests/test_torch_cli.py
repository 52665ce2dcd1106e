"""The slices as a whole: ``videopose3d_torch.runner.main`` against
``videopose3d_tpu.runner.main`` on the same synthetic H36M archives.

``--evaluate`` of one JAX-CLI checkpoint with the fused and xla serving engines:
per-action protocol numbers agree to relative 1e-4 (float32 models summed in
other orders) and the action-wise average lines are equal.  Supervised and
semi-supervised (``-sun``) training from one initial checkpoint with dropout 0:
the epoch lines and the final protocol numbers agree to relative 1e-4, the JAX
CLI evaluates the port's checkpoint to the port's own numbers, and the
trajectory model crosses between the packages' checkpoints."""

import ast
import pathlib
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from videopose3d_tpu import runner as jax_runner
from videopose3d_tpu.checkpoint import save_checkpoint
from videopose3d_tpu.models.convert import (params_from_torch_state_dict,
                                            params_to_torch_state_dict)
from videopose3d_tpu.models.temporal import TemporalModelConfig as JConfig
from videopose3d_torch import runner
from videopose3d_torch.arguments import parse_args
from videopose3d_torch.checkpoint import (OpaqueObject, load_any_checkpoint,
                                          model_state_dict)
from videopose3d_torch.models.convert import state_dict_from_jax
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


@pytest.mark.parametrize("c", [30, 1030, 3636])
def test_fused_serving_engine_takes_any_width(c):
    """The fused evaluation blocks hold nothing per channel in shared memory and
    pad widths that are not whole 16-byte words: --evaluate --serving-engine
    fused on CUDA refuses no width, as the JAX CLI."""
    args = parse_args(["-k", "gt", "-arc", "3,3,3", "-ch", str(c), "--device", "cuda",
                       "--evaluate", "epoch_3.bin", "--serving-engine", "fused"])
    assert runner.kernel_width_error(args) is None


@pytest.mark.parametrize("c", [30, 1030, 1952, 3636])
def test_int8_serving_engine_takes_any_width(c):
    """The int8 stage kernels hold nothing per channel in shared memory, and the
    int8 forward pads a width that is not a multiple of 16 with zero channels:
    --serving-engine int8 on CUDA refuses no width, as the JAX CLI."""
    args = parse_args(["-k", "gt", "-arc", "3,3,3", "-ch", str(c), "--device", "cuda",
                       "--evaluate", "epoch_3.bin", "--serving-engine", "int8"])
    assert runner.kernel_width_error(args) is None


@pytest.mark.parametrize("c", [30, 1030, 3636])
def test_train_engine_pallas_takes_any_width(c):
    """The train block pads C % 4 != 0 and its tap GEMMs have no shared-memory
    ceiling: --train-engine pallas on CUDA refuses no width, as the JAX CLI."""
    args = parse_args(["-k", "gt", "-arc", "3,3,3", "-ch", str(c), "--device", "cuda",
                       "--train-engine", "pallas"])
    assert runner.kernel_width_error(args) is None


@pytest.mark.parametrize("engine,c,extra,limit", [
    ("int8_fused", 15169, [], "at most 15168 channels"),
    ("bf16_fused", 1024, ["--compute-dtype", "bfloat16", "--frames-per-step", "17"],
     "1 to 16 frames"),
    ("bf16_fused", 19016, ["--compute-dtype", "bfloat16"], "at most 19008 channels"),
    ("int8_fused", 1024, ["--frames-per-step", "17"], "1 to 16 frames"),
])
def test_streaming_fused_widths_are_refused_before_loading(tmp_path, engine, c, extra,
                                                           limit):
    """python -m videopose3d_torch.streaming with a fused engine on CUDA: a -ch or
    --frames-per-step the fused step kernel cannot take ends the run before the
    archive or the checkpoint is read (neither exists), naming the limit and the
    per-layer engine."""
    from videopose3d_torch import streaming
    argv = ["-k", "myvideos", "--data-dir", str(tmp_path / "missing"), "--checkpoint",
            str(tmp_path / "missing.bin"), "-arc", "3,3,3", "-ch", str(c), "--engine",
            engine, "--output", str(tmp_path / "out.npz"), "--device", "cuda", *extra]
    with pytest.raises(SystemExit, match=limit) as refused:
        streaming.main(argv)
    assert f"--engine {engine.replace('_fused', '')}" in str(refused.value)
    assert not (tmp_path / "out.npz").exists()


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("c", [30, 1000, 1216, 2048, 4096])
def test_streaming_bf16_fused_takes_any_width(c, k):
    """Both tensor-core steps, bf16 and int8, take any C up to their ceilings
    (zero-filled K and N tails, element-wise staging where rows are not 16-byte
    aligned), as JAX's full-width kernels do."""
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    for engine in ("bf16_fused", "int8_fused"):
        assert sf.step_limit_error(engine, c, (3, 3, 3, 3), k) is None, engine


@pytest.mark.parametrize("b,k", [(1, 1), (256, 1), (1024, 1), (256, 8), (1024, 8), (5, 16)])
def test_streaming_bf16_plan_fills_the_card_within_shared_memory(b, k):
    """stream_bf16_plan: for every C up to the ceiling a plan whose shared memory
    fits the opt-in limit, rows a multiple of 16 and >= k, and a power-of-two
    cluster that leaves each block a column; at B = 1,024, k = 1 at least half
    the card's SMs busy from C = 512 on, and at the full width 13 clusters of 8
    CUDA blocks of 80 rows: one wave (a cluster of 8 fits in 120 of 132 SMs)."""
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    from videopose3d_torch.ops.kernels.temporal_block import SMEM_OPT_IN
    top = sf.BF16_MAX_CHANNELS
    assert top >= 4096
    assert sf.step_smem_bytes(False, top) <= SMEM_OPT_IN < sf.step_smem_bytes(False, top + 1)
    assert sf.stream_bf16_plan(b, k, top + 1) is None
    assert "at most" in sf.step_limit_error("bf16_fused", top + 1, (3, 3), k)
    for c in sorted({1, 8, 9, 30, 64, 512, 1000, 1024, 1216, 2048, 4096, top,
                     *range(7, top, 997)}):
        rows, slices = sf.stream_bf16_plan(b, k, c)
        assert sf.bf16_smem_bytes(rows, slices, c) <= SMEM_OPT_IN, c
        assert rows % 16 == 0 and rows >= k and slices in (1, 2, 4, 8)
        assert (slices - 1) * sf._slice_cols(c, slices) < c
        if (b, k) == (1024, 1) and c >= 512:
            assert -(-b // rows) * slices >= 64, c
    if (b, k) == (1024, 1):
        assert sf.stream_bf16_plan(b, k, 1024) == (80, 8)


@pytest.mark.parametrize("b,k", [(1, 1), (256, 1), (1024, 1), (256, 8), (1024, 8), (5, 16)])
def test_streaming_int8_plan_fills_the_card_within_shared_memory(b, k):
    """stream_int8_plan: for every C up to the ceiling (at least 8,192) a plan
    whose shared memory fits the opt-in limit, rows a multiple of 16 and >= k, and
    a power-of-two cluster that leaves each block a column; at B = 1,024, k = 1 at
    least half the card's SMs busy from C = 512 on, and at the full width 13
    clusters of 8 CUDA blocks of 80 rows, as the bf16 step."""
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    from videopose3d_torch.ops.kernels.temporal_block import SMEM_OPT_IN
    top = sf.INT8_MAX_CHANNELS
    assert top >= 8192
    assert sf.step_smem_bytes(True, top) <= SMEM_OPT_IN < sf.step_smem_bytes(True, top + 1)
    assert sf.stream_int8_plan(b, k, top + 1) is None
    assert "at most" in sf.step_limit_error("int8_fused", top + 1, (3, 3), k)
    for c in sorted({1, 8, 9, 30, 64, 512, 1000, 1024, 2080, 4096, 8192, top,
                     *range(7, top, 997)}):
        rows, slices = sf.stream_int8_plan(b, k, c)
        assert sf.int8_smem_bytes(rows, slices, c) <= SMEM_OPT_IN, c
        assert rows % 16 == 0 and rows >= k and slices in (1, 2, 4, 8)
        assert (slices - 1) * sf._slice_cols(c, slices) < c
        if (b, k) == (1024, 1) and c >= 512:
            assert -(-b // rows) * slices >= 64, c
    if (b, k) == (1024, 1):
        assert sf.stream_int8_plan(b, k, 1024) == (80, 8)


@pytest.mark.parametrize("b,k,plan", [(256, 1, (32, 8)), (1024, 1, (80, 8)),
                                      (256, 8, (80, 4)), (1024, 8, (48, 2))])
def test_streaming_int8_plan_picks_the_swept_plan(b, k, plan):
    """stream_int8_plan at C = 1,024 (-arc 3,3,3,3,3), B = 256 and 1,024, k = 1
    and 8 picks the fastest plan of two kernel_ab.py --sweep stream_int8 runs on an
    H100, or one within 1.3 % of it (at B = 256, k = 8 in one run).  Without the
    cluster's meeting cost it picked 80 x 8 at B = 1,024, k = 8, 8.6 % and 11 %
    behind 48 x 2."""
    from videopose3d_torch.ops.kernels import streaming_fused as sf
    assert sf.stream_int8_plan(b, k, 1024) == plan


@pytest.mark.parametrize("c", [30, 40])
def test_int8_step_packing_round_trips(c):
    """pack_int8_step: (ceil32(K) / 4, ceil8(N)) int32 whose bytes unpack to the
    int8 weights, with zero K and N tails; prepare_int8_fused packs every block's
    taps and 1x1 weights beside the model, which it leaves as it was."""
    from videopose3d_torch.ops.kernels.temporal_block_int8 import (Int8Block, QuantizedModel,
                                                                    pack_int8_step)
    from videopose3d_torch.streaming import prepare_int8_fused
    rng = np.random.default_rng(c)
    i8 = lambda *shape: torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    f32 = lambda: torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    blocks = [Int8Block(i8(3, c, c), i8(c, c), f32(), f32(), f32(), f32(), f32())
              for _ in range(2)]
    q = QuantizedModel(i8(3, 34, c).to(torch.bfloat16), f32(), f32(), blocks,
                       i8(c, 51).to(torch.bfloat16), f32()[:51])
    kp, np_ = -(-c // 32) * 32, -(-c // 8) * 8

    def unpack(p):
        assert p.dtype == torch.int32 and p.shape == (kp // 4, np_)
        return p.contiguous().view(torch.int8).reshape(kp // 4, np_, 4).permute(
            0, 2, 1).reshape(kp, np_)

    prepared = prepare_int8_fused(q)
    assert prepared.q is q and len(prepared.packs) == len(blocks)
    for blk, (wa, wb) in zip(q.blocks, prepared.packs):
        for w, p in [*zip(blk.wq_a, wa), (blk.wq_b, wb)]:
            full = unpack(p)
            assert torch.equal(full[:c, :c], w)
            assert not full[c:].any() and not full[:, c:].any()
    assert torch.equal(pack_int8_step(blocks[0].wq_b), prepared.packs[0][1])


def test_device_cuda_raises_without_a_card(workdir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(_args(workdir, "fused"))


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
                   "ops/kernels/temporal_block_int8.py", "models/convert.py",
                   "visualization.py", "profiling.py", "native.py", "checkpoint.py"):
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


_SEMI_EPOCH = re.compile(r"^\[(\d+)\] time \S+ lr (\S+) 3d_train (\S+) 3d_eval (\S+) "
                         r"traj_eval (\S+) 3d_valid (\S+) traj_valid (\S+) "
                         r"2d_train_sup (\S+) 2d_train_unsup (\S+) 2d_valid (\S+)$")


def _semi_epoch_lines(out):
    """[(epoch, lr text, [the nine losses])] from the printed semi-supervised lines."""
    return [(int(m.group(1)), m.group(2), [float(v) for v in m.groups()[2:]])
            for m in map(_SEMI_EPOCH.match, out.splitlines()) if m]


@pytest.fixture(scope="module")
def semi_workdir(tmp_path_factory):
    """Archives with a labeled (S1) and an unlabeled (S5) subject and one random
    initial checkpoint of both models (``epoch: 0``, no optimizer state), copied
    into one checkpoint directory per package."""
    root = tmp_path_factory.mktemp("semi_cli")
    (root / "data").mkdir()
    write_h36m_archives(str(root / "data"), subjects=("S1", "S5", "S9", "S11"),
                        n_frames=60)
    torch.manual_seed(5)
    pos = TemporalModel(TemporalModelConfig(17, 2, 17, (3, 3), channels=32))
    traj = TemporalModel(TemporalModelConfig(17, 2, 1, (3, 3), channels=32))
    for name in ("jax", "port"):
        (root / name).mkdir()
        torch.save({"epoch": 0, "lr": 0.001, "optimizer": None,
                    "model_pos": model_state_dict(pos),
                    "model_traj": model_state_dict(traj)}, root / name / "init.bin")
    return root


def _semi_args(root, ckpt, epochs=2, resume="init.bin", dropout="0"):
    """Two epochs, the first of warmup; half of S1 labeled (8 steps of 64, the
    last partial) against all of S5 unlabeled (15 batches), so that a checkpoint
    lands inside the unlabeled stream's permutation."""
    (root / ckpt).mkdir(exist_ok=True)
    if not (root / ckpt / "init.bin").exists():
        shutil.copy(root / "jax" / "init.bin", root / ckpt / "init.bin")
    return ["-k", "gt", "-arc", "3,3", "-ch", "32", "-b", "64", "-e", str(epochs),
            "--warmup", "1", "-drop", dropout, "-str", "S1", "-sun", "S5", "--subset",
            "0.5", "-ste", "S9,S11", "--data-dir", str(root / "data"), "-c",
            str(root / ckpt), "-r", resume, "--eval-bucket", "16",
            "--checkpoint-frequency", "1"]


def test_semi_training_cli_matches_jax(semi_workdir, capsys):
    root = semi_workdir
    jax_runner.main(_semi_args(root, "jax") + ["--rng-impl", "threefry2x32"])
    want = capsys.readouterr().out
    runner.main(_semi_args(root, "port") + ["--device", "cpu", "--train-engine", "pallas"])
    got = capsys.readouterr().out

    for out in (got, want):
        assert "INFO: Semi-supervision on 480 frames" in out.splitlines()
    got_epochs, want_epochs = _semi_epoch_lines(got), _semi_epoch_lines(want)
    assert [e[:2] for e in got_epochs] == [e[:2] for e in want_epochs] == [
        (1, "0.001000"), (2, "0.000950")]
    for (_, _, g), (_, _, w) in zip(got_epochs, want_epochs):
        np.testing.assert_allclose(g, w, rtol=1e-4)
        assert all(np.isfinite(g)) and g[7] > 0  # 2d_train_unsup
    assert re.search(r"^INFO: trained 16 steps in \S+ s \(\S+ frames/s, engine pallas, "
                     r"device cpu\)$", got, re.M)
    got_p, want_p = protocol_numbers(got), protocol_numbers(want)
    assert list(got_p) == list(want_p) == ["Walking", "Eating"]
    for action in want_p:
        np.testing.assert_allclose(got_p[action], want_p[action], rtol=1e-4)

    # The trajectory model crosses between the packages' checkpoints, and the
    # unlabeled stream's place in its permutation is saved.
    tcfg = JConfig(num_joints_in=17, in_features=2, num_joints_out=1, filter_widths=(3, 3),
                   channels=32)
    port_chk = load_any_checkpoint(str(root / "port" / "epoch_1.bin"))
    tparams, tstate = params_from_torch_state_dict(tcfg, port_chk["model_traj"])
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tparams),
                               jax.tree_util.tree_map(np.asarray, tstate))
    assert back.keys() == port_chk["model_traj"].keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, port_chk["model_traj"][k], err_msg=k)
    jax_chk = load_any_checkpoint(str(root / "jax" / "epoch_1.bin"))
    traj = TemporalModel(TemporalModelConfig(17, 2, 1, (3, 3), channels=32))
    runner.load_model(traj, jax_chk["model_traj"])
    assert port_chk["stream_idx_semi"] == jax_chk["stream_idx_semi"] == 8
    for a, b in zip(port_chk["stream_rng_semi"], jax_chk["stream_rng_semi"]):
        np.testing.assert_array_equal(a, b)


def test_semi_resume_across_warmup_repeats_epoch_two(semi_workdir, capsys):
    """A warmup epoch, a checkpoint and a resumed full epoch print the epoch-2
    line and protocol numbers of two epochs in one run, with dropout on: the
    trajectory model, the optimizer over both models, both samplers (the
    unlabeled one inside its permutation) and the dropout generator travel in the
    checkpoint."""
    root = semi_workdir

    def run(ckpt, epochs, resume):
        runner.main(_semi_args(root, ckpt, epochs, resume, dropout="0.25")
                    + ["--device", "cpu"])
        return capsys.readouterr().out

    straight = run("semi_straight", 2, "init.bin")
    run("semi_split", 1, "init.bin")
    resumed = run("semi_split", 2, "epoch_1.bin")
    assert "This model was trained for 1 epochs" in resumed
    assert "WARNING" not in resumed
    assert [e[0] for e in _semi_epoch_lines(resumed)] == [2]
    assert _semi_epoch_lines(resumed)[0][1:] == _semi_epoch_lines(straight)[1][1:]
    assert protocol_numbers(resumed) == protocol_numbers(straight)
