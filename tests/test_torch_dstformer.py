"""MotionBERT's DSTformer in the port (``models/dstformer.py``) against the
benchmark's plain float64 reference (``perfbench/reference/dstformer.py``, which
imports nothing of the program), at a small size: 32 features, depth 2, 2 heads,
clips of 27 frames of 17 joints, seeded random weights (biases, LayerNorms and
gates drawn too, so every parameter is exercised).  Also the supervised step
through K1's CPU path on 3-feature keypoints, the evaluator's clip cut, the CLI's
``--model dstformer`` (train, checkpoint, resume, evaluate) and what it refuses,
the attention's axes, and its spans and counters."""

import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench.reference import dstformer as rd  # noqa: E402
from videopose3d_torch import profiling, runner  # noqa: E402
from videopose3d_torch.arguments import parse_args  # noqa: E402
from videopose3d_torch.data.generators import (ChunkedPairSampler,  # noqa: E402
                                               FlatSequenceDataset)
from videopose3d_torch.evaluate import Evaluator  # noqa: E402
from videopose3d_torch.models import dstformer as dst  # noqa: E402
from videopose3d_torch.train import (SupervisedTrainer, TrainLoopConfig,  # noqa: E402
                                     make_optimizer)

from torch_port_helpers import write_h36m_archives  # noqa: E402

SMALL = dict(dim_feat=32, dim_rep=32, depth=2, num_heads=2, maxlen=27)
CFG = dst.DSTformerConfig(**SMALL)
REF_CFG = {k: getattr(CFG, k) for k in (
    "num_joints", "dim_in", "dim_out", "dim_feat", "dim_rep", "depth", "num_heads",
    "mlp_ratio", "maxlen", "qkv_bias", "att_fuse", "ln_eps")}
PERM = np.array([0, 4, 5, 6, 1, 2, 3, 7, 8, 9, 10, 14, 15, 16, 11, 12, 13])
SEEDS = [0, 2 ** 31 + 5]
# float64 against float64: the two sum in other orders, so they part by rounding
# alone, ~1e-15 of a value's size after two layers; 1e-10 leaves that 1e5x room.
F64_TOL = 1e-10
# The port's float32 step against the float64 reference: float32 rounding
# (~6e-8 a value) grows through two layers and a backward to ~1e-6 of a value's
# size; 1e-4 leaves that 100x room and still fails a wrong term of the loss.
F32_TOL = 1e-4
# The parameters' change after the first Adam step: lr * g / (|g| + eps) an
# element, which for |g| near eps (1e-8) turns float32 rounding of the gradient
# into a visible share of lr (1.7e-4 of the largest change read here); 2e-3
# leaves that 10x room and still fails a step that is not AdamW's.
ADAM_TOL = 2e-3


def _model(seed, dtype=torch.float64):
    """The small DSTformer with every parameter drawn from ``seed``."""
    m = dst.DSTformer(CFG).to(dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float64) * 0.1)
    return m


def _weights(m):
    return {n: p.detach().clone() for n, p in m.named_parameters()}


def _clips(seed, n=3, frames=27):
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(n, frames, 17, 3, generator=g, dtype=torch.float64)
    y = torch.randn(n, frames, 17, 3, generator=g, dtype=torch.float64)
    y[:, :, 0] = 0.0
    return x, y


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_reference_names_every_parameter():
    m = dst.DSTformer(CFG)
    shapes = {n: tuple(s) for n, s, _ in rd.param_shapes(REF_CFG)}
    assert shapes == {n: tuple(p.shape) for n, p in m.named_parameters()}


def test_published_sizes_are_the_defaults():
    c = dst.DSTformerConfig()
    assert (c.depth, c.dim_feat, c.dim_rep, c.num_heads, c.dim_feat // c.num_heads,
            c.mlp_ratio * c.dim_feat, c.maxlen, c.num_joints, c.dim_in, c.qkv_bias,
            c.att_fuse, c.ln_eps) == (5, 512, 512, 8, 64, 1024, 243, 17, 3, True, True, 1e-6)
    n = sum(p.numel() for p in dst.DSTformer(c).parameters())
    assert 42.0e6 < n < 42.8e6  # 42.4 M, counted from the shapes


def test_initialisation_is_the_published_one():
    m = dst.DSTformer(CFG)
    for gate in m.ts_attn:
        assert torch.all(gate.weight == 0) and torch.all(gate.bias == 0.5)
    w = m.blocks_st[0].attn_s.qkv.weight.detach()
    assert float(w.abs().max()) <= 0.04 + 1e-7 and 0.015 < float(w.std()) < 0.02
    assert torch.all(m.blocks_ts[1].mlp_t.fc2.bias == 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_forward_matches_the_reference(seed):
    m = _model(seed)
    x, _ = _clips(seed)
    assert _rel(m(x), rd.forward(_weights(m), REF_CFG, x)) < F64_TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_loss_and_every_gradient_match_the_reference(seed):
    m = _model(seed)
    x, y = _clips(seed)
    loss = dst.per_sample_loss(m(x), y).mean()
    grads = torch.autograd.grad(loss, list(m.parameters()))
    w = {k: v.requires_grad_() for k, v in _weights(m).items()}
    ref = rd.per_clip_loss(rd.forward(w, REF_CFG, x), y).mean()
    ref_grads = dict(zip(w, torch.autograd.grad(ref, list(w.values()))))
    assert abs(loss.item() - ref.item()) / ref.item() < F64_TOL
    for (name, _), g in zip(m.named_parameters(), grads):
        assert _rel(g, ref_grads[name]) < F64_TOL, name


def test_one_adamw_step_matches_the_reference():
    m = _model(1)
    x, y = _clips(1)
    w0 = _weights(m)
    opt = make_optimizer(m, 2e-4)
    assert isinstance(opt, torch.optim.AdamW) and opt.param_groups[0]["weight_decay"] == 0.01
    dst.per_sample_loss(m(x), y).mean().backward()
    opt.step()
    _, _, params = rd.train_steps(w0, REF_CFG, [(x.numpy(), y.numpy())], 2e-4, 0.01,
                                  torch.float64, "cpu", group=2)
    for name, p in m.named_parameters():
        moved = params[name] - w0[name]
        assert _rel(p.detach() - w0[name], moved) < F64_TOL, name


def _tracks(n_seq=3, frames=70, seed=3):
    rng = np.random.default_rng(seed)
    p2 = [np.concatenate([rng.uniform(-0.5, 0.5, (frames, 17, 2)),
                          rng.uniform(0.5, 1.0, (frames, 17, 1))], -1).astype(np.float32)
          for _ in range(n_seq)]
    p3 = [(rng.standard_normal((frames, 17, 3)) * 0.2).astype(np.float32) for _ in range(n_seq)]
    return p2, p3


def test_flip_negates_x_and_keeps_the_confidence():
    p2, p3 = _tracks(1, 5)
    ds = FlatSequenceDataset(p2, p3, margins=(0, 0, 0, 0), flip_perms=(PERM, PERM))
    flipped = ds.flat_2d_padded[ds.aug_offset_2d:]
    np.testing.assert_array_equal(flipped[:, :, 0], -p2[0][:, PERM, 0])
    np.testing.assert_array_equal(flipped[:, :, 1:], p2[0][:, PERM, 1:])


@pytest.mark.parametrize("gather_impl", ["xla", "pallas"])
def test_supervised_step_through_k1_matches_the_reference(gather_impl):
    """One ``SupervisedTrainer.step`` (K1's CPU path: 51-float rows, flips on) in
    float32 against the float64 reference on the same clips."""
    p2, p3 = _tracks()
    m = _model(4, torch.float32)
    w0 = _weights(m)
    clip, batch = CFG.maxlen, 4
    loop = TrainLoopConfig(batch_size=batch, chunk_length=clip, pad=0, causal_shift=0,
                           learning_rate=2e-4, use_strided=False, gather_impl=gather_impl)
    dev = FlatSequenceDataset(p2, p3, margins=FlatSequenceDataset.training_margins(0, 0, clip),
                              flip_perms=(PERM, PERM)).to_device("cpu")
    sampler = ChunkedPairSampler([len(p) for p in p2], batch, clip, random_seed=7,
                                 augment=True, use_native=False)
    meta, n_valid = next(sampler.next_epoch())
    opt = make_optimizer(m, 2e-4)
    loss = SupervisedTrainer(m, loop, opt).step(dev, meta, n_valid, 0.0)
    chunks = rd.first_batches([len(p) for p in p2], batch, 1, clip, 7, True)[0]
    np.testing.assert_array_equal(chunks, meta[:n_valid])
    x2, x3 = rd.windows(p2, p3, chunks, PERM, PERM)
    losses, grads, params = rd.train_steps(w0, REF_CFG, [(x2, x3)], 2e-4, 0.01,
                                           torch.float64, "cpu", group=3)
    assert abs(float(loss) - losses[0]) / losses[0] < F32_TOL
    beta1 = opt.param_groups[0]["betas"][0]
    for name, p in m.named_parameters():
        assert _rel(opt.state[p]["exp_avg"].double() / (1 - beta1), grads[name]) < F32_TOL, name
        assert _rel(p.detach().double() - w0[name].double(),
                    params[name] - w0[name].double()) < ADAM_TOL, name


@pytest.mark.parametrize("frames", [27, 40, 59])
def test_evaluator_cuts_videos_into_clips(frames):
    """Whole clips of 27, the last edge-padded and its padded frames dropped."""
    m = _model(5)
    x = torch.randn(2, frames, 17, 3, generator=torch.Generator().manual_seed(frames),
                    dtype=torch.float64)
    got = Evaluator(CFG, engine="xla", device=torch.device("cpu")).infer(m, x)
    assert got.shape == (2, frames, 17, 3)
    w = _weights(m)
    for start in range(0, frames, 27):
        idx = np.minimum(np.arange(start, start + 27), frames - 1)
        want = rd.forward(w, REF_CFG, x[:, idx])[:, :frames - start]
        assert _rel(got[:, start:start + 27], want) < F64_TOL


def test_evaluator_takes_the_xla_engine_only():
    with pytest.raises(ValueError, match="xla"):
        Evaluator(CFG, engine="fused", device=torch.device("cpu"))


@pytest.mark.parametrize("axis", ["spatial", "temporal"])
def test_attention_mixes_only_its_axis(axis):
    """A change to one joint of one frame moves, after one attention sub-layer,
    only that frame's joints (spatial) or that joint's frames (temporal)."""
    m = _model(6)
    block = m.blocks_st[0]
    attn = block.attn_s if axis == "spatial" else block.attn_t
    x, _ = _clips(6, n=1)
    h = m.joints_embed(x)
    moved = h.clone()
    moved[0, 5, 3] += 1.0
    diff = (attn(moved) - attn(h)).abs().amax(dim=-1)[0]  # (T, J)
    hit = diff > 1e-12
    if axis == "spatial":
        assert hit[5].all() and not hit[torch.arange(27) != 5].any()
    else:
        assert hit[:, 3].all() and not hit[:, torch.arange(17) != 3].any()


def test_spans_and_counters_of_a_step():
    """Under a profiler a forward counts one spatial and one temporal attention
    a stream a layer, the step's tokens, and opens the attention and gate spans
    in the forward and the backward."""
    m = _model(7, torch.float32)
    x, y = _clips(7, n=2)
    profiling.reset_counters()
    with torch.profiler.profile() as prof:
        pred = dst.forward_train(m, x.float())
        dst.per_sample_loss(pred, y.float()).mean().backward()
    c = profiling.counters()
    assert c["dst.attention_spatial"] == c["dst.attention_temporal"] == 2 * CFG.depth
    assert c["dst.tokens"] == 2 * 27 * 17
    names = [e.name for e in prof.events()]
    for span in ("vp3d.dst.attention.spatial", "vp3d.dst.attention.temporal"):
        assert names.count(span) == 2 * 2 * CFG.depth  # forward and backward
    assert names.count("vp3d.dst.fuse") == CFG.depth


def test_confidence_of_one_for_datasets_without_scores():
    kps = {"S1": {"Walk": [np.zeros((4, 17, 2), np.float32)]}}
    runner._with_confidence(kps)
    assert kps["S1"]["Walk"][0].shape == (4, 17, 3)
    assert np.all(kps["S1"]["Walk"][0][..., 2] == 1.0)


def _small_config(num_kps, num_joints):
    return dst.DSTformerConfig(num_joints=num_kps, **SMALL)


def test_cli_trains_checkpoints_resumes_and_evaluates(tmp_path, capsys):
    write_h36m_archives(tmp_path, subjects=("S1", "S9"), n_frames=60)
    base = ["--model", "dstformer", "-k", "gt", "-str", "S1", "-ste", "S9", "--data-dir",
            str(tmp_path), "-c", str(tmp_path / "ck"), "--device", "cpu", "-b", "4",
            "--checkpoint-frequency", "1"]
    with mock.patch.object(runner, "_dstformer_config", _small_config):
        runner.main(base + ["-e", "1"])
        first = capsys.readouterr().out
        runner.main(base + ["-e", "2", "-r", "epoch_1.bin"])
        resumed = capsys.readouterr().out
        runner.main(base + ["--evaluate", "epoch_2.bin"])
        evaluated = capsys.readouterr().out
    assert "INFO: Training the DSTformer on clips of 27 frames (4 a step, AdamW)" in first
    assert "[1] time" in first and "lr 0.000200" in first
    assert "This model was trained for 1 epochs" in resumed and "[2] time" in resumed
    assert "lr 0.000198" in resumed  # the recipe's decay of 0.99 an epoch
    assert "engine xla" in resumed
    chk = torch.load(tmp_path / "ck" / "epoch_2.bin", weights_only=False)
    assert chk["model_kind"] == "dstformer" and chk["model_config"]["dim_feat"] == 32
    assert "Protocol #1   (MPJPE) action-wise average" in evaluated
    # The final evaluation of the resumed run and --evaluate of its checkpoint agree.
    tail = lambda out: [l for l in out.splitlines() if "action-wise average" in l]
    assert tail(resumed) == tail(evaluated)
    with pytest.raises(SystemExit, match="dstformer"):
        runner.main(["-k", "gt", "-arc", "3,3", "-ch", "16", "--data-dir", str(tmp_path),
                     "-c", str(tmp_path / "ck"), "--device", "cpu", "-ste", "S9",
                     "--evaluate", "epoch_2.bin"])


@pytest.mark.parametrize("flag", [["-arc", "3,3,3"], ["--causal"], ["--dense"], ["-ch", "256"],
                                  ["-sun", "S5"], ["--warmup", "2"], ["--no-proj"],
                                  ["--linear-projection"], ["--no-bone-length"],
                                  ["--stride", "2"]])
def test_cli_refuses_convnet_flags(flag, capsys):
    with pytest.raises(SystemExit):
        parse_args(["--model", "dstformer"] + flag)
    assert "--model dstformer does not take" in capsys.readouterr().err


@pytest.mark.parametrize("flag,missing", [(["--train-engine", "pallas"], "attention core"),
                                          (["--serving-engine", "fused"], "xla")])
def test_cli_refuses_engines_without_kernels(flag, missing, capsys):
    with pytest.raises(SystemExit):
        parse_args(["--model", "dstformer"] + flag)
    assert missing in capsys.readouterr().err


def test_cli_defaults_follow_the_model():
    dst_args, tcn_args = parse_args(["--model", "dstformer"]), parse_args([])
    assert (dst_args.batch_size, dst_args.learning_rate, dst_args.lr_decay) == (32, 2e-4, 0.99)
    assert (tcn_args.batch_size, tcn_args.learning_rate, tcn_args.lr_decay) == (1024, 1e-3, 0.95)
