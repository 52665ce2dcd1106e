"""The port's semi-supervised trainer against the benchmark's plain float64
reference of the whole semi step (``perfbench/reference/semi.py``, which imports
nothing of the program): one warm-up step and three full ones at 3 blocks of 32
channels from seeded random weights, on both train engines, with and without
dropout; the trajectory network's depth keeping the back-projection in its
unclamped range; and the CLI's ``-sun`` under ``--train-engine pallas`` running
both networks' residual blocks through the train-block kernels, the pose
network's dropout masks drawn first."""

import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import semi_data, synth  # noqa: E402
from perfbench.reference import semi as rs  # noqa: E402
from videopose3d_torch import runner  # noqa: E402
from videopose3d_torch import train as ttrain  # noqa: E402
from videopose3d_torch.data.generators import FlatSequenceDataset  # noqa: E402
from videopose3d_torch.models import temporal  # noqa: E402
from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig  # noqa: E402

from torch_port_helpers import write_h36m_archives  # noqa: E402

CFG = {"filter_widths": [3, 3, 3], "channels": 32, "num_joints_in": 17, "in_features": 2,
       "num_joints_out": 17, "trajectory_joints_out": 1, "dropout": 0.25, "causal": False,
       "skeleton_parents": [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15]}
TRAFFIC = {"labeled_sequences": 2, "unlabeled_sequences": 4, "frames_per_sequence": 200}
BATCH, SEED, MASK_SEED, LR = 64, 2 ** 31 + 77, 5, 1e-3
PAD = 13  # receptive field 27
STEPS = 4  # one warm-up step, then three full ones


def _model(cfg, weights, engine, dropout):
    m = TemporalModel(TemporalModelConfig(
        num_joints_in=17, in_features=2, num_joints_out=cfg["num_joints_out"],
        filter_widths=tuple(cfg["filter_widths"]), channels=cfg["channels"], dropout=dropout,
        train_engine=engine))
    synth.load_into(m, weights)
    return m.train()


def _run(engine, dropout):
    """The port's four steps and the reference's over the same weights, data,
    chunks and dropout masks, each reference step from the parameters the port
    began it with: both as per step (losses [pose, trajectory, projection,
    bone, total], {leaf: gradient norm}, {leaf: update norm}, parameters)."""
    cfg = {**CFG, "dropout": dropout}
    cfg_traj = semi_data.trajectory_config(cfg)
    w_pos = synth.make_weights(cfg, SEED, "cpu")
    w_traj = semi_data.trajectory_weights(cfg, SEED, "cpu")
    p2_l, p3_l = semi_data.labeled_set(TRAFFIC, SEED, "cpu")
    p2_u, cams_u = semi_data.unlabeled_set(TRAFFIC, SEED, "cpu")
    perm = synth.flip_perm(17)
    lab = rs.first_batches([len(p) for p in p2_l], BATCH, STEPS, 11, True)
    unl = rs.first_batches([len(p) for p in p2_u], BATCH, STEPS, 12, True)

    margins = FlatSequenceDataset.training_margins(PAD, 0, 1)
    dev_l = FlatSequenceDataset(p2_l, p3_l, None, margins=margins,
                                flip_perms=(perm, perm)).to_device("cpu")
    dev_u = FlatSequenceDataset(p2_u, None, cams_u, margins=margins,
                                flip_perms=(perm, perm)).to_device("cpu")
    pos, traj = _model(cfg, w_pos, engine, dropout), _model(cfg_traj, w_traj, engine, dropout)
    optimizer = ttrain.make_optimizer([pos, traj], LR)
    loop = ttrain.TrainLoopConfig(batch_size=BATCH, chunk_length=1, pad=PAD, causal_shift=0)
    trainer = ttrain.SemiSupervisedTrainer(pos, traj, loop, optimizer,
                                           np.asarray(cfg["skeleton_parents"]))
    names = {f"{p}.{n}": t for p, m in (("pos", pos), ("traj", traj))
             for n, t in m.named_parameters()}
    gen = torch.Generator().manual_seed(MASK_SEED)
    checked, steps = [], []
    for k, ((chunks_l, n_l), (chunks_u, n_u)) in enumerate(zip(lab, unl)):
        before = {n: p.detach().clone() for n, p in names.items()}
        out = trainer.step(dev_l, dev_u, chunks_l.astype(np.int32), n_l,
                           chunks_u.astype(np.int32), n_u, 0.1, k == 0, generator=gen)
        checked.append((rs.five_losses(*(float(v) for v in out)),
                        {n: float(p.grad.double().norm()) for n, p in names.items()},
                        {n: float((p.detach() - before[n]).double().norm())
                         for n, p in names.items()}, before))
        x2_l, x3_l, root_l = rs.labeled_windows(p2_l, p3_l, chunks_l, PAD, 0, perm, perm)
        step = {"x2_l": x2_l, "x3_l": x3_l, "root_l": root_l, "n_l": n_l}
        if k > 0:  # the warm-up step's unlabeled batch goes unused, as in the CLI
            x2_u, target_u, cam_u = rs.unlabeled_windows(p2_u, cams_u, chunks_u, PAD, 0, perm)
            step.update(x2_u=x2_u, target_u=target_u, cam_u=cam_u, n_u=n_u)
        steps.append(step)
    ref = rs.semi_steps(w_pos, w_traj, cfg, cfg_traj, steps, cfg["skeleton_parents"],
                        MASK_SEED, LR, torch.float64, "cpu",
                        starts=[c[3] for c in checked])
    return checked, ref


@pytest.mark.parametrize("dropout", [0.0, 0.25])
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_semi_trainer_matches_float64_reference(engine, dropout):
    checked, ref = _run(engine, dropout)
    got, want = (np.asarray([c[0] for c in run]) for run in (checked, ref))
    # The warm-up step: no projection or bone term (the latter read as a remainder).
    assert got[0, 2] == want[0, 2] == want[0, 3] == 0.0 and abs(got[0, 3]) < 1e-6
    np.testing.assert_allclose(got[0, [0, 1, 4]], want[0, [0, 1, 4]], rtol=1e-6)
    assert np.all(want[1:, 2:4] > 0)  # the projection and bone terms are live
    numbers = rs.compare(checked[1:], ref[1:])
    # float32 sums over 64 rows of 32-channel blocks against float64, every step
    # from the same parameters: the losses agree to a few float32 roundings
    # (at most 1.7e-7 measured), held to 1e-6.  The bone term is read as the
    # total's remainder, so it carries the total's rounding over its own
    # smaller size (at most 1.1e-6 measured), held to 1e-5.
    assert numbers["loss1_gap"] < 1e-6 and numbers["loss_gap"] < 1e-6
    assert numbers["bone_gap"] < 1e-5
    # Each step's gradient and update, by leaf norm as the benchmark compares
    # them (Adam's step is sign-sensitive where a gradient is near zero, so
    # elements are not compared), as a share of the larger of the leaf's and
    # the median leaf's norm: the gradients within 1e-5 (float32 sums of
    # 64-row products; at most 4.7e-7 measured), the updates within 1e-4 (at
    # most 1.7e-5 measured).
    assert numbers["grad_gap"] < 1e-5 and numbers["change_gap"] < 1e-4
    assert numbers["leaves_left_out"] <= 2


def test_trajectory_depth_keeps_the_projection_unclamped():
    """With the trajectory network's depth bias in [4, 6] m nearly all the
    back-projected points lie inside the camera model's clamp, so the
    projection loss has a gradient in every output of the trajectory network."""
    cfg = {**CFG, "dropout": 0.0}
    cfg_traj = semi_data.trajectory_config(cfg)
    w_pos = {k: v.double() for k, v in synth.make_weights(cfg, SEED, "cpu").items()}
    w_traj = {k: v.double().requires_grad_() for k, v in
              semi_data.trajectory_weights(cfg, SEED, "cpu").items()}
    p2_u, cams_u = semi_data.unlabeled_set(TRAFFIC, SEED, "cpu")
    (chunks, _), = rs.first_batches([len(p) for p in p2_u], BATCH, 1, 12, True)
    x2, target, cams = (torch.as_tensor(a, dtype=torch.float64) for a in
                        rs.unlabeled_windows(p2_u, cams_u, chunks, PAD, 0,
                                             synth.flip_perm(17)))
    from perfbench.reference import model as rm
    masks = [None] * len(rm.mask_shapes(cfg, BATCH))
    points = (rm.strided_forward(w_pos, cfg, x2, masks)
              + rm.strided_forward(w_traj, cfg_traj, x2, masks))
    assert 4.0 <= float(w_traj["shrink.bias"][2].detach()) <= 6.0
    # Random poses reach ~1 m, so a few points fall outside; 99.4 % lie inside
    # here (97-100 % over seeds and widths).
    ratio = (points[..., :2] / points[..., 2:]).abs()
    assert float((ratio < 1).double().mean()) > 0.95
    loss = (rs.project(points, cams) - target).norm(dim=-1).mean()
    grad, = torch.autograd.grad(loss, w_traj["shrink.bias"])
    assert bool((grad.abs() > 1e-6).all()), grad


def test_sun_pallas_runs_both_networks_on_the_kernels(tmp_path, capsys):
    """``-sun`` under ``--train-engine pallas``: the trajectory model's config
    takes the engine, its residual blocks go through the fused path and none
    through the plain one, and each step draws the pose model's masks, then the
    trajectory model's, from the one generator."""
    (tmp_path / "data").mkdir()
    write_h36m_archives(str(tmp_path / "data"), subjects=("S1", "S5", "S9"), n_frames=60)
    blocks, draws = [], []
    fused, plain, mask_draws = (temporal._block_fused, temporal._block_plain,
                                temporal._mask_draws)

    def log_block(kind, block):
        def run(model, *args, **kw):
            blocks.append((kind, model.config.num_joints_out))
            return block(model, *args, **kw)
        return run

    def logged_draws(cfg, generator, shard):
        draw = mask_draws(cfg, generator, shard)

        def run(shape, count):
            draws.append(cfg.num_joints_out)
            return draw(shape, count)
        return run

    with mock.patch.object(temporal, "_block_fused", log_block("fused", fused)), \
            mock.patch.object(temporal, "_block_plain", log_block("plain", plain)), \
            mock.patch.object(temporal, "_mask_draws", logged_draws):
        runner.main(["-k", "gt", "-arc", "3,3", "-ch", "16", "-b", "64", "-e", "1",
                     "--warmup", "0", "-str", "S1", "-sun", "S5", "-ste", "S9",
                     "--data-dir", str(tmp_path / "data"), "-c", str(tmp_path / "ckpt"),
                     "--eval-bucket", "16", "--no-eval", "--train-engine", "pallas",
                     "--device", "cpu"])
    assert "INFO: Semi-supervision on" in capsys.readouterr().out
    assert ("fused", 1) in blocks and ("fused", 17) in blocks
    assert not any(kind == "plain" for kind, _ in blocks)
    # -arc 3,3: the expand's mask and one block's two, per network and step.
    assert len(draws) % 4 == 0 and draws == [17, 17, 1, 1] * (len(draws) // 4)

