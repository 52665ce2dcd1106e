"""Data parallelism of videopose3d_torch on the CPU: two gloo ranks, spawned with
torch.multiprocessing (``torch_parallel_workers``), against one process on the
global batch; and the single-process device round-robin of the evaluation and
the streaming lifter's ``mesh=``.

Tolerances, each with its reason:
* the all-reduces of small integers: exact;
* BatchNorm and the train block at 2 ranks: within 1e-5 of each tensor's
  largest entry (the per-channel sums add the ranks' float32 partial sums, an
  order of summation the single process does not take);
* the trainers: per-step losses within 1e-5 relative over 3 steps, the ranks'
  weights bitwise equal (every rank applies the same all-reduced gradients), and
  against the single process within ``tests/test_torch_train.py``'s bounds for
  weights taken through the optimizer (2e-3 relative, 2e-5 absolute);
* the sharded per-epoch losses: within 1e-6 relative (float32 per-rank sums);
* device round-robin and ``mesh=``: bitwise (the same operations per video or
  stream, in the same order).
"""

import numpy as np
import pytest
import torch

from videopose3d_torch import runner
from videopose3d_torch.arguments import parse_args
from videopose3d_torch.data import generators as tgen
from videopose3d_torch.evaluate import Evaluator, evaluate_actionwise
from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig
from videopose3d_torch.models.temporal import batchnorm_train
from videopose3d_torch.ops.kernels.train_block import fused_train_block
from videopose3d_torch.parallel import mesh
from videopose3d_torch.streaming import StreamingCausalLifter

import torch_parallel_workers as W

CPU = torch.device("cpu")


def _close(got, want, tol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.mark.parametrize("total,world", [(16, 2), (5, 2), (7, 3), (2, 4)])
def test_rank_rows_tile_the_batch_in_order(total, world):
    rows = [mesh.rank_rows(total, r, world) for r in range(world)]
    assert rows[0][0] == 0 and rows[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    sizes = [b - a for a, b in rows]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    assert mesh.shard_batch_size(total, world) % world == 0
    assert 0 <= mesh.shard_batch_size(total, world) - total < world


def test_batch_shard_takes_its_segments():
    t = torch.arange(10)
    shard = mesh.BatchShard(((1, 3), (6, 8)), 10)
    assert shard.take(t).tolist() == [1, 2, 6, 7]


def test_all_reduce_forward_and_backward(tmp_path):
    """SUM forward; backward, the SUM of every rank's upstream gradient (so a
    value every rank uses alike collects world-size times its gradient)."""
    for r in W.run_ranks(tmp_path, "all_reduce_rank"):
        assert r["y"].tolist() == [3.0, 30.0]
        assert r["grad"].tolist() == [3.0, 6.0]
        assert r["replicated"].tolist() == [2.0]
        assert all(bool((g == 3.0).all()) for g in r["flat"])
        assert r["joined"]


@pytest.mark.parametrize("b", [6, 7])
def test_batchnorm_two_ranks_match_one(tmp_path, b):
    rng = np.random.default_rng(b)
    c = 5
    bn = torch.nn.BatchNorm1d(c)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.2, 0.2)
        bn.running_mean.uniform_(-0.5, 0.5)
    inputs = {"x": (rng.standard_normal((b, 3, c)) * 2 + 1).astype(np.float32),
              "r": rng.standard_normal((b, 3, c)).astype(np.float32),
              "state": {k: v.clone() for k, v in bn.state_dict().items()}}
    ranks = W.run_ranks(tmp_path, "batchnorm_rank", inputs)
    x = torch.tensor(inputs["x"], requires_grad=True)
    out = batchnorm_train(x, bn, 0.1)
    (out * torch.from_numpy(inputs["r"])).sum().backward()
    _close(torch.cat([r["out"] for r in ranks]), out.detach(), what="out")
    _close(torch.cat([r["dx"] for r in ranks]), x.grad, what="dx")
    for r in ranks:
        _close(r["dw"], bn.weight.grad, what="dscale")
        _close(r["db"], bn.bias.grad, what="dbias")
        _close(r["mean"], bn.running_mean, what="running mean")
        _close(r["var"], bn.running_var, what="running var")


@pytest.mark.parametrize("b,c,dropout", [(5, 8, 0.25), (4, 6, 0.0)])
def test_train_block_two_ranks_match_one(tmp_path, b, c, dropout):
    """A ragged global batch (5 rows: 3 and 2) and a width the block pads: the
    output, statistics and input gradient of the global batch, and the
    BatchNorm scale/bias gradients counted once (each rank returns its own
    sums; the gradient all-reduce adds them)."""
    rng = np.random.default_rng(c)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = 9
    mask = lambda: (None if not dropout else
                    ((rng.uniform(size=(b, t // 3, c)) > dropout) / (1 - dropout))
                    .astype(np.float32))
    inputs = {"x": f(b, t, c), "wa": f(3, c, c) * 0.3, "wb": f(c, c) * 0.3,
              "sa": rng.uniform(0.5, 1.5, c).astype(np.float32), "ba": f(c) * 0.1,
              "sb": rng.uniform(0.5, 1.5, c).astype(np.float32), "bb": f(c) * 0.1,
              "mask_a": mask(), "mask_b": mask(), "shift_a": f(c) * 0.1,
              "shift_b": f(c) * 0.1, "r": f(b, t // 3, c)}
    ranks = W.run_ranks(tmp_path, "train_block_rank", inputs)
    x = torch.tensor(inputs["x"], requires_grad=True)
    params = {k: torch.tensor(inputs[k], requires_grad=True) for k in W.TRAIN_BLOCK_PARAMS}
    masks = [None if inputs[k] is None else torch.from_numpy(inputs[k])
             for k in ("mask_a", "mask_b")]
    out, *stats = fused_train_block(
        x, *params.values(), *masks, torch.from_numpy(inputs["shift_a"]),
        torch.from_numpy(inputs["shift_b"]), center=1, fw=3, plain=True)
    (out * torch.from_numpy(inputs["r"])).sum().backward()
    _close(torch.cat([r["out"] for r in ranks]), out.detach(), what="out")
    _close(torch.cat([r["dx"] for r in ranks]), x.grad, what="dx")
    for r in ranks:
        for i, s in enumerate(stats):
            _close(r["stats"][i], s.detach(), what=f"statistic {i}")
        for k, p in params.items():
            _close(r["d" + k], p.grad, what="d" + k)


def _assert_weights(ranks, want):
    """The ranks' weights bitwise equal, and close to the single process's."""
    got = ranks[0]
    for other in ranks[1:]:
        for k, v in got.items():
            assert torch.equal(v, other[k]), k
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-3, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("engine,dropout", [("pallas", 0.0), ("pallas", 0.25),
                                            ("xla", 0.25)])
def test_supervised_trainer_two_ranks_match_one(tmp_path, engine, dropout):
    """Three steps, the last of 6 valid rows (all on rank 0): the ranks' loss
    shares add up to the single process's losses, the dropout masks being the
    global draw."""
    ranks = W.run_ranks(tmp_path, "supervised_rank", engine, dropout)
    want_losses, want_state = W.supervised_losses(engine, dropout)
    np.testing.assert_allclose(np.sum([r[0] for r in ranks], axis=0), want_losses,
                               rtol=1e-5)
    _assert_weights([r[1] for r in ranks], want_state)


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_semi_trainer_two_ranks_match_one(tmp_path, dropout):
    """A warmup step and two full ones, the last with partial labeled (6 rows)
    and unlabeled (10 rows) batches: the four losses, the bone-length term's
    gradient counted once."""
    ranks = W.run_ranks(tmp_path, "semi_rank", "pallas", dropout)
    want_losses, (want_pos, want_traj) = W.semi_losses("pallas", dropout)
    np.testing.assert_allclose(np.sum([r[0] for r in ranks], axis=0), want_losses,
                               rtol=1e-5)
    assert np.all(np.asarray(want_losses)[1:, 2] > 0)
    _assert_weights([r[1][0] for r in ranks], want_pos)
    _assert_weights([r[1][1] for r in ranks], want_traj)


def test_sharded_eval_set_matches_one_process(tmp_path):
    ranks = W.run_ranks(tmp_path, "eval_set_rank")
    want = W.eval_set_losses()
    for got in ranks:
        assert got[3] == want[3] == 21 + 40 + 33 + 12 + 25
        np.testing.assert_allclose(got[:3], want[:3], rtol=1e-6)


def test_eval_set_device_round_robin_is_bitwise():
    assert W.eval_set_losses(devices=[CPU, CPU]) == W.eval_set_losses()


def test_actionwise_device_round_robin_is_bitwise(capsys):
    p2, p3, _ = W.videos(seed=9, lengths=(21, 40, 33))
    perm = W.flip_perm()
    net = W.model(seed=4)
    actions = {"Walking": [0, 1], "Eating": [2]}

    def make_batcher(idx):
        return tgen.UnchunkedBatcher(None, [p3[i] for i in idx], [p2[i] for i in idx],
                                     pad=W.PAD, causal_shift=0, augment=True,
                                     kps_flip_perm=perm, joints_flip_perm=perm)

    evaluator = Evaluator(net.config, joints_flip_perm=perm, device=CPU)
    one = evaluate_actionwise(evaluator, net, actions, make_batcher)
    printed = capsys.readouterr().out
    two = evaluate_actionwise(evaluator, net, actions, make_batcher, devices=[CPU, CPU])
    assert two == one and capsys.readouterr().out == printed


@pytest.mark.parametrize("engine", ["bf16", "int8"])
def test_streaming_mesh_is_bitwise_the_unsharded_lifter(engine):
    """Four streams split over two devices, contiguous shards of two, for 30
    frames (past the receptive field of 27)."""
    from videopose3d_torch.ops.kernels.temporal_block_int8 import quantize_temporal_model
    j, t = W.J, 30
    cfg = TemporalModelConfig(j, 2, j, (3, 3, 3), causal=True, channels=W.CHANNELS)
    torch.manual_seed(6)
    net = TemporalModel(cfg).eval()
    frames = np.random.default_rng(6).standard_normal((4, t, j, 2)).astype(np.float32)
    q = (quantize_temporal_model(cfg, net, torch.from_numpy(frames[:1]))
         if engine == "int8" else None)
    kw = dict(engine=engine, quantized=q)
    outs = []
    for lifter in (StreamingCausalLifter(cfg, net, device=CPU, **kw),
                   StreamingCausalLifter(cfg, net, mesh=[CPU, CPU], **kw)):
        lifter.reset(frames[:, 0])
        outs.append(torch.stack([lifter.step(frames[:, i]) for i in range(t)]))
    assert outs[1].shape == (t, 4, j, 3)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("engine", ["bf16_fused", "int8_fused"])
def test_streaming_fused_engines_refuse_mesh(engine):
    cfg = TemporalModelConfig(W.J, 2, W.J, (3, 3), causal=True, channels=W.CHANNELS,
                              compute_dtype="bfloat16")
    net = TemporalModel(cfg)
    with pytest.raises(ValueError, match="MultiDeviceStreamingLifter"):
        StreamingCausalLifter(cfg, net, engine=engine, quantized=object(),
                              mesh=[CPU, CPU])
    with pytest.raises(ValueError, match="mutually exclusive"):
        StreamingCausalLifter(cfg, net, mesh=[CPU], device=CPU)


def test_no_mesh_under_a_multi_process_launcher_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="independent copies"):
        runner.join_process_group(parse_args(["--no-mesh", "--device", "cpu"]), CPU)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert runner.join_process_group(parse_args(["--no-mesh", "--device", "cpu"]),
                                     CPU) is None
    monkeypatch.delenv("WORLD_SIZE")
    assert runner.join_process_group(parse_args(["--device", "cpu"]), CPU) is None


@pytest.mark.parametrize("n", [0, 1, 3])
def test_eval_devices_on_the_cpu_are_one_device(n):
    args = parse_args(["--device", "cpu", "--eval-devices", str(n)])
    assert runner.eval_devices(args, CPU, None) is None
