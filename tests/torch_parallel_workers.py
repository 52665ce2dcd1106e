"""Rank programs of tests/test_torch_parallel.py and the harness that spawns them:
each rank joins a gloo process group through a ``file://`` rendezvous in the
test's own directory (so parallel test workers never share a port), runs one
function of this module and saves what it returns.  JAX-free, so that a spawned
rank imports only torch and videopose3d_torch."""

import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from videopose3d_torch import train as ttrain
from videopose3d_torch.data import generators as tgen
from videopose3d_torch.evaluate import DeviceEvalSet, Evaluator
from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                batchnorm_train)
from videopose3d_torch.ops.kernels.train_block import fused_train_block
from videopose3d_torch.parallel import mesh

J = 17
BATCH = 16
ARCH = (3, 3)
CHANNELS = 32
PAD = 4  # receptive field 9
KPS_LEFT, KPS_RIGHT = [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]
# The Human3.6M skeleton's parents after the 32 -> 17 joint cut.
PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15])
RANK_TIMEOUT_S = 240
CPU = torch.device("cpu")


def run_ranks(tmp_path, name, *args, world=2, timeout=RANK_TIMEOUT_S):
    """Run ``name(rank, world, *args)`` of this module on ``world`` spawned gloo
    ranks; returns their results in rank order.  A rank that fails, or does not
    finish within ``timeout`` seconds, fails the call."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(name, r, world, str(tmp_path), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(tmp_path / f"error_{r}.txt").read_text() for r in range(world)
              if (tmp_path / f"error_{r}.txt").exists()]
    assert not hung, f"ranks {hung} of {name} did not finish in {timeout} s: {errors}"
    assert all(p.exitcode == 0 for p in procs), (
        f"{name}: exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [torch.load(tmp_path / f"result_{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(name, rank, world, out, args):
    torch.set_num_threads(2)
    try:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rdv"),
                                rank=rank, world_size=world)
        torch.save(globals()[name](rank, world, *args), os.path.join(out, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Data and models shared with the single-process references
# ---------------------------------------------------------------------------


def flip_perm():
    perm = np.arange(J)
    perm[KPS_LEFT] = KPS_RIGHT
    perm[KPS_RIGHT] = KPS_LEFT
    return perm


def videos(seed, lengths, labeled=True):
    """2D keypoints, 3D poses with their roots 3..5 m in front of the camera,
    and intrinsics near Human3.6M's normalized ones."""
    rng = np.random.default_rng(seed)
    p2, p3 = [], []
    for n in lengths:
        x2d = (rng.standard_normal((n, J, 2)) * 0.3).astype(np.float32)
        pose = np.concatenate([0.5 * x2d, 0.3 * np.sin(2 * x2d[..., :1])], axis=-1)
        pose[:, 0] = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                               rng.uniform(3.0, 5.0, n)], axis=-1)
        p2.append(x2d)
        p3.append(pose.astype(np.float32))
    cams = [np.concatenate([rng.uniform(2.2, 2.4, 2), rng.uniform(-0.02, 0.02, 2),
                            rng.uniform(-0.2, 0.2, 3), rng.uniform(-0.003, 0.003, 2)]
                           ).astype(np.float32) for _ in lengths]
    return p2, (p3 if labeled else None), cams


# Labeled: 19 frames, 38 pairs with flips: steps of 16, 16 and 6 (the last
# batch's valid rows all on rank 0).  Unlabeled: 21 frames, 42 pairs: 16, 16, 10.
LABELED = dict(seed=5, lengths=(10, 9))
UNLABELED = dict(seed=6, lengths=(12, 9), labeled=False)
STEPS = 3


def model(joints_out=J, engine="xla", dropout=0.0, seed=0):
    torch.manual_seed(seed)
    return TemporalModel(TemporalModelConfig(J, 2, joints_out, ARCH, dropout=dropout,
                                             channels=CHANNELS, train_engine=engine))


def _dataset(p2, p3, cams, chunk_length=1):
    perm = flip_perm()
    return tgen.FlatSequenceDataset(
        p2, p3, cams,
        margins=tgen.FlatSequenceDataset.training_margins(PAD, 0, chunk_length),
        flip_perms=(perm, perm)).to_device(CPU)


def supervised_losses(engine, dropout, dp=None, chunk_length=1):
    """STEPS supervised steps from one initialisation: (per-step losses, the final
    state dicts of the model and of the optimizer).  ``chunk_length`` > 1 trains
    the dilated form on chunks of that many frames, BATCH // chunk_length a
    step (as --stride)."""
    p2, p3, cams = videos(**LABELED)
    net = model(engine=engine, dropout=dropout)
    batch = BATCH // chunk_length
    loop = ttrain.TrainLoopConfig(batch_size=batch, chunk_length=chunk_length, pad=PAD,
                                  causal_shift=0, use_strided=chunk_length == 1)
    optimizer = ttrain.make_optimizer(net, loop.learning_rate)
    trainer = ttrain.SupervisedTrainer(net, loop, optimizer, dp=dp)
    dev = _dataset(p2, p3, cams, chunk_length)
    sampler = tgen.ChunkedPairSampler([len(s) for s in p2], batch, chunk_length,
                                      augment=True)
    generator = torch.Generator().manual_seed(7)
    steps = list(sampler.next_epoch())
    assert len(steps) == STEPS and steps[-1][1] <= batch // 2
    losses = [float(trainer.step(dev, meta, nv, 0.1, generator)) for meta, nv in steps]
    return losses, net.state_dict()


def semi_losses(engine, dropout, dp=None):
    """A warmup step and two full ones (the last with partial labeled and
    unlabeled batches) of the semi-supervised trainer: (per-step four losses, the
    final state dicts of both models)."""
    p2, p3, cams = videos(**LABELED)
    u2, _, ucams = videos(**UNLABELED)
    pos = model(engine=engine, dropout=dropout)
    traj = model(1, engine=engine, dropout=dropout, seed=1)
    loop = ttrain.TrainLoopConfig(batch_size=BATCH, chunk_length=1, pad=PAD, causal_shift=0)
    optimizer = ttrain.make_optimizer([pos, traj], loop.learning_rate)
    trainer = ttrain.SemiSupervisedTrainer(pos, traj, loop, optimizer, PARENTS, dp=dp)
    dev, dev_semi = _dataset(p2, p3, cams), _dataset(u2, None, ucams)
    sampler = tgen.ChunkedPairSampler([len(s) for s in p2], BATCH, 1, augment=True)
    semi = tgen.ChunkedPairSampler([len(s) for s in u2], BATCH, 1, random_seed=4321,
                                   augment=True, endless=True).next_epoch()
    generator = torch.Generator().manual_seed(7)
    losses = []
    for i, (meta, nv) in enumerate(sampler.next_epoch()):
        meta_u, nv_u = next(semi)
        out = trainer.step(dev, dev_semi, meta, nv, meta_u, nv_u, 0.1, i == 0, generator)
        losses.append([float(t) for t in out])
    assert len(losses) == STEPS
    return losses, (pos.state_dict(), traj.state_dict())


def eval_set_losses(shard=None, devices=None):
    """The semi-supervised per-epoch losses of a labeled set of five videos."""
    p2, p3, cams = videos(seed=8, lengths=(21, 40, 33, 12, 25))
    perm = flip_perm()
    batcher = tgen.UnchunkedBatcher(cams, p3, p2, pad=PAD, causal_shift=0,
                                    kps_flip_perm=perm, joints_flip_perm=perm, bucket=16)
    pos, traj = model(seed=2), model(1, seed=3)
    evalset = DeviceEvalSet(batcher, pad=PAD, device=CPU, with_traj=True, shard=shard,
                            devices=devices)
    return evalset.losses(Evaluator(pos.config, joints_flip_perm=perm, device=CPU), pos,
                          Evaluator(traj.config, device=CPU), traj)


# ---------------------------------------------------------------------------
# Rank programs
# ---------------------------------------------------------------------------


def all_reduce_rank(rank, world):
    """The autograd all-reduce with other upstream gradients on each rank, a
    replicated use of it, and the flat gradient all-reduce; initialize_distributed
    keeps the group this process joined."""
    joined = mesh.initialize_distributed(CPU) and dist.get_world_size() == world
    t = torch.tensor([rank + 1.0, 10.0 * (rank + 1)], requires_grad=True)
    y = mesh.all_reduce_sum(t)
    (y * torch.tensor([1.0, 2.0]) * (rank + 1)).sum().backward()
    replicated = torch.tensor([float(rank)], requires_grad=True)
    mesh.all_reduce_sum(replicated).sum().backward()
    lin = torch.nn.Linear(3, 2)
    for p in lin.parameters():
        p.grad = torch.full_like(p, rank + 1.0)
    mesh.all_reduce_gradients(lin.parameters())
    return {"y": y.detach(), "grad": t.grad, "replicated": replicated.grad,
            "flat": [p.grad for p in lin.parameters()], "joined": joined}


def batchnorm_rank(rank, world, inputs):
    """batchnorm_train on this rank's rows of the global batch: the rank's output
    and input gradient, the all-reduced parameter gradients, the running stats."""
    x, r, state = inputs["x"], inputs["r"], inputs["state"]
    start, stop = mesh.rank_rows(x.shape[0], rank, world)
    bn = torch.nn.BatchNorm1d(x.shape[-1])
    bn.load_state_dict(state)
    xl = torch.tensor(x[start:stop], requires_grad=True)
    shard = mesh.BatchShard(((start, stop),), x.shape[0])
    out = batchnorm_train(xl, bn, 0.1, shard)
    (out * torch.from_numpy(r[start:stop])).sum().backward()
    mesh.all_reduce_gradients(bn.parameters())
    return {"out": out.detach(), "dx": xl.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "mean": bn.running_mean, "var": bn.running_var}


TRAIN_BLOCK_PARAMS = ("wa", "wb", "sa", "ba", "sb", "bb")


def train_block_rank(rank, world, inputs):
    """fused_train_block(plain=True) on this rank's rows: the rank's output and
    input gradient, the batch statistics, the all-reduced weight gradients."""
    b = inputs["x"].shape[0]
    start, stop = mesh.rank_rows(b, rank, world)
    shard = mesh.BatchShard(((start, stop),), b)
    x = torch.tensor(inputs["x"][start:stop], requires_grad=True)
    params = {k: torch.tensor(inputs[k], requires_grad=True) for k in TRAIN_BLOCK_PARAMS}
    masks = [None if inputs[k] is None else torch.from_numpy(inputs[k][start:stop])
             for k in ("mask_a", "mask_b")]
    out, *stats = fused_train_block(
        x, params["wa"], params["wb"], params["sa"], params["ba"], params["sb"],
        params["bb"], *masks, torch.from_numpy(inputs["shift_a"]),
        torch.from_numpy(inputs["shift_b"]), center=1, fw=3, plain=True, shard=shard)
    (out * torch.from_numpy(inputs["r"][start:stop])).sum().backward()
    mesh.all_reduce_gradients(params.values())
    return {"out": out.detach(), "dx": x.grad, "stats": [s.detach() for s in stats],
            **{"d" + k: p.grad for k, p in params.items()}}


def supervised_rank(rank, world, engine, dropout, chunk_length=1):
    return supervised_losses(engine, dropout, mesh.DataParallel.from_group(), chunk_length)


def semi_rank(rank, world, engine, dropout):
    return semi_losses(engine, dropout, mesh.DataParallel.from_group())


def eval_set_rank(rank, world):
    return eval_set_losses(shard=(rank, world))
