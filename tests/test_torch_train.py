"""The supervised trainer of videopose3d_torch against the JAX package's: from one
initial (params, state) carried across, with dropout 0, both train engines of the
port (the fused engine through its kernels' plain versions on the CPU) take the
same steps as ``videopose3d_tpu.train.SupervisedTrainer`` over the same
descriptors, the final partial batch included.

Tolerances: per-step losses rtol 1e-5 and weights after the steps rtol 2e-3 /
atol 2e-5 (the JAX package's own trajectory bounds against torch,
``tests/test_train_parity_torch.py``); running BatchNorm statistics rtol 1e-4 /
atol 1e-6 (float32 batch sums in other orders, damped by the momentum)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from videopose3d_tpu.data.generators import FlatSequenceDataset as JFlat
from videopose3d_tpu.models.temporal import TemporalModelConfig as JConfig
from videopose3d_tpu.models.temporal import init_temporal_model
from videopose3d_tpu.train import SupervisedTrainer as JTrainer
from videopose3d_tpu.train import TrainLoopConfig as JLoop
from videopose3d_tpu.train import bn_momentum_for_epoch as jax_momentum
from videopose3d_torch import train as ttrain
from videopose3d_torch.data.generators import ChunkedPairSampler, FlatSequenceDataset
from videopose3d_torch.models.convert import jax_params_from_model, state_dict_from_jax
from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                dropout_mask, forward_strided)

from torch_port_helpers import H36M_KPS_LEFT, H36M_KPS_RIGHT

STEPS = 5
BATCH = 16
ARCH = (3, 3)
PAD = 4  # receptive field 9


def _data(seed=5, lengths=(20, 17)):
    """Learnable synthetic videos: 3D targets are a smooth function of the 2D
    input, so the losses move.  37 chunks, flipped too: 74 pairs, five steps of
    16 with a final partial batch of 10."""
    rng = np.random.default_rng(seed)
    p2, p3 = [], []
    for n in lengths:
        x2d = rng.standard_normal((n, 17, 2)).astype(np.float32)
        depth = 0.3 * np.sin(2 * x2d[..., :1]) + 0.2 * x2d[..., 1:]
        p2.append(x2d)
        p3.append(np.concatenate([0.5 * x2d, depth], axis=-1).astype(np.float32))
    return p2, p3


def _perm():
    perm = np.arange(17)
    perm[H36M_KPS_LEFT] = H36M_KPS_RIGHT
    perm[H36M_KPS_RIGHT] = H36M_KPS_LEFT
    return perm


def _descriptors(lengths):
    sampler = ChunkedPairSampler(lengths, BATCH, 1, augment=True)
    steps = [(m, nv) for m, nv in sampler.next_epoch()]
    assert len(steps) == STEPS and steps[-1][1] == 10
    return steps


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer's per-step losses and final (params, state, moments)."""
    kwargs = dict(num_joints_in=17, in_features=2, num_joints_out=17,
                  filter_widths=ARCH, dropout=0.0, channels=32)
    params, state = init_temporal_model(JConfig(**kwargs), jax.random.PRNGKey(4))
    init = jax.tree_util.tree_map(np.asarray, (params, state))
    p2, p3 = _data()
    perm = _perm()
    loop = JLoop(batch_size=BATCH, chunk_length=1, pad=PAD, causal_shift=0,
                 gather_impl="xla")
    dev = JFlat(p2, p3, margins=JFlat.training_margins(PAD, 0, 1),
                flip_perms=(perm, perm)).to_device(flatten_2d=True)
    trainer = JTrainer(JConfig(**kwargs), loop, perm, perm)
    opt_state = trainer.init_optimizer(params)
    rng = jax.random.PRNGKey(0)
    momentum = jax_momentum(loop, 0)
    losses = []
    for meta, n_valid in _descriptors([len(s) for s in p2]):
        params, state, opt_state, rng, loss = trainer.step(
            params, state, opt_state, rng, dev, meta, n_valid, momentum)
        losses.append(float(loss))
    ams = opt_state.inner_state[0]
    moments = {k: jax.tree_util.tree_map(np.asarray, getattr(ams, k))
               for k in ("m", "v", "vmax")}
    final = jax.tree_util.tree_map(np.asarray, (params, state))
    return kwargs, init, np.asarray(losses), final, moments, momentum


def _assert_tree_close(got, want, rtol, atol, what):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_leaves(want)
    assert len(flat_g) == len(flat_w)
    for (path, g), w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_trainer_tracks_jax_trainer(jax_run, engine):
    kwargs, (params, state), want_losses, (want_p, want_s), want_m, momentum = jax_run
    model = TemporalModel(TemporalModelConfig(**kwargs, train_engine=engine))
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in state_dict_from_jax(params, state).items()})
    p2, p3 = _data()
    perm = _perm()
    loop = ttrain.TrainLoopConfig(batch_size=BATCH, chunk_length=1, pad=PAD,
                                  causal_shift=0)
    dev = FlatSequenceDataset(p2, p3, margins=FlatSequenceDataset.training_margins(
        PAD, 0, 1), flip_perms=(perm, perm)).to_device(torch.device("cpu"))
    optimizer = ttrain.make_optimizer(model, loop.learning_rate)
    trainer = ttrain.SupervisedTrainer(model, loop, optimizer)
    assert ttrain.bn_momentum_for_epoch(loop, 0) == momentum
    losses = [float(trainer.step(dev, meta, n_valid, momentum))
              for meta, n_valid in _descriptors([len(s) for s in p2])]

    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got_p, got_s, got_m = jax_params_from_model(model, optimizer)
    _assert_tree_close(got_p, want_p, 2e-3, 2e-5, "params")
    _assert_tree_close(got_s, want_s, 1e-4, 1e-6, "running stats")
    for key in ("m", "v", "vmax"):
        # Moments: relative to each leaf's largest entry (f32 sums in other orders).
        for g, w in zip(jax.tree_util.tree_leaves(got_m[key]),
                        jax.tree_util.tree_leaves(want_m[key])):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3 * np.abs(w).max())


def test_final_partial_batch_is_masked():
    """The padded rows of the last batch change no loss: a batch of 10 real rows
    padded to 16 gives the loss of those 10 rows."""
    pred = torch.randn(16, 1, 17, 3, generator=torch.Generator().manual_seed(0))
    target = torch.randn(16, 1, 17, 3, generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(16) < 10).float()
    per_sample = ttrain._mpjpe_per_sample(pred, target)
    masked = ttrain._masked_sample_mean(per_sample, mask)
    torch.testing.assert_close(masked, per_sample[:10].mean())


def test_schedules_match_jax():
    kw = dict(batch_size=64, chunk_length=1, pad=13, causal_shift=0, epochs=60)
    jloop, tloop = JLoop(**kw), ttrain.TrainLoopConfig(**kw)
    for epoch in range(-1, 61):
        assert ttrain.bn_momentum_for_epoch(tloop, epoch) == jax_momentum(jloop, epoch)
    model = TemporalModel(TemporalModelConfig(17, 2, 17, ARCH, channels=8))
    optimizer = ttrain.make_optimizer(model, 1e-3)
    assert optimizer.defaults["amsgrad"]
    lr = 1e-3
    for _ in range(3):
        lr *= 0.95
        ttrain.set_learning_rate(optimizer, lr)
    assert optimizer.param_groups[0]["lr"] == 1e-3 * 0.95 * 0.95 * 0.95
    with pytest.raises(ValueError, match="chunk_length == 1"):
        ttrain.TrainLoopConfig(batch_size=64, chunk_length=3, pad=13, causal_shift=0)


def test_dropout_masks_are_shared_by_both_engines():
    """The dropout stream cannot match the JAX package's (other generators); the
    two engines of the port draw the same masks, so with dropout on their losses
    agree, and the masks have the quantised keep probability."""
    mask = dropout_mask(0.25, (64, 27, 64), torch.float32,
                        torch.Generator().manual_seed(0))
    assert set(mask.unique().tolist()) == {0.0, float(np.float32(4.0 / 3.0))}
    assert abs(float((mask > 0).float().mean()) - 0.75) < 0.01
    odd = dropout_mask(0.3, (64, 27, 64), torch.float32, torch.Generator().manual_seed(0))
    keep = 45875 / 65536  # 0.7 quantised to 16 bits
    assert odd.unique().tolist() == [0.0, pytest.approx(1 / keep)]
    assert dropout_mask(0.0, (4,), torch.float32, torch.Generator()) is None

    cfg = TemporalModelConfig(17, 2, 17, (3, 3, 3), dropout=0.25, channels=32)
    torch.manual_seed(0)
    base = TemporalModel(cfg)
    x = torch.randn(16, 27, 17, 2, generator=torch.Generator().manual_seed(2))
    outs = []
    for engine in ("xla", "pallas"):
        model = TemporalModel(dataclasses.replace(cfg, train_engine=engine))
        model.load_state_dict(base.state_dict())
        outs.append(forward_strided(model, x, momentum=0.1,
                                    generator=torch.Generator().manual_seed(7)))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-6)
