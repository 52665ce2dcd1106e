"""Semi-supervised training of videopose3d_torch against the JAX package's, on
the CPU at -arc 3,3, 32 channels, batch 16, from numpy seeds: the camera
functions, the batch assembly with cameras, the endless unlabeled sampler, the
semi-supervised train step and the per-epoch trajectory losses.

Tolerances, each with its reason:
* projections: values and gradients within 1e-6 relative (float32, the same
  operations; the 3-term sums may be taken in another order), with an absolute
  floor of 1e-6 of the tensor's largest entry for entries near 0;
* image_coordinates / camera_to_world: bitwise (the same numpy operations);
* batch assembly and the sampler: bitwise and equal (pure indexing, numpy's
  permutation);
* the train step: per-step losses within 1e-5 relative; params, running
  statistics and AMSGrad moments at ``tests/test_torch_train.py``'s bounds
  (float32 sums in other orders, carried through the optimizer);
* the trajectory evaluation losses: within 1e-5 relative (float32 inference
  summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videopose3d_tpu.data import generators as jgen
from videopose3d_tpu.evaluate import DeviceEvalSet as JEvalSet
from videopose3d_tpu.evaluate import Evaluator as JEvaluator
from videopose3d_tpu.models.temporal import TemporalModelConfig as JConfig
from videopose3d_tpu.models.temporal import init_temporal_model
from videopose3d_tpu.ops import camera as jcam
from videopose3d_tpu.train import SemiSupervisedTrainer as JSemi
from videopose3d_tpu.train import TrainLoopConfig as JLoop
from videopose3d_torch import train as ttrain
from videopose3d_torch.data import generators as tgen
from videopose3d_torch.evaluate import DeviceEvalSet, Evaluator
from videopose3d_torch.models.convert import jax_params_from_model, state_dict_from_jax
from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig
from videopose3d_torch.ops import camera as tcam

from torch_port_helpers import H36M_KPS_LEFT, H36M_KPS_RIGHT

J = 17
BATCH = 16
ARCH = (3, 3)
CHANNELS = 32
PAD = 4  # receptive field 9
# The Human3.6M skeleton's parents after the 32 -> 17 joint cut.
PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15])


def _perm():
    perm = np.arange(J)
    perm[H36M_KPS_LEFT] = H36M_KPS_RIGHT
    perm[H36M_KPS_RIGHT] = H36M_KPS_LEFT
    return perm


def _cameras(rng, count):
    """Intrinsics near Human3.6M's normalized ones: focal ~2.3, centre ~0,
    radial and tangential distortion of their size."""
    return [np.concatenate([rng.uniform(2.2, 2.4, 2), rng.uniform(-0.02, 0.02, 2),
                            rng.uniform(-0.2, 0.2, 3), rng.uniform(-0.003, 0.003, 2)]
                           ).astype(np.float32) for _ in range(count)]


# ---------------------------------------------------------------------------
# Camera functions
# ---------------------------------------------------------------------------


def _points(seed, clamped):
    """(8, 5, J, 3) camera-space points at depth 2..6: |x/z|, |y/z| in
    [0.02, 0.9] or, with ``clamped``, half of them in [1.1, 2] (past the clamp,
    away from its ties at 1)."""
    rng = np.random.default_rng(seed)
    shape = (8, 5, J)
    z = rng.uniform(2.0, 6.0, shape)
    ratio = rng.uniform(0.02, 0.9, shape + (2,)) * rng.choice([-1, 1], shape + (2,))
    if clamped:
        far = rng.uniform(size=shape + (2,)) < 0.5
        ratio = np.where(far, np.sign(ratio) * rng.uniform(1.1, 2.0, shape + (2,)), ratio)
    return np.concatenate([ratio * z[..., None], z[..., None]], axis=-1).astype(np.float32)


@pytest.mark.parametrize("clamped", [False, True])
@pytest.mark.parametrize("linear", [False, True])
def test_projection_values_and_gradients_match_jax(linear, clamped):
    x = _points(1 + clamped, clamped)
    cam = np.stack(_cameras(np.random.default_rng(3), x.shape[0]))
    weight = np.random.default_rng(4).standard_normal(x.shape[:-1] + (2,)).astype(np.float32)
    jf = jcam.project_to_2d_linear if linear else jcam.project_to_2d
    tf = tcam.project_to_2d_linear if linear else tcam.project_to_2d

    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(cam)))
    want_gx, want_gc = jax.grad(lambda a, c: jnp.sum(jf(a, c) * weight), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(cam))
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(cam).requires_grad_(True)
    got = tf(xt, ct)
    (got * torch.from_numpy(weight)).sum().backward()

    for what, g, w in (("values", got.detach().numpy(), want),
                       ("d/dX", xt.grad.numpy(), np.asarray(want_gx)),
                       ("d/dcam", ct.grad.numpy(), np.asarray(want_gc))):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                   err_msg=what)
    if clamped:  # clamped coordinates: no gradient through x/z and y/z
        far = np.abs(x[..., :2] / x[..., 2:]) > 1
        assert far.any() and (~far).any()
        assert np.all(xt.grad.numpy()[..., :2][far] == 0)


def test_numpy_camera_functions_equal_jax_bitwise():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (6, J, 2))
    np.testing.assert_array_equal(tcam.image_coordinates(pts, w=1000, h=1002),
                                  jcam.image_coordinates(pts, w=1000, h=1002))
    x = rng.standard_normal((6, J, 3)).astype(np.float32)
    q = rng.standard_normal(4).astype(np.float32)
    q /= np.linalg.norm(q)
    t = rng.standard_normal(3).astype(np.float32)
    np.testing.assert_array_equal(tcam.camera_to_world(x, q, t),
                                  jcam.camera_to_world(x, q, t))
    qs = rng.standard_normal((6, 4)).astype(np.float32)
    np.testing.assert_array_equal(tcam.camera_to_world(x, qs, t),
                                  jcam.camera_to_world(x, qs, t))
    np.testing.assert_array_equal(tcam.world_to_camera(x, q, t),
                                  jcam.world_to_camera(x, q, t))


# ---------------------------------------------------------------------------
# Batch assembly and the endless sampler
# ---------------------------------------------------------------------------


def _videos(seed=5, lengths=(21, 17, 30), labeled=True):
    """2D keypoints, 3D poses with their roots 3..5 m in front of the camera
    (the trajectory loss weighs by the inverse depth), and cameras."""
    rng = np.random.default_rng(seed)
    p2, p3 = [], []
    for n in lengths:
        x2d = (rng.standard_normal((n, J, 2)) * 0.3).astype(np.float32)
        rel = np.concatenate([0.5 * x2d, 0.3 * np.sin(2 * x2d[..., :1])], axis=-1)
        root = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                         rng.uniform(3.0, 5.0, n)], axis=-1)
        pose = rel.copy()
        pose[:, 0] = root
        p2.append(x2d)
        p3.append(pose.astype(np.float32))
    return p2, (p3 if labeled else None), _cameras(rng, len(lengths))


@pytest.mark.parametrize("with_3d", [True, False])
@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("gather", ["pallas", "xla"])
def test_batch_assembly_with_cameras_matches_jax(gather, augment, with_3d):
    """Cameras (negated intrinsics 2 and 7 on flipped rows), the 2D windows with
    their joint axis, and the 3D targets, bitwise as the JAX package's, through
    the window gather's plain version ("pallas" on a CPU tensor) and plain
    indexing."""
    p2, p3, cams = _videos(labeled=with_3d)
    perm = _perm()
    margins = jgen.FlatSequenceDataset.training_margins(PAD, 0, 1)
    flip_perms = (perm, perm) if augment else None
    jdev = jgen.FlatSequenceDataset(p2, p3, cams, margins=margins,
                                    flip_perms=flip_perms).to_device()
    tdev = tgen.FlatSequenceDataset(p2, p3, cams, margins=margins,
                                    flip_perms=flip_perms).to_device(torch.device("cpu"))
    sampler = tgen.ChunkedPairSampler([len(s) for s in p2], BATCH, 1, augment=augment)
    flipped = 0
    for meta, _ in sampler.next_epoch():
        flipped += int(meta[:, 3].sum())
        want = jgen.assemble_chunked_batch_contiguous(
            jdev.flat_2d_padded, jdev.flat_3d_padded, jdev.cameras, jdev.base_2d,
            jdev.base_3d, jnp.asarray(meta), pad=PAD, causal_shift=0, chunk_length=1,
            kps_flip_perm=tuple(perm), joints_flip_perm=tuple(perm), with_3d=with_3d,
            with_cameras=True, aug_offset_2d=jdev.aug_offset_2d,
            aug_offset_3d=jdev.aug_offset_3d, joint_axis_2d=True)
        got = tgen.assemble_chunked_batch_contiguous(
            tdev, meta, pad=PAD, causal_shift=0, chunk_length=1, gather_impl=gather,
            with_3d=with_3d, with_cameras=True, joint_axis_2d=True)
        assert got[2].shape == (BATCH, 2 * PAD + 1, J, 2)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (flipped > 0) == augment


def _draws(sampler, steps):
    it = sampler.next_epoch()
    return [(m.copy(), nv) for m, nv in (next(it) for _ in range(steps))]


def test_endless_sampler_matches_jax_and_resumes_exactly():
    """The unlabeled stream (random_seed 4321, endless) yields the JAX sampler's
    descriptors over three permutations, final partial batches included; its
    stream_state taken mid-permutation resumes the same sequence in a new
    sampler; an endless sampler over no chunks raises."""
    lengths = [23, 40, 9, 1]
    kw = dict(random_seed=4321, augment=True, endless=True)
    tsamp = tgen.ChunkedPairSampler(lengths, BATCH, 1, **kw)
    jsamp = jgen.ChunkedPairSampler(lengths, BATCH, 1, use_native=False, **kw)
    steps = 3 * tsamp.num_batches
    got, want = _draws(tsamp, steps), _draws(jsamp, steps)
    assert [nv for _, nv in got] == [nv for _, nv in want]
    assert sum(nv < BATCH for _, nv in got) == 3
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(g, w)

    a = tgen.ChunkedPairSampler(lengths, BATCH, 1, **kw)
    it = a.next_epoch()
    for _ in range(a.num_batches + 2):  # two batches into the second permutation
        next(it)
    state = a.stream_state()
    assert state[0] == 2
    b = tgen.ChunkedPairSampler(lengths, BATCH, 1, **kw)
    b.set_stream_state(state)
    j = jgen.ChunkedPairSampler(lengths, BATCH, 1, use_native=False, **kw)
    j.set_stream_state(state)
    rest = [next(it) for _ in range(a.num_batches + 3)]
    for (ga, na), (gb, nb), (gj, nj) in zip(rest, _draws(b, len(rest)), _draws(j, len(rest))):
        assert na == nb == nj
        np.testing.assert_array_equal(gb, ga)
        np.testing.assert_array_equal(gj, ga)
    assert tgen.ChunkedPairSampler(lengths, BATCH, 1).stream_state() is None

    with pytest.raises(ValueError, match="no training chunks"):
        next(tgen.ChunkedPairSampler([0, 0], BATCH, 1, endless=True).next_epoch())


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

LOSS_SWITCHES = {"default": {}, "linear": {"linear_projection": True},
                 "no_proj": {"no_proj": True}, "no_bone": {"bone_length_term": False}}
STEPS = 5  # one warmup step, then four full ones


def _model_kwargs(joints_out):
    return dict(num_joints_in=J, in_features=2, num_joints_out=joints_out,
                filter_widths=ARCH, dropout=0.0, channels=CHANNELS)


def _semi_data():
    """Labeled videos of 37 chunks (74 with flips: five steps of 16, the fifth
    of 10) and unlabeled ones of 36 (72: a batch of 8 at the fifth step of the
    endless stream)."""
    perm = _perm()
    p2, p3, cams = _videos(seed=5, lengths=(20, 17))
    u2, _, ucams = _videos(seed=6, lengths=(19, 17), labeled=False)
    return perm, (p2, p3, cams), (u2, ucams)


def _descriptors(labeled, unlabeled):
    sampler = tgen.ChunkedPairSampler([len(s) for s in labeled], BATCH, 1, augment=True)
    semi = tgen.ChunkedPairSampler([len(s) for s in unlabeled], BATCH, 1,
                                   random_seed=4321, augment=True, endless=True)
    semi_iter = semi.next_epoch()
    steps = [(m, nv, *next(semi_iter)) for m, nv in sampler.next_epoch()]
    assert len(steps) == STEPS and steps[-1][1] < BATCH and steps[-1][3] < BATCH
    return steps


_JAX_RUNS = {}


def _jax_run(switch):
    """The JAX trainer's per-step losses and final weights, statistics and
    moments for one loss switch, from PRNG keys 4 (pose) and 5 (trajectory)."""
    if switch in _JAX_RUNS:
        return _JAX_RUNS[switch]
    perm, (p2, p3, cams), (u2, ucams) = _semi_data()
    cfg, tcfg = JConfig(**_model_kwargs(J)), JConfig(**_model_kwargs(1))
    pos = init_temporal_model(cfg, jax.random.PRNGKey(4))
    traj = init_temporal_model(tcfg, jax.random.PRNGKey(5))
    init = jax.tree_util.tree_map(np.asarray, (pos, traj))
    loop = JLoop(batch_size=BATCH, chunk_length=1, pad=PAD, causal_shift=0,
                 gather_impl="xla", **LOSS_SWITCHES[switch])
    margins = jgen.FlatSequenceDataset.training_margins(PAD, 0, 1)
    dev = jgen.FlatSequenceDataset(p2, p3, cams, margins=margins,
                                   flip_perms=(perm, perm)).to_device()
    dev_semi = jgen.FlatSequenceDataset(u2, None, ucams, margins=margins,
                                        flip_perms=(perm, perm)).to_device()
    trainer = JSemi(cfg, tcfg, loop, perm, perm, PARENTS)
    params = {"pos": pos[0], "traj": traj[0]}
    states = {"pos": pos[1], "traj": traj[1]}
    opt_state = trainer.init_optimizer(params)
    rng = jax.random.PRNGKey(0)
    losses = []
    for i, (meta, nv, meta_u, nv_u) in enumerate(_descriptors(p2, u2)):
        params, states, opt_state, rng, *step_losses = trainer.step(
            params, states, opt_state, rng, dev, dev_semi, meta, nv, meta_u, nv_u, 0.1,
            i == 0)
        losses.append([float(v) for v in step_losses])
    ams = opt_state.inner_state[0]
    moments = {k: jax.tree_util.tree_map(np.asarray, getattr(ams, k))
               for k in ("m", "v", "vmax")}
    final = jax.tree_util.tree_map(np.asarray, (params, states))
    _JAX_RUNS[switch] = (init, np.asarray(losses), final, moments)
    return _JAX_RUNS[switch]


def _port_model(kwargs, engine, params, state):
    model = TemporalModel(TemporalModelConfig(**kwargs, train_engine=engine))
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in state_dict_from_jax(params, state).items()})
    return model


def _assert_tree_close(got, want, rtol, atol, what):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_leaves(want)
    assert len(flat_g) == len(flat_w)
    for (path, g), w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("switch", list(LOSS_SWITCHES))
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_semi_trainer_tracks_jax_trainer(engine, switch):
    """One warmup step and four full ones (the last with a partial labeled and a
    partial unlabeled batch) from one JAX initialisation: the four losses of
    every step, then both models' weights, running statistics and AMSGrad
    moments, as the JAX trainer's.  The trajectory model trains on the plain
    blocks whatever the pose model's engine (the JAX runner gives it none)."""
    (pos, traj), want_losses, (want_p, want_s), want_m = _jax_run(switch)
    perm, (p2, p3, cams), (u2, ucams) = _semi_data()
    pos_model = _port_model(_model_kwargs(J), engine, *pos)
    traj_model = _port_model(_model_kwargs(1), "xla", *traj)
    loop = ttrain.TrainLoopConfig(batch_size=BATCH, chunk_length=1, pad=PAD,
                                  causal_shift=0, **LOSS_SWITCHES[switch])
    margins = tgen.FlatSequenceDataset.training_margins(PAD, 0, 1)
    cpu = torch.device("cpu")
    dev = tgen.FlatSequenceDataset(p2, p3, cams, margins=margins,
                                   flip_perms=(perm, perm)).to_device(cpu)
    dev_semi = tgen.FlatSequenceDataset(u2, None, ucams, margins=margins,
                                        flip_perms=(perm, perm)).to_device(cpu)
    optimizer = ttrain.make_optimizer([pos_model, traj_model], loop.learning_rate)
    trainer = ttrain.SemiSupervisedTrainer(pos_model, traj_model, loop, optimizer, PARENTS)
    losses = []
    for i, (meta, nv, meta_u, nv_u) in enumerate(_descriptors(p2, u2)):
        out = trainer.step(dev, dev_semi, meta, nv, meta_u, nv_u, 0.1, i == 0)
        assert all(t.ndim == 0 for t in out)
        losses.append([float(t) for t in out])
    losses = np.asarray(losses)
    assert losses[0, 2] == 0.0 and np.all(losses[1:, 2] > 0)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)

    for name, model in (("pos", pos_model), ("traj", traj_model)):
        got_p, got_s, got_m = jax_params_from_model(model, optimizer)
        _assert_tree_close(got_p, want_p[name], 2e-3, 2e-5, f"{name} params")
        _assert_tree_close(got_s, want_s[name], 1e-4, 1e-6, f"{name} running stats")
        for key in ("m", "v", "vmax"):
            for g, w in zip(jax.tree_util.tree_leaves(got_m[key]),
                            jax.tree_util.tree_leaves(want_m[key][name])):
                np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3 * np.abs(w).max())


def test_semi_trainer_draws_dropout_masks_pose_model_first():
    """With dropout on, both engines of the pose model draw the same masks from
    the step's one generator (the pose model's first, then the trajectory
    model's), so their four losses agree."""
    perm, (p2, p3, cams), (u2, ucams) = _semi_data()
    margins = tgen.FlatSequenceDataset.training_margins(PAD, 0, 1)
    cpu = torch.device("cpu")
    dev = tgen.FlatSequenceDataset(p2, p3, cams, margins=margins,
                                   flip_perms=(perm, perm)).to_device(cpu)
    dev_semi = tgen.FlatSequenceDataset(u2, None, ucams, margins=margins,
                                        flip_perms=(perm, perm)).to_device(cpu)
    meta, nv, meta_u, nv_u = _descriptors(p2, u2)[1]
    torch.manual_seed(0)
    bases = [TemporalModel(TemporalModelConfig(**{**_model_kwargs(j), "dropout": 0.25}))
             for j in (J, 1)]
    out = {}
    for engine in ("xla", "pallas"):
        pos, traj = (TemporalModel(dataclasses.replace(b.config, train_engine=e))
                     for b, e in zip(bases, (engine, "xla")))
        for m, b in zip((pos, traj), bases):
            m.load_state_dict(b.state_dict())
        loop = ttrain.TrainLoopConfig(batch_size=BATCH, chunk_length=1, pad=PAD,
                                      causal_shift=0)
        trainer = ttrain.SemiSupervisedTrainer(
            pos, traj, loop, ttrain.make_optimizer([pos, traj], 1e-3), PARENTS)
        gen = torch.Generator().manual_seed(9)
        out[engine] = [float(t) for t in trainer.step(dev, dev_semi, meta, nv, meta_u,
                                                      nv_u, 0.1, False, gen)]
    np.testing.assert_allclose(out["pallas"], out["xla"], rtol=1e-5)


# ---------------------------------------------------------------------------
# The per-epoch trajectory losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("labeled", [True, False])
def test_trajectory_eval_losses_match_jax(labeled):
    """DeviceEvalSet.losses with the trajectory model: the pose, trajectory and
    2D reconstruction MPJPE of every video, frame-weighted, as the JAX
    package's (the unlabeled split has the reconstruction alone)."""
    p2, p3, cams = _videos(seed=8, lengths=(21, 40, 33), labeled=labeled)
    perm = _perm()
    cfg, tcfg = JConfig(**_model_kwargs(J)), JConfig(**_model_kwargs(1))
    params, state = init_temporal_model(cfg, jax.random.PRNGKey(1))
    tparams, tstate = init_temporal_model(tcfg, jax.random.PRNGKey(2))
    kw = dict(pad=PAD, causal_shift=0, kps_flip_perm=perm, joints_flip_perm=perm,
              bucket=16)
    want = JEvalSet(jgen.UnchunkedBatcher(cams, p3, p2, **kw), pad=PAD,
                    with_traj=True).losses(
        JEvaluator(cfg, joints_flip_perm=perm), params, state,
        traj_evaluator=JEvaluator(tcfg), traj_params=tparams, traj_state=tstate)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    model = _port_model(_model_kwargs(J), "xla", *to_np((params, state)))
    traj = _port_model(_model_kwargs(1), "xla", *to_np((tparams, tstate)))
    cpu = torch.device("cpu")
    evalset = DeviceEvalSet(tgen.UnchunkedBatcher(cams, p3, p2, **kw), pad=PAD, device=cpu,
                            with_traj=True)
    got = evalset.losses(Evaluator(model.config, joints_flip_perm=perm, device=cpu), model,
                         Evaluator(traj.config, device=cpu), traj)
    assert got[3] == want[3] == sum(len(s) for s in p2)
    assert (got[0] > 0) == (got[1] > 0) == labeled and got[2] > 0
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-5)
    assert evalset.loss(Evaluator(model.config, device=cpu), model) == got[0]
