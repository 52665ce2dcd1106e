"""Dilated-form training of videopose3d_torch (``--stride > 1``, ``--dense``,
``--disable-optimizations``) against the JAX package's, on the CPU at small
widths from numpy seeds: the train-mode forward, the batch assembly of chunks,
the supervised and semi-supervised trainers with ``use_strided=False``, two gloo
ranks against one process, and the CLI.

Tolerances, each with its reason:
* the forward in float32: outputs within 1e-5 of their largest entry, the
  running statistics within 1e-6 relative and 1e-7 absolute, each gradient
  within 1e-5 of its norm (the JAX package sums the concatenated taps in one
  product, the port tap by tap: float32 sums in other orders); bfloat16 and
  "mixed": outputs and statistics within 1.6e-2 of their largest entry (four
  bf16 steps, the bound of the kernel tests), gradients by cosine similarity
  above 0.995, the JAX package's bound for its bf16 train block (the JAX
  package sums the taps in one concatenated product and the port tap by tap
  with ``addmm_``: the sums differ in their last bits, and a bf16
  pre-activation that rounds across 0 in one order and not the other flips a
  ReLU gate);
* the batch assembly: bitwise (pure indexing);
* the trainers: per-step losses within 1e-5 relative; weights rtol 2e-3 /
  atol 2e-5, running statistics rtol 1e-4 / atol 1e-6 and AMSGrad moments as in
  ``tests/test_torch_train.py``;
* two ranks against one process: ``tests/test_torch_parallel.py``'s bounds;
* the CLI: epoch and protocol numbers within 1e-4 relative, as
  ``tests/test_torch_cli.py``.
"""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videopose3d_tpu import runner as jax_runner
from videopose3d_tpu.data import generators as jgen
from videopose3d_tpu.models.temporal import TemporalModelConfig as JConfig
from videopose3d_tpu.models.temporal import forward_dilated as jax_forward_dilated
from videopose3d_tpu.models.temporal import init_temporal_model
from videopose3d_tpu.train import SemiSupervisedTrainer as JSemi
from videopose3d_tpu.train import SupervisedTrainer as JSup
from videopose3d_tpu.train import TrainLoopConfig as JLoop
from videopose3d_torch import runner
from videopose3d_torch import train as ttrain
from videopose3d_torch.checkpoint import model_state_dict
from videopose3d_torch.data import generators as tgen
from videopose3d_torch.models.convert import (jax_params_from_model, jax_params_from_state_dict,
                                              state_dict_from_jax)
from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                forward_dilated_train, receptive_field)

import torch_parallel_workers as W
from test_torch_parallel import _assert_weights
from test_torch_semi import PARENTS, _videos
from test_torch_train import _assert_tree_close, _data, _perm
from torch_port_helpers import jax_model, protocol_numbers, write_h36m_archives

J = 17
CHANNELS = 32


# ---------------------------------------------------------------------------
# The train-mode forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fw,frames,extra", [
    ((3, 3, 3), 30, {}),                                 # 4 output frames
    ((3, 3), 12, dict(dense=True)),                      # dense taps of 7
    ((3, 3, 3), 30, dict(causal=True)),
    ((3, 5), 40, dict(dense=True, causal=True)),         # dense taps of 31
    ((3, 3), 12, dict(compute_dtype="bfloat16")),
    ((3, 3), 12, dict(compute_dtype="mixed")),
])
def test_forward_dilated_train_matches_jax(fw, frames, extra):
    """Output, every running statistic and every parameter's gradient of a sum
    of squares of the output, one forward from the same weights and statistics."""
    kwargs = dict(num_joints_in=J, in_features=2, num_joints_out=J, filter_widths=fw,
                  channels=CHANNELS, dropout=0.0, **extra)
    cfg, params, state, _, model = jax_model(kwargs, seed=3)
    x = np.random.default_rng(4).standard_normal((5, frames, J, 2)).astype(np.float32)

    def loss(p):
        y, new_state = jax_forward_dilated(cfg, p, state, jnp.asarray(x), train=True,
                                           momentum=0.3)
        return jnp.sum(jnp.square(y)), (y, new_state)

    (_, (want, want_state)), want_grads = jax.value_and_grad(loss, has_aux=True)(params)
    model.train()
    got = forward_dilated_train(model, torch.from_numpy(x), momentum=0.3)
    assert got.dtype == torch.float32
    assert got.shape == (5, frames - receptive_field(model.config) + 1, J, 3)
    got.square().sum().backward()

    f32 = extra.get("compute_dtype", "float32") == "float32"
    tol = 1e-5 if f32 else 1.6e-2
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= tol * np.abs(want).max()
    _, got_s = jax_params_from_model(model)
    got_g, _ = jax_params_from_state_dict(
        {**{k: v.numpy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")},
         **{k: p.grad.numpy() for k, p in model.named_parameters()}})
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got_g)[0],
                            jax.tree_util.tree_leaves(want_grads)):
        g, w = np.asarray(g, np.float64).ravel(), np.asarray(w, np.float64).ravel()
        if f32:
            err = float(np.linalg.norm(g - w) / np.linalg.norm(w))
            assert err <= 1e-5, (jax.tree_util.keystr(path), err)
        else:
            cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
            assert cos > 0.995, (jax.tree_util.keystr(path), cos)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got_s)[0],
                            jax.tree_util.tree_leaves(want_state)):
        w = np.asarray(w)
        if f32:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=jax.tree_util.keystr(path))
        else:
            assert np.abs(g - w).max() <= tol * np.abs(w).max(), jax.tree_util.keystr(path)


def test_forward_dilated_train_ignores_the_train_engine():
    """The JAX package runs no train-block kernel on the dilated form: both
    engines give the same poses, dropout masks included."""
    cfg = TemporalModelConfig(J, 2, J, (3, 3, 3), dropout=0.25, channels=CHANNELS)
    torch.manual_seed(0)
    base = TemporalModel(cfg)
    x = torch.randn(6, 29, J, 2, generator=torch.Generator().manual_seed(1))
    outs = []
    for engine in ("xla", "pallas"):
        model = TemporalModel(TemporalModelConfig(J, 2, J, (3, 3, 3), dropout=0.25,
                                                  channels=CHANNELS, train_engine=engine))
        model.load_state_dict(base.state_dict())
        outs.append(forward_dilated_train(model, x, momentum=0.1,
                                          generator=torch.Generator().manual_seed(7)))
    assert outs[0].shape == (6, 3, J, 3)
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="receptive field"):
        forward_dilated_train(base, x[:, :26], momentum=0.1)


# ---------------------------------------------------------------------------
# Batch assembly of chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,pad,causal_shift", [(3, 4, 0), (2, 13, 13), (5, 1, 0)])
def test_chunk_assembly_matches_jax(chunk, pad, causal_shift):
    """Windows of chunk + 2*pad rows and targets of chunk rows, flips included,
    bitwise as the JAX package's, over margins of training_margins(..., chunk)."""
    p2, p3 = _data(seed=9, lengths=(23, 17, 4))
    perm = _perm()
    margins = tgen.FlatSequenceDataset.training_margins(pad, causal_shift, chunk)
    assert jgen.FlatSequenceDataset.training_margins(pad, causal_shift, chunk) == margins
    jdev = jgen.FlatSequenceDataset(p2, p3, margins=margins, flip_perms=(perm, perm)
                                    ).to_device(flatten_2d=True)
    tdev = tgen.FlatSequenceDataset(p2, p3, margins=margins, flip_perms=(perm, perm)
                                    ).to_device(torch.device("cpu"))
    sampler = tgen.ChunkedPairSampler([len(s) for s in p2], 8, chunk, augment=True)
    jsampler = jgen.ChunkedPairSampler([len(s) for s in p2], 8, chunk, augment=True,
                                       use_native=False)
    for (meta, nv), (jmeta, jnv) in zip(sampler.next_epoch(), jsampler.next_epoch()):
        assert nv == jnv and np.array_equal(meta, jmeta)
        _, want_3d, want_2d = jgen.assemble_chunked_batch_contiguous(
            jdev.flat_2d_padded, jdev.flat_3d_padded, None, jdev.base_2d, jdev.base_3d,
            jnp.asarray(meta), pad=pad, causal_shift=causal_shift, chunk_length=chunk,
            kps_flip_perm=tuple(perm), joints_flip_perm=tuple(perm),
            aug_offset_2d=jdev.aug_offset_2d, aug_offset_3d=jdev.aug_offset_3d,
            cols_2d=jdev.cols_2d or 0)
        for gather in ("pallas", "xla"):
            _, got_3d, got_2d = tgen.assemble_chunked_batch_contiguous(
                tdev, meta, pad=pad, causal_shift=causal_shift, chunk_length=chunk,
                gather_impl=gather)
            assert got_2d.shape == (8, chunk + 2 * pad, J * 2)
            np.testing.assert_array_equal(got_2d.numpy(),
                                          np.asarray(want_2d).reshape(got_2d.shape))
            np.testing.assert_array_equal(got_3d.numpy(), np.asarray(want_3d))


# ---------------------------------------------------------------------------
# The trainers
# ---------------------------------------------------------------------------

# name -> (filter widths, chunk length (--stride), batch (-b // --stride), model
# options).  Labeled videos of 20 and 17 frames with flips: every case takes
# four or five steps, the last a partial batch.
CASES = {
    "stride3": ((3, 3), 3, 8, {}),
    "dense": ((3, 3), 1, 16, dict(dense=True)),
    "disable_optimizations": ((3, 3), 1, 16, {}),
    "causal_stride2": ((3, 3, 3), 2, 8, dict(causal=True)),
}


def _geometry(case):
    fw, chunk, batch, extra = CASES[case]
    cfg = TemporalModelConfig(J, 2, J, fw, channels=CHANNELS, **extra)
    rf = receptive_field(cfg)
    pad = (rf - 1) // 2
    return fw, chunk, batch, extra, pad, pad if extra.get("causal") else 0


def _kwargs(case, joints_out=J):
    fw, _, _, extra, _, _ = _geometry(case)
    return dict(num_joints_in=J, in_features=2, num_joints_out=joints_out,
                filter_widths=fw, dropout=0.0, channels=CHANNELS, **extra)


def _loops(case, **switches):
    _, chunk, batch, _, pad, shift = _geometry(case)
    kw = dict(batch_size=batch, chunk_length=chunk, pad=pad, causal_shift=shift,
              use_strided=False, **switches)
    return JLoop(**kw, gather_impl="xla"), ttrain.TrainLoopConfig(**kw)


def _steps(lengths, case, seed=1234, endless=False):
    _, chunk, batch, _, _, _ = _geometry(case)
    sampler = tgen.ChunkedPairSampler(lengths, batch, chunk, random_seed=seed,
                                      augment=True, endless=endless)
    return sampler.next_epoch()


def _moments_close(got_m, want_m):
    for key in ("m", "v", "vmax"):
        for g, w in zip(jax.tree_util.tree_leaves(got_m[key]),
                        jax.tree_util.tree_leaves(want_m[key])):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3 * np.abs(w).max())


def _port_model(kwargs, engine, params, state):
    model = TemporalModel(TemporalModelConfig(**kwargs, train_engine=engine))
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in state_dict_from_jax(params, state).items()})
    return model


@pytest.mark.parametrize("case", list(CASES))
def test_supervised_trainer_tracks_jax_dilated(case):
    """From one JAX initialisation: every step's loss, then the weights, running
    statistics and AMSGrad moments, as the JAX trainer's with
    use_strided=False; the port's pallas engine trains the plain blocks here."""
    p2, p3 = _data()
    perm = _perm()
    jloop, loop = _loops(case)
    margins = tgen.FlatSequenceDataset.training_margins(loop.pad, loop.causal_shift,
                                                        loop.chunk_length)
    jcfg = JConfig(**_kwargs(case))
    params, state = init_temporal_model(jcfg, jax.random.PRNGKey(4))
    init = jax.tree_util.tree_map(np.asarray, (params, state))
    jdev = jgen.FlatSequenceDataset(p2, p3, margins=margins, flip_perms=(perm, perm)
                                    ).to_device(flatten_2d=True)
    trainer = JSup(jcfg, jloop, perm, perm)
    opt_state = trainer.init_optimizer(params)
    rng = jax.random.PRNGKey(0)
    steps = list(_steps([len(s) for s in p2], case))
    assert len(steps) >= 3 and steps[-1][1] < loop.batch_size
    want_losses = []
    for meta, nv in steps:
        params, state, opt_state, rng, loss = trainer.step(params, state, opt_state, rng,
                                                           jdev, meta, nv, 0.1)
        want_losses.append(float(loss))

    model = _port_model(_kwargs(case), "pallas", *init)
    dev = tgen.FlatSequenceDataset(p2, p3, margins=margins, flip_perms=(perm, perm)
                                   ).to_device(torch.device("cpu"))
    optimizer = ttrain.make_optimizer(model, loop.learning_rate)
    port = ttrain.SupervisedTrainer(model, loop, optimizer)
    losses = [float(port.step(dev, meta, nv, 0.1)) for meta, nv in steps]

    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got_p, got_s, got_m = jax_params_from_model(model, optimizer)
    _assert_tree_close(got_p, jax.tree_util.tree_map(np.asarray, params), 2e-3, 2e-5,
                       "params")
    _assert_tree_close(got_s, jax.tree_util.tree_map(np.asarray, state), 1e-4, 1e-6,
                       "running stats")
    ams = opt_state.inner_state[0]
    _moments_close(got_m, {k: jax.tree_util.tree_map(np.asarray, getattr(ams, k))
                           for k in ("m", "v", "vmax")})


@pytest.mark.parametrize("case", ["stride3", "dense"])
def test_semi_trainer_tracks_jax_dilated(case):
    """A warmup step, then full ones on labeled and unlabeled chunks (the last
    with partial batches): the four losses of every step, then both models'
    weights, running statistics and moments, as the JAX trainer's."""
    perm = _perm()
    p2, p3, cams = _videos(seed=5, lengths=(20, 17))
    u2, _, ucams = _videos(seed=6, lengths=(19, 17), labeled=False)
    jloop, loop = _loops(case)
    margins = tgen.FlatSequenceDataset.training_margins(loop.pad, 0, loop.chunk_length)
    jcfg, jtcfg = JConfig(**_kwargs(case)), JConfig(**_kwargs(case, 1))
    pos = init_temporal_model(jcfg, jax.random.PRNGKey(4))
    traj = init_temporal_model(jtcfg, jax.random.PRNGKey(5))
    init = jax.tree_util.tree_map(np.asarray, (pos, traj))
    jdev = jgen.FlatSequenceDataset(p2, p3, cams, margins=margins,
                                    flip_perms=(perm, perm)).to_device()
    jdev_semi = jgen.FlatSequenceDataset(u2, None, ucams, margins=margins,
                                         flip_perms=(perm, perm)).to_device()
    trainer = JSemi(jcfg, jtcfg, jloop, perm, perm, PARENTS)
    params, states = {"pos": pos[0], "traj": traj[0]}, {"pos": pos[1], "traj": traj[1]}
    opt_state = trainer.init_optimizer(params)
    rng = jax.random.PRNGKey(0)
    semi = _steps([len(s) for s in u2], case, seed=4321, endless=True)
    steps = [(m, nv, *next(semi)) for m, nv in _steps([len(s) for s in p2], case)]
    assert len(steps) >= 3 and steps[-1][1] < loop.batch_size
    want = []
    for i, (meta, nv, meta_u, nv_u) in enumerate(steps):
        params, states, opt_state, rng, *out = trainer.step(
            params, states, opt_state, rng, jdev, jdev_semi, meta, nv, meta_u, nv_u, 0.1,
            i == 0)
        want.append([float(v) for v in out])

    pos_model = _port_model(_kwargs(case), "pallas", *init[0])
    traj_model = _port_model(_kwargs(case, 1), "xla", *init[1])
    cpu = torch.device("cpu")
    dev = tgen.FlatSequenceDataset(p2, p3, cams, margins=margins,
                                   flip_perms=(perm, perm)).to_device(cpu)
    dev_semi = tgen.FlatSequenceDataset(u2, None, ucams, margins=margins,
                                        flip_perms=(perm, perm)).to_device(cpu)
    optimizer = ttrain.make_optimizer([pos_model, traj_model], loop.learning_rate)
    port = ttrain.SemiSupervisedTrainer(pos_model, traj_model, loop, optimizer, PARENTS)
    got = [[float(t) for t in port.step(dev, dev_semi, meta, nv, meta_u, nv_u, 0.1, i == 0)]
           for i, (meta, nv, meta_u, nv_u) in enumerate(steps)]
    got = np.asarray(got)
    assert got[0, 2] == 0.0 and np.all(got[1:, 2] > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)

    ams = opt_state.inner_state[0]
    for name, model in (("pos", pos_model), ("traj", traj_model)):
        got_p, got_s, got_m = jax_params_from_model(model, optimizer)
        _assert_tree_close(got_p, jax.tree_util.tree_map(np.asarray, params[name]), 2e-3,
                           2e-5, f"{name} params")
        _assert_tree_close(got_s, jax.tree_util.tree_map(np.asarray, states[name]), 1e-4,
                           1e-6, f"{name} running stats")
        _moments_close(got_m, {k: jax.tree_util.tree_map(np.asarray, getattr(ams, k)[name])
                               for k in ("m", "v", "vmax")})


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_dilated_supervised_trainer_two_ranks_match_one(tmp_path, dropout):
    """Chunks of 2 frames, three steps of 8 (the last of 4 valid rows, all on
    rank 0): the ranks' loss shares add up to the single process's losses, the
    BatchNorm statistics over the global batch's rows and the masks the global
    draw."""
    ranks = W.run_ranks(tmp_path, "supervised_rank", "pallas", dropout, 2)
    want_losses, want_state = W.supervised_losses("pallas", dropout, chunk_length=2)
    np.testing.assert_allclose(np.sum([r[0] for r in ranks], axis=0), want_losses,
                               rtol=1e-5)
    _assert_weights([r[1] for r in ranks], want_state)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

_EPOCH = re.compile(r"^\[(\d+)\] time \S+ lr (\S+) 3d_train (\S+) 3d_eval (\S+) "
                    r"3d_valid (\S+)$")


def _epoch_lines(out):
    return [(int(m.group(1)), m.group(2), [float(v) for v in m.group(3, 4, 5)])
            for m in map(_EPOCH.match, out.splitlines()) if m]


@pytest.fixture(scope="module")
def cli_workdir(tmp_path_factory):
    """Archives with a training subject, and one random initial checkpoint per
    architecture (``epoch: 0``, no optimizer state)."""
    root = tmp_path_factory.mktemp("dilated_cli")
    (root / "data").mkdir()
    write_h36m_archives(str(root / "data"), subjects=("S1", "S9", "S11"), n_frames=40)
    for dense in (False, True):
        torch.manual_seed(3)
        model = TemporalModel(TemporalModelConfig(J, 2, J, (3, 3), channels=CHANNELS,
                                                  dense=dense))
        torch.save({"epoch": 0, "lr": 0.001, "optimizer": None, "model_traj": None,
                    "model_pos": model_state_dict(model)},
                   root / f"init{'_dense' if dense else ''}.bin")
    return root


def _cli_args(root, ckpt, flags, init):
    (root / ckpt).mkdir()
    shutil.copy(root / init, root / ckpt / "init.bin")
    return ["-k", "gt", "-arc", "3,3", "-ch", str(CHANNELS), "-b", "64", "-e", "2",
            "-drop", "0", "-str", "S1", "-ste", "S9,S11", "--data-dir", str(root / "data"),
            "-c", str(root / ckpt), "-r", "init.bin", "--eval-bucket", "16",
            "--checkpoint-frequency", "1", *flags]


@pytest.mark.parametrize("flags,chunk", [(["--stride", "2"], 2), (["--dense"], 1),
                                         (["--disable-optimizations"], 1)])
def test_dilated_training_cli_matches_jax(cli_workdir, flags, chunk, capsys):
    """Two epochs from one initial checkpoint at -drop 0: the epoch lines and the
    protocol numbers as the JAX CLI's; the JAX CLI evaluates the port's last
    checkpoint (dense kernels of 7 taps included) to the port's numbers."""
    root = cli_workdir
    name = flags[0].strip("-")
    init = "init_dense.bin" if "--dense" in flags else "init.bin"
    jax_runner.main(_cli_args(root, f"jax_{name}", flags, init)
                    + ["--rng-impl", "threefry2x32"])
    want = capsys.readouterr().out
    runner.main(_cli_args(root, f"port_{name}", flags, init)
                + ["--device", "cpu", "--train-engine", "pallas"])
    got = capsys.readouterr().out

    assert (f"INFO: Training the dilated form on chunks of {chunk} frames (plain blocks)"
            in got)
    assert re.search(r"^INFO: trained \d+ steps in \S+ s \(\S+ frames/s, dilated form, "
                     r"device cpu\)$", got, re.M)
    got_e, want_e = _epoch_lines(got), _epoch_lines(want)
    assert [e[:2] for e in got_e] == [e[:2] for e in want_e] == [(1, "0.001000"),
                                                                 (2, "0.000950")]
    for (_, _, g), (_, _, w) in zip(got_e, want_e):
        np.testing.assert_allclose(g, w, rtol=1e-4)
    got_p, want_p = protocol_numbers(got), protocol_numbers(want)
    assert list(got_p) == list(want_p) == ["Walking", "Eating"]
    for action in want_p:
        np.testing.assert_allclose(got_p[action], want_p[action], rtol=1e-4)

    shutil.copy(root / f"port_{name}" / "epoch_2.bin", root / f"jax_{name}" / "port.bin")
    jax_runner.main(["-k", "gt", "-arc", "3,3", "-ch", str(CHANNELS), "-str", "S1", "-ste",
                     "S9,S11", "--data-dir", str(root / "data"), "-c",
                     str(root / f"jax_{name}"), "--evaluate", "port.bin", "--eval-bucket",
                     "16", "--rng-impl", "threefry2x32", *flags])
    evaluated = protocol_numbers(capsys.readouterr().out)
    for action, numbers in evaluated.items():
        np.testing.assert_allclose(numbers, got_p[action], rtol=1e-4)
