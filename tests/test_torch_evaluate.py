"""videopose3d_torch's evaluation against videopose3d_tpu's on the same
synthetic sequences and weights: the batcher bit for bit, and every protocol
number of evaluate_actionwise for the xla and fused engines, with and without
test-time augmentation (relative 1e-4: both are float32 models summed in other
orders, ~1e-6 relative, reduced over whole videos).  The raw videos the card
path evaluates (``raw_epoch``, padded by ``padded_rows``, staged with their 3D
poses) against the batcher's padded ones, bit for bit."""

import numpy as np
import pytest
import torch

from videopose3d_tpu.data.generators import UnchunkedBatcher as JaxBatcher
from videopose3d_tpu.evaluate import Evaluator as JaxEvaluator
from videopose3d_tpu.evaluate import evaluate_actionwise as jax_evaluate_actionwise
from videopose3d_tpu.models.temporal import receptive_field
from videopose3d_torch.data.generators import UnchunkedBatcher, padded_rows
from videopose3d_torch.evaluate import (Evaluator, _stage, _staged_frames, _staged_poses,
                                        _staged_words, evaluate_actionwise)
from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig

from torch_port_helpers import (H36M_KPS_LEFT, H36M_KPS_RIGHT, average_lines,
                                jax_model, protocol_numbers)

KPS_PERM = np.arange(17)
KPS_PERM[H36M_KPS_LEFT], KPS_PERM[H36M_KPS_RIGHT] = H36M_KPS_RIGHT, H36M_KPS_LEFT
JOINTS_PERM = np.roll(np.arange(17), 3)  # any permutation the merge must undo


def _sequences(seed=0):
    rng = np.random.default_rng(seed)
    seqs = {}
    for action, lengths in (("Walking", (40, 57)), ("Eating", (70,)),
                            ("Sitting", (33, 21))):
        seqs[action] = [
            ((rng.standard_normal((n, 17, 3)) * 0.2).astype(np.float32),
             rng.uniform(-1, 1, (n, 17, 2)).astype(np.float32))
            for n in lengths]
    return seqs


@pytest.mark.parametrize("causal,augment,bucket_pow2", [
    (False, False, False), (False, True, False), (True, True, True)])
def test_batcher_matches_jax_bit_for_bit(causal, augment, bucket_pow2):
    seqs = [s for v in _sequences().values() for s in v]
    cams = [np.arange(9, dtype=np.float32) + i for i in range(len(seqs))]
    kw = dict(pad=13, causal_shift=13 if causal else 0, augment=augment,
              kps_flip_perm=KPS_PERM, joints_flip_perm=JOINTS_PERM, bucket=16,
              bucket_pow2=bucket_pow2)
    ours = UnchunkedBatcher(cams, [s[0] for s in seqs], [s[1] for s in seqs], **kw)
    ref = JaxBatcher(cams, [s[0] for s in seqs], [s[1] for s in seqs], **kw)
    assert ours.num_frames() == ref.num_frames()
    got, want = list(ours.next_epoch()), list(ref.next_epoch())
    assert len(got) == len(want) == len(seqs)
    for g, w in zip(got, want):
        assert g[3] == w[3]
        for a, b in zip(g[:3], w[:3]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _raw_batcher(causal, augment, bucket_pow2, lengths=(1, 15, 16, 17, 40), pad=13):
    """A batcher of videos of ``lengths`` frames (bucket 16: 16 and 32 are a
    bucket's edge), with cameras and 3D poses."""
    rng = np.random.default_rng(len(lengths))
    p2 = [rng.uniform(-1, 1, (n, 17, 2)).astype(np.float32) for n in lengths]
    p3 = [(rng.standard_normal((n, 17, 3)) * 0.2).astype(np.float32) for n in lengths]
    cams = [np.arange(9, dtype=np.float32) + i for i in range(len(lengths))]
    return UnchunkedBatcher(cams, p3, p2, pad=pad, causal_shift=pad if causal else 0,
                            augment=augment, kps_flip_perm=KPS_PERM,
                            joints_flip_perm=JOINTS_PERM, bucket=16,
                            bucket_pow2=bucket_pow2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("bucket_pow2", [False, True])
def test_padded_rows_matches_batcher_bit_for_bit(causal, augment, bucket_pow2):
    """``padded_rows`` on a raw video's frames is ``next_epoch``'s ``padded_2d`` bit
    for bit, with n an int or a 0-d int32 tensor (as the card's graph reads it), and
    frames past the n-th left unread."""
    batcher = _raw_batcher(causal, augment, bucket_pow2)
    perm = torch.as_tensor(KPS_PERM) if augment else None
    for (_, _, want, n), video in zip(batcher.next_epoch(), batcher.raw_epoch()):
        frames = torch.from_numpy(video.poses_2d)
        # Rows past the n-th as the staged buffer holds them: other data.
        spare = torch.cat([frames, torch.full((video.t_bucket - n + 3, 17, 2), 7.0)])
        for count in (n, torch.tensor(n, dtype=torch.int32)):
            got = padded_rows(spare, count, length=video.length, left=video.left,
                              flip_perm=perm)
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert got.numpy().tobytes() == want.tobytes(), (n, count)


@pytest.mark.parametrize("augment", [False, True])
def test_raw_epoch_matches_next_epoch(augment):
    """``raw_epoch`` yields the videos of ``next_epoch``, in its order, skipping the
    same empty one: the same n, 3D poses and cameras, the frames as stored, and the
    padded length ``next_epoch`` pads to."""
    rng = np.random.default_rng(3)
    lengths = (40, 0, 1, 16, 33)
    p2 = [rng.uniform(-1, 1, (n, 17, 2)).astype(np.float32) for n in lengths]
    p3 = [rng.standard_normal((n, 17, 3)).astype(np.float32) for n in lengths]
    cams = [np.arange(9, dtype=np.float32) * i for i in range(len(lengths))]
    batcher = UnchunkedBatcher(cams, p3, p2, pad=4, augment=augment,
                               kps_flip_perm=KPS_PERM, joints_flip_perm=JOINTS_PERM,
                               bucket=16)
    want, got = list(batcher.next_epoch()), list(batcher.raw_epoch())
    assert [w[3] for w in want] == [v.n for v in got] == [40, 1, 16, 33]
    kept = [i for i, n in enumerate(lengths) if n]
    for (cam, b3, b2, n), video, i in zip(want, got, kept):
        assert video.poses_2d is p2[i] and video.cam is cams[i]
        np.testing.assert_array_equal(b3[0], video.poses_3d)
        np.testing.assert_array_equal(cam[0], video.cam)
        assert b2.shape[1] == video.length == video.t_bucket + 8
        assert (video.pad, video.causal_shift) == (4, 0)


@pytest.mark.parametrize("engine,augment", [
    ("xla", False), ("xla", True), ("fused", False), ("fused", True)])
def test_predict_raw_video_matches_padded(engine, augment):
    """A raw video as the card path stages it (n, frames and 3D poses in one buffer
    of stale data) and pads it (``padded_rows`` on the staged frames) predicts the
    poses of the batcher's padded input bit for bit, and its staged 3D poses are the
    batcher's; ``predict_async`` refuses a raw video off a card."""
    cfg = TemporalModelConfig(17, 2, 17, (3, 3), channels=16)
    torch.manual_seed(2)
    model = TemporalModel(cfg).eval()
    batcher = _raw_batcher(False, augment, False, lengths=(1, 16, 23), pad=4)  # field 9
    evaluator = Evaluator(cfg, joints_flip_perm=JOINTS_PERM, engine=engine,
                          device=torch.device("cpu"))
    perm = torch.as_tensor(KPS_PERM) if augment else None
    for (_, b3, b2, n), video in zip(batcher.next_epoch(), batcher.raw_epoch()):
        # As a graph's buffer: room for t_bucket frames and poses.
        buf = torch.full((4 + video.t_bucket * (17 * 2 + 17 * 3),), float("nan"))
        assert _staged_words(video) <= buf.numel()
        _stage(buf.numpy(), video)
        count, frames = _staged_frames(buf, video.t_bucket, video.poses_2d.shape[1:])
        assert count.dtype == torch.int32 and int(count) == n
        x = padded_rows(frames, count, length=video.length, left=video.left,
                        flip_perm=perm)
        want = evaluator.predict_async(model, b2, augment)
        got = evaluator.predict_async(model, x, augment)
        assert got.shape == want.shape == (1, video.t_bucket, 17, 3)
        assert torch.equal(got, want), n
        assert torch.equal(_staged_poses(buf, video), torch.from_numpy(b3[0]))
        with pytest.raises(ValueError, match="on a card"):
            evaluator.predict_async(model, video, augment)


@pytest.mark.parametrize("engine,augment", [
    ("xla", False), ("xla", True), ("fused", False), ("fused", True)])
def test_evaluate_actionwise_matches_jax(engine, augment, capsys):
    kwargs = dict(num_joints_in=17, in_features=2, num_joints_out=17,
                  filter_widths=(3, 3, 3), channels=32)
    cfg, params, state, tcfg, model = jax_model(kwargs, seed=4)
    pad = (receptive_field(cfg) - 1) // 2
    seqs = _sequences(seed=1)
    all_actions = {a: [(a, i) for i in range(len(v))] for a, v in seqs.items()}

    def batcher_factory(cls):
        def make(pairs):
            return cls(None, [seqs[a][i][0] for a, i in pairs],
                       [seqs[a][i][1] for a, i in pairs], pad=pad,
                       augment=augment, kps_flip_perm=KPS_PERM,
                       joints_flip_perm=JOINTS_PERM, bucket=16)
        return make

    want = jax_evaluate_actionwise(
        JaxEvaluator(cfg, joints_flip_perm=JOINTS_PERM, engine=engine), params,
        state, all_actions, batcher_factory(JaxBatcher))
    want_out = capsys.readouterr().out
    got = evaluate_actionwise(
        Evaluator(tcfg, joints_flip_perm=JOINTS_PERM, engine=engine,
                  device=torch.device("cpu")),
        model, all_actions, batcher_factory(UnchunkedBatcher))
    got_out = capsys.readouterr().out

    np.testing.assert_allclose(got, want, rtol=1e-4)
    got_n, want_n = protocol_numbers(got_out), protocol_numbers(want_out)
    assert list(got_n) == list(want_n) == list(seqs)
    for action in want_n:
        assert len(got_n[action]) == 4
        np.testing.assert_allclose(got_n[action], want_n[action], rtol=1e-4,
                                   err_msg=action)
    assert len(average_lines(got_out)) == 4
    assert f"Test time augmentation: {augment}" in got_out


def test_int8_engine_is_not_ported():
    """The int8 engine is served by the port: evaluate_actionwise with TTA gives
    the JAX int8 engine's protocol numbers to relative 1e-4.  Both quantize on
    the first predicted batch; they are not bitwise, because XLA on the CPU
    contracts the int8 epilogues' ``a * s + b`` into fused multiply-adds where
    torch rounds twice, which flips an int8 rounding only at a tie, and the
    frame-averaged protocols move far less than one flipped pose."""
    kwargs = dict(num_joints_in=17, in_features=2, num_joints_out=17,
                  filter_widths=(3, 3, 3), channels=32)
    cfg, params, state, tcfg, model = jax_model(kwargs, seed=6)
    pad = (receptive_field(cfg) - 1) // 2
    seqs = _sequences(seed=2)
    all_actions = {a: [(a, i) for i in range(len(v))] for a, v in seqs.items()}

    def batcher_factory(cls):
        def make(pairs):
            return cls(None, [seqs[a][i][0] for a, i in pairs],
                       [seqs[a][i][1] for a, i in pairs], pad=pad, augment=True,
                       kps_flip_perm=KPS_PERM, joints_flip_perm=JOINTS_PERM, bucket=16)
        return make

    want = jax_evaluate_actionwise(
        JaxEvaluator(cfg, joints_flip_perm=JOINTS_PERM, engine="int8"), params, state,
        all_actions, batcher_factory(JaxBatcher), verbose=False)
    evaluator = Evaluator(tcfg, joints_flip_perm=JOINTS_PERM, engine="int8",
                          device=torch.device("cpu"))
    got = evaluate_actionwise(evaluator, model, all_actions,
                              batcher_factory(UnchunkedBatcher), verbose=False)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert evaluator._q is not None
