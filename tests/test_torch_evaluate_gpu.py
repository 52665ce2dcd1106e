"""The evaluator's card path against its eager path, on the card: a raw video
(``UnchunkedBatcher.raw_epoch``) staged with its 3D poses in one pinned upload,
padded and mirrored on the card and, on the ``fused`` and ``int8`` engines,
evaluated by one CUDA-graph replay per padded length, gives the poses and the four
protocol means of the batcher's padded input through the eager path bit for bit;
the poses it returns stay each video's own; a change to the model's tensors
recaptures; the replays count as the eager path's launches.

Needs a CUDA device (marker ``gpu``; skipped elsewhere).  Imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_evaluate_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videopose3d_torch import profiling
from videopose3d_torch.data.generators import UnchunkedBatcher
from videopose3d_torch.evaluate import Evaluator, evaluate
from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                _fused_operands, receptive_field)
from videopose3d_torch.ops.kernels import protocols as pk
from videopose3d_torch.ops.kernels import temporal_block as tb

pytestmark = pytest.mark.gpu

J = 17
LEFT, RIGHT = [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]
PERM = np.arange(J)
PERM[LEFT], PERM[RIGHT] = RIGHT, LEFT
# Buckets of 16: 5 -> 16, 20 and 27 -> 32 (two lengths of one graph), 40 -> 48.
LENGTHS = (20, 5, 27, 40, 27)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(cuda, dtype="bfloat16", seed=0):
    cfg = TemporalModelConfig(J, 2, J, (3, 3, 3), channels=64, compute_dtype=dtype)
    torch.manual_seed(seed)
    net = TemporalModel(cfg)
    with torch.no_grad():  # BatchNorm statistics away from the identity
        for bn in [net.expand_bn, *net.layers_bn]:
            bn.running_mean.uniform_(-0.1, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    return cfg, net.eval().to(cuda)


def _batcher(cfg, augment, lengths=LENGTHS, seed=1):
    rng = np.random.default_rng(seed)
    p2 = [(rng.standard_normal((n, J, 2)) * 0.3).astype(np.float32) for n in lengths]
    p3 = [(rng.standard_normal((n, J, 3)) * 0.2).astype(np.float32) for n in lengths]
    return UnchunkedBatcher(None, p3, p2, pad=(receptive_field(cfg) - 1) // 2,
                            augment=augment, kps_flip_perm=PERM, joints_flip_perm=PERM,
                            bucket=16)


def _eager(evaluator, net, batcher, cuda):
    """Each video's poses and protocol means through the eager path (the batcher's
    padded input)."""
    out = []
    for _, b3, b2, n in batcher.next_epoch():
        pred = evaluator.predict_async(net, b2, batcher.augment_enabled())
        target = torch.from_numpy(b3[0]).to(cuda)
        out.append((pred, pk.video_protocols(pred[0].contiguous(), target, n)))
    return out


def _raw(evaluator, net, batcher):
    """Each video's poses and protocol means through the card path."""
    out = []
    for video in batcher.raw_epoch():
        pred = evaluator.predict_async(net, video, batcher.augment_enabled())
        out.append((pred, pk.video_protocols(pred[0].contiguous(), evaluator.target,
                                             video.n)))
    return out


def _counted(fn):
    """``fn()`` with the program's counters on (they count under a profiler)."""
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        result = fn()
    return result, profiling.counters()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("augment", [True, False])
def test_graph_matches_eager_bit_for_bit(cuda, dtype, augment):
    """Three buckets, two lengths inside one: poses and the four means bitwise the
    eager fused path's, also replayed in another order; ``evaluate()`` gives the
    frame-weighted means of the eager path's per-video means, digit for digit; one
    capture a padded length, and one video run eagerly before the first."""
    cfg, net = _model(cuda, dtype)
    batcher = _batcher(cfg, augment)
    evaluator = Evaluator(net.config, joints_flip_perm=PERM, engine="fused", device=cuda)
    want = _eager(evaluator, net, batcher, cuda)
    expand = tb.LAUNCHES["expand"]
    got, counters = _counted(lambda: _raw(evaluator, net, batcher))
    assert tb.LAUNCHES["expand"] - expand == len(LENGTHS) + 1
    assert counters["eval.graph_captures"] == 3
    assert counters["eval.graph_replays"] == len(LENGTHS)
    for (p_got, m_got), (p_want, m_want), n in zip(got, want, LENGTHS):
        assert p_got.shape == p_want.shape
        assert torch.equal(p_got, p_want), n
        assert torch.equal(m_got, m_want), n
    # The graphs share one memory pool: replayed in the reverse order, still exact.
    for video, (p_want, _) in zip(reversed(list(batcher.raw_epoch())), reversed(want)):
        assert torch.equal(evaluator.predict_async(net, video, augment), p_want)
    sums, total = np.zeros(4), 0
    for n, (_, means) in zip(LENGTHS, want):
        sums += [n * float(e) for e in means.cpu().numpy()]
        total += n
    numbers = evaluate(evaluator, net, batcher, verbose=False)
    assert numbers == tuple(sums / total * 1000)


@pytest.mark.parametrize("augment", [True, False])
def test_int8_graph_matches_eager_bit_for_bit(cuda, augment):
    """The ``int8`` engine's graphs, calibrated: poses and the four means bitwise
    the eager int8 path's, one capture a padded length; a new calibration
    captures again, and the poses are the eager path's on it."""
    cfg, net = _model(cuda, "float32")
    batcher = _batcher(cfg, augment)
    rng = np.random.default_rng(5)
    evaluator = Evaluator(net.config, joints_flip_perm=PERM, engine="int8", device=cuda)
    for scale in (0.3, 0.6):
        evaluator.set_calibration((rng.standard_normal((2, 40, J, 2)) * scale).astype(np.float32))
        want = _eager(evaluator, net, batcher, cuda)
        got, counters = _counted(lambda: _raw(evaluator, net, batcher))
        assert counters["eval.graph_captures"] == 3
        assert counters["eval.graph_replays"] == len(LENGTHS)
        for (p_got, m_got), (p_want, m_want), n in zip(got, want, LENGTHS):
            assert torch.equal(p_got, p_want), n
            assert torch.equal(m_got, m_want), n


def test_returned_poses_stay_each_videos_own(cuda):
    """Three videos of one bucket, then more replays of it: each tensor returned
    still holds its own video's poses."""
    cfg, net = _model(cuda)
    lengths = (17, 30, 25, 32, 19)
    batcher = _batcher(cfg, True, lengths=lengths, seed=3)
    evaluator = Evaluator(net.config, joints_flip_perm=PERM, engine="fused", device=cuda)
    want = [p for p, _ in _eager(evaluator, net, batcher, cuda)]
    kept = [evaluator.predict_async(net, video, True) for video in batcher.raw_epoch()]
    for video in batcher.raw_epoch():  # replays of the same graph after them
        evaluator.predict_async(net, video, True)
    torch.cuda.synchronize()
    for got, p, n in zip(kept, want, lengths):
        assert torch.equal(got, p), n
    assert len({t.data_ptr() for t in kept}) == len(kept)


def test_weight_update_recaptures(cuda):
    """An in-place update of the weights (an optimizer step) makes the next video
    capture again, and its poses are the eager path's under the new weights."""
    cfg, net = _model(cuda)
    batcher = _batcher(cfg, True, lengths=(21, 29), seed=4)
    evaluator = Evaluator(net.config, joints_flip_perm=PERM, engine="fused", device=cuda)
    _raw(evaluator, net, batcher)  # captured at the old weights
    with torch.no_grad():
        net.layers_conv[1].weight.mul_(1.5)
    want = _eager(evaluator, net, batcher, cuda)
    got, counters = _counted(lambda: _raw(evaluator, net, batcher))
    assert counters["eval.graph_captures"] == 1
    assert counters["eval.graph_replays"] == 2
    for (p_got, m_got), (p_want, m_want) in zip(got, want):
        assert torch.equal(p_got, p_want)
        assert torch.equal(m_got, m_want)


def _tensors(tree):
    """The tensors of a nest of tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in _tensors(item)]
    return []


def test_graphs_hold_their_operands(cuda):
    """A float32 ``fused`` evaluator on the model after a bfloat16 one replaces the
    model's cached fused operands, and the memory they held is written over: the
    bfloat16 graphs still read the operands they were captured over, so their poses
    stay the eager path's bit for bit."""
    cfg, net = _model(cuda)
    batcher = _batcher(cfg, True)
    bf16 = Evaluator(net.config, joints_flip_perm=PERM, engine="fused", device=cuda)
    want = _eager(bf16, net, batcher, cuda)
    _raw(bf16, net, batcher)  # the captures
    sizes = [t.numel() for t in _tensors(_fused_operands(net, torch.bfloat16))]
    f32 = Evaluator(dataclasses.replace(net.config, compute_dtype="float32"),
                    joints_flip_perm=PERM, engine="fused", device=cuda)
    _raw(f32, net, batcher)
    # Blocks of the bfloat16 operands' sizes, as the allocator hands them out now.
    junk = [torch.full((n,), float("nan"), dtype=torch.bfloat16, device=cuda)
            for n in sizes for _ in range(4)]
    got, counters = _counted(lambda: _raw(bf16, net, batcher))
    assert "eval.graph_captures" not in counters
    for (p_got, m_got), (p_want, m_want), n in zip(got, want, LENGTHS):
        assert torch.equal(p_got, p_want), n
        assert torch.equal(m_got, m_want), n
    del junk


def test_replays_count_as_eager_launches(cuda):
    """After the captures, ``evaluate()`` replays once a video, captures nothing,
    and counts the K3 and protocol launches the eager path counts."""
    cfg, net = _model(cuda)
    batcher = _batcher(cfg, True)
    evaluator = Evaluator(net.config, joints_flip_perm=PERM, engine="fused", device=cuda)
    evaluate(evaluator, net, batcher, verbose=False)  # the captures

    def launches(fn):
        before = {**tb.LAUNCHES, **pk.LAUNCHES}
        fn()
        torch.cuda.synchronize()
        return {k: v - before[k] for k, v in {**tb.LAUNCHES, **pk.LAUNCHES}.items()}

    eager = launches(lambda: _eager(evaluator, net, batcher, cuda))
    graphed, counters = _counted(
        lambda: launches(lambda: evaluate(evaluator, net, batcher, verbose=False)))
    assert graphed == eager
    assert eager["expand"] == eager["shrink"] == eager["protocols"] == len(LENGTHS)
    assert counters["eval.graph_replays"] == len(LENGTHS)
    assert "eval.graph_captures" not in counters
    assert not any(what == "model" for what, _ in evaluator._copies)  # no copy on "cuda"
    assert evaluate(evaluator, net, batcher, verbose=False, devices=[cuda, cuda]) == \
        evaluate(evaluator, net, batcher, verbose=False)


@pytest.mark.parametrize("engine", ["xla", "int8"])
def test_eager_engines_take_raw_videos(cuda, engine):
    """``xla`` runs a raw video eagerly and ``int8`` (quantized on the first
    video, no calibration set) by its graphs, padded on the card: the padded
    input's poses bit for bit, and a replay a video only for ``int8``."""
    cfg, net = _model(cuda, "float32")
    batcher = _batcher(cfg, True)
    evaluator = Evaluator(net.config, joints_flip_perm=PERM, engine=engine, device=cuda)
    want = _eager(evaluator, net, batcher, cuda)
    got, counters = _counted(lambda: _raw(evaluator, net, batcher))
    for (p_got, m_got), (p_want, m_want), n in zip(got, want, LENGTHS):
        assert torch.equal(p_got, p_want), n
        assert torch.equal(m_got, m_want), n
    assert counters.get("eval.graph_replays", 0) == (len(LENGTHS) if engine == "int8" else 0)
