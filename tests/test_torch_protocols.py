"""The protocol kernel's plain version (``ops/kernels/protocols.py``: the kernel's
arithmetic, float64, a one-sided Jacobi SVD a frame) against ``ops/losses.py``'s
host protocols run on float64 copies of the same poses, to 1e-9 relative (both
float64; the SVDs differ in method, not in precision).  Poses with mirrored frames
(improper alignments), scaled by 1e-3 and 1e3, planar and one-frame videos; and
``evaluate()``'s numbers on the CPU from per-video plain protocols of its own
predictions (1e-6: the host path sums in float32)."""

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from protocol_cases import KINDS, host_protocols, video
from videopose3d_torch import evaluate as ev
from videopose3d_torch.data import generators as tgen
from videopose3d_torch.ops.kernels import protocols as pk


def _plain(pred, target, n):
    return pk.video_protocols(torch.as_tensor(pred), torch.as_tensor(target), n)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("n", [2, 3, 129, 3500])
@pytest.mark.parametrize("joints", [17, 15])
def test_plain_protocols_match_host(joints, n, kind):
    pred, target = video(n, joints, kind, seed=n + joints)
    got = _plain(pred, target, n)
    assert got.dtype == torch.float64 and got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), host_protocols(pred[:n], target), rtol=1e-9,
                               atol=0)


def test_plain_protocols_of_planar_poses():
    """Targets in one plane: the third singular value is 0 and the proper rotation
    still unique."""
    pred, target = video(64, 17, seed=5)
    target[..., 2] = 0.0
    np.testing.assert_allclose(_plain(pred, target, 64).numpy(),
                               host_protocols(pred[:64], target), rtol=1e-9, atol=0)


def test_plain_protocols_of_one_frame():
    """MPJVE over no frame difference is NaN, as NumPy's mean of nothing."""
    pred, target = video(1, 17, seed=6)
    got = _plain(pred, target, 1).numpy()
    with np.errstate(invalid="ignore"), pytest.warns(RuntimeWarning):
        want = host_protocols(pred[:1], target)
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-9, atol=0)
    assert np.isnan(got[3]) and np.isnan(want[3])


def test_plain_protocols_refuse_mismatched_shapes():
    pred, target = video(10, 17)
    with pytest.raises(ValueError, match="target"):
        _plain(pred, target[:9], 10)
    with pytest.raises(ValueError, match="out of range"):
        _plain(pred[:9], target, 10)
    with pytest.raises(ValueError, match="out of range"):
        _plain(pred, target[:0], 0)


@pytest.mark.parametrize("augment", [False, True])
def test_evaluate_numbers_from_plain_protocols(augment):
    """``evaluate()``'s host numbers equal the frame-weighted plain protocols of the
    poses it predicted, video by video: the card path's arithmetic."""
    p2, p3, _ = W.videos(seed=9, lengths=(21, 40, 33))
    perm = W.flip_perm()
    net = W.model(seed=4).eval()
    evaluator = ev.Evaluator(net.config, joints_flip_perm=perm, device=W.CPU)
    batcher = tgen.UnchunkedBatcher(None, p3, p2, pad=W.PAD, causal_shift=0,
                                    augment=augment, kps_flip_perm=perm,
                                    joints_flip_perm=perm, bucket=16)
    poses = []
    predict = evaluator.predict_async

    def recorded(model, batch_2d, augment, device=None):
        poses.append(predict(model, batch_2d, augment, device))
        return poses[-1]

    evaluator.predict_async = recorded
    got = ev.evaluate(evaluator, net, batcher, verbose=False)
    sums = np.zeros(4)
    for pred, target in zip(poses, p3):
        sums += len(target) * _plain(pred[0], target, len(target)).numpy()
    np.testing.assert_allclose(got, sums / sum(map(len, p3)) * 1000, rtol=1e-6, atol=0)
