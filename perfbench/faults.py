"""Faults planted under the timed path, by name: each a context manager that
breaks the program while it is open.  The tests see ``correct`` come out false
under each; ``controls.py --fault`` reads the compared numbers under one on the
card."""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def frozen_optimizer():
    """A training step that leaves the model's state unchanged."""
    with mock.patch.object(torch.optim.Adam, "step", lambda self, closure=None: None):
        yield


@contextlib.contextmanager
def half_batch_loss():
    """Half of the batch left out of the loss, the mean taken over the rest."""
    from videopose3d_torch import train
    with mock.patch.object(train, "_valid", lambda rows, n, device:
                           (torch.arange(rows, device=device) < n // 2).float()):
        yield


@contextlib.contextmanager
def one_row_tta():
    """The mirrored row left out of the test-time augmentation's mean."""
    from videopose3d_torch.evaluate import Evaluator
    with mock.patch.object(Evaluator, "_tta_merge", lambda self, pred, augment: pred[:1]):
        yield


@contextlib.contextmanager
def half_frames_protocol():
    """P-MPJPE over the first half of each video's frames, the mean taken over
    them."""
    from videopose3d_torch import evaluate
    p_mpjpe = evaluate.p_mpjpe
    with mock.patch.object(evaluate, "p_mpjpe", lambda pred, target: p_mpjpe(
            pred[:len(pred) // 2], target[:len(target) // 2])):
        yield


@contextlib.contextmanager
def altered_poses():
    """An answer altered where it is produced: one frame's poses shifted."""
    from videopose3d_torch.evaluate import Evaluator
    infer = Evaluator.infer

    def altered(self, model, x):
        out = infer(self, model, x).clone()
        out[:, 3] += 0.05
        return out

    with mock.patch.object(Evaluator, "infer", altered):
        yield


@contextlib.contextmanager
def frozen_rings():
    """A streaming step that leaves the rings' positions unchanged."""
    from videopose3d_torch import streaming
    with mock.patch.object(streaming, "_advance_ptrs", lambda ptrs, caps, k=1: list(ptrs)):
        yield


@contextlib.contextmanager
def altered_stream_poses():
    """One joint of every stream's pose shifted where the step produces it."""
    from videopose3d_torch import streaming
    poses = streaming._poses

    def altered(config, flat, b, k):
        out = poses(config, flat, b, k).clone()
        out[:, 5, 0] += 0.05
        return out

    with mock.patch.object(streaming, "_poses", altered):
        yield


# The faults each kind of cell can have (no cell exchanges anything between chips).
BY_DRIVER = {
    "train": [frozen_optimizer, half_batch_loss],
    "eval": [one_row_tta, half_frames_protocol, altered_poses],
    "stream": [frozen_rings, altered_stream_poses],
}
FAULTS = {f.__name__: f for fs in BY_DRIVER.values() for f in fs}
