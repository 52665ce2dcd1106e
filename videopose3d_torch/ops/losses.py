"""Evaluation protocols: MPJPE, P-MPJPE, N-MPJPE and MPJVE.

Counterpart of ``videopose3d_tpu/ops/losses.py``.  The numpy forms run on the
host over fetched predictions, as in the JAX package: ``evaluate()`` takes them
for an evaluator on the CPU, while on a card one kernel a video computes all four
where the poses are (``ops/kernels/protocols.py``, float64, the same semantics).
:func:`mpjpe` is the torch form, for losses computed on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def mpjpe(predicted, target):
    """Protocol #1 on tensors: mean Euclidean distance over (..., J, 3) poses."""
    assert predicted.shape == target.shape, (predicted.shape, target.shape)
    return torch.mean(torch.linalg.vector_norm(predicted - target, dim=-1))


def mpjpe_per_sample(pred, target):
    """(B,) per-sample MPJPE of (B, T, J, 3) tensors (mean over frames and
    joints)."""
    return torch.linalg.vector_norm(pred - target, dim=-1).mean(dim=(1, 2))


def mpjpe_np(predicted, target):
    """Protocol #1 on host numpy."""
    assert predicted.shape == target.shape, (predicted.shape, target.shape)
    return float(np.mean(np.linalg.norm(predicted - target, axis=-1)))


def n_mpjpe_np(predicted, target):
    """Protocol #3 on host numpy: MPJPE after the optimal per-frame scale
    ``<target, predicted> / ||predicted||^2`` (averaged over joints)."""
    assert predicted.shape == target.shape, (predicted.shape, target.shape)
    norm_predicted = np.mean(np.sum(predicted ** 2, axis=3, keepdims=True),
                             axis=2, keepdims=True)
    norm_target = np.mean(np.sum(target * predicted, axis=3, keepdims=True),
                          axis=2, keepdims=True)
    scale = norm_target / norm_predicted
    return mpjpe_np(scale * predicted, target)


def _similarity_align(points, anchor):
    """Per-frame least-squares similarity transform (rotation, scale,
    translation) of ``points`` onto ``anchor``, both (N, J, 3); the rotation's
    smallest singular axis is reflected when the polar factor is improper."""
    pts_center = points.mean(axis=1, keepdims=True)
    anc_center = anchor.mean(axis=1, keepdims=True)
    pts_c = points - pts_center
    anc_c = anchor - anc_center
    pts_scale = np.linalg.norm(pts_c, axis=(1, 2), keepdims=True)
    anc_scale = np.linalg.norm(anc_c, axis=(1, 2), keepdims=True)
    pts_c = pts_c / pts_scale
    anc_c = anc_c / anc_scale

    xcov = np.einsum("nji,njk->nik", pts_c, anc_c)
    left, sv, right_t = np.linalg.svd(xcov)
    improper = np.linalg.det(left @ right_t) < 0
    left[improper, :, -1] = -left[improper, :, -1]
    sv[improper, -1] = -sv[improper, -1]
    rot = left @ right_t

    gain = sv.sum(axis=1)[:, None, None] * anc_scale / pts_scale
    shift = anc_center - gain * (pts_center @ rot)
    return gain * (points @ rot) + shift


def p_mpjpe(predicted, target):
    """Protocol #2: MPJPE after rigid (Procrustes) alignment, (N, J, 3) numpy."""
    assert predicted.shape == target.shape, (predicted.shape, target.shape)
    aligned = _similarity_align(np.asarray(predicted), np.asarray(target))
    return np.mean(np.linalg.norm(aligned - np.asarray(target), axis=-1))


def mean_velocity_error(predicted, target):
    """MPJVE: mean Euclidean distance of the first temporal derivatives."""
    assert predicted.shape == target.shape, (predicted.shape, target.shape)
    velocity_predicted = np.diff(np.asarray(predicted), axis=0)
    velocity_target = np.diff(np.asarray(target), axis=0)
    return np.mean(np.linalg.norm(velocity_predicted - velocity_target, axis=-1))
