"""The four evaluation protocols of Pavllo et al. in float64 NumPy, as the paper
code computes them per video: MPJPE, P-MPJPE (after a rigid alignment with scale
per frame), N-MPJPE (after a scale per frame) and MPJVE (of the velocities)."""

from __future__ import annotations

import numpy as np


def mpjpe(pred, target):
    return float(np.mean(np.linalg.norm(pred - target, axis=-1)))


def n_mpjpe(pred, target):
    norm_pred = np.mean(np.sum(pred ** 2, axis=-1, keepdims=True), axis=-2, keepdims=True)
    norm_target = np.mean(np.sum(target * pred, axis=-1, keepdims=True), axis=-2,
                          keepdims=True)
    return mpjpe(norm_target / norm_pred * pred, target)


def p_mpjpe(pred, target):
    """(N, J, 3) poses."""
    mu_x, mu_y = target.mean(axis=1, keepdims=True), pred.mean(axis=1, keepdims=True)
    x0, y0 = target - mu_x, pred - mu_y
    norm_x = np.sqrt(np.sum(x0 ** 2, axis=(1, 2), keepdims=True))
    norm_y = np.sqrt(np.sum(y0 ** 2, axis=(1, 2), keepdims=True))
    x0, y0 = x0 / norm_x, y0 / norm_y
    u, s, vt = np.linalg.svd(np.matmul(x0.transpose(0, 2, 1), y0))
    v = vt.transpose(0, 2, 1)
    r = np.matmul(v, u.transpose(0, 2, 1))
    sign = np.sign(np.linalg.det(r))[:, None]
    v[:, :, -1] *= sign
    s[:, -1] *= sign.flatten()
    r = np.matmul(v, u.transpose(0, 2, 1))
    a = np.sum(s, axis=1, keepdims=True)[:, :, None] * norm_x / norm_y
    t = mu_x - a * np.matmul(mu_y, r)
    return mpjpe(a * np.matmul(pred, r) + t, target)


def mpjve(pred, target):
    return float(np.mean(np.linalg.norm(np.diff(pred, axis=0) - np.diff(target, axis=0),
                                        axis=-1)))


def protocols(videos):
    """Frame-weighted means in mm over ``videos`` of (pred (N, J, 3), target (N, J,
    3)), the target's root joint set to 0: (MPJPE, P-MPJPE, N-MPJPE, MPJVE)."""
    sums, total = np.zeros(4), 0
    for pred, target in videos:
        pred = np.asarray(pred, np.float64)
        target = np.asarray(target, np.float64).copy()
        target[:, 0] = 0.0
        n = len(pred)
        sums += n * np.array([mpjpe(pred, target), p_mpjpe(pred, target),
                              n_mpjpe(pred, target), mpjve(pred, target)])
        total += n
    return sums / total * 1000
