"""Videos for the protocol kernel's tests and the host protocols they are held to
(imports no JAX, so the card's tests share it).

``video(n, joints, kind, seed)`` gives float32 ``pred`` (n + 7, J, 3), whose last 7
frames are not the video's and hold large values, and ``target`` (n, J, 3).  Each
predicted frame is its target rotated, scaled, moved and perturbed; ``kind``:
"mixed" mirrors every third frame (an improper alignment), "tiny" and "huge" scale
every frame of both by 1e-3 and 1e3."""

import numpy as np

from videopose3d_torch.ops.losses import mean_velocity_error, mpjpe_np, n_mpjpe_np, p_mpjpe

KINDS = {"mixed": 1.0, "tiny": 1e-3, "huge": 1e3}


def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], 1)


def video(n, joints, kind="mixed", seed=0):
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((n, joints, 3)) * 0.25
    pred = np.einsum("fjk,fkl->fjl", target, _rotations(rng, n))
    pred = pred * rng.uniform(0.7, 1.3, (n, 1, 1)) + rng.standard_normal((n, 1, 3)) * 0.1
    pred += rng.standard_normal((n, joints, 3)) * 0.03
    if kind == "mixed":
        pred[::3, :, 0] *= -1.0
    scale = KINDS[kind]
    tail = rng.standard_normal((7, joints, 3)) * 1e4
    pred = np.concatenate([pred * scale, tail])
    return pred.astype(np.float32), (target * scale).astype(np.float32)


def host_protocols(pred, target):
    """(MPJPE, P-MPJPE, N-MPJPE, MPJVE) of ``ops/losses.py`` in float64, the
    target's root joint zeroed as ``evaluate()`` zeroes it."""
    p = np.asarray(pred, np.float64)
    t = np.array(target, np.float64)
    t[:, 0] = 0.0
    return np.array([mpjpe_np(p, t), float(p_mpjpe(p, t)), n_mpjpe_np(p[None], t[None]),
                     float(mean_velocity_error(p, t))])
