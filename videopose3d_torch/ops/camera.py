"""Camera model: screen-coordinate normalization, world<->camera transforms on
host numpy arrays, and the differentiable Human3.6M projection on tensors (and
on numpy arrays, for the dataset preparation).

Counterpart of ``videopose3d_tpu/ops/camera.py``.  The numpy functions keep the
JAX package's numpy paths (the float64 promotion of the ``[1, h/w]`` offset
included), so preprocessing matches it bit for bit.  ``project_to_2d`` and
``project_to_2d_linear`` take torch tensors and are differentiable by autograd:
they sit inside the semi-supervised reconstruction loss.

Intrinsic parameter vector layout (9,)::

    [fx, fy, cx, cy, k1, k2, k3, p1, p2]

focal(2) + center(2) + radial distortion(3) + tangential distortion(2).
"""

from __future__ import annotations

import numpy as np
import torch

from videopose3d_torch.ops.quaternion import qinverse, qrot


def normalize_screen_coordinates(X, w, h):
    """Map pixel coords so [0, w] -> [-1, 1], preserving aspect ratio."""
    assert X.shape[-1] == 2, f"expected (...,2), got {X.shape}"
    return X / w * 2.0 - np.array([1.0, h / w])


def image_coordinates(X, w, h):
    """Inverse of :func:`normalize_screen_coordinates`."""
    assert X.shape[-1] == 2, f"expected (...,2), got {X.shape}"
    return (X + np.array([1.0, h / w])) * w / 2.0


def _broadcast_quat(q, X):
    """A (4,) quaternion or a leading batch (B, 4) of them expanded to
    ``X.shape[:-1] + (4,)``: batch axes align from the left."""
    q = np.reshape(q, q.shape[:-1] + (1,) * (X.ndim - q.ndim) + (4,))
    return np.broadcast_to(q, X.shape[:-1] + (4,))


def world_to_camera(X, R, t):
    """World-frame points -> camera frame: rotate by R^-1 after translating by -t.
    ``R`` is a (4,) quaternion or a leading batch (B, 4) of them."""
    return qrot(_broadcast_quat(qinverse(np.asarray(R)), X), X - t)


def camera_to_world(X, R, t):
    """Camera-frame points -> world frame."""
    return qrot(_broadcast_quat(np.asarray(R), X), X) + t


def _split_intrinsics(camera_params, ndim):
    """(N, 9) intrinsics broadcast against (N, ..., 3) points, split into
    f, c, k, p."""
    assert camera_params.shape[-1] == 9, \
        f"expected (...,9) intrinsics, got {tuple(camera_params.shape)}"
    camera_params = camera_params.reshape(
        camera_params.shape[:1] + (1,) * (ndim - 2) + (9,))
    return (camera_params[..., :2], camera_params[..., 2:4], camera_params[..., 4:7],
            camera_params[..., 7:])


def project_to_2d(X, camera_params):
    """Human3.6M projection with radial and tangential distortion, differentiable.

    The perspective-divided coordinates are clamped to [-1, 1] before the
    distortion, as in the reference: the clamp keeps the distortion polynomial
    away from points near the camera plane and is part of the trained loss
    surface (a clamped coordinate has zero gradient).

    Args:
      X: (N, ..., 3) points in camera space.
      camera_params: (N, 9) intrinsics ``[f(2), c(2), k(3), p(2)]``.

    Returns (N, ..., 2) points in normalized screen coordinates.
    """
    assert X.shape[-1] == 3, f"expected (...,3) points, got {tuple(X.shape)}"
    assert camera_params.ndim == 2 and X.shape[0] == camera_params.shape[0]
    f, c, k, p = _split_intrinsics(camera_params, X.ndim)
    XX = torch.clamp(X[..., :2] / X[..., 2:], -1.0, 1.0)
    r2 = torch.sum(XX * XX, dim=-1, keepdim=True)
    radial = 1.0 + torch.sum(k * torch.cat([r2, r2 * r2, r2 * r2 * r2], dim=-1),
                             dim=-1, keepdim=True)
    tan = torch.sum(p * XX, dim=-1, keepdim=True)
    XXX = XX * (radial + tan) + p * r2
    return f * XXX + c


def project_to_2d_np(X, camera_params):
    """:func:`project_to_2d` on host numpy arrays, the JAX package's numpy path
    operation for operation, so the ground-truth 2D archives that
    ``data/prepare/h36m_3d.py`` projects are bitwise the JAX package's."""
    assert X.shape[-1] == 3, f"expected (...,3) points, got {X.shape}"
    assert camera_params.ndim == 2 and X.shape[0] == camera_params.shape[0]
    f, c, k, p = _split_intrinsics(camera_params, X.ndim)
    XX = np.clip(X[..., :2] / X[..., 2:], -1.0, 1.0)
    r2 = np.sum(XX * XX, axis=-1, keepdims=True)
    radial = 1.0 + np.sum(k * np.concatenate([r2, r2 * r2, r2 * r2 * r2], axis=-1),
                          axis=-1, keepdims=True)
    tan = np.sum(p * XX, axis=-1, keepdims=True)
    XXX = XX * (radial + tan) + p * r2
    return f * XXX + c


def project_to_2d_linear(X, camera_params):
    """Pinhole projection (focal length and principal point only), with the same
    clamp as :func:`project_to_2d`."""
    assert X.shape[-1] == 3, f"expected (...,3) points, got {tuple(X.shape)}"
    assert camera_params.ndim == 2 and X.shape[0] == camera_params.shape[0]
    f, c, _, _ = _split_intrinsics(camera_params, X.ndim)
    XX = torch.clamp(X[..., :2] / X[..., 2:], -1.0, 1.0)
    return f * XX + c
