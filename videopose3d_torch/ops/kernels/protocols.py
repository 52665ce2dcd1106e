"""The four evaluation protocols of one video on the device: CUDA kernel and its
plain PyTorch version.

No TPU counterpart: the JAX package fetches each video's poses and runs the
protocols in host NumPy (``ops/losses.py``).  :func:`video_protocols` gives the
video's four means, MPJPE, P-MPJPE, N-MPJPE and MPJVE (metres, float64), with the
semantics of ``mpjpe_np``, ``p_mpjpe``, ``n_mpjpe_np`` and
``mean_velocity_error`` on the first ``n`` frames of the poses against the
target with its root joint zeroed.  Every sum, the per-frame 3 x 3 SVD and the
distances are float64; the SVD is a one-sided Jacobi SVD of fixed sweeps whose
rotations keep ``V`` proper, with ``U``'s third axis the cross product of the
first two, so the improper case comes out as a negative third singular value and
``R = U V^T`` is proper (``csrc/protocols.cu`` has the design).

Dispatch: tensors on the CPU take :func:`video_protocols_plain`; CUDA tensors
launch the kernel or raise.  No library solver: ``torch.linalg``'s check their
convergence on the host, a synchronisation per call.  ``LAUNCHES`` counts the
kernel's calls, each two launches (the blocks' sums, then their fixed-order sum).
"""

from __future__ import annotations

import torch

from videopose3d_torch.ops.kernels.build import launch

LAUNCHES = {"protocols": 0}
MAX_JOINTS = 32
MAX_BLOCKS = 132 * 4  # csrc/protocols.cu's kMaxBlocks: rows of the blocks' sums
SWEEPS = 8
_PAIRS = ((0, 1), (0, 2), (1, 2))


def _norm(x):
    return torch.sqrt((x * x).sum(-1))


def _align_rotation(a):
    """(F, 3, 3) float64 cross-covariances -> (the best proper rotations (F, 3, 3),
    the signed sums of singular values (F,)), as the kernel's ``align_rotation``."""
    a = a.clone()
    v = torch.eye(3, dtype=a.dtype, device=a.device).expand_as(a).clone()
    for _ in range(SWEEPS):
        for p, q in _PAIRS:
            ap, aq = a[:, :, p], a[:, :, q]
            alpha, beta, gamma = (ap * ap).sum(1), (aq * aq).sum(1), (ap * aq).sum(1)
            live = gamma != 0
            zeta = (beta - alpha) / torch.where(live, 2 * gamma, 1.0)
            t = torch.copysign(torch.ones_like(zeta), zeta) / (
                zeta.abs() + torch.sqrt(1 + zeta * zeta))
            c = torch.where(live, 1 / torch.sqrt(1 + t * t), 1.0)[:, None]
            s = torch.where(live, c[:, 0] * t, 0.0)[:, None]
            for m in (a, v):
                mp, mq = m[:, :, p].clone(), m[:, :, q].clone()
                m[:, :, p] = c * mp - s * mq
                m[:, :, q] = s * mp + c * mq
    sig = _norm(a.transpose(1, 2))
    for k in range(2):  # bubble the norms into descending order, as the kernel
        for l in range(2, k, -1):
            swap = (sig[:, l] > sig[:, l - 1])[:, None]
            for m in (a, v):
                lo, hi = m[:, :, l - 1].clone(), m[:, :, l].clone()
                m[:, :, l - 1] = torch.where(swap, hi, lo)
                m[:, :, l] = torch.where(swap, -lo, hi)
            lo, hi = sig[:, l - 1].clone(), sig[:, l].clone()
            sig[:, l - 1], sig[:, l] = torch.where(swap[:, 0], hi, lo), torch.where(
                swap[:, 0], lo, hi)
    e1 = torch.eye(3, dtype=a.dtype, device=a.device)[0]
    pos = (sig[:, 0] > 0)[:, None]
    u1 = torch.where(pos, a[:, :, 0] / torch.where(pos, sig[:, :1], 1.0), e1)
    w = a[:, :, 1] - (u1 * a[:, :, 1]).sum(1, keepdim=True) * u1
    wn = _norm(w)[:, None]
    ok = (wn > 1e-300) & (wn > 1e-12 * sig[:, :1])
    u2 = torch.where(ok, w / torch.where(ok, wn, 1.0), _any_orthogonal(u1))
    u3 = torch.linalg.cross(u1, u2)
    total = sig[:, 0] + (u2 * a[:, :, 1]).sum(1) + (u3 * a[:, :, 2]).sum(1)
    u = torch.stack([u1, u2, u3], dim=2)
    return u @ v.transpose(1, 2), total


def _any_orthogonal(u):
    """A unit vector orthogonal to each unit row of ``u`` (F, 3), as the kernel's."""
    x, y, z = u.unbind(1)
    zero = torch.zeros_like(x)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    first = ((ax <= ay) & (ax <= az))[:, None]
    second = (ay <= az)[:, None]
    out = torch.where(first, torch.stack([zero, z, -y], 1),
                      torch.where(second, torch.stack([-z, zero, x], 1),
                                  torch.stack([y, -x, zero], 1)))
    return out / _norm(out)[:, None]


def video_protocols_plain(pred, target, n: int):
    """The kernel's arithmetic in float64 PyTorch: ``pred`` (>= n, J, 3) and
    ``target`` (n, J, 3) -> (4,) float64 means (MPJPE, P-MPJPE, N-MPJPE, MPJVE)."""
    p = pred[:n].double()
    t = target.double().clone()
    t[:, 0] = 0.0
    joints = p.shape[1]
    e1 = _norm(p - t).sum()
    scale = (t * p).sum((1, 2)) / (p * p).sum((1, 2))
    e3 = _norm(scale[:, None, None] * p - t).sum()
    pc = p - p.mean(1, keepdim=True)
    ac = t - t.mean(1, keepdim=True)
    rot, total = _align_rotation(pc.transpose(1, 2) @ ac)
    gain = total / (pc * pc).sum((1, 2))
    e2 = _norm(gain[:, None, None] * (pc @ rot) - ac).sum()
    ev = _norm(torch.diff(p, dim=0) - torch.diff(t, dim=0)).sum()
    frames = float(n * joints)
    return torch.stack([e1 / frames, e2 / frames, e3 / frames,
                        ev / float((n - 1) * joints)])


def video_protocols(pred, target, n: int):
    """The four protocol means of one video: float32 ``pred`` (T >= n, J, 3), of
    which the first ``n`` frames are read in place, and ``target`` (n, J, 3) on the
    same device -> a (4,) float64 tensor there, not yet synchronised (MPJVE is NaN
    for n = 1, as NumPy's mean of nothing)."""
    if pred.ndim != 3 or pred.shape[-1] != 3 or target.shape != (n, pred.shape[1], 3):
        raise ValueError(f"video_protocols: pred must be (T, J, 3) and target (n, J, 3), "
                         f"got {tuple(pred.shape)} and {tuple(target.shape)} at n={n}")
    if not 0 < n <= pred.shape[0]:
        raise ValueError(f"video_protocols: n={n} out of range for {pred.shape[0]} frames")
    if pred.device.type == "cpu" and target.device.type == "cpu":
        return video_protocols_plain(pred, target, n)
    joints = pred.shape[1]
    if pred.device != target.device:
        raise ValueError(f"target is on {target.device}, pred on {pred.device}")
    if pred.dtype != torch.float32 or target.dtype != torch.float32:
        raise ValueError(f"video_protocols: float32 poses only, got {pred.dtype} and "
                         f"{target.dtype}")
    if not (pred.is_contiguous() and target.is_contiguous()):
        raise ValueError("video_protocols: pred and target must be contiguous")
    if not 0 < joints <= MAX_JOINTS:
        raise ValueError(f"video_protocols: {joints} joints, the kernel takes 1 to "
                         f"{MAX_JOINTS}")
    part = torch.empty(MAX_BLOCKS, 4, dtype=torch.float64, device=pred.device)
    out = torch.empty(4, dtype=torch.float64, device=pred.device)
    launch("vp3d_video_protocols", pred.device, pred, target, n, joints, part, out,
           count=(LAUNCHES, "protocols"))
    return out
