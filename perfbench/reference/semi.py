"""The reference of the first semi-supervised training steps (Pavllo et al.,
CVPR 2019, "3D human pose estimation in video with temporal convolutions and
semi-supervised training", section 4; the paper code's ``run.py:319-398``) in
plain PyTorch: a pose network and a trajectory network in the strided training
form (``model.strided_forward``), the windows of a labeled and an unlabeled
stream, the four losses, and AMSGrad over both networks' parameters.

One step, on a labeled batch of 2D windows with their 3D joints and, after
warm-up, an unlabeled batch of 2D windows with their cameras:

* the two batches are concatenated; both networks see the whole batch, so the
  BatchNorm statistics run over both halves;
* the pose loss is the MPJPE of the labeled rows' root-centred poses;
* the trajectory loss is the MPJPE of the root's camera-space position on the
  labeled rows, each sample weighted by the inverse depth of its true root;
* the projection loss back-projects the unlabeled rows' ``pose + trajectory``
  through the Human3.6M camera model (:func:`project`) and takes its MPJPE
  against the unlabeled rows' 2D keypoints of the output frame;
* the bone loss is the mean over the bones of the absolute difference between
  the labeled and the unlabeled rows' mean bone lengths (of the predicted
  poses).

Departures from the paper code's ``run.py``, each the program's too:

* Every mean over samples is over the valid rows of a batch: the final partial
  batch of a permutation is filled with copies of its first row (which take
  part in the BatchNorm statistics and nowhere else), where the paper code
  runs a smaller batch.
* The unlabeled stream has its own chunk permutation, drawn by its own
  ``RandomState``, and runs on across permutations; the paper code zips the
  two generators' epochs.
* The dropout masks come from one generator, the pose network's first, in the
  draw order of ``model.mask_shapes``; the paper code draws each module's with
  the global generator.
* The loss is one float64 sum (``dtype``), and the gradient is taken once of
  the total, as ``run.py`` does with its ``loss_total.backward()``.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model as ref
from perfbench.reference import train as rt


def first_batches(lengths, batch: int, steps: int, random_seed: int, augment: bool):
    """(chunk rows (batch, 4), valid rows) of the first ``steps`` batches of the
    first permutation (``train.first_batches``); a final partial batch is filled
    with copies of its first row."""
    return [(np.concatenate([rows, np.broadcast_to(rows[:1], (batch - len(rows), 4))]),
             len(rows))
            for rows in rt.first_batches(lengths, batch, steps, random_seed, augment)]


def labeled_windows(poses_2d, poses_3d, chunks, pad: int, causal_shift: int, kps_perm,
                    joints_perm):
    """(2D windows (B, 2*pad + 1, J, 2), root-centred targets (B, 1, J, 3), the
    roots' camera-space positions (B, 1, 1, 3)) of single-frame chunks; a
    flipped chunk's root has x negated."""
    x2, x3 = rt.windows(poses_2d, poses_3d, chunks, pad, causal_shift, kps_perm, joints_perm)
    roots = np.stack([poses_3d[seq][start:start + 1, :1] for seq, start, _, _ in chunks])
    roots[chunks[:, 3] != 0, ..., 0] *= -1
    return x2, x3, roots


def unlabeled_windows(poses_2d, cameras, chunks, pad: int, causal_shift: int, kps_perm):
    """(2D windows (B, 2*pad + 1, J, 2), the keypoints of each window's centre
    frame, the chunk's own for a non-causal model (B, 1, J, 2), intrinsics
    (B, 9)); frames past a sequence's ends repeat its edge frame; a flipped
    chunk mirrors x, swaps left and right, and negates the camera's centre x
    and tangential p1."""
    x2, cams = [], []
    for seq, start, _, flip in chunks:
        p2 = poses_2d[seq]
        idx = np.clip(np.arange(start - pad - causal_shift, start + pad - causal_shift + 1),
                      0, len(p2) - 1)
        w2 = p2[idx].copy()
        cam = np.array(cameras[seq], np.float64)
        if flip:
            w2 = w2[:, kps_perm]
            w2[..., 0] *= -1
            cam[[2, 7]] *= -1
        x2.append(w2)
        cams.append(cam)
    x2 = np.stack(x2)
    return x2, x2[:, pad:pad + 1], np.stack(cams)


def project(points, cams, distortion: bool = True):
    """Human3.6M's camera model: (B, T, J, 3) camera-space points and (B, 9)
    intrinsics ``[fx, fy, cx, cy, k1, k2, k3, p1, p2]`` -> (B, T, J, 2)
    normalised screen points.  With u, v the perspective-divided coordinates,
    each clamped to [-1, 1], and r^2 = u^2 + v^2:

        s  = 1 + k1 r^2 + k2 r^4 + k3 r^6 + p1 u + p2 v
        u' = u s + p1 r^2,   v' = v s + p2 r^2
        x  = fx u' + cx,     y  = fy v' + cy

    (the paper code's distortion, its tangential part as that code writes
    it); without ``distortion`` the pinhole x = fx u + cx, y = fy v + cy."""
    c = [cams[:, i, None, None] for i in range(9)]
    fx, fy, cx, cy, k1, k2, k3, p1, p2 = c
    u = torch.clamp(points[..., 0] / points[..., 2], -1.0, 1.0)
    v = torch.clamp(points[..., 1] / points[..., 2], -1.0, 1.0)
    if distortion:
        r2 = u * u + v * v
        s = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3 + p1 * u + p2 * v
        u, v = u * s + p1 * r2, v * s + p2 * r2
    return torch.stack([fx * u + cx, fy * v + cy], dim=-1)


def _masked_mean(per_sample, n_valid: int):
    return per_sample[:n_valid].sum() / max(n_valid, 1)


def _mpjpe_per_sample(pred, target):
    return torch.linalg.vector_norm(pred - target, dim=-1).mean(dim=(1, 2))


def bone_lengths(poses, parents):
    """(B, J - 1) mean lengths over the frames of each joint's bone to its
    parent (joint 0, the root, has none)."""
    child = list(range(1, len(parents)))
    return torch.linalg.vector_norm(poses[:, :, child] - poses[:, :, list(parents[1:])],
                                    dim=-1).mean(dim=1)


def semi_steps(w_pos, w_traj, cfg_pos, cfg_traj, steps, parents, mask_seed: int, lr: float,
               dtype, device, distortion: bool = True, bone_term: bool = True, starts=None):
    """Run both networks from the weights ``w_pos`` / ``w_traj`` over ``steps``
    with AMSGrad.  A step is a dict of host arrays: ``x2_l``, ``x3_l``,
    ``root_l`` (labeled windows, targets and roots) and ``n_l`` (valid labeled
    rows), and after warm-up ``x2_u``, ``target_u``, ``cam_u`` and ``n_u``.

    With ``starts``, step t begins from ``starts[t - 1]`` (the parameters a
    checked program held before that step, {"pos.<name>" | "traj.<name>":
    tensor}) in place of those the previous step left, and the moments carry
    on: each step's losses, gradient and update are then those of the checked
    program's own state, and rounding does not compound from step to step.

    Returns, per step: its [pose, trajectory, projection, bone, total] losses,
    {leaf: gradient norm}, {leaf: update norm} and the parameters it began from
    ({leaf: tensor} in ``dtype``)."""
    params = {}
    for prefix, w in (("pos.", w_pos), ("traj.", w_traj)):
        params.update({prefix + k: v.detach().to(device, dtype).clone().requires_grad_()
                       for k, v in w.items() if "running" not in k})
    nets = [({k[len(p):]: v for k, v in params.items() if k.startswith(p)}, cfg)
            for p, cfg in (("pos.", cfg_pos), ("traj.", cfg_traj))]
    state = {k: (torch.zeros_like(p), torch.zeros_like(p), torch.zeros_like(p))
             for k, p in params.items()}
    gen = torch.Generator(device=device).manual_seed(mask_seed)
    put = lambda a: torch.as_tensor(np.asarray(a), device=device, dtype=dtype)
    out = []
    for t, s in enumerate(steps, start=1):
        if starts is not None:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(starts[t - 1][k])
        before = {k: p.detach().clone() for k, p in params.items()}
        full = "x2_u" in s
        x = put(np.concatenate([s["x2_l"], s["x2_u"]]) if full else s["x2_l"])
        preds = []
        for w, cfg in nets:  # the pose network's masks first
            masks = ref.dropout_masks(cfg["dropout"], ref.mask_shapes(cfg, x.shape[0]), gen,
                                      dtype)
            preds.append(ref.strided_forward(w, cfg, x, masks))
        pred_pos, pred_traj = preds
        b, n_l = len(s["x2_l"]), s["n_l"]
        root = put(s["root_l"])
        loss_pos = _masked_mean(_mpjpe_per_sample(pred_pos[:b], put(s["x3_l"])), n_l)
        dist = torch.linalg.vector_norm(pred_traj[:b] - root, dim=-1) / root[..., 2]
        loss_traj = _masked_mean(dist.mean(dim=(1, 2)), n_l)
        zero = torch.zeros((), device=device, dtype=dtype)
        loss_proj = loss_bone = zero
        if full:
            n_u = s["n_u"]
            points = pred_pos[b:] + pred_traj[b:]
            loss_proj = _masked_mean(_mpjpe_per_sample(
                project(points, put(s["cam_u"]), distortion), put(s["target_u"])), n_u)
            if bone_term:
                bones = bone_lengths(pred_pos, parents)
                mean_l = bones[:n_l].sum(0) / max(n_l, 1)
                mean_u = bones[b:b + n_u].sum(0) / max(n_u, 1)
                loss_bone = (mean_l - mean_u).abs().mean()
        total = loss_pos + loss_traj + loss_proj + loss_bone
        grads = torch.autograd.grad(total, list(params.values()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m, v, vmax = state[k]
                m.mul_(rt.BETAS[0]).add_(g, alpha=1 - rt.BETAS[0])
                v.mul_(rt.BETAS[1]).addcmul_(g, g, value=1 - rt.BETAS[1])
                torch.maximum(vmax, v, out=vmax)
                denom = vmax.sqrt() / np.sqrt(1 - rt.BETAS[1] ** t) + rt.EPS
                p.sub_(lr / (1 - rt.BETAS[0] ** t) * m / denom)
            out.append(([float(v.detach()) for v in (loss_pos, loss_traj, loss_proj, loss_bone,
                                                      total)],
                        {k: float(g.double().norm()) for k, g in zip(params, grads)},
                        {k: float((p.double() - before[k].double()).norm())
                         for k, p in params.items()},
                        before))
    return out


def five_losses(pose, traj, proj, total):
    """A program's (pose, trajectory, projection, total) losses as
    :func:`semi_steps`' five: the bone term is what the total holds beyond the
    other three."""
    return [pose, traj, proj, total - pose - traj - proj, total]


def compare(checked, ref):
    """The compared numbers of checked steps against the reference's from the
    same parameters, both as :func:`semi_steps` returns them: relative gaps of
    step 1's total loss, of the pose, trajectory and projection losses and of
    the bone term (the worst over the steps), and the worst kept leaf's gap of a
    step's gradient norm and of its update's norm (``train.leaf_gap``)."""
    gap = lambda a, b: abs(a - b) / abs(b)
    grad_gaps, update_gaps, left_out = [], [], 0
    for (_, grads, updates, _), (_, ref_g, ref_u, _) in zip(checked, ref):
        keep = rt.kept_leaves(ref_g)
        left_out = max(left_out, len(ref_g) - len(keep))
        grad_gaps.append(rt.leaf_gap(grads, ref_g, keep))
        update_gaps.append(rt.leaf_gap(updates, ref_u, keep))
    pairs = [(c[0], r[0]) for c, r in zip(checked, ref)]
    return {"loss1_gap": gap(pairs[0][0][4], pairs[0][1][4]),
            "loss_gap": max(gap(p[i], r[i]) for p, r in pairs for i in range(3)),
            "bone_gap": max(gap(p[3], r[3]) for p, r in pairs),
            "grad_gap": max(grad_gaps), "change_gap": max(update_gaps),
            "leaves_left_out": left_out}
