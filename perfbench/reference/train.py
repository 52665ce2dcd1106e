"""The reference of the first training steps: which chunks each batch holds (the
paper code's ``ChunkedGenerator``: its chunk pairs, shuffled by
``numpy.random.RandomState``), the windows of those chunks, the strided model's
loss and gradients, and Adam with AMSGrad (``torch.optim.Adam`` semantics,
written out).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model as ref

BETAS = (0.9, 0.999)
EPS = 1e-8


def chunk_pairs(lengths, chunk_length: int, augment: bool):
    """(seq, start, end, flip) rows of every chunk, each sequence's unflipped
    chunks then its flipped ones."""
    rows = []
    for i, n in enumerate(lengths):
        n_chunks = (n + chunk_length - 1) // chunk_length
        offset = (n_chunks * chunk_length - n) // 2
        bounds = np.arange(n_chunks + 1) * chunk_length - offset
        for flip in ((0, 1) if augment else (0,)):
            rows.append(np.stack([np.full(n_chunks, i), bounds[:-1], bounds[1:],
                                  np.full(n_chunks, flip)], axis=1))
    return np.concatenate(rows).astype(np.int64)


def first_batches(lengths, batch: int, steps: int, random_seed: int, augment: bool):
    """The chunk rows of the first ``steps`` batches of the first epoch."""
    order = np.random.RandomState(random_seed).permutation(chunk_pairs(lengths, 1, augment))
    return [order[k * batch:(k + 1) * batch] for k in range(steps)]


def windows(poses_2d, poses_3d, chunks, pad: int, causal_shift: int, kps_perm,
            joints_perm):
    """(keypoint windows (B, 2*pad + 1, J, 2), root-centred targets (B, 1, J, 3))
    of single-frame chunks; frames past a sequence's ends repeat its edge
    frame; a flipped chunk mirrors x and swaps left and right."""
    x2, x3 = [], []
    for seq, start, _, flip in chunks:
        p2, p3 = poses_2d[seq], poses_3d[seq]
        idx = np.clip(np.arange(start - pad - causal_shift, start + pad - causal_shift + 1),
                      0, len(p2) - 1)
        w2, w3 = p2[idx].copy(), p3[start:start + 1].copy()
        if flip:
            w2 = w2[:, kps_perm]
            w2[..., 0] *= -1
            w3 = w3[:, joints_perm]
            w3[..., 0] *= -1
        w3[:, 0] = 0.0
        x2.append(w2)
        x3.append(w3)
    return np.stack(x2), np.stack(x3)


def train_steps(w0, cfg, batches, mask_seed: int, lr: float, dtype, device):
    """Run the strided model from the weights ``w0`` over ``batches`` of
    (keypoints, targets) with AMSGrad.  Returns (losses, the first step's
    gradients, the parameters after the last step), gradients and parameters as
    {name: tensor} in ``dtype``."""
    params = {k: v.detach().to(device, dtype).clone().requires_grad_()
              for k, v in w0.items() if "running" not in k}
    state = {k: (torch.zeros_like(p), torch.zeros_like(p), torch.zeros_like(p))
             for k, p in params.items()}
    gen = torch.Generator(device=device).manual_seed(mask_seed)
    losses, first_grads = [], None
    for t, (x2, x3) in enumerate(batches, start=1):
        x2 = torch.as_tensor(x2, device=device, dtype=dtype)
        x3 = torch.as_tensor(x3, device=device, dtype=dtype)
        masks = ref.dropout_masks(cfg["dropout"], ref.mask_shapes(cfg, x2.shape[0]), gen,
                                  dtype)
        loss = ref.mpjpe_loss(ref.strided_forward(params, cfg, x2, masks), x3)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(params, grads)}
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m, v, vmax = state[k]
                m.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                torch.maximum(vmax, v, out=vmax)
                denom = vmax.sqrt() / np.sqrt(1 - BETAS[1] ** t) + EPS
                p.sub_(lr / (1 - BETAS[0] ** t) * m / denom)
    return losses, first_grads, {k: p.detach() for k, p in params.items()}


def kept_leaves(ref_grad_norms, floor: float = 1e-3):
    """The leaves compared: those whose reference gradient norm is at least
    ``floor`` of the median leaf's (under it, a leaf moves under Adam by
    rounding alone)."""
    median = float(np.median(list(ref_grad_norms.values())))
    return {k for k, g in ref_grad_norms.items() if g >= floor * median}


def leaf_gap(prog, ref_norms, keep):
    """The worst kept leaf's gap between the program's norm and the reference's,
    as a share of the larger of that leaf's reference norm and the median
    leaf's.  ``prog`` and ``ref_norms``: {leaf: norm}."""
    median = float(np.median([ref_norms[k] for k in keep]))
    return max(abs(prog[k] - ref_norms[k]) / max(ref_norms[k], median) for k in keep)
