"""MotionBERT's DSTformer in plain PyTorch, for the float64 check of its training
steps: the forward (Zhu et al., ICCV 2023; the paper code's
``lib/model/DSTformer.py``) from a state dict in that code's names, the recipe's
loss, AdamW written out step by step, and which clips the first batches hold.

No kernels, no autograd Functions: LayerNorm, GELU, both attentions and the
stream gate are written out; ``torch.autograd`` takes the gradients.  ``dtype``
is the precision everything runs in; :func:`train_steps` sets whether a float32
matmul may use the TF32 tensor cores (``tf32``, a control's precision; off, for
both matmuls and cuDNN, otherwise).  LayerNorm holds
no statistics across clips, so a batch's gradient is the sum of its groups' of
``group`` clips: :func:`train_steps` takes them in turn, which keeps a float64
step of 16 full clips inside one card's memory.

``cfg`` is a configuration dict of ``configs/`` (``num_joints``, ``dim_in``,
``dim_out``, ``dim_feat``, ``dim_rep``, ``depth``, ``num_heads``,
``mlp_ratio``, ``maxlen``, ``qkv_bias``, ``att_fuse``, ``ln_eps``).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.model import precision
from perfbench.reference.train import chunk_pairs

BETAS = (0.9, 0.999)
EPS = 1e-8
LOSS_WEIGHTS = (1.0, 0.5, 20.0)  # MPJPE, N-MPJPE, velocity


def param_shapes(cfg):
    """(name, shape, kind) of every parameter, in the paper code's names; kind is
    "weight" (a linear layer's), "bias", "embed", "ln_weight", "ln_bias",
    "gate_weight" or "gate_bias"."""
    c, r, j = cfg["dim_feat"], cfg["dim_rep"], cfg["num_joints"]
    h = cfg["mlp_ratio"] * c
    out = [("joints_embed.weight", (c, cfg["dim_in"]), "weight"),
           ("joints_embed.bias", (c,), "bias"),
           ("pos_embed", (1, j, c), "embed"),
           ("temp_embed", (1, cfg["maxlen"], 1, c), "embed")]
    linears = {"attn_{a}.qkv": (3 * c, c), "attn_{a}.proj": (c, c),
               "mlp_{a}.fc1": (h, c), "mlp_{a}.fc2": (c, h)}
    for stream in ("blocks_st", "blocks_ts"):
        for layer in range(cfg["depth"]):
            for a in ("s", "t"):
                for norm in (f"norm1_{a}", f"norm2_{a}"):
                    out += [(f"{stream}.{layer}.{norm}.weight", (c,), "ln_weight"),
                            (f"{stream}.{layer}.{norm}.bias", (c,), "ln_bias")]
                for name, shape in linears.items():
                    name = f"{stream}.{layer}.{name.format(a=a)}"
                    out.append((f"{name}.weight", shape, "weight"))
                    if cfg["qkv_bias"] or not name.endswith("qkv"):
                        out.append((f"{name}.bias", (shape[0],), "bias"))
    out += [("norm.weight", (c,), "ln_weight"), ("norm.bias", (c,), "ln_bias"),
            ("pre_logits.fc.weight", (r, c), "weight"), ("pre_logits.fc.bias", (r,), "bias"),
            ("head.weight", (cfg["dim_out"], r), "weight"),
            ("head.bias", (cfg["dim_out"],), "bias")]
    if cfg["att_fuse"]:
        for layer in range(cfg["depth"]):
            out += [(f"ts_attn.{layer}.weight", (2, 2 * c), "gate_weight"),
                    (f"ts_attn.{layer}.bias", (2,), "gate_bias")]
    return out


def layer_norm(x, w, name, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w[f"{name}.weight"] + w[f"{name}.bias"]


def linear(x, w, name):
    out = x @ w[f"{name}.weight"].t()
    bias = w.get(f"{name}.bias")
    return out if bias is None else out + bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / np.sqrt(2.0)))


def softmax(s):
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def attention(x, w, name, heads: int, axis: str):
    """Multi-head self-attention of (B, T, J, C) tokens among the joints of each
    frame (``axis`` "spatial") or the frames of each joint ("temporal")."""
    b, t, j, c = x.shape
    d = c // heads
    q, k, v = linear(x, w, f"{name}.qkv").reshape(b, t, j, 3, heads, d).unbind(dim=3)
    if axis == "spatial":
        p = softmax(torch.einsum("btjhd,btkhd->bthjk", q, k) * d ** -0.5)
        o = torch.einsum("bthjk,btkhd->btjhd", p, v)
    else:
        p = softmax(torch.einsum("btjhd,bujhd->bjhtu", q, k) * d ** -0.5)
        o = torch.einsum("bjhtu,bujhd->btjhd", p, v)
    return linear(o.reshape(b, t, j, c), w, f"{name}.proj")


def stream(h, w, cfg, name, order):
    """One stream of a layer: for each axis of ``order`` (("s", "t") for ST,
    ("t", "s") for TS) pre-norm attention, then a pre-norm MLP, both residual."""
    eps = cfg["ln_eps"]
    for a in order:
        axis = "spatial" if a == "s" else "temporal"
        h = h + attention(layer_norm(h, w, f"{name}.norm1_{a}", eps), w, f"{name}.attn_{a}",
                          cfg["num_heads"], axis)
        m = gelu(linear(layer_norm(h, w, f"{name}.norm2_{a}", eps), w, f"{name}.mlp_{a}.fc1"))
        h = h + linear(m, w, f"{name}.mlp_{a}.fc2")
    return h


def forward(w, cfg, x):
    """(B, T, J, dim_in) keypoints -> (B, T, J, dim_out) poses, in ``x``'s and
    ``w``'s dtype."""
    t = x.shape[1]
    h = linear(x, w, "joints_embed") + w["pos_embed"] + w["temp_embed"][:, :t]
    for layer in range(cfg["depth"]):
        h_st = stream(h, w, cfg, f"blocks_st.{layer}", ("s", "t"))
        h_ts = stream(h, w, cfg, f"blocks_ts.{layer}", ("t", "s"))
        if cfg["att_fuse"]:
            alpha = softmax(linear(torch.cat([h_st, h_ts], dim=-1), w, f"ts_attn.{layer}"))
            h = h_st * alpha[..., 0:1] + h_ts * alpha[..., 1:2]
        else:
            h = (h_st + h_ts) * 0.5
    h = torch.tanh(linear(layer_norm(h, w, "norm", cfg["ln_eps"]), w, "pre_logits.fc"))
    return linear(h, w, "head")


def per_clip_loss(pred, target):
    """(B,) MPJPE + 0.5 N-MPJPE + 20 velocity error of each clip of (B, T, J, 3)
    poses, the prediction's root joint set to 0 (the target's is)."""
    pred = torch.cat([torch.zeros_like(pred[:, :, :1]), pred[:, :, 1:]], dim=2)

    def mpjpe(a, b):  # the norm's gradient is 0 where a joint's distance is (the root)
        return torch.linalg.vector_norm(a - b, dim=-1).mean(dim=(1, 2))

    scale = ((target * pred).sum(dim=-1, keepdim=True).mean(dim=2, keepdim=True)
             / (pred ** 2).sum(dim=-1, keepdim=True).mean(dim=2, keepdim=True))
    velocity = mpjpe(pred[:, 1:] - pred[:, :-1], target[:, 1:] - target[:, :-1])
    a, b, c = LOSS_WEIGHTS
    return a * mpjpe(pred, target) + b * mpjpe(scale * pred, target) + c * velocity


def first_batches(lengths, batch: int, steps: int, clip: int, random_seed: int,
                  augment: bool):
    """The (seq, start, end, flip) rows of the valid clips of the first ``steps``
    batches of the first epoch: the paper code's chunk pairs of ``clip`` frames,
    shuffled by ``numpy.random.RandomState``."""
    order = np.random.RandomState(random_seed).permutation(
        chunk_pairs(lengths, clip, augment))
    return [order[k * batch:(k + 1) * batch] for k in range(steps)]


def windows(poses_2d, poses_3d, chunks, kps_perm, joints_perm):
    """(keypoint clips (B, L, J, F), root-centred targets (B, L, J, 3)) of the
    chunks, frames past a sequence's ends repeating its edge frame; a flipped
    chunk mirrors x (the confidence stays) and swaps left and right."""
    x2, x3 = [], []
    for seq, start, end, flip in chunks:
        p2, p3 = poses_2d[seq], poses_3d[seq]
        idx = np.clip(np.arange(start, end), 0, len(p2) - 1)
        w2, w3 = p2[idx].copy(), p3[idx].copy()
        if flip:
            w2 = w2[:, kps_perm]
            w2[..., 0] *= -1
            w3 = w3[:, joints_perm]
            w3[..., 0] *= -1
        w3[:, 0] = 0.0
        x2.append(w2)
        x3.append(w3)
    return np.stack(x2), np.stack(x3)


def train_steps(w0, cfg, batches, lr: float, weight_decay: float, dtype, device,
                group: int = 4, tf32: bool = False):
    """Run the DSTformer from the weights ``w0`` over ``batches`` of (keypoint
    clips, targets) with AdamW (``torch.optim.AdamW`` semantics, written out).
    Each batch's loss is the mean of its clips', its gradient the sum of its
    groups' of ``group`` clips.  Returns (losses, the first step's gradients, the
    parameters after the last step), gradients and parameters as {name: tensor}
    in ``dtype``."""
    with precision(tf32):
        return _train_steps(w0, cfg, batches, lr, weight_decay, dtype, device, group)


def _train_steps(w0, cfg, batches, lr, weight_decay, dtype, device, group):
    params = {k: v.detach().to(device, dtype).clone().requires_grad_() for k, v in w0.items()}
    state = {k: (torch.zeros_like(p), torch.zeros_like(p)) for k, p in params.items()}
    losses, first_grads = [], None
    for t, (x2, x3) in enumerate(batches, start=1):
        n = len(x2)
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        loss = 0.0
        for g0 in range(0, n, group):
            xg = torch.as_tensor(x2[g0:g0 + group], device=device, dtype=dtype)
            yg = torch.as_tensor(x3[g0:g0 + group], device=device, dtype=dtype)
            part = per_clip_loss(forward(params, cfg, xg), yg).sum() / n
            for (k, acc), g in zip(grads.items(),
                                   torch.autograd.grad(part, list(params.values()))):
                acc += g
            loss += float(part.detach())
        losses.append(loss)
        if first_grads is None:
            first_grads = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, p in params.items():
                g, (m, v) = grads[k], state[k]
                p.mul_(1.0 - lr * weight_decay)
                m.mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                v.mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                denom = v.sqrt() / np.sqrt(1.0 - BETAS[1] ** t) + EPS
                p.sub_(lr / (1.0 - BETAS[0] ** t) * m / denom)
    return losses, first_grads, {k: p.detach() for k, p in params.items()}
