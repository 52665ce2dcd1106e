"""The temporal convolutional model of Pavllo et al. (CVPR 2019) in plain PyTorch:
the dilated inference form and the strided training form (the paper code's
``TemporalModel`` and ``TemporalModelOptimized1f``), from a state dict in that
code's names.

No kernels, no caches: every convolution is a sum of tap products, BatchNorm is
written out.  ``dtype`` is the precision everything runs in; ``tf32`` lets a
float32 matmul use the TF32 tensor cores (a control's precision).
"""

from __future__ import annotations

import contextlib

import torch

BN_EPS = 1e-5


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls in TF32 (``tf32``) or in true float32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def dilations(cfg):
    d = [1]
    for fw in cfg["filter_widths"][:-1]:
        d.append(d[-1] * fw)
    return d


def pads(cfg):
    return [(fw - 1) * d // 2 for fw, d in zip(cfg["filter_widths"], dilations(cfg))]


def receptive_field(cfg):
    return 1 + 2 * sum(pads(cfg))


def fp8(t):
    """``t`` rounded to float8 e4m3 under one scale for the tensor (its largest
    magnitude at e4m3's largest, 448): a control's operand precision."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def conv(x, w, dilation: int = 1, operand=None):
    """Valid convolution of channels-last (R, T, C_in) with a (C_out, C_in, k)
    weight: the sum over taps j of x[:, j*d :][:T_out] @ w[:, :, j]^T, each
    product's operands first passed through ``operand`` (e.g. :func:`fp8`)."""
    if operand is not None:
        x, w = operand(x), operand(w)
    k = w.shape[2]
    t_out = x.shape[1] - (k - 1) * dilation
    out = x[:, :t_out] @ w[:, :, 0].t()
    for j in range(1, k):
        out = out + x[:, j * dilation: j * dilation + t_out] @ w[:, :, j].t()
    return out


def bn_eval(y, w, name):
    mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
    return (y - mean) / torch.sqrt(var + BN_EPS) * w[f"{name}.weight"] + w[f"{name}.bias"]


def dilated_forward(w, cfg, x, dtype=torch.float64, operand=None):
    """Inference forward, eval-mode BatchNorm: (R, T, J_in, F) keypoints ->
    (R, T - receptive_field + 1, J_out, 3) poses, all in ``dtype``; every
    convolution's operands pass through ``operand`` when it is given."""
    w = {k: v.to(dtype) for k, v in w.items()}
    conv_ = lambda a, b, d=1: conv(a, b, d, operand)
    x = x.reshape(x.shape[0], x.shape[1], -1).to(dtype)
    x = torch.relu(bn_eval(conv_(x, w["expand_conv.weight"]), w, "expand_bn"))
    ds, ps = dilations(cfg), pads(cfg)
    for i in range(len(cfg["filter_widths"]) - 1):
        pad = ps[i + 1]
        shift = pad if cfg["causal"] else 0
        res = x[:, pad + shift: x.shape[1] - pad + shift]
        y = conv_(x, w[f"layers_conv.{2 * i}.weight"], ds[i + 1])
        y = torch.relu(bn_eval(y, w, f"layers_bn.{2 * i}"))
        y = conv_(y, w[f"layers_conv.{2 * i + 1}.weight"])
        y = torch.relu(bn_eval(y, w, f"layers_bn.{2 * i + 1}"))
        x = res + y
    out = conv_(x, w["shrink.weight"]) + w["shrink.bias"]
    return out.reshape(out.shape[0], out.shape[1], -1, 3)


def strided_conv(x, w):
    """Convolution of width k and stride k over channels-last (B, T, C_in)."""
    b, t, c = x.shape
    k = w.shape[2]
    return x.reshape(b, t // k, k * c) @ w.permute(2, 1, 0).reshape(k * c, -1)


def bn_train(y, w, name):
    """Training BatchNorm: the batch's mean and biased variance over (B, T)."""
    mean = y.mean(dim=(0, 1))
    var = ((y - mean) ** 2).mean(dim=(0, 1))
    return (y - mean) / torch.sqrt(var + BN_EPS) * w[f"{name}.weight"] + w[f"{name}.bias"]


def strided_forward(w, cfg, x, masks):
    """Training forward of the strided form: (B, receptive_field, J_in, F)
    keypoints -> (B, 1, J_out, 3) poses, with training BatchNorm and the dropout
    ``masks`` (expand's, then each block's two, pre-scaled; None: no dropout)."""
    masks = iter(masks)
    x = x.reshape(x.shape[0], x.shape[1], -1)

    def drop(y):
        m = next(masks)
        return y if m is None else y * m

    x = drop(torch.relu(bn_train(strided_conv(x, w["expand_conv.weight"]), w, "expand_bn")))
    for i, fw in enumerate(cfg["filter_widths"][1:]):
        b, t, c = x.shape
        center = fw // 2 + (fw // 2 if cfg["causal"] else 0)
        res = x.reshape(b, t // fw, fw, c)[:, :, center]
        y = strided_conv(x, w[f"layers_conv.{2 * i}.weight"])
        y = drop(torch.relu(bn_train(y, w, f"layers_bn.{2 * i}")))
        y = y @ w[f"layers_conv.{2 * i + 1}.weight"][:, :, 0].t()
        y = drop(torch.relu(bn_train(y, w, f"layers_bn.{2 * i + 1}")))
        x = res + y
    out = x @ w["shrink.weight"][:, :, 0].t() + w["shrink.bias"]
    return out.reshape(out.shape[0], out.shape[1], -1, 3)


def mask_shapes(cfg, batch: int):
    """Activation shapes of the strided form's dropout masks, in draw order."""
    c = cfg["channels"]
    t = receptive_field(cfg) // cfg["filter_widths"][0]
    shapes = [(batch, t, c)]
    for fw in cfg["filter_widths"][1:]:
        t //= fw
        shapes += [(batch, t, c)] * 2
    return shapes


def dropout_masks(rate: float, shapes, generator, dtype):
    """Inverted-dropout masks drawn from ``generator`` in order: a keep
    probability of k/256 draws one byte per element and keeps it below k, any
    other one 16 bits; kept elements are scaled by the realised 1/keep."""
    if rate == 0.0:
        return [None] * len(shapes)
    keep = 1.0 - rate
    k8 = round(keep * 256)
    if abs(keep * 256 - k8) < 1e-9 and 0 < k8 < 256:
        threshold, denom, bits = k8, 256, torch.uint8
    else:
        threshold, denom, bits = min(max(round(keep * 65536), 1), 65535), 65536, torch.int32
    return [(torch.randint(0, denom, s, generator=generator, device=generator.device,
                           dtype=bits) < threshold).to(dtype) * (denom / threshold)
            for s in shapes]


def mpjpe_loss(pred, target):
    """Mean over the batch of each sample's mean joint distance."""
    return torch.linalg.vector_norm(pred - target, dim=-1).mean(dim=(1, 2)).mean()
