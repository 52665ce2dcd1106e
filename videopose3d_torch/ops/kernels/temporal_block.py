"""Fused dilated residual blocks of the evaluation model: CUDA kernels and their
plain PyTorch versions.

Counterpart of ``videopose3d_tpu/ops/pallas/temporal_block.py``.  One residual
block in inference mode is

    h   = relu(bn1(dilated_conv_k(x)))
    out = x[:, off : off + T_out] + relu(bn2(conv1x1(h)))

with ``off = (k-1)*d//2 + causal_shift``.  ``fused_expand_block`` computes the
expand convolution (raw keypoints -> C channels) first and ``fused_shrink_block``
projects the block output to ``J_out*3`` coordinates last, so the fused
evaluation path reads the raw keypoints once and writes C-wide activations only
between blocks.

Layout at this surface is the JAX package's: channels-last ``(B, T, C)``
activations and ``(k, C_in, C_out)`` weights.  Activations and weights share one
dtype (float32 or bfloat16); the folded BatchNorm affines are float32 and every
sum is float32.  The values are cast to the activation dtype at the points where
the TPU kernel casts: the expand output ``e``, ``h`` before the 1x1 GEMM, the
residual sum, and the block output before the shrink projection.

Dispatch: a tensor on the CPU takes the ``*_plain`` version; a CUDA tensor
launches the kernel (``csrc/temporal_block.cu``) or raises.  ``LAUNCHES`` counts
kernel launches per kernel.
"""

from __future__ import annotations

import ctypes

import torch

from videopose3d_torch.models.temporal import BN_EPS

LAUNCHES = {"expand": 0, "dilated": 0, "shrink": 0}

_VARIANT = {"dilated": 0, "expand": 1, "shrink": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fold_batchnorm(weight, bias, running_mean, running_var, eps: float = BN_EPS):
    """Inference BatchNorm as an affine ``bn(x) = x * scale + shift`` (float32)."""
    scale = weight.float() * torch.rsqrt(running_var.float() + eps)
    return scale, bias.float() - running_mean.float() * scale


def _matrix(w):
    """A 1x1 conv weight given as (1, C_in, C_out) or (C_in, C_out)."""
    return w.reshape(w.shape[-2], w.shape[-1])


def _taps(xf, w, dilation: int, t_out: int):
    """float32 sum over taps j of ``xf[:, j*d : j*d + t_out] @ w[j]``."""
    acc = xf[:, :t_out] @ w[0]
    for j in range(1, w.shape[0]):
        acc = acc + xf[:, j * dilation: j * dilation + t_out] @ w[j]
    return acc


def _geometry(t: int, n_taps: int, dilation: int, causal_shift: int):
    t_out = t - (n_taps - 1) * dilation
    if t_out < 1:
        raise ValueError(f"input of {t} frames is shorter than the block's "
                         f"reach {(n_taps - 1) * dilation + 1}")
    return t_out, (n_taps - 1) * dilation // 2 + causal_shift


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def fused_dilated_block_plain(x, w_taps, bn1_scale, bn1_shift, w2, bn2_scale,
                              bn2_shift, *, dilation: int, causal_shift: int = 0):
    """One residual block, (B, T, C) -> (B, T - (k-1)*d, C) in ``x.dtype``."""
    dt = x.dtype
    t_out, off = _geometry(x.shape[1], w_taps.shape[0], dilation, causal_shift)
    xf = x.float()
    acc = _taps(xf, w_taps.to(dt).float(), dilation, t_out)
    h = torch.relu(acc * bn1_scale + bn1_shift).to(dt).float()
    y = torch.relu(h @ _matrix(w2).to(dt).float() * bn2_scale + bn2_shift)
    return (xf[:, off: off + t_out] + y).to(dt)


def fused_expand_block_plain(x_raw, w0, bn0_scale, bn0_shift, w_taps, bn1_scale,
                             bn1_shift, w2, bn2_scale, bn2_shift, *, dilation: int,
                             causal_shift: int = 0):
    """Expand conv (k0 taps, C_in -> C) + the first residual block.

    (B, T, C_in) -> (B, T - (k0-1) - (k-1)*d, C) in ``w_taps.dtype``.
    """
    dt = w_taps.dtype
    t_e = x_raw.shape[1] - (w0.shape[0] - 1)
    if t_e < 1:
        raise ValueError(f"input of {x_raw.shape[1]} frames is shorter than the "
                         f"expand conv's width {w0.shape[0]}")
    xr = x_raw.to(dt).float()
    e = torch.relu(_taps(xr, w0.to(dt).float(), 1, t_e) * bn0_scale + bn0_shift)
    return fused_dilated_block_plain(
        e.to(dt), w_taps, bn1_scale, bn1_shift, w2, bn2_scale, bn2_shift,
        dilation=dilation, causal_shift=causal_shift)


def fused_shrink_block_plain(x, w_taps, bn1_scale, bn1_shift, w2, bn2_scale,
                             bn2_shift, w_shrink, b_shrink, *, dilation: int,
                             causal_shift: int = 0):
    """Last residual block + the 1x1 shrink projection and bias.

    (B, T, C) -> (B, T - (k-1)*d, J_out*3) in float32.
    """
    block_out = fused_dilated_block_plain(
        x, w_taps, bn1_scale, bn1_shift, w2, bn2_scale, bn2_shift,
        dilation=dilation, causal_shift=causal_shift)
    ws = _matrix(w_shrink).to(x.dtype).float()
    return block_out.float() @ ws + b_shrink.float()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name, t, device, dtype, shape, align: int = 1):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(kind, x, *, t_out, channels, w0=None, s0=None, b0=None, w_taps,
            s1, b1, dilation, res_offset, w2, s2, b2, ws=None, bs=None, out):
    """Check every operand against the kernel's contract and launch it."""
    if x.device.type != "cuda":
        raise ValueError(f"the {kind} kernel runs on CUDA tensors, got {x.device}")
    dt = w_taps.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {dt}: the kernels take float32 or bfloat16")
    dev = x.device
    batch, t_in, x_cols = x.shape
    c, n_taps, k0 = channels, w_taps.shape[0], 0
    if c % 4:
        raise ValueError(f"channels must be a multiple of 4, got {c}")
    _check("x", x, dev, dt, (batch, t_in, x_cols))
    if w0 is not None:
        k0 = w0.shape[0]
        _check("w0", w0, dev, dt, (k0, x_cols, c))
        _check("bn0_scale", s0, dev, torch.float32, (c,))
        _check("bn0_shift", b0, dev, torch.float32, (c,))
    elif x_cols != c:
        raise ValueError(f"x has {x_cols} channels, the block {c}")
    _check("w_taps", w_taps, dev, dt, (n_taps, c, c))
    _check("w2", w2, dev, dt, (c, c))
    for name, v in (("bn1_scale", s1), ("bn1_shift", b1), ("bn2_scale", s2),
                    ("bn2_shift", b2)):
        _check(name, v, dev, torch.float32, (c,))
    j3 = 0
    if ws is not None:
        j3 = ws.shape[1]
        _check("w_shrink", ws, dev, dt, (c, j3))
        _check("b_shrink", bs, dev, torch.float32, (j3,))
    lib = _load()
    variant = _VARIANT[kind]
    span = (n_taps - 1) * dilation
    smem = lib.vp3d_block_smem_bytes(variant, c, x_cols, k0, span)
    if smem > lib.vp3d_block_max_smem_bytes():
        raise ValueError(f"the {kind} kernel needs {smem} bytes of shared memory at "
                         f"{c} channels and reach {span}; at most "
                         f"{lib.vp3d_block_max_smem_bytes()} are available")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.vp3d_temporal_block(
            variant, _DTYPE_CODE[dt], batch, t_in, t_out, c, _ptr(x), x_cols,
            _ptr(w0), _ptr(s0), _ptr(b0), k0, _ptr(w_taps), _ptr(s1), _ptr(b1),
            n_taps, dilation, res_offset, _ptr(w2), _ptr(s2), _ptr(b2), _ptr(ws),
            _ptr(bs), j3, _ptr(out), ctypes.c_void_p(stream))
    if code != 0:
        raise RuntimeError(f"the {kind} kernel failed to launch: "
                           f"{lib.vp3d_error_string(code).decode()} ({code})")
    LAUNCHES[kind] += 1
    return out


def _load():
    from videopose3d_torch.ops.kernels.build import load_library
    return load_library()


def fused_dilated_block(x, w_taps, bn1_scale, bn1_shift, w2, bn2_scale, bn2_shift,
                        *, dilation: int, causal_shift: int = 0):
    """One residual block (inference): (B, T, C) -> (B, T - (k-1)*d, C).

    Args:
      x: (B, T, C) activations, float32 or bfloat16.
      w_taps: (k, C, C) dilated conv weights, cast to ``x.dtype``.
      bn1_scale/shift, bn2_scale/shift: (C,) float32 folded BatchNorm affines.
      w2: (C, C) or (1, C, C) 1x1 conv weights, cast to ``x.dtype``.
      dilation: temporal dilation d; the residual is read at row offset
        ``(k-1)*d//2 + causal_shift``.
    """
    if x.device.type == "cpu":
        return fused_dilated_block_plain(
            x, w_taps, bn1_scale, bn1_shift, w2, bn2_scale, bn2_shift,
            dilation=dilation, causal_shift=causal_shift)
    b, t, c = x.shape
    t_out, off = _geometry(t, w_taps.shape[0], dilation, causal_shift)
    out = torch.empty((b, t_out, c), dtype=x.dtype, device=x.device)
    return _launch("dilated", x, t_out=t_out, channels=c, w_taps=w_taps.to(x.dtype),
                   s1=bn1_scale, b1=bn1_shift, dilation=dilation, res_offset=off,
                   w2=_matrix(w2).to(x.dtype), s2=bn2_scale, b2=bn2_shift, out=out)


def fused_expand_block(x_raw, w0, bn0_scale, bn0_shift, w_taps, bn1_scale, bn1_shift,
                       w2, bn2_scale, bn2_shift, *, dilation: int,
                       causal_shift: int = 0):
    """Expand conv + first residual block: (B, T, C_in) -> (B, T_out, C).

    ``x_raw`` is cast to the weights' dtype first, as the TPU wrapper does;
    ``w0`` is (k0, C_in, C), the other arguments as :func:`fused_dilated_block`.
    ``T_out = T - (k0-1) - (k-1)*d``.
    """
    if x_raw.device.type == "cpu":
        return fused_expand_block_plain(
            x_raw, w0, bn0_scale, bn0_shift, w_taps, bn1_scale, bn1_shift, w2,
            bn2_scale, bn2_shift, dilation=dilation, causal_shift=causal_shift)
    dt = w_taps.dtype
    x_raw = x_raw.to(dt)
    b, t, _ = x_raw.shape
    c = w_taps.shape[-1]
    t_out, off = _geometry(t - (w0.shape[0] - 1), w_taps.shape[0], dilation,
                           causal_shift)
    out = torch.empty((b, t_out, c), dtype=dt, device=x_raw.device)
    return _launch("expand", x_raw, t_out=t_out, channels=c, w0=w0.to(dt),
                   s0=bn0_scale, b0=bn0_shift, w_taps=w_taps, s1=bn1_scale,
                   b1=bn1_shift, dilation=dilation, res_offset=off,
                   w2=_matrix(w2).to(dt), s2=bn2_scale, b2=bn2_shift, out=out)


def fused_shrink_block(x, w_taps, bn1_scale, bn1_shift, w2, bn2_scale, bn2_shift,
                       w_shrink, b_shrink, *, dilation: int, causal_shift: int = 0):
    """Last residual block + shrink projection: (B, T, C) -> (B, T_out, J_out*3)
    float32.  ``w_shrink`` is (C, J_out*3) or (1, C, J_out*3), cast to ``x.dtype``,
    and
    ``b_shrink`` (J_out*3,) float32."""
    if x.device.type == "cpu":
        return fused_shrink_block_plain(
            x, w_taps, bn1_scale, bn1_shift, w2, bn2_scale, bn2_shift, w_shrink,
            b_shrink, dilation=dilation, causal_shift=causal_shift)
    b, t, c = x.shape
    ws = _matrix(w_shrink).to(x.dtype)
    t_out, off = _geometry(t, w_taps.shape[0], dilation, causal_shift)
    out = torch.empty((b, t_out, ws.shape[1]), dtype=torch.float32, device=x.device)
    return _launch("shrink", x, t_out=t_out, channels=c, w_taps=w_taps.to(x.dtype),
                   s1=bn1_scale, b1=bn1_shift, dilation=dilation, res_offset=off,
                   w2=_matrix(w2).to(x.dtype), s2=bn2_scale, b2=bn2_shift, ws=ws,
                   bs=b_shrink, out=out)
