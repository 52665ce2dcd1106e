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

Any width: the kernels copy rows in 16-byte words, so on a CUDA tensor every
width (the channels, the expand block's keypoint columns, the shrink's outputs)
must be a whole word of the dtype.  ``models/temporal.forward_dilated_fused``
pads the model's operands to whole words once, with zero weights, zero BatchNorm
affines and a zero shrink bias (``pad``, ``padded_block``): the padded channels
stay exactly 0 through every block and add exact zeros to every sum, and only
the poses are cut back.  The plain versions take any width.

Dispatch: a tensor on the CPU takes the ``*_plain`` version; a CUDA tensor
launches the kernel (``csrc/temporal_block.cu``) or raises.  ``LAUNCHES`` counts
kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from videopose3d_torch.models.temporal import BN_EPS
from videopose3d_torch.ops.kernels.build import check, launch, sm_count

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


# The most dynamic shared memory a CUDA block may opt in to (the streaming step
# sizes its tiles against it).
SMEM_OPT_IN = 232_448

# k3_plan's rates: a stage GEMM's products per second on one SM, float32 at 45
# TFLOP/s (fitted to the CUDA-core tile; on the 3xTF32 one its picks stay the fastest
# slice counts) and bf16 at 216 TFLOP/s (k3_mma_kernel's rate within a wave), over
# 132 SMs; and the cost of a split's second launch.  Fitted to kernel_ab.py's K3
# sweep on an H100 (PERF.md).
K3_SM_FLOPS = {torch.float32: 45e12 / 132, torch.bfloat16: 216e12 / 132}
K3_SPLIT_LAUNCH_S = 3e-6


def k3_plan(m: int, k: int, n: int, sms: int = 132, dtype=torch.float32):
    """The slices ``((start, stop), ...)`` of the summed dimension of a stage GEMM
    (m x k) @ (k x n) in ``dtype`` on ``sms`` SMs, whose rows per slice the stage's
    launch passes to the kernel: ``train_block.tap_gemm_plan``'s cost model (the
    stage GEMMs run the same 128 x 128 tile over 32-row slabs) at the dtype
    kernel's rate, split no further than one wave of resident CUDA blocks holds
    where the tiles fit in one.  At B = 2, T_out = 2,234, C = 1,024 on 132 SMs the
    tap GEMM's 280 tiles split in 6 in float32 and in 2 in bf16, the float32 1x1's
    in 4."""
    from videopose3d_torch.ops.kernels.train_block import tap_gemm_plan
    return tap_gemm_plan(m, k, n, sms, sm_flops=K3_SM_FLOPS[dtype],
                         launch_s=K3_SPLIT_LAUNCH_S, one_wave=True)


def k3_gemms(kind: str, batch: int, t_in: int, t_out: int, c: int, *, x_cols: int = 0,
             k0: int = 0, n_taps: int = 3, j3: int = 0):
    """The (m, k, n) of each GEMM the ``kind`` stage's kernel chain runs, in order:
    (expand) the raw window's, the taps', the 1x1's and (shrink) the projection's."""
    m = batch * t_out
    gemms = [(m, n_taps * c, c), (m, c, c)]
    if kind == "expand":
        gemms.insert(0, (batch * (t_in - k0 + 1), k0 * x_cols, c))
    if kind == "shrink":
        gemms.append((m, c, j3))
    return gemms


def word(dtype) -> int:
    """Elements per 16-byte word, the unit the kernels copy rows in."""
    return 16 // dtype.itemsize


def whole_words(n: int, dtype) -> int:
    """``n`` rounded up to a whole number of 16-byte words of ``dtype``."""
    return -(-n // word(dtype)) * word(dtype)


def pad(v, *sizes):
    """``v`` zero-padded at the end of its last ``len(sizes)`` axes to ``sizes``
    (``v`` itself where it has them)."""
    pads = []
    for have, want in zip(reversed(v.shape[-len(sizes):]), reversed(sizes)):
        pads += [0, want - have]
    return F.pad(v, pads) if any(pads) else v


def padded_block(c: int, w_taps, bn1_scale, bn1_shift, w2, bn2_scale, bn2_shift):
    """A residual block's operands at ``c`` >= C channels: zero weights and zero
    BatchNorm affines, so the padded channels of h and of the block output are
    relu(0 * 0 + 0) = 0 and add exact zeros to every sum."""
    return (pad(w_taps, c, c), pad(bn1_scale, c), pad(bn1_shift, c),
            pad(_matrix(w2), c, c), pad(bn2_scale, c), pad(bn2_shift, c))


def channel_limit_error(c: int):
    """Why the fused evaluation kernels (``--serving-engine fused`` on CUDA) cannot
    run at ``c`` channels, or None: they take any width, as the JAX package's.
    Nothing is held per channel in shared memory, and ``forward_dilated_fused``
    pads widths that are not whole 16-byte words."""
    if c < 1:
        return f"{c} channels: the fused evaluation blocks need at least one channel"
    return None


@functools.lru_cache(maxsize=None)
def _layout(kind, batch, t_in, t_out, c, x_cols, k0, n_taps, j3, dtype, sms):
    """What a stage's launch takes besides its operands, once per shape: the rows
    per slice of each GEMM of its chain (``k3_plan``, as a C int array), the
    float32 products of its largest split, and its workspace: the bytes, and the
    offset in them of e (expand), h, the shrink's block output and a split's
    products, each part 256-byte aligned (None where the stage has no such part)."""
    gemms = k3_gemms(kind, batch, t_in, t_out, c, x_cols=x_cols, k0=k0, n_taps=n_taps,
                     j3=j3)
    plans = [k3_plan(m, k, n, sms, dtype) for m, k, n in gemms]
    k_slices = (ctypes.c_int * len(plans))(*(plan[0][1] for plan in plans))
    part_floats = max([len(plan) * m * n for plan, (m, _, n) in zip(plans, gemms)
                       if len(plan) > 1], default=0)
    esize = dtype.itemsize
    parts = [esize * batch * (t_in - k0 + 1) * c if kind == "expand" else 0,
             esize * batch * t_out * c, esize * batch * t_out * c if kind == "shrink" else 0,
             4 * part_floats]
    offsets, at = [], 0
    for size in parts:
        offsets.append(at if size else None)
        at += -(-size // 256) * 256
    return k_slices, part_floats, tuple(offsets), at


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
    c, n_taps, k0, j3 = channels, w_taps.shape[0], 0, 0
    wd = word(dt)
    if c % wd:
        raise ValueError(f"{c} channels: the {kind} kernel takes a multiple of {wd} "
                         f"channels in {dt} (forward_dilated_fused pads other widths)")
    if w0 is not None:
        k0 = w0.shape[0]
        if x_cols % wd:
            raise ValueError(f"{x_cols} input columns: the expand kernel takes a "
                             f"multiple of {wd} (forward_dilated_fused pads them)")
        check("w0", w0, dev, dt, (k0, x_cols, c), align=16)
        check("bn0_scale", s0, dev, torch.float32, (c,))
        check("bn0_shift", b0, dev, torch.float32, (c,))
    elif x_cols != c:
        raise ValueError(f"x has {x_cols} channels, the block {c}")
    check("x", x, dev, dt, (batch, t_in, x_cols), align=16)
    check("w_taps", w_taps, dev, dt, (n_taps, c, c), align=16)
    check("w2", w2, dev, dt, (c, c), align=16)
    for name, v in (("bn1_scale", s1), ("bn1_shift", b1), ("bn2_scale", s2),
                    ("bn2_shift", b2)):
        check(name, v, dev, torch.float32, (c,))
    if ws is not None:
        j3 = bs.shape[0]
        check("b_shrink", bs, dev, torch.float32, (j3,))
        check("w_shrink", ws, dev, dt, (c, j3), align=16)
        if j3 % wd:
            raise ValueError(f"{j3} output columns: the shrink kernel takes a multiple "
                             f"of {wd} (forward_dilated_fused pads them)")
    k_slices, part_floats, offsets, size = _layout(kind, batch, t_in, t_out, c, x_cols,
                                                   k0, n_taps, j3, dt, sm_count(dev))
    work = torch.empty(size, dtype=torch.uint8, device=dev)
    base = work.data_ptr()
    e, h, y, part = (None if o is None else base + o for o in offsets)
    launch("vp3d_temporal_block", dev, _VARIANT[kind], _DTYPE_CODE[dt], batch, t_in, t_out,
           c, x, x_cols, w0, s0, b0, k0, w_taps, s1, b1, n_taps, dilation, res_offset, w2,
           s2, b2, ws, bs, j3, e, h, y, part, part_floats, k_slices, out,
           count=(LAUNCHES, kind))
    return out


def fused_dilated_block(x, w_taps, bn1_scale, bn1_shift, w2, bn2_scale, bn2_shift,
                        *, dilation: int, causal_shift: int = 0):
    """One residual block (inference): (B, T, C) -> (B, T - (k-1)*d, C).

    Args:
      x: (B, T, C) activations, float32 or bfloat16; on CUDA, C a whole number of
        16-byte words (``padded_block``).
      w_taps: (k, C, C) dilated conv weights, cast to ``x.dtype``.
      bn1_scale/shift, bn2_scale/shift: (C,) float32 folded BatchNorm affines.
      w2: (C, C) or (1, C, C) 1x1 conv weights, cast to ``x.dtype``.
      dilation: temporal dilation d; the residual is read at row offset
        ``(k-1)*d//2 + causal_shift``.
    """
    if x.device.type == "cpu":
        return fused_dilated_block_plain(x, w_taps, bn1_scale, bn1_shift, w2, bn2_scale,
                                         bn2_shift, dilation=dilation,
                                         causal_shift=causal_shift)
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
    ``w0`` is (k0, C_in, C), the other arguments as :func:`fused_dilated_block`
    (on CUDA, C_in a whole number of 16-byte words too).
    ``T_out = T - (k0-1) - (k-1)*d``.
    """
    geo = dict(dilation=dilation, causal_shift=causal_shift)
    if x_raw.device.type == "cpu":
        return fused_expand_block_plain(x_raw, w0, bn0_scale, bn0_shift, w_taps, bn1_scale,
                                        bn1_shift, w2, bn2_scale, bn2_shift, **geo)
    dt = w_taps.dtype
    b, t, _ = x_raw.shape
    c = w_taps.shape[-1]
    t_out, off = _geometry(t - (w0.shape[0] - 1), w_taps.shape[0], dilation, causal_shift)
    out = torch.empty((b, t_out, c), dtype=dt, device=x_raw.device)
    return _launch("expand", x_raw.to(dt), t_out=t_out, channels=c, w0=w0.to(dt),
                   s0=bn0_scale, b0=bn0_shift, w_taps=w_taps, s1=bn1_scale, b1=bn1_shift,
                   dilation=dilation, res_offset=off, w2=_matrix(w2).to(dt), s2=bn2_scale,
                   b2=bn2_shift, out=out)


def fused_shrink_block(x, w_taps, bn1_scale, bn1_shift, w2, bn2_scale, bn2_shift,
                       w_shrink, b_shrink, *, dilation: int, causal_shift: int = 0):
    """Last residual block + shrink projection: (B, T, C) -> (B, T_out, J) float32.
    ``w_shrink`` is (C, J) or (1, C, J), cast to ``x.dtype``, and ``b_shrink``
    (J,) float32; on CUDA, J a whole number of 16-byte words of ``x.dtype``."""
    geo = dict(dilation=dilation, causal_shift=causal_shift)
    ws = _matrix(w_shrink)
    if x.device.type == "cpu":
        return fused_shrink_block_plain(x, w_taps, bn1_scale, bn1_shift, w2, bn2_scale,
                                        bn2_shift, ws, b_shrink, **geo)
    b, t, c = x.shape
    t_out, off = _geometry(t, w_taps.shape[0], dilation, causal_shift)
    out = torch.empty((b, t_out, b_shrink.shape[0]), dtype=torch.float32, device=x.device)
    return _launch("shrink", x, t_out=t_out, channels=c, w_taps=w_taps.to(x.dtype),
                   s1=bn1_scale, b1=bn1_shift, dilation=dilation, res_offset=off,
                   w2=_matrix(w2).to(x.dtype), s2=bn2_scale, b2=bn2_shift,
                   ws=ws.to(x.dtype), bs=b_shrink, out=out)
