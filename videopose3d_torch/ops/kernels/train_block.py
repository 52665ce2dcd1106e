"""Fused strided residual block of the training model, forward and backward:
CUDA kernels, their plain PyTorch versions, and the ``autograd.Function`` that
chains them.

Counterpart of ``videopose3d_tpu/ops/pallas/train_block.py``.  Over the free
``(n, fw, C)`` view ``x3`` of a ``(B, T, C)`` input (n = B * T/fw), the block is

    u   = x3 @ Wa                      (the strided conv)
    d   = mask_a * relu(bn_a(u))       (train-mode BatchNorm, dropout)
    v   = d @ Wb                       (the 1x1 conv)
    out = x3[:, center] + mask_b * relu(bn_b(v))

with the batch statistics taken in the GEMM epilogues as per-channel sums of
``(u - shift)`` and its square, shifted by the running mean.  One function per
Pallas launch, each with a ``*_plain`` twin of the same signature:

    forward:  conv_stats, norm_drop_matmul_stats, norm_drop_res
    backward: relu_mask_bn_sums (once per BatchNorm), dz_matmul_dd + dw_gemm
              (together the Pallas ``_dz_matmul_dw_kernel``), du_dtaps_res

and the O(C) statistics glue between them in torch.  ``dWa = x3^T @ du`` is a
plain matmul, as the JAX package leaves it to XLA.

Dtypes: activations, weights and masks share one dtype (float32 or bfloat16);
BatchNorm parameters, statistics and every sum are float32.  Values are cast at
the points the Pallas bodies cast, and the BatchNorm affine runs in the
activation dtype with the constants the forward used, so the backward ReLU gate
replays the forward's pre-activation exactly.

Dispatch: tensors on the CPU take the plain versions (inside the same
``FusedTrainBlock``, so the CPU tests exercise its backward); CUDA tensors
launch the kernels of ``csrc/train_block.cu`` or raise.  ``LAUNCHES`` counts
kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from videopose3d_torch.models.temporal import BN_EPS
from videopose3d_torch.ops.kernels.temporal_block import _check

LAUNCHES = {"conv_stats": 0, "norm_drop_matmul_stats": 0, "norm_drop_res": 0,
            "relu_mask_bn_sums": 0, "dz_matmul_dd": 0, "dw_gemm": 0,
            "du_dtaps_res": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _affine(z, gate):
    """The BatchNorm affine ``(z - mean) * inv + bias`` in z's dtype, with the
    (3, C) gate constants ``[mean, inv, bias]`` already in that dtype."""
    return (z - gate[0]) * gate[1] + gate[2]


def _sums(y, shift):
    yf = y.float() - shift
    return yf.sum(0), (yf * yf).sum(0)


def _bn_input_grad(gz, z, coef):
    """``c0 * (gz - c1 - zhat * c2)``, zhat = (z - mean) * inv, in float32;
    coef rows: [inv * scale, c1, c2, inv, mean]."""
    zhat = (z.float() - coef[4]) * coef[3]
    return coef[0] * (gz.float() - coef[1] - zhat * coef[2])


def conv_stats_plain(x3, wa, shift, *, center: int):
    """(n, fw, C) taps, (fw, C, C) weights -> u (n, C), res = x3[:, center], and
    the float32 sums of (u - shift) and (u - shift)^2."""
    n, fw, c = x3.shape
    u = (x3.reshape(n, fw * c).float() @ wa.reshape(fw * c, c).float()).to(x3.dtype)
    return (u, x3[:, center].contiguous(), *_sums(u, shift))


def norm_drop_matmul_stats_plain(u, mask, gate, wb, shift):
    """d = mask * relu(bn(u)), v = d @ Wb, and the sums of (v - shift)."""
    d = torch.relu(_affine(u, gate))
    if mask is not None:
        d = d * mask
    v = (d.float() @ wb.float()).to(u.dtype)
    return (d, v, *_sums(v, shift))


def norm_drop_res_plain(v, mask, gate, res):
    """out = res + mask * relu(bn(v))."""
    e = torch.relu(_affine(v, gate))
    if mask is not None:
        e = e * mask
    return res + e


def relu_mask_bn_sums_plain(g, z, mask, stat, gate):
    """gz = g * mask * [bn(z) > 0] (stored in g's dtype) with the float32 sums of
    gz (d_bias) and gz * zhat (d_scale); stat rows: [mean, inv] float32."""
    keep = (_affine(z, gate) > 0).float()
    gz = g.float()
    if mask is not None:
        gz = gz * mask.float()
    gz = gz * keep
    zhat = (z.float() - stat[0]) * stat[1]
    return gz.to(g.dtype), gz.sum(0), (gz * zhat).sum(0)


def dz_matmul_dd_plain(gz, z, coef, wb):
    """dz = the BatchNorm input gradient (in gz's dtype) and dd = dz @ Wb^T."""
    dz = _bn_input_grad(gz, z, coef).to(gz.dtype)
    return dz, (dz.float() @ wb.float().t()).to(gz.dtype)


def dw_gemm_plain(a, b):
    """a^T @ b over the rows, float32: (n, C) x (n, C) -> (C, C)."""
    return a.float().t() @ b.float()


def du_dtaps_res_plain(ga, u, g, coef, wa, *, center: int):
    """du = the BatchNorm input gradient and dx3[:, j] = du @ Wa[j]^T, with the
    residual cotangent g added to the center tap."""
    du = _bn_input_grad(ga, u, coef).to(ga.dtype)
    taps = [(du.float() @ w.float().t()).to(ga.dtype) for w in wa]
    taps[center] = taps[center] + g
    return du, torch.stack(taps, dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    from videopose3d_torch.ops.kernels.build import load_library
    return load_library()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(key, fn_name, *args):
    """Launch one kernel on the current stream; raise if the launch failed."""
    lib = _lib()
    device = next(a for a in args if isinstance(a, torch.Tensor)).device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn_name)(
            *[_ptr(a) if isinstance(a, torch.Tensor) or a is None else a for a in args],
            ctypes.c_void_p(stream))
    if code != 0:
        raise RuntimeError(f"the {key} kernel failed to launch: "
                           f"{lib.vp3d_error_string(code).decode()} ({code})")
    if key is not None:
        LAUNCHES[key] += 1


# The row-tile kernels' geometry (csrc/tile_gemm.cuh): TM rows of C float32 values
# per CUDA block in shared memory, of which a block may opt in to SMEM_OPT_IN bytes.
TM, SMEM_OPT_IN = 16, 232_448


def tile_smem_bytes(c: int) -> int:
    """Shared memory of the row-tile kernels at c channels (``vp3d_tb_smem_bytes``)."""
    return 4 * TM * c


def channel_limit_error(c: int):
    """Why the train-block kernels cannot run at ``c`` channels, or None: rows are
    copied in 16-byte words (C % 4 == 0), and norm_drop_matmul_stats and
    dz_matmul_dd hold a TM x C float32 tile in shared memory."""
    if c % 4:
        return (f"{c} channels: the train-block kernels (--train-engine pallas on CUDA) "
                "take a multiple of 4 channels; use --train-engine xla")
    if tile_smem_bytes(c) > SMEM_OPT_IN:
        return (f"{c} channels: the train-block kernels (--train-engine pallas on CUDA) "
                f"hold a {TM} x C float32 tile in at most {SMEM_OPT_IN} bytes of shared "
                f"memory, so at most {SMEM_OPT_IN // tile_smem_bytes(1)} channels; use "
                "--train-engine xla")
    return None


def _validate(t, c: int, *, row_tile: bool = True):
    """Device, dtype and width limits of the train-block kernels; ``row_tile``:
    the kernel holds a TM x C tile in shared memory."""
    if t.device.type != "cuda":
        raise ValueError(f"the train-block kernels run on CUDA tensors, got {t.device}")
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {t.dtype}: the kernels take float32 or "
                         "bfloat16")
    err = channel_limit_error(c)
    if err and (row_tile or c % 4):
        raise ValueError(err)


def _check_all(device, dt, **operands):
    """Operands as name=(tensor | None, dtype | None for dt, shape)."""
    for name, (t, dtype, shape) in operands.items():
        if t is not None:
            _check(name, t, device, dtype or dt, shape)


def _reduce(part, c: int):
    """Sums the (2, n_tiles, C) per-tile partials in tile order -> (2, C)."""
    out = torch.empty((2, c), dtype=torch.float32, device=part.device)
    _call(None, "vp3d_tb_stats_reduce", part.shape[1], c, part[0], part[1], out[0],
          out[1])
    return out


def _partials(kind: int, n: int, c: int, device):
    """(2, n_tiles, C) float32 per-tile partial sums; kind as ``vp3d_tb_sum_rows``."""
    rows = _lib().vp3d_tb_sum_rows(kind)
    return torch.empty((2, -(-n // rows), c), dtype=torch.float32, device=device)


def conv_stats(x3, wa, shift, *, center: int):
    """Kernel of :func:`conv_stats_plain` (Pallas ``_conv_stats_kernel``): the tap
    GEMM ``x3 (n, fw C) @ wa (fw C, C)`` over the :func:`tap_gemm_plan` slices of
    its summed dimension, then the partial sums' in-order reduction."""
    if x3.device.type == "cpu":
        return conv_stats_plain(x3, wa, shift, center=center)
    n, fw, c = x3.shape
    dt = x3.dtype
    _validate(x3, c, row_tile=False)
    align = 4 * x3.element_size()  # whole 4-element rows of 16 (8) bytes
    _check("x3", x3, x3.device, dt, (n, fw, c), align=align)
    _check("wa", wa, x3.device, dt, (fw, c, c), align=align)
    _check("shift", shift, x3.device, torch.float32, (c,))
    if not 0 <= center < fw:
        raise ValueError(f"center tap {center} out of range for {fw} taps")
    plan = tap_gemm_plan(n, fw * c, c, _sms(x3.device))
    u = torch.empty((n, c), dtype=dt, device=x3.device)
    res = torch.empty_like(u)
    part = _partials(2, n, c, x3.device)
    _call("conv_stats", "vp3d_tb_conv_stats", _DTYPE_CODE[dt], n, c, fw, center, len(plan),
          plan[0][1], x3, wa, shift, u, res, part[0], part[1], _split_scratch(plan, n, c, u))
    s = _reduce(part, c)
    return u, res, s[0], s[1]


def norm_drop_matmul_stats(u, mask, gate, wb, shift):
    """Kernel of :func:`norm_drop_matmul_stats_plain`."""
    if u.device.type == "cpu":
        return norm_drop_matmul_stats_plain(u, mask, gate, wb, shift)
    dt = u.dtype
    n, c = u.shape
    _validate(u, c)
    _check_all(u.device, dt, u=(u, None, (n, c)), mask=(mask, None, (n, c)),
               gate=(gate, None, (3, c)), wb=(wb, None, (c, c)),
               shift=(shift, torch.float32, (c,)))
    d = torch.empty_like(u)
    v = torch.empty_like(u)
    part = _partials(0, n, c, u.device)
    _call("norm_drop_matmul_stats", "vp3d_tb_norm_drop_matmul_stats", _DTYPE_CODE[dt], n,
          c, u, mask, gate, wb, shift, d, v, part[0], part[1])
    s = _reduce(part, c)
    return d, v, s[0], s[1]


def norm_drop_res(v, mask, gate, res):
    """Kernel of :func:`norm_drop_res_plain`."""
    if v.device.type == "cpu":
        return norm_drop_res_plain(v, mask, gate, res)
    dt = v.dtype
    n, c = v.shape
    _validate(v, c)
    _check_all(v.device, dt, v=(v, None, (n, c)), mask=(mask, None, (n, c)),
               gate=(gate, None, (3, c)), res=(res, None, (n, c)))
    out = torch.empty_like(v)
    _call("norm_drop_res", "vp3d_tb_norm_drop_res", _DTYPE_CODE[dt], n, c, v, mask, gate,
          res, out)
    return out


def relu_mask_bn_sums(g, z, mask, stat, gate):
    """Kernel of :func:`relu_mask_bn_sums_plain`."""
    if g.device.type == "cpu":
        return relu_mask_bn_sums_plain(g, z, mask, stat, gate)
    dt = g.dtype
    n, c = g.shape
    _validate(g, c)
    _check_all(g.device, dt, g=(g, None, (n, c)), z=(z, None, (n, c)),
               mask=(mask, None, (n, c)), stat=(stat, torch.float32, (2, c)),
               gate=(gate, None, (3, c)))
    gz = torch.empty_like(g)
    part = _partials(1, n, c, g.device)
    _call("relu_mask_bn_sums", "vp3d_tb_relu_mask_bn_sums", _DTYPE_CODE[dt], n, c, g, z,
          mask, stat, gate, gz, part[0], part[1])
    s = _reduce(part, c)
    return gz, s[0], s[1]


def dz_matmul_dd(gz, z, coef, wb):
    """Kernel of :func:`dz_matmul_dd_plain`."""
    if gz.device.type == "cpu":
        return dz_matmul_dd_plain(gz, z, coef, wb)
    dt = gz.dtype
    n, c = gz.shape
    _validate(gz, c)
    _check_all(gz.device, dt, gz=(gz, None, (n, c)), z=(z, None, (n, c)),
               coef=(coef, torch.float32, (5, c)), wb=(wb, None, (c, c)))
    dz = torch.empty_like(gz)
    dd = torch.empty_like(gz)
    _call("dz_matmul_dd", "vp3d_tb_dz_matmul_dd", _DTYPE_CODE[dt], n, c, gz, z, coef,
          wb.t().contiguous(), dz, dd)
    return dz, dd


# The 128 x 128-tile SGEMMs' geometry (csrc/sgemm_tile.cuh): DW_TILE x DW_TILE output
# tiles per CUDA block, slabs of DW_ROWS rows of the summed dimension, and
# DW_BLOCKS_PER_SM CUDA blocks resident per SM.
DW_TILE, DW_ROWS, DW_BLOCKS_PER_SM = 128, 32, 2


def dw_gemm_plan(n: int, c: int, sms: int = 132):
    """The row slices of dw_gemm's split over n: ``[(start, stop), ...]`` in
    order, each a whole number of DW_ROWS slabs but the last, together [0, n).

    C = 1,024 has only 64 output tiles for the card's ``sms`` SMs, so the rows
    are split into as many slices as one wave of resident CUDA blocks holds
    (``DW_BLOCKS_PER_SM * sms // tiles``, 4 at C = 1,024 on 132 SMs), and never
    more slices than slabs."""
    slabs = -(-n // DW_ROWS)
    tiles = (-(-c // DW_TILE)) ** 2
    want = max(1, min(slabs, DW_BLOCKS_PER_SM * sms // tiles))
    rows = -(-slabs // want) * DW_ROWS
    return [(s, min(n, s + rows)) for s in range(0, n, rows)]


# tap_gemm_plan's cost model of a tap GEMM on the card: each SM works through its
# share of the CUDA blocks at TAP_SM_FLOPS (45 TFLOP/s over 132 SMs, the kernel's
# rate at full size); a split adds its float32 partials' write and read-back at
# SPLIT_BYTES_PER_S and a second launch.  Fitted to the slice sweeps of both
# kernels at n = 1,024 to 27,648 on an H100 (PERF.md, section 6).
TAP_SM_FLOPS = 45e12 / 132
SPLIT_BYTES_PER_S, SPLIT_LAUNCH_S = 3e12, 1e-5
TAP_MAX_SLICES = 8


@functools.lru_cache(maxsize=None)
def tap_gemm_plan(m: int, k: int, n: int, sms: int = 132):
    """The slices ``((start, stop), ...)`` of the summed dimension of a tap GEMM
    (m x k) @ (k x n), the products of conv_stats and du_dtaps_res: in order,
    each a whole number of DW_ROWS slabs but the last, together [0, k).

    The count (at most TAP_MAX_SLICES, the smallest of equals) is the one the
    cost model above puts first: ceil(blocks / sms) blocks of the slice's work
    per SM, plus the split's partials.  Shorter blocks even out the SMs' shares
    where the tiles leave a ragged last round; at C = 1,024 on 132 SMs
    conv_stats splits in 2 at n <= 9,216 and du_dtaps_res at n = 1,024."""
    tiles = -(-m // DW_TILE) * -(-n // DW_TILE)
    slabs = -(-k // DW_ROWS)

    def plan(s):
        rows = -(-slabs // s) * DW_ROWS
        return tuple((a, min(k, a + rows)) for a in range(0, k, rows))

    def cost(s):
        slices = plan(s)
        block = 2 * DW_TILE ** 2 * slices[0][1] / TAP_SM_FLOPS
        t = -(-tiles * len(slices) // sms) * block
        if len(slices) > 1:
            t += len(slices) * m * n * 8 / SPLIT_BYTES_PER_S + SPLIT_LAUNCH_S
        return t

    return plan(min(range(1, min(slabs, TAP_MAX_SLICES) + 1), key=lambda s: (cost(s), s)))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split_scratch(plan, m: int, n: int, like):
    """The float32 (slices, m, n) products of a split tap GEMM, or None."""
    if len(plan) == 1:
        return None
    return torch.empty((len(plan), m, n), dtype=torch.float32, device=like.device)


def dw_gemm(a, b):
    """Kernel of :func:`dw_gemm_plain`: one launch of the tiled GEMM over the
    :func:`dw_gemm_plan` slices and, with more than one slice, one of their
    in-order sum."""
    if a.device.type == "cpu":
        return dw_gemm_plain(a, b)
    dt = a.dtype
    n, c = a.shape
    _validate(a, c)
    for name, t in (("a", a), ("b", b)):  # whole 4-element cp.async copies
        _check(name, t, a.device, dt, (n, c), align=4 * a.element_size())
    plan = dw_gemm_plan(n, c, _sms(a.device))
    dw = torch.empty((c, c), dtype=torch.float32, device=a.device)
    part = (None if len(plan) == 1 else
            torch.empty((len(plan), c, c), dtype=torch.float32, device=a.device))
    _call("dw_gemm", "vp3d_tb_dw_gemm", _DTYPE_CODE[dt], n, c, len(plan), plan[0][1], a, b,
          part, dw)
    return dw


def du_dtaps_res(ga, u, g, coef, wa, *, center: int):
    """Kernel of :func:`du_dtaps_res_plain`: an elementwise launch for du, then
    the tap GEMM ``du (n, C) @ Wt (C, fw C)`` with ``Wt[o, j C + i] = wa[j][i, o]``
    over the :func:`tap_gemm_plan` slices, g added to the center tap."""
    if ga.device.type == "cpu":
        return du_dtaps_res_plain(ga, u, g, coef, wa, center=center)
    dt = ga.dtype
    n, c = ga.shape
    _validate(ga, c, row_tile=False)
    fw = wa.shape[0]
    _check_all(ga.device, dt, ga=(ga, None, (n, c)), u=(u, None, (n, c)),
               g=(g, None, (n, c)), coef=(coef, torch.float32, (5, c)),
               wa=(wa, None, (fw, c, c)))
    if not 0 <= center < fw:
        raise ValueError(f"center tap {center} out of range for {fw} taps")
    plan = tap_gemm_plan(n, c, fw * c, _sms(ga.device))
    du = torch.empty_like(ga)
    dx3 = torch.empty((n, fw, c), dtype=dt, device=ga.device)
    _call("du_dtaps_res", "vp3d_tb_du_dtaps_res", _DTYPE_CODE[dt], n, c, fw, center,
          len(plan), plan[0][1], ga, u, g, coef,
          wa.permute(2, 0, 1).reshape(c, fw * c).contiguous(),
          du, dx3, _split_scratch(plan, n, fw * c, ga))
    return du, dx3


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def _finalize_stats(s1, s2, n: int, shift):
    """Biased batch mean and variance from the shifted one-pass sums."""
    m1 = s1 / n
    return shift + m1, torch.clamp(s2 / n - m1 * m1, min=0.0)


def _affine_consts(mean, var, scale, bias, dtype):
    """(3, C) ``[mean, inv * scale, bias]`` in the activation dtype: the
    constants of the forward's BatchNorm affine, which the backward gate reuses."""
    inv = torch.rsqrt(var + BN_EPS) * scale
    return torch.stack([mean, inv, bias]).to(dtype)


def _bwd_consts(mean, var, scale, s1, s2, n: int):
    """(5, C) float32 ``[inv * scale, s1/n, s2/n, inv, mean]``."""
    inv = torch.rsqrt(var + BN_EPS)
    return torch.stack([inv * scale, s1 / n, s2 / n, inv, mean])


_KERNELS = {"conv_stats": conv_stats, "norm_drop_matmul_stats": norm_drop_matmul_stats,
            "norm_drop_res": norm_drop_res, "relu_mask_bn_sums": relu_mask_bn_sums,
            "dz_matmul_dd": dz_matmul_dd, "dw_gemm": dw_gemm,
            "du_dtaps_res": du_dtaps_res}
_PLAIN = {"conv_stats": conv_stats_plain,
          "norm_drop_matmul_stats": norm_drop_matmul_stats_plain,
          "norm_drop_res": norm_drop_res_plain, "relu_mask_bn_sums": relu_mask_bn_sums_plain,
          "dz_matmul_dd": dz_matmul_dd_plain, "dw_gemm": dw_gemm_plain,
          "du_dtaps_res": du_dtaps_res_plain}


class FusedTrainBlock(torch.autograd.Function):
    """One strided residual block in training mode, as the JAX
    ``fused_train_block`` (``ops/pallas/train_block.py:282``).

    ``apply(x, wa, wb, sa, ba, sb, bb, mask_a, mask_b, shift_a, shift_b, center,
    fw, plain)``:
      x: (B, T, C), T divisible by fw, float32 or bfloat16.
      wa: (fw, C, C), wb: (C, C) in x's dtype.
      sa/ba/sb/bb: (C,) float32 BatchNorm scale and bias.
      mask_a/mask_b: (B, T/fw, C) pre-scaled dropout masks in x's dtype, or None.
      shift_a/shift_b: (C,) float32 centring points of the batch statistics (the
        running means); no gradient.
      center: the residual tap, fw: the filter width.
      plain: run the plain versions on any device (the reference a CUDA run is
        held against); otherwise the kernels on a CUDA tensor.

    Returns (out (B, T/fw, C), mean_a, var_a, mean_b, var_b): the biased batch
    statistics carry no gradient.
    """

    @staticmethod
    def forward(ctx, x, wa, wb, sa, ba, sb, bb, mask_a, mask_b, shift_a, shift_b,
                center, fw, plain):
        ops = _PLAIN if plain else _KERNELS
        b, t, c = x.shape
        n = b * (t // fw)
        dt = x.dtype
        x3 = x.reshape(n, fw, c)
        ma = None if mask_a is None else mask_a.reshape(n, c)
        mb = None if mask_b is None else mask_b.reshape(n, c)
        u, res, s1a, s2a = ops["conv_stats"](x3, wa, shift_a, center=center)
        mean_a, var_a = _finalize_stats(s1a, s2a, n, shift_a)
        gate_a = _affine_consts(mean_a, var_a, sa, ba, dt)
        d, v, s1b, s2b = ops["norm_drop_matmul_stats"](u, ma, gate_a, wb, shift_b)
        mean_b, var_b = _finalize_stats(s1b, s2b, n, shift_b)
        gate_b = _affine_consts(mean_b, var_b, sb, bb, dt)
        out = ops["norm_drop_res"](v, mb, gate_b, res)
        ctx.save_for_backward(x3, wa, wb, sa, sb, ma, mb, u, d, v, mean_a, var_a,
                              mean_b, var_b, gate_a, gate_b)
        ctx.center, ctx.ops = center, ops
        ctx.mark_non_differentiable(mean_a, var_a, mean_b, var_b)
        return out.reshape(b, t // fw, c), mean_a, var_a, mean_b, var_b

    @staticmethod
    def backward(ctx, g, *_stats_grads):
        (x3, wa, wb, sa, sb, ma, mb, u, d, v, mean_a, var_a, mean_b, var_b, gate_a,
         gate_b) = ctx.saved_tensors
        ops = ctx.ops
        n, fw, c = x3.shape
        g2 = g.reshape(n, c).to(x3.dtype).contiguous()

        def stat(mean, var):
            return torch.stack([mean, torch.rsqrt(var + BN_EPS)])

        gz, dbb, dsb = ops["relu_mask_bn_sums"](g2, v, mb, stat(mean_b, var_b), gate_b)
        dz, dd = ops["dz_matmul_dd"](gz, v, _bwd_consts(mean_b, var_b, sb, dbb, dsb, n),
                                     wb)
        dwb = ops["dw_gemm"](d, dz)
        ga, dba, dsa = ops["relu_mask_bn_sums"](dd, u, ma, stat(mean_a, var_a), gate_a)
        du, dx3 = ops["du_dtaps_res"](ga, u, g2,
                                      _bwd_consts(mean_a, var_a, sa, dba, dsa, n), wa,
                                      center=ctx.center)
        # The weight gradient over the batch: one large plain matmul.
        dwa = (x3.reshape(n, fw * c).float().t() @ du.float()).reshape(fw, c, c)
        return (dx3.reshape(g.shape[0], -1, c), dwa.to(wa.dtype), dwb.to(wb.dtype),
                dsa, dba, dsb, dbb, None, None, None, None, None, None, None)


def fused_train_block(x, wa, wb, sa, ba, sb, bb, mask_a, mask_b, shift_a, shift_b, *,
                      center: int, fw: int, plain: bool = False):
    """:class:`FusedTrainBlock` applied: (out, mean_a, var_a, mean_b, var_b)."""
    return FusedTrainBlock.apply(x, wa, wb, sa, ba, sb, bb, mask_a, mask_b, shift_a,
                                 shift_b, center, fw, plain)
