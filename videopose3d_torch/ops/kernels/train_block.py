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

and the O(C) statistics glue between them in torch.  ``dWa = x3^T @ du``, which
the JAX package leaves to XLA, is a second ``dw_gemm`` launch (an (fw C, C)
output).  Every product runs on the tensor cores: float32 in 3xTF32 (float32's
accuracy) on Hopper's warpgroup MMAs (``wgmma``), whose B operand a
:func:`tf32_parts` pass first splits K-major, bfloat16 exactly in one TF32 pass on
``mma.sync``; the plans (:func:`tap_gemm_plan`, :func:`dw_gemm_plan`) slice each at
its dtype's rate.

Data parallel (a ``parallel.BatchShard``): the batch statistics are the global
batch's.  The forward sums of ``conv_stats`` and ``norm_drop_matmul_stats`` and
the backward sums of both ``relu_mask_bn_sums`` are all-reduced between the
launches and divided by the global row count; the gradients of the BatchNorm
scale and bias leave as this rank's sums, which the gradient all-reduce adds up.

Dtypes: activations, weights and masks share one dtype (float32 or bfloat16);
BatchNorm parameters, statistics and every sum are float32.  Values are cast at
the points the Pallas bodies cast, and the BatchNorm affine runs in the
activation dtype with the constants the forward used, so the backward ReLU gate
replays the forward's pre-activation exactly.

Dispatch: tensors on the CPU take the plain versions (inside the same
``FusedTrainBlock``, so the CPU tests exercise its backward); CUDA tensors
launch the kernels of ``csrc/train_block.cu`` or raise.  ``LAUNCHES`` counts
kernel launches per kernel, and the float32 GEMMs on warpgroup MMAs
(``k2_wgmma_gemms``), which the profiling counter ``train.k2_wgmma_gemms`` also
counts while a profiler records.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from videopose3d_torch.models.temporal import BN_EPS
from videopose3d_torch.ops.kernels.build import check, launch, sm_count
from videopose3d_torch.parallel import mesh
from videopose3d_torch.profiling import count, span

LAUNCHES = {"conv_stats": 0, "norm_drop_matmul_stats": 0, "norm_drop_res": 0,
            "relu_mask_bn_sums": 0, "dz_matmul_dd": 0, "dw_gemm": 0,
            "du_dtaps_res": 0, "tf32_split": 0, "k2_wgmma_gemms": 0}

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
    """a^T @ b over the rows, float32: (n, m) x (n, C) -> (m, C)."""
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


def channel_limit_error(c: int):
    """Why the train block (``--train-engine pallas`` on CUDA) cannot run at ``c``
    channels, or None: it takes any width, as the JAX package's.  The kernels
    copy rows in 16-byte words (C % 4 == 0) and hold nothing per channel in
    shared memory; :func:`fused_train_block` pads other widths with zero
    channels."""
    if c < 1:
        return f"{c} channels: the train block needs at least one channel"
    return None


def _validate(t, c: int):
    """Device, dtype and width limits of the train-block kernels: whole 16-byte
    rows (C % 4 == 0)."""
    if t.device.type != "cuda":
        raise ValueError(f"the train-block kernels run on CUDA tensors, got {t.device}")
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {t.dtype}: the kernels take float32 or "
                         "bfloat16")
    if c % 4:
        raise ValueError(f"{c} channels: the train-block kernels take a multiple of 4 "
                         "channels (fused_train_block pads other widths)")


def _check_all(device, dt, **operands):
    """Operands as name=(tensor | None, dtype | None for dt, shape)."""
    for name, (t, dtype, shape) in operands.items():
        if t is not None:
            check(name, t, device, dtype or dt, shape)


def _reduce(part, c: int):
    """Sums the (2, n_tiles, C) per-tile partials in tile order -> (2, C)."""
    out = torch.empty((2, c), dtype=torch.float32, device=part.device)
    launch("vp3d_tb_stats_reduce", part.device, part.shape[1], c, part[0], part[1],
           out[0], out[1])
    return out


def _partials(n: int, c: int, device):
    """(2, n_tiles, C) float32 per-tile partial sums of the tap GEMMs' DW_TILE-row
    tiles."""
    return torch.empty((2, -(-n // DW_TILE), c), dtype=torch.float32, device=device)


def conv_stats(x3, wa, shift, *, center: int):
    """Kernel of :func:`conv_stats_plain` (Pallas ``_conv_stats_kernel``): the tap
    GEMM ``x3 (n, fw C) @ wa (fw C, C)`` over the :func:`tap_gemm_plan` slices of
    its summed dimension, then the partial sums' in-order reduction."""
    if x3.device.type == "cpu":
        return conv_stats_plain(x3, wa, shift, center=center)
    n, fw, c = x3.shape
    dt = x3.dtype
    _validate(x3, c)
    align = 4 * x3.element_size()  # whole 4-element rows of 16 (8) bytes
    check("x3", x3, x3.device, dt, (n, fw, c), align=align)
    check("wa", wa, x3.device, dt, (fw, c, c), align=align)
    check("shift", shift, x3.device, torch.float32, (c,))
    if not 0 <= center < fw:
        raise ValueError(f"center tap {center} out of range for {fw} taps")
    plan = tap_gemm_plan(n, fw * c, c, sm_count(x3.device), dt)
    # B = wa (fw C, C); float32 takes it K-major: transposed
    b = (tf32_parts(wa.reshape(fw * c, c), transpose=True) if dt == torch.float32 else
         (wa, None))
    u = torch.empty((n, c), dtype=dt, device=x3.device)
    res = torch.empty_like(u)
    part = _partials(n, c, x3.device)
    launch("vp3d_tb_conv_stats", x3.device, _DTYPE_CODE[dt], n, c, fw, center, len(plan),
           plan[0][1], x3, *b, shift, u, res, part[0], part[1],
           _split_scratch(plan, n, c, u), count=(LAUNCHES, "conv_stats"))
    _count_gemm(dt)
    s = _reduce(part, c)
    return u, res, s[0], s[1]


def norm_drop_matmul_stats(u, mask, gate, wb, shift):
    """Kernel of :func:`norm_drop_matmul_stats_plain` (Pallas
    ``_norm_drop_matmul_stats_kernel``): an elementwise launch for d, then the
    one-tap GEMM ``d (n, C) @ wb (C, C)`` over the :func:`tap_gemm_plan` slices
    of its summed dimension with conv_stats's epilogue, then the partial sums'
    in-order reduction."""
    if u.device.type == "cpu":
        return norm_drop_matmul_stats_plain(u, mask, gate, wb, shift)
    dt = u.dtype
    n, c = u.shape
    _validate(u, c)
    _check_all(u.device, dt, u=(u, None, (n, c)), mask=(mask, None, (n, c)),
               gate=(gate, None, (3, c)), shift=(shift, torch.float32, (c,)))
    check("wb", wb, u.device, dt, (c, c), align=4 * u.element_size())
    plan = tap_gemm_plan(n, c, c, sm_count(u.device), dt)
    b = tf32_parts(wb, transpose=True) if dt == torch.float32 else (wb, None)
    d = torch.empty_like(u)
    v = torch.empty_like(u)
    part = _partials(n, c, u.device)
    launch("vp3d_tb_norm_drop_matmul_stats", u.device, _DTYPE_CODE[dt], n, c, len(plan),
           plan[0][1], u, mask, gate, *b, shift, d, v, part[0], part[1],
           _split_scratch(plan, n, c, u), count=(LAUNCHES, "norm_drop_matmul_stats"))
    _count_gemm(dt)
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
    launch("vp3d_tb_norm_drop_res", v.device, _DTYPE_CODE[dt], n, c, v, mask, gate, res,
           out, count=(LAUNCHES, "norm_drop_res"))
    return out


# relu_mask_bn_sums's geometry (csrc/train_block.cu RS_COLS, RS_SLOTS, RS_UNROLL,
# RS_MAX_CLUSTER): a CUDA block owns a strip of SUM_COLS columns over a slice of the
# rows, reads SUM_SLOTS rows at once and keeps SUM_UNROLL of those reads of g, z and
# the mask in flight; the slices of one strip are one thread block cluster of at
# most SUM_MAX_CLUSTER blocks (past 8, the H100's non-portable sizes), which adds up
# their sums.  SUM_BYTES_IN_FLIGHT is what the whole grid should keep in flight:
# on an H100, half and twice as much ran slower in both dtypes (kernel_ab.py
# --sweep k2ew, PERF.md section 6).
SUM_COLS, SUM_SLOTS, SUM_UNROLL, SUM_MAX_CLUSTER = 32, 16, 4, 16
SUM_BYTES_IN_FLIGHT = 6 << 20


@functools.lru_cache(maxsize=None)
def relu_sums_plan(n: int, c: int, esize: int = 4):
    """The row slices ``((start, stop), ...)`` of relu_mask_bn_sums's clusters for
    ``esize``-byte values: in order, all of one length but the last, together
    [0, n); every column strip runs one CUDA block per slice.

    The slice count (the cluster size) doubles, up to SUM_MAX_CLUSTER, while the
    grid keeps under SUM_BYTES_IN_FLIGHT of loads in flight and every slice keeps
    at least SUM_SLOTS rows: at C = 1,024, 8 slices in float32 and 16 in bf16,
    256 and 512 CUDA blocks at every n of the training step, which covers the
    132 SMs of an H100."""
    strips = -(-c // SUM_COLS)
    block_bytes = SUM_SLOTS * SUM_UNROLL * 3 * SUM_COLS * esize
    k = 1
    while (k < SUM_MAX_CLUSTER and strips * k * block_bytes < SUM_BYTES_IN_FLIGHT
           and n >= 2 * k * SUM_SLOTS):
        k *= 2
    rows = -(-n // k)
    return tuple((a, min(n, a + rows)) for a in range(0, n, rows))


def relu_mask_bn_sums(g, z, mask, stat, gate):
    """Kernel of :func:`relu_mask_bn_sums_plain`: one launch of clusters over the
    :func:`relu_sums_plan` row slices, which writes gz and the finished sums."""
    if g.device.type == "cpu":
        return relu_mask_bn_sums_plain(g, z, mask, stat, gate)
    dt = g.dtype
    n, c = g.shape
    _validate(g, c)
    align = 4 * g.element_size()  # whole 4-element words of 16 (8) bytes
    for name, t, shape in (("g", g, (n, c)), ("z", z, (n, c)), ("mask", mask, (n, c)),
                           ("gate", gate, (3, c))):
        if t is not None:
            check(name, t, g.device, dt, shape, align=align)
    check("stat", stat, g.device, torch.float32, (2, c), align=16)
    plan = relu_sums_plan(n, c, g.element_size())
    gz = torch.empty_like(g)
    sums = torch.empty((2, c), dtype=torch.float32, device=g.device)
    launch("vp3d_tb_relu_mask_bn_sums", g.device, _DTYPE_CODE[dt], n, c, len(plan),
           plan[0][1], g, z, mask, stat, gate, gz, sums,
           count=(LAUNCHES, "relu_mask_bn_sums"))
    return gz, sums[0], sums[1]


def dz_matmul_dd(gz, z, coef, wb):
    """Kernel of :func:`dz_matmul_dd_plain` (the dd half of Pallas
    ``_dz_matmul_dw_kernel``; dWb is :func:`dw_gemm`): an elementwise launch for
    dz, then the one-tap GEMM ``dz (n, C) @ Wb^T (C, C)`` over the
    :func:`tap_gemm_plan` slices."""
    if gz.device.type == "cpu":
        return dz_matmul_dd_plain(gz, z, coef, wb)
    dt = gz.dtype
    n, c = gz.shape
    _validate(gz, c)
    _check_all(gz.device, dt, gz=(gz, None, (n, c)), z=(z, None, (n, c)),
               coef=(coef, torch.float32, (5, c)), wb=(wb, None, (c, c)))
    plan = tap_gemm_plan(n, c, c, sm_count(gz.device), dt)
    # B = Wb^T: K-major as Wb is; bf16 takes it (k, n) row-major.
    b = tf32_parts(wb, transpose=False) if dt == torch.float32 else (wb.t().contiguous(), None)
    dz = torch.empty_like(gz)
    dd = torch.empty_like(gz)
    launch("vp3d_tb_dz_matmul_dd", gz.device, _DTYPE_CODE[dt], n, c, len(plan), plan[0][1],
           gz, z, coef, *b, dz, dd, _split_scratch(plan, n, c, gz),
           count=(LAUNCHES, "dz_matmul_dd"))
    _count_gemm(dt)
    return dz, dd


# The 128 x 128-tile GEMMs' geometry (csrc/sgemm_tile.cuh, csrc/wgmma_tile.cuh):
# DW_TILE x DW_TILE output tiles per CUDA block, slabs of DW_ROWS rows of the summed
# dimension, and DW_BLOCKS_PER_SM CUDA blocks resident per SM in bf16 (one
# persistent block an SM in float32).
DW_TILE, DW_ROWS, DW_BLOCKS_PER_SM = 128, 32, 2


def dw_gemm_plan(n: int, m: int, c: int, sms: int = 132, dtype=torch.float32):
    """The row slices of dw_gemm's split over n for an (m, c) output in ``dtype``:
    ``((start, stop), ...)`` in order, each a whole number of DW_ROWS slabs but the
    last, together [0, n).

    The same tiles as a tap GEMM's, the rows its summed dimension, so the same
    cost model picks the count (:func:`tap_gemm_plan`): at C = 1,024 on 132 SMs
    dWb's 64 tiles and dWa's 192 (m = 3 C) split in 2 at every n of the step, but
    dWa in float32 at n = 1,024."""
    return tap_gemm_plan(m, n, c, sms, dtype)


# tap_gemm_plan's cost model of a K2 GEMM on the card: each SM works through its
# share of the CUDA blocks at its dtype's rate (K2_SM_FLOPS over 132 SMs: float32's
# 3xTF32 work at 100 TFLOP/s on warpgroup MMAs, bf16 at 52 on mma.sync); a split adds
# its float32 partials' write and read-back at SPLIT_BYTES_PER_S and a second launch.
# Checked against the slice sweeps of the kernels at n = 128 to 27,648 on an H100
# (PERF.md, section 6).
K2_SM_FLOPS = {torch.float32: 100e12 / 132, torch.bfloat16: 52e12 / 132}
SPLIT_BYTES_PER_S, SPLIT_LAUNCH_S = 3e12, 1e-5
TAP_MAX_SLICES = 8


@functools.lru_cache(maxsize=None)
def tap_gemm_plan(m: int, k: int, n: int, sms: int = 132, dtype=torch.float32, *,
                  sm_flops: float | None = None, launch_s: float = SPLIT_LAUNCH_S,
                  one_wave: bool = False):
    """The slices ``((start, stop), ...)`` of the summed dimension of a tap GEMM
    (m x k) @ (k x n) in ``dtype``, the products of conv_stats,
    norm_drop_matmul_stats, dz_matmul_dd and du_dtaps_res: in order, each a whole
    number of DW_ROWS slabs but the last, together [0, k).

    The count (at most TAP_MAX_SLICES, the smallest of equals) is the one the
    cost model above puts first: ceil(blocks / sms) blocks of the slice's work
    per SM, plus the split's partials.  Shorter blocks even out the SMs' shares
    where the tiles leave a ragged last round; at C = 1,024 on 132 SMs conv_stats
    splits in 2 at n <= 9,216 and du_dtaps_res in bf16 at n = 1,024.  The
    evaluation blocks' GEMMs (``temporal_block.k3_plan``) run the mma.sync tile at
    their own rate per SM (``sm_flops``, else the dtype's K2_SM_FLOPS) and cost of
    a second launch (``launch_s``); with ``one_wave``, tiles that one wave of
    DW_BLOCKS_PER_SM resident CUDA blocks per SM holds are split no further than
    it holds."""
    sm_flops = K2_SM_FLOPS[dtype] if sm_flops is None else sm_flops
    tiles = -(-m // DW_TILE) * -(-n // DW_TILE)
    slabs = -(-k // DW_ROWS)

    def plan(s):
        rows = -(-slabs // s) * DW_ROWS
        return tuple((a, min(k, a + rows)) for a in range(0, k, rows))

    def cost(s):
        slices = plan(s)
        if one_wave and tiles <= DW_BLOCKS_PER_SM * sms < tiles * len(slices):
            return float("inf")
        block = 2 * DW_TILE ** 2 * slices[0][1] / sm_flops
        t = -(-tiles * len(slices) // sms) * block
        if len(slices) > 1:
            t += len(slices) * m * n * 8 / SPLIT_BYTES_PER_S + launch_s
        return t

    return plan(min(range(1, min(slabs, TAP_MAX_SLICES) + 1), key=lambda s: (cost(s), s)))


def _count_gemm(dtype) -> None:
    """One K2 GEMM launched: a float32 one, on warpgroup MMAs, counts in LAUNCHES and
    the profiling counter."""
    if dtype == torch.float32:
        LAUNCHES["k2_wgmma_gemms"] += 1
        count("train.k2_wgmma_gemms")


def tf32_parts(src, *, transpose: bool):
    """The float32 GEMMs' B: big = tf32(x) and small = tf32(x - big) (float32, round
    to nearest, ties away) of the float32 matrix ``src`` (rows, cols), one launch of
    ``tf32_split_kernel``; with ``transpose``, transposed into (cols, ld), ld = rows
    rounded up to whole 16-byte words, with zeros past rows; else (rows, cols)."""
    if src.device.type == "cpu":
        return tf32_parts_plain(src, transpose=transpose)
    rows, cols = src.shape
    if transpose:
        ld = -(-rows // 4) * 4
        shape = (cols, ld)
    else:
        ld, shape = cols, (rows, cols)
    big = torch.empty(shape, dtype=torch.float32, device=src.device)
    small = torch.empty_like(big)
    launch("vp3d_tb_tf32_split", src.device, int(transpose), rows, cols, ld,
           src.contiguous(), big, small, count=(LAUNCHES, "tf32_split"))
    return big, small


def tf32_parts_plain(src, *, transpose: bool):
    """Plain version of :func:`tf32_parts`: the same parts by integer arithmetic on
    the float32 bits (add half a TF32 step, clear the 13 low bits)."""
    def rna(x):
        return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    big = rna(src.float())
    small = rna(src.float() - big)
    if not transpose:
        return big, small
    pad = -src.shape[0] % 4
    return tuple(F.pad(t.t(), (0, pad)).contiguous() for t in (big, small))


def _split_scratch(plan, m: int, n: int, like):
    """The float32 (slices, m, n) products of a split tap GEMM, or None."""
    if len(plan) == 1:
        return None
    return torch.empty((len(plan), m, n), dtype=torch.float32, device=like.device)


def dw_gemm(a, b):
    """Kernel of :func:`dw_gemm_plain` (a (n, m), b (n, C), m % 4 == 0): one
    launch of the tiled GEMM (float32: after b's transposed :func:`tf32_parts`)
    over the :func:`dw_gemm_plan` slices and, with more than one slice, one of
    their in-order sum."""
    if a.device.type == "cpu":
        return dw_gemm_plain(a, b)
    dt = a.dtype
    n, m = a.shape
    c = b.shape[-1]
    _validate(a, m)
    _validate(b, c)
    for name, t, shape in (("a", a, (n, m)), ("b", b, (n, c))):  # whole 4-element copies
        check(name, t, a.device, dt, shape, align=4 * a.element_size())
    plan = dw_gemm_plan(n, m, c, sm_count(a.device), dt)
    dw = torch.empty((m, c), dtype=torch.float32, device=a.device)
    part = (None if len(plan) == 1 else
            torch.empty((len(plan), m, c), dtype=torch.float32, device=a.device))
    # float32: b^T K-major, (c, ldb), its rows padded to whole 16-byte words
    bt = tf32_parts(b, transpose=True) if dt == torch.float32 else (b, None)
    launch("vp3d_tb_dw_gemm", a.device, _DTYPE_CODE[dt], n, m, c, len(plan), plan[0][1],
           bt[0].shape[-1], a, *bt, part, dw, count=(LAUNCHES, "dw_gemm"))
    _count_gemm(dt)
    return dw


def du_dtaps_res(ga, u, g, coef, wa, *, center: int):
    """Kernel of :func:`du_dtaps_res_plain`: an elementwise launch for du, then
    the tap GEMM ``du (n, C) @ Wt (C, fw C)`` with ``Wt[o, j C + i] = wa[j][i, o]``
    over the :func:`tap_gemm_plan` slices, g added to the center tap."""
    if ga.device.type == "cpu":
        return du_dtaps_res_plain(ga, u, g, coef, wa, center=center)
    dt = ga.dtype
    n, c = ga.shape
    _validate(ga, c)
    fw = wa.shape[0]
    _check_all(ga.device, dt, ga=(ga, None, (n, c)), u=(u, None, (n, c)),
               g=(g, None, (n, c)), coef=(coef, torch.float32, (5, c)),
               wa=(wa, None, (fw, c, c)))
    if not 0 <= center < fw:
        raise ValueError(f"center tap {center} out of range for {fw} taps")
    plan = tap_gemm_plan(n, c, fw * c, sm_count(ga.device), dt)
    # B = Wt: K-major as wa (fw C, C) is; bf16 takes Wt itself.
    b = (tf32_parts(wa.reshape(fw * c, c), transpose=False) if dt == torch.float32 else
         (wa.permute(2, 0, 1).reshape(c, fw * c).contiguous(), None))
    du = torch.empty_like(ga)
    dx3 = torch.empty((n, fw, c), dtype=dt, device=ga.device)
    launch("vp3d_tb_du_dtaps_res", ga.device, _DTYPE_CODE[dt], n, c, fw, center, len(plan),
           plan[0][1], ga, u, g, coef, *b, du, dx3, _split_scratch(plan, n, fw * c, ga),
           count=(LAUNCHES, "du_dtaps_res"))
    _count_gemm(dt)
    return du, dx3


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def _finalize_stats(s1, s2, n: int, shift):
    """Biased batch mean and variance from the shifted one-pass sums."""
    m1 = s1 / n
    return shift + m1, torch.clamp(s2 / n - m1 * m1, min=0.0)


def _global_sums(s1, s2, shard):
    """The per-channel sums ``(s1, s2)`` over every rank of ``shard`` (one
    all-reduce), or as they are without one."""
    if shard is None:
        return s1, s2
    return tuple(mesh.all_reduce_(torch.stack([s1, s2]), shard.group))


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
    fw, plain, shard)``:
      x: (B, T, C), T divisible by fw, float32 or bfloat16.
      wa: (fw, C, C), wb: (C, C) in x's dtype.
      sa/ba/sb/bb: (C,) float32 BatchNorm scale and bias.
      mask_a/mask_b: (B, T/fw, C) pre-scaled dropout masks in x's dtype, or None.
      shift_a/shift_b: (C,) float32 centring points of the batch statistics (the
        running means); no gradient.
      center: the residual tap, fw: the filter width.
      plain: run the plain versions on any device (the reference a CUDA run is
        held against); otherwise the kernels on a CUDA tensor.
      shard: None, or the ``parallel.BatchShard`` whose rows x holds: the batch
        statistics are then the global batch's.

    Returns (out (B, T/fw, C), mean_a, var_a, mean_b, var_b): the biased batch
    statistics carry no gradient.
    """

    @staticmethod
    def forward(ctx, x, wa, wb, sa, ba, sb, bb, mask_a, mask_b, shift_a, shift_b,
                center, fw, plain, shard=None):
        with span("vp3d.k2.forward"):
            ops = _PLAIN if plain else _KERNELS
            b, t, c = x.shape
            n = b * (t // fw)
            n_stats = n if shard is None else shard.total * (t // fw)
            dt = x.dtype
            x3 = x.reshape(n, fw, c)
            ma = None if mask_a is None else mask_a.reshape(n, c)
            mb = None if mask_b is None else mask_b.reshape(n, c)
            u, res, s1a, s2a = ops["conv_stats"](x3, wa, shift_a, center=center)
            s1a, s2a = _global_sums(s1a, s2a, shard)
            mean_a, var_a = _finalize_stats(s1a, s2a, n_stats, shift_a)
            gate_a = _affine_consts(mean_a, var_a, sa, ba, dt)
            d, v, s1b, s2b = ops["norm_drop_matmul_stats"](u, ma, gate_a, wb, shift_b)
            s1b, s2b = _global_sums(s1b, s2b, shard)
            mean_b, var_b = _finalize_stats(s1b, s2b, n_stats, shift_b)
            gate_b = _affine_consts(mean_b, var_b, sb, bb, dt)
            out = ops["norm_drop_res"](v, mb, gate_b, res)
            ctx.save_for_backward(x3, wa, wb, sa, sb, ma, mb, u, d, v, mean_a, var_a,
                                  mean_b, var_b, gate_a, gate_b)
            ctx.center, ctx.ops, ctx.shard, ctx.n_stats = center, ops, shard, n_stats
            ctx.mark_non_differentiable(mean_a, var_a, mean_b, var_b)
            return out.reshape(b, t // fw, c), mean_a, var_a, mean_b, var_b

    @staticmethod
    def backward(ctx, g, *_stats_grads):
        with span("vp3d.k2.backward"):
            (x3, wa, wb, sa, sb, ma, mb, u, d, v, mean_a, var_a, mean_b, var_b, gate_a,
             gate_b) = ctx.saved_tensors
            ops, shard, n_stats = ctx.ops, ctx.shard, ctx.n_stats
            n, fw, c = x3.shape
            g2 = g.reshape(n, c).to(x3.dtype).contiguous()

            def stat(mean, var):
                return torch.stack([mean, torch.rsqrt(var + BN_EPS)])

            # The BatchNorm input gradients take the global sums; dsb/dbb/dsa/dba
            # stay this rank's, as the gradient all-reduce adds them up.
            gz, dbb, dsb = ops["relu_mask_bn_sums"](g2, v, mb, stat(mean_b, var_b), gate_b)
            consts_b = _bwd_consts(mean_b, var_b, sb, *_global_sums(dbb, dsb, shard), n_stats)
            dz, dd = ops["dz_matmul_dd"](gz, v, consts_b, wb)
            dwb = ops["dw_gemm"](d, dz)
            ga, dba, dsa = ops["relu_mask_bn_sums"](dd, u, ma, stat(mean_a, var_a), gate_a)
            consts_a = _bwd_consts(mean_a, var_a, sa, *_global_sums(dba, dsa, shard), n_stats)
            du, dx3 = ops["du_dtaps_res"](ga, u, g2, consts_a, wa, center=ctx.center)
            dwa = ops["dw_gemm"](x3.reshape(n, fw * c), du).reshape(fw, c, c)
            return (dx3.reshape(g.shape[0], -1, c), dwa.to(wa.dtype), dwb.to(wb.dtype),
                    dsa, dba, dsb, dbb, None, None, None, None, None, None, None, None)


def fused_train_block(x, wa, wb, sa, ba, sb, bb, mask_a, mask_b, shift_a, shift_b, *,
                      center: int, fw: int, plain: bool = False, shard=None):
    """:class:`FusedTrainBlock` applied: (out, mean_a, var_a, mean_b, var_b); with
    a ``shard``, the statistics are the global batch's.

    Any C: where C % 4 != 0 the channel axis is zero-padded to the kernels' next
    multiple of 4 on every device (so the CPU runs this route too), with
    BatchNorm scale 1 and bias 0 on the padded channels.  Those stay exactly 0
    through the block (zero weights, zero statistics), add exact zeros to every
    sum, and are cut from the outputs, so their gradients are dropped."""
    c = x.shape[-1]
    pad = -c % 4
    if not pad:
        return FusedTrainBlock.apply(x, wa, wb, sa, ba, sb, bb, mask_a, mask_b, shift_a,
                                     shift_b, center, fw, plain, shard)
    last = lambda t, value=0.0: None if t is None else F.pad(t, (0, pad), value=value)
    outs = FusedTrainBlock.apply(
        last(x), F.pad(wa, (0, pad, 0, pad)), F.pad(wb, (0, pad, 0, pad)), last(sa, 1.0),
        last(ba), last(sb, 1.0), last(bb), last(mask_a), last(mask_b), last(shift_a),
        last(shift_b), center, fw, plain, shard)
    return tuple(t[..., :c] for t in outs)
