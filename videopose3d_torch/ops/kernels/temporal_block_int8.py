"""w8a8 int8 serving of the dilated model: the quantizer, the three stage kernels
(expand, mid block, shrink) and their plain PyTorch versions.

Counterpart of ``videopose3d_tpu/ops/pallas/temporal_block_int8.py``.

* Weights are symmetric int8 per output channel, with the input stream's static
  per-channel activation scale folded in before quantization.
* The residual stream is non-negative and travels between stages as int8 in
  0..127 with a static per-channel scale calibrated by an f32 forward.
* Inside a block, ``h`` is requantized per row: the row maximum over all C
  channels stretches the row to 0..127, and the row scale factors out of the 1x1
  product, so the consumer multiplies its int32 accumulator rows back by it.

One stage, with ``acc`` exact int32 sums of int8 products:

    real = relu(float(sum_j x[t + j*d] @ Wa_j) * A1 + B1)
    m    = max(max_c real, 1);   hq = round(real * (127 / m))
    y    = relu(float(hq @ Wb) * (m * (1/127)) * A2 + B2)
    out  = float(x[t + off]) * R + y        -> clip(round(out), 0, 127) as int8,
                                               or f32 for the last block

``int8_expand_block`` first computes its int8 input ``e`` from the pre-tapped
bf16 keypoints, and ``int8_shrink_block`` projects the last block's f32 output,
cast to bf16, to J_out*3 coordinates.  Every float step is one IEEE operation
with one rounding, in the order above; the kernels evaluate the same operations
in the same order without contraction, so the int8 streams of kernel and plain
version are equal bit for bit.  The expand's dot of bf16 products is summed in
float64 by both and rounded once to float32 (see ``int8_expand_block_plain``).

Tap modes: ``slice`` reads each tap's rows at their offset; ``accshift`` (the
TPU's realignment experiment, ``tools/exp_realign.py``) computes a tap whose
offset ``j*d`` is not a multiple of 32 over the 32-aligned rows ``rows + 32``
and adds the int32 partials from row ``j*d % 32`` on.  Integer sums commute, so
both modes give equal bits.

Layout at this surface is the JAX package's: channels-last activations and
``(k, C_in, C_out)`` weights.  The kernels' dp4a weight packing is made once,
when a :class:`Int8Block` is built.

Dispatch: a tensor on the CPU takes the ``*_plain`` version; a CUDA tensor
launches the kernel (``csrc/temporal_block_int8.cu``) or raises.  ``LAUNCHES``
counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional

import torch

from videopose3d_torch.models.temporal import _channels_last, _fold, receptive_field
from videopose3d_torch.ops.kernels.temporal_block import (SMEM_OPT_IN, _check, _geometry,
                                                          _load, _ptr)

QMAX = 127.0
# Blocks whose dilation is at least this run the accshift tap mode: the default
# of ``models.temporal.forward_dilated_int8``, read at each call.  Off unless
# asked for: the two modes give equal bits, and accshift only adds work here.
ACCSHIFT_MIN_DILATION = 10 ** 9
ACCSHIFT_ALIGN = 32

# Launches per kernel: one key per stage and tap mode (the template instances of
# csrc/temporal_block_int8.cu).
LAUNCHES = {"int8_expand": 0, "int8_dilated": 0, "int8_shrink": 0,
            "int8_expand_accshift": 0, "int8_dilated_accshift": 0,
            "int8_shrink_accshift": 0}

_VARIANT = {"int8_dilated": 0, "int8_expand": 1, "int8_shrink": 2}
TAP_MODES = ("slice", "accshift")


def _full_div(a, b: float):
    """``a / b`` for a python scalar ``b`` as an IEEE division: torch computes
    ``tensor / scalar`` on CUDA, and ``scalar / tensor`` everywhere, as a
    reciprocal and a multiply."""
    return a / torch.full_like(a, b)


def _rdiv(b: float, a):
    """``b / a`` elementwise as an IEEE division."""
    return torch.full_like(a, b) / a


def _pack_dp4a(w):
    """(K, N) int8 -> (K/4, N) int32 whose bytes are ``w[4g : 4g+4, n]``, the
    operand order of ``__dp4a``; None when K is not a multiple of 4."""
    k, n = w.shape
    if k % 4:
        return None
    groups = w.reshape(k // 4, 4, n).permute(0, 2, 1).contiguous()
    return groups.view(torch.int32).reshape(k // 4, n)


@dataclasses.dataclass
class Int8Block:
    """One residual block of the int8 model: int8 weights in the JAX layout and
    the folded f32 epilogue vectors; ``pa``/``pb`` are the dp4a packing of
    ``wq_a``/``wq_b``."""

    wq_a: torch.Tensor      # (k, C, C) int8
    wq_b: torch.Tensor      # (C, C) int8
    A1: torch.Tensor        # (C,) float32
    B1: torch.Tensor
    A2: torch.Tensor
    B2: torch.Tensor
    R: torch.Tensor
    pa: Optional[torch.Tensor] = dataclasses.field(init=False, repr=False)
    pb: Optional[torch.Tensor] = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        packed = [_pack_dp4a(w) for w in self.wq_a]
        self.pa = None if packed[0] is None else torch.stack(packed)
        self.pb = _pack_dp4a(self.wq_b)


@dataclasses.dataclass
class QuantizedModel:
    """The int8 serving model (the JAX package's quantized pytree)."""

    expand_w: torch.Tensor      # (k0, J_in*F, C) bfloat16
    expand_scale: torch.Tensor  # (C,) float32
    expand_shift: torch.Tensor
    blocks: List[Int8Block]
    shrink_w: torch.Tensor      # (C, J_out*3) bfloat16
    shrink_b: torch.Tensor      # (J_out*3,) float32
    # The model padded to the stage kernels' channel multiple (channel_padded).
    padded: Optional["QuantizedModel"] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)


# The stage kernels take a multiple of CHANNEL_MULTIPLE channels (their int8 rows are
# copied in 16-byte words and their dp4a weights packed in groups of 4 rows).
CHANNEL_MULTIPLE = 16


def pad_channels(q: QuantizedModel, c: int) -> QuantizedModel:
    """``q`` with ``c - C`` zero channels appended: int8 weights 0, the A/B/R
    affines and the expand's scale and shift 0, the shrink's rows 0.  A padded
    channel of e, of every stream and of h is relu(0 * 0 + 0) = 0; it adds exact
    zeros to every int32 sum, leaves each row maximum (floored at 1) as it was, and
    contributes 0 to the shrink, so the poses are those of ``q``, bit for bit."""
    pad = c - q.expand_scale.shape[0]
    last = lambda t: torch.nn.functional.pad(t, (0, pad))
    both = lambda t: torch.nn.functional.pad(t, (0, pad, 0, pad))
    blocks = [Int8Block(both(b.wq_a), both(b.wq_b), *(last(getattr(b, n))
                                                      for n in ("A1", "B1", "A2", "B2", "R")))
              for b in q.blocks]
    return QuantizedModel(last(q.expand_w), last(q.expand_scale), last(q.expand_shift),
                          blocks, torch.nn.functional.pad(q.shrink_w, (0, 0, 0, pad)),
                          q.shrink_b)


def channel_padded(q: QuantizedModel) -> QuantizedModel:
    """``q`` at the next multiple of CHANNEL_MULTIPLE channels: ``q`` itself where
    it is one, else its :func:`pad_channels` form, made once and kept on ``q``."""
    c = q.expand_scale.shape[0]
    if c % CHANNEL_MULTIPLE == 0:
        return q
    if q.padded is None:
        q.padded = pad_channels(q, -(-c // CHANNEL_MULTIPLE) * CHANNEL_MULTIPLE)
    return q.padded


# ---------------------------------------------------------------------------
# Quantizer
# ---------------------------------------------------------------------------


def _per_out_channel_int8(w_eff):
    """Symmetric int8 of (..., C_out) weights, one scale per output channel:
    (int8 weights, (C_out,) float32 dequant scales)."""
    dims = tuple(range(w_eff.ndim - 1))
    absmax = torch.clamp_min(w_eff.abs().amax(dim=dims), 1e-8)
    scale = _full_div(absmax, QMAX)
    q = torch.clamp(torch.round(w_eff / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale.float()


def _conv_f32(x, conv, dilation: int):
    """Valid dilated conv over channels-last x as one float32 matmul over the
    concatenated taps (the JAX package's ``_conv_matmul``)."""
    w = _channels_last(conv, torch.float32)
    k = w.shape[0]
    t_out = x.shape[1] - (k - 1) * dilation
    taps = torch.cat([x[:, j * dilation: j * dilation + t_out] for j in range(k)], dim=-1)
    return taps @ w.reshape(-1, w.shape[-1])


@torch.no_grad()
def calibration_ranges(model, x_calib) -> Dict[str, object]:
    """Per-channel absmax (floored at 1e-6) of every quantization point over a
    float32 eval forward of ``x_calib`` (B, T, J, F): the expand output
    ``"expand"``, and per block the mid activation ``"h"`` and the output
    stream ``"stream"`` (lists).  TF32 is off throughout (on the card it would
    move the ranges by ~1e-3 relative, and every scale with them)."""
    from videopose3d_torch.evaluate import full_float32
    with full_float32():
        return _calibration_ranges(model, x_calib)


def _calibration_ranges(model, x_calib):
    cfg = model.config
    x = x_calib.float().reshape(x_calib.shape[0], x_calib.shape[1], -1)
    n_blocks = len(cfg.filter_widths) - 1

    def absmax(v):
        return torch.clamp_min(v.abs().amax(dim=(0, 1)), 1e-6)

    caps: Dict[str, object] = {"h": [], "stream": []}
    s0, b0 = _fold(model.expand_bn)
    x = torch.relu(_conv_f32(x, model.expand_conv, 1) * s0 + b0)
    caps["expand"] = absmax(x)
    for i in range(n_blocks):
        pad = cfg.pads[i + 1]
        shift = cfg.causal_shifts_dilated[i + 1]
        res = x[:, pad + shift: x.shape[1] - pad + shift]
        s1, b1 = _fold(model.layers_bn[2 * i])
        s2, b2 = _fold(model.layers_bn[2 * i + 1])
        h = torch.relu(_conv_f32(x, model.layers_conv[2 * i], cfg.dilations[i + 1]) * s1
                       + b1)
        caps["h"].append(absmax(h))
        y = torch.relu(_conv_f32(h, model.layers_conv[2 * i + 1], 1) * s2 + b2)
        x = res + y
        caps["stream"].append(absmax(x))
    return caps


def _check_config(cfg):
    if cfg.dense:
        raise ValueError("int8 path does not support dense convolutions")
    if len(cfg.filter_widths) - 1 < 2:
        raise ValueError("int8 path expects at least 2 residual blocks")


@torch.no_grad()
def quantize_from_ranges(cfg, model, caps, *, margin: float = 1.25,
                         floor_frac: float = 0.5) -> QuantizedModel:
    """The int8 model from calibrated ranges ``caps`` (as
    :func:`calibration_ranges` returns them).

    Each per-channel range is floored at ``floor_frac`` times its layer's
    maximum (a channel silent on the calibration data would otherwise get a
    ~1e-6 range whose reciprocal explodes when it fires) and widened by
    ``margin`` (headroom over the calibration set's extremes).
    """
    _check_config(cfg)
    n_blocks = len(cfg.filter_widths) - 1

    def widen(v):
        return torch.maximum(v, floor_frac * v.max()) * margin

    v0 = widen(caps["expand"])
    h_caps = [widen(v) for v in caps["h"]]
    stream_caps = [widen(v) for v in caps["stream"]]

    s0, b0 = _fold(model.expand_bn)
    blocks = []
    v_in = v0
    for i in range(n_blocks):
        s1, b1 = _fold(model.layers_bn[2 * i])
        s2, b2 = _fold(model.layers_bn[2 * i + 1])
        h_max, v_out = h_caps[i], stream_caps[i]
        # Fold the input stream's per-channel dequant into the conv weights,
        # then quantize per output channel.
        w_a = _channels_last(model.layers_conv[2 * i], torch.float32)     # (k, C, C)
        wq_a, wsc_a = _per_out_channel_int8(w_a * _full_div(v_in, QMAX)[None, :, None])
        w_b = _channels_last(model.layers_conv[2 * i + 1], torch.float32)[0]  # (C, C)
        wq_b, wsc_b = _per_out_channel_int8(w_b * _full_div(h_max, QMAX)[:, None])
        a1 = wsc_a * s1 * QMAX / h_max
        b1q = b1 * QMAX / h_max
        if i == n_blocks - 1:
            # The last block keeps f32 outputs for the shrink projection.
            a2, b2q, r = wsc_b * s2, b2, _full_div(v_in, QMAX)
        else:
            a2, b2q, r = wsc_b * s2 * QMAX / v_out, b2 * QMAX / v_out, v_in / v_out
        blocks.append(Int8Block(wq_a.contiguous(), wq_b.contiguous(),
                                *(v.float().contiguous() for v in (a1, b1q, a2, b2q, r))))
        v_in = v_out

    return QuantizedModel(
        expand_w=_channels_last(model.expand_conv, torch.bfloat16),
        expand_scale=(s0 * QMAX / v0).float(),
        expand_shift=(b0 * QMAX / v0).float(),
        blocks=blocks,
        shrink_w=_channels_last(model.shrink, torch.bfloat16)[0],
        shrink_b=model.shrink.bias.detach().float().clone())


def quantize_temporal_model(cfg, model, x_calib, *, margin: float = 1.25,
                            floor_frac: float = 0.5) -> QuantizedModel:
    """Calibrate on ``x_calib`` (B, T, J, F), T >= receptive field, and
    quantize: :func:`calibration_ranges` then :func:`quantize_from_ranges`.
    Coverage matters for trained models: calibrate across several clips of
    the serving distribution (``Evaluator.set_calibration`` takes a list)."""
    _check_config(cfg)
    rf = receptive_field(cfg)
    if x_calib.shape[1] < rf:
        raise ValueError(
            f"calibration input has {x_calib.shape[1]} frames but the model's "
            f"receptive field is {rf}; supply at least one full window")
    return quantize_from_ranges(cfg, model, calibration_ranges(model, x_calib),
                                margin=margin, floor_frac=floor_frac)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _i8mm(a, w):
    """Exact int32 ``a @ w`` of int8 operands.  The products are summed in
    float64, which is exact on every device: |sum| <= K * 127^2 < 2^53."""
    return (a.double() @ w.double()).to(torch.int32)


def _rows(x, start: int, n: int):
    """Rows ``start .. start + n`` of (B, T, C) x, zeros past its end."""
    part = x[:, start: start + n]
    if part.shape[1] < n:
        part = torch.nn.functional.pad(part, (0, 0, 0, n - part.shape[1]))
    return part


def _check_mode(tap_mode):
    if tap_mode not in TAP_MODES:
        raise ValueError(f"unknown tap_mode {tap_mode!r}")


def _tap_sum(x, wq_a, dilation: int, t_out: int, tap_mode: str):
    """int32 ``sum_j x[j*d :][:t_out] @ wq_a[j]``; in accshift mode a tap at an
    unaligned offset is summed over the aligned window and sliced after."""
    acc = None
    for j in range(wq_a.shape[0]):
        start = j * dilation
        off = start % ACCSHIFT_ALIGN
        if tap_mode == "slice" or off == 0:
            p = _i8mm(x[:, start: start + t_out], wq_a[j])
        else:
            p = _i8mm(_rows(x, start - off, t_out + ACCSHIFT_ALIGN), wq_a[j])
            p = p[:, off: off + t_out]
        acc = p if acc is None else acc + p
    return acc


def _residual(x, offset: int, t_out: int, tap_mode: str):
    """The residual rows ``x[offset :][:t_out]`` as float32; accshift converts
    the aligned window and slices after (the convert is elementwise)."""
    off = offset % ACCSHIFT_ALIGN
    if tap_mode == "slice" or off == 0:
        return x[:, offset: offset + t_out].float()
    return _rows(x, offset - off, t_out + ACCSHIFT_ALIGN).float()[:, off: off + t_out]


def _block_body(x, blk: Int8Block, dilation: int, causal_shift: int, tap_mode: str):
    """The block's float32 output before the final rounding, (B, T_out, C)."""
    _check_mode(tap_mode)
    t_out, off = _geometry(x.shape[1], blk.wq_a.shape[0], dilation, causal_shift)
    acc = _tap_sum(x, blk.wq_a, dilation, t_out, tap_mode)
    real = torch.relu(acc.float() * blk.A1 + blk.B1)
    rowmax = torch.clamp_min(real.amax(dim=-1, keepdim=True), 1.0)
    hq = torch.round(real * _rdiv(QMAX, rowmax)).to(torch.int8)
    y = torch.relu(_i8mm(hq, blk.wq_b).float() * (rowmax * (1.0 / QMAX)) * blk.A2
                   + blk.B2)
    return _residual(x, off, t_out, tap_mode) * blk.R + y


def _to_stream(v):
    return torch.clamp(torch.round(v), 0.0, QMAX).to(torch.int8)


def int8_dilated_block_plain(x, blk: Int8Block, *, dilation: int, causal_shift: int = 0,
                             tap_mode: str = "slice"):
    """One mid block: (B, T, C) int8 -> (B, T - (k-1)*d, C) int8."""
    return _to_stream(_block_body(x, blk, dilation, causal_shift, tap_mode))


def int8_expand_block_plain(x_taps, w0, scale, shift, blk: Int8Block, *, dilation: int,
                            causal_shift: int = 0, tap_mode: str = "slice"):
    """Expand + block 0: (B, T, K) pre-tapped keypoints -> (B, T - (k-1)*d, C) int8.

    ``x_taps`` is cast to bf16 and multiplied by the (K, C) bf16 ``w0``; the
    bf16 products are exact and their sum is taken in float64 and rounded once
    to float32, so kernel and plain version agree on ``e`` but where the exact
    sum lies within ~1e-16 relative of a float32 rounding midpoint.  (Two
    float32 sums in different orders would flip the rounding of ``e`` on ~1e-4
    of its elements, and each flip moves block 0's per-row requantization.)
    Then ``e = clip(round(relu(acc * scale + shift)), 0, 127)``.
    """
    eacc = (x_taps.to(torch.bfloat16).double() @ w0.double()).float()
    e = _to_stream(torch.relu(eacc * scale + shift))
    return int8_dilated_block_plain(e, blk, dilation=dilation, causal_shift=causal_shift,
                                    tap_mode=tap_mode)


def int8_shrink_block_plain(x, blk: Int8Block, w_shrink, b_shrink, *, dilation: int,
                            causal_shift: int = 0, tap_mode: str = "slice"):
    """Last block + shrink: (B, T, C) int8 -> (B, T - (k-1)*d, J_out*3) float32;
    the block's f32 output is cast to bf16 for the (C, J_out*3) bf16 projection,
    summed in float32, plus the bias."""
    out = _block_body(x, blk, dilation, causal_shift, tap_mode)
    return out.to(torch.bfloat16).float() @ w_shrink.float() + b_shrink


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


# The stage kernels' geometry (csrc/temporal_block_int8.cu, csrc/int8_gemm.cuh): TM
# output rows per CUDA block, WARPS warps, SLACK rows of accshift window slack.
TM, WARPS, SLACK = 16, 8, ACCSHIFT_ALIGN


def stage_smem_bytes(kind: str, c: int, *, k_in: int = 0, span: int = 0,
                     accshift: bool = False) -> int:
    """Shared memory of one CUDA block of the ``kind`` stage at c channels
    (``vp3d_i8_smem_bytes``): the expand's raw input rows (float32, k_in columns
    padded to 4) and e (int8) over every row its taps (reach ``span``) and
    residual read, or the other stages' staged tap rows; then real (float32), hq
    (int8), the row scales and the per-warp row maxima."""
    a16 = lambda b: (b + 15) & ~15
    slack = SLACK if accshift else 0
    if kind == "int8_expand":
        rows = -(-(TM + span + slack) // TM) * TM
        staged = a16(4 * rows * ((k_in + 3) & ~3)) + a16(rows * c)
    else:
        staged = a16((TM + slack) * c)
    return staged + 4 * TM * c + a16(TM * c) + 4 * (3 + WARPS) * TM


def channel_limit_error(c: int, widths, *, c_in: int,
                        accshift_min_d: int = ACCSHIFT_MIN_DILATION):
    """Why the int8 stage kernels (``--serving-engine int8`` on CUDA) cannot serve
    the model of filter ``widths`` at ``c`` channels over ``c_in`` keypoint
    columns, or None; known without the card.  ``forward_dilated_int8`` pads the
    model to a multiple of CHANNEL_MULTIPLE channels, and at that width each
    stage's CUDA block must fit in shared memory: the expand (pre-tapped input of
    ``widths[0] * c_in`` columns) with block 0, the mid blocks, and the last block
    with the shrink, at the tap mode ``forward_dilated_int8`` gives each."""
    engine = "the int8 stage kernels (--serving-engine int8 on CUDA)"
    cp = -(-c // CHANNEL_MULTIPLE) * CHANNEL_MULTIPLE
    n_blocks, d = len(widths) - 1, 1
    for i in range(n_blocks):
        d *= widths[i]
        kind = ("int8_expand" if i == 0 else "int8_shrink" if i == n_blocks - 1
                else "int8_dilated")
        smem = stage_smem_bytes(kind, cp, k_in=widths[0] * c_in if i == 0 else 0,
                                span=(widths[i + 1] - 1) * d, accshift=d >= accshift_min_d)
        if smem > SMEM_OPT_IN:
            return (f"{c} channels: {engine}: the {kind} kernel of block {i} needs "
                    f"{smem} bytes of shared memory; at most {SMEM_OPT_IN} are "
                    "available; use --serving-engine xla")
    return None


def _launch(kind, x, blk: Int8Block, *, t_out, dilation, res_offset, tap_mode,
            w0=None, s0=None, b0=None, ws=None, bs=None, out):
    """Check every operand against the kernel's contract and launch it."""
    _check_mode(tap_mode)
    if x.device.type != "cuda":
        raise ValueError(f"the {kind} kernel runs on CUDA tensors, got {x.device}")
    dev = x.device
    batch, t_in, x_cols = x.shape
    n_taps, c = blk.wq_a.shape[0], blk.wq_a.shape[-1]
    if c % 16:
        raise ValueError(f"channels must be a multiple of 16, got {c} "
                         "(forward_dilated_int8 pads other widths)")
    if w0 is not None:
        _check("x", x, dev, torch.bfloat16, (batch, t_in, x_cols))
        _check("w0", w0, dev, torch.bfloat16, (x_cols, c))
        _check("expand_scale", s0, dev, torch.float32, (c,))
        _check("expand_shift", b0, dev, torch.float32, (c,))
    else:
        _check("x", x, dev, torch.int8, (batch, t_in, c), align=16)
    _check("packed wq_a", blk.pa, dev, torch.int32, (n_taps, c // 4, c))
    _check("packed wq_b", blk.pb, dev, torch.int32, (c // 4, c))
    for name in ("A1", "B1", "A2", "B2", "R"):
        _check(name, getattr(blk, name), dev, torch.float32, (c,))
    j3 = 0
    if ws is not None:
        j3 = ws.shape[1]
        _check("w_shrink", ws, dev, torch.bfloat16, (c, j3))
        _check("b_shrink", bs, dev, torch.float32, (j3,))
    variant, accshift = _VARIANT[kind], int(tap_mode == "accshift")
    span = (n_taps - 1) * dilation
    k_in = x_cols if w0 is not None else 0
    smem = stage_smem_bytes(kind, c, k_in=k_in, span=span, accshift=bool(accshift))
    if smem > SMEM_OPT_IN:
        raise ValueError(f"the {kind} kernel needs {smem} bytes of shared memory at "
                         f"{c} channels and reach {span}; at most {SMEM_OPT_IN} are "
                         "available")
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.vp3d_int8_block(
            variant, accshift, batch, t_in, t_out, c, _ptr(x), k_in, _ptr(w0), _ptr(s0),
            _ptr(b0), _ptr(blk.pa), _ptr(blk.A1), _ptr(blk.B1), n_taps, dilation,
            res_offset, _ptr(blk.pb), _ptr(blk.A2), _ptr(blk.B2), _ptr(blk.R), _ptr(ws),
            _ptr(bs), j3, _ptr(out), ctypes.c_void_p(stream))
    if code != 0:
        raise RuntimeError(f"the {kind} kernel failed to launch: "
                           f"{lib.vp3d_error_string(code).decode()} ({code})")
    LAUNCHES[kind + ("_accshift" if accshift else "")] += 1
    return out


def int8_dilated_block(x, blk: Int8Block, *, dilation: int, causal_shift: int = 0,
                       tap_mode: str = "slice"):
    """One mid block: (B, T, C) int8 stream -> (B, T - (k-1)*d, C) int8.  The
    residual is read at row offset ``(k-1)*d//2 + causal_shift``."""
    if x.device.type == "cpu":
        return int8_dilated_block_plain(x, blk, dilation=dilation,
                                        causal_shift=causal_shift, tap_mode=tap_mode)
    b, t, c = x.shape
    t_out, off = _geometry(t, blk.wq_a.shape[0], dilation, causal_shift)
    out = torch.empty((b, t_out, c), dtype=torch.int8, device=x.device)
    return _launch("int8_dilated", x, blk, t_out=t_out, dilation=dilation,
                   res_offset=off, tap_mode=tap_mode, out=out)


def int8_expand_block(x_taps, w0, scale, shift, blk: Int8Block, *, dilation: int,
                      causal_shift: int = 0, tap_mode: str = "slice"):
    """Expand + block 0: (B, T, K) pre-tapped keypoints (cast to bf16) and the
    (K, C) bf16 expand weights -> (B, T - (k-1)*d, C) int8 stream."""
    if x_taps.device.type == "cpu":
        return int8_expand_block_plain(x_taps, w0, scale, shift, blk, dilation=dilation,
                                       causal_shift=causal_shift, tap_mode=tap_mode)
    x_taps = x_taps.to(torch.bfloat16).contiguous()
    b, t, _ = x_taps.shape
    c = blk.wq_a.shape[-1]
    t_out, off = _geometry(t, blk.wq_a.shape[0], dilation, causal_shift)
    out = torch.empty((b, t_out, c), dtype=torch.int8, device=x_taps.device)
    return _launch("int8_expand", x_taps, blk, t_out=t_out, dilation=dilation,
                   res_offset=off, tap_mode=tap_mode, w0=w0, s0=scale, b0=shift,
                   out=out)


def int8_shrink_block(x, blk: Int8Block, w_shrink, b_shrink, *, dilation: int,
                      causal_shift: int = 0, tap_mode: str = "slice"):
    """Last block + shrink: (B, T, C) int8 -> (B, T - (k-1)*d, J_out*3) float32,
    with (C, J_out*3) bf16 ``w_shrink`` and (J_out*3,) f32 ``b_shrink``."""
    if x.device.type == "cpu":
        return int8_shrink_block_plain(x, blk, w_shrink, b_shrink, dilation=dilation,
                                       causal_shift=causal_shift, tap_mode=tap_mode)
    b, t, _ = x.shape
    t_out, off = _geometry(t, blk.wq_a.shape[0], dilation, causal_shift)
    out = torch.empty((b, t_out, w_shrink.shape[1]), dtype=torch.float32, device=x.device)
    return _launch("int8_shrink", x, blk, t_out=t_out, dilation=dilation,
                   res_offset=off, tap_mode=tap_mode, ws=w_shrink, bs=b_shrink, out=out)
