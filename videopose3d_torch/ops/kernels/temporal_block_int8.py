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
``(k, C_in, C_out)`` weights.  The kernels' weight packing
(:func:`pack_int8_step`, shared with the fused int8 streaming step) is made once,
when a :class:`Int8Block` is built.

Any width: nothing is held per channel in shared memory; a CUDA stage takes a
multiple of 16 channels, and ``models/temporal.forward_dilated_int8`` pads other
widths with zero channels once (:func:`channel_padded`).

Dispatch: a tensor on the CPU takes the ``*_plain`` version; a CUDA tensor
launches the kernel (``csrc/temporal_block_int8.cu``) or raises.  ``LAUNCHES``
counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional

import torch

from videopose3d_torch.models.temporal import _channels_last, _fold, receptive_field
from videopose3d_torch.ops.kernels.build import check, launch, sm_count
from videopose3d_torch.ops.kernels.temporal_block import _geometry, k3_plan, pad, whole_words
from videopose3d_torch.ops.kernels.train_block import (DW_BLOCKS_PER_SM, DW_TILE,
                                                       TAP_MAX_SLICES)

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


def pack_int8_step(w):
    """(K, N) int8 -> (ceil32(K) / 4, ceil8(N)) int32 whose bytes (g, n) are
    ``w[4g : 4g+4, n]``, zero past K and N: the int8 kernels' weight layout (an
    m16n8k32 B fragment register holds 4 consecutive K values of one column), of
    the stages here and of the fused streaming step."""
    k, n = w.shape
    kp, np_ = -(-k // 32) * 32, -(-n // 8) * 8
    padded = torch.zeros((kp, np_), dtype=torch.int8, device=w.device)
    padded[:k, :n] = w
    return padded.reshape(kp // 4, 4, np_).permute(0, 2, 1).contiguous().view(
        torch.int32).reshape(kp // 4, np_)


@dataclasses.dataclass
class Int8Block:
    """One residual block of the int8 model: int8 weights in the JAX layout and
    the folded f32 epilogue vectors; ``pa``/``pb`` are :func:`pack_int8_step` of
    each tap of ``wq_a`` and of ``wq_b``, made once, the int8 kernels' layout."""

    wq_a: torch.Tensor      # (k, C, C) int8
    wq_b: torch.Tensor      # (C, C) int8
    A1: torch.Tensor        # (C,) float32
    B1: torch.Tensor
    A2: torch.Tensor
    B2: torch.Tensor
    R: torch.Tensor
    pa: torch.Tensor = dataclasses.field(init=False, repr=False)
    pb: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.pa = torch.stack([pack_int8_step(w) for w in self.wq_a])
        self.pb = pack_int8_step(self.wq_b)


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
    # shrink_w and shrink_b padded to whole 16-byte words of outputs (shrink_operands).
    shrink_words: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)


def quantized_on(q: QuantizedModel, device) -> QuantizedModel:
    """``q`` on ``device`` (the int8 kernels' weight packing is rebuilt there)."""
    to = lambda t: t.to(device)
    return QuantizedModel(
        expand_w=to(q.expand_w), expand_scale=to(q.expand_scale),
        expand_shift=to(q.expand_shift),
        blocks=[Int8Block(to(b.wq_a), to(b.wq_b), to(b.A1), to(b.B1), to(b.A2), to(b.B2),
                          to(b.R)) for b in q.blocks],
        shrink_w=to(q.shrink_w), shrink_b=to(q.shrink_b))


# The stage kernels take a multiple of CHANNEL_MULTIPLE channels (their int8 rows are
# copied in 16-byte words).
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


def shrink_operands(q: QuantizedModel):
    """``q``'s (C, J) shrink weights and (J,) bias zero-padded to J a whole number
    of 16-byte bf16 words, as the shrink stage's kernel takes them (its projection
    copies rows in such words): made once and kept on ``q``.  The padded outputs
    are bias 0 plus 0."""
    if q.shrink_words is None:
        c, j3 = q.shrink_w.shape
        jp = whole_words(j3, torch.bfloat16)
        q.shrink_words = (pad(q.shrink_w, c, jp).contiguous(), pad(q.shrink_b, jp).contiguous())
    return q.shrink_words


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


# The stage's chain (csrc/temporal_block_int8.cu): accshift windows of SLACK rows
# past T_out per batch row, row maxima per TILE columns.
SLACK, TILE = ACCSHIFT_ALIGN, 128
# The workspace parts of a stage, in the order of vp3d_int8_block's ``work``.
_WORK = ("e", "shifted", "real", "rmax", "rs", "hq", "part", "y", "fpart")


def _shifted_taps(n_taps: int, dilation: int, accshift: bool) -> int:
    """Taps the accshift mode multiplies over aligned windows of their own."""
    return sum(1 for j in range(n_taps) if accshift and (j * dilation) % ACCSHIFT_ALIGN)


def int8_gemms(kind: str, batch: int, t_out: int, c: int, *, n_taps: int = 3,
               dilation: int = 1, accshift: bool = False, j3: int = 0):
    """The (m, k, n, dtype) of each GEMM the ``kind`` stage's chain runs, in order:
    (accshift) the unaligned taps' over their windows, split at the tap boundaries;
    the aligned taps', the 1x1's and (shrink) the projection's."""
    m = batch * t_out
    shifted = _shifted_taps(n_taps, dilation, accshift)
    gemms = [(batch * (t_out + SLACK), shifted * c, c, torch.int8)] if shifted else []
    gemms += [(m, (n_taps - shifted) * c, c, torch.int8), (m, c, c, torch.int8)]
    if kind == "int8_shrink":
        gemms.append((m, c, j3, torch.bfloat16))
    return gemms


# Summed columns per K tile of the int8 GEMMs (a slice is a whole number of them).
INT8_SLAB = 64
# The int8 GEMMs' cost of one more slice, in waves of resident CUDA blocks of the
# whole summed dimension: fitted to kernel_ab.py's int8 sweep on an H100 (PERF.md),
# where 2 slices beat 1 and 3 at both the tap GEMM (K = 3,072) and the 1x1 (1,024)
# of every stage whose tiles spill past one wave.
INT8_SPLIT_WAVES = 0.25


def int8_plan(m: int, k: int, n: int, sms: int = 132):
    """The slices ``((start, stop), ...)`` of the summed dimension of an int8 stage
    GEMM (m x k) @ (k x n) on ``sms`` SMs.  It counts waves: with s slices, the
    waves of DW_BLOCKS_PER_SM resident 128 x 128 tiles per SM that the tiles'
    slices take, each 1/s of the summed dimension long, plus INT8_SPLIT_WAVES per
    slice past the first.  At B = 2, T = 2,242, C = 1,024 on 132 SMs (4,468 /
    4,432 / 4,324 rows: 280 / 280 / 272 tiles on 264 resident blocks) both the
    tap GEMM and the 1x1 split in 2; the shrink stage's 256 tiles stay whole."""
    tiles = -(-m // DW_TILE) * -(-n // DW_TILE)
    slabs = -(-k // INT8_SLAB)

    def plan(s):
        rows = -(-slabs // s) * INT8_SLAB
        return tuple((a, min(k, a + rows)) for a in range(0, k, rows))

    def waves(s):
        n_slices = len(plan(s))
        return (-(-tiles * n_slices // (DW_BLOCKS_PER_SM * sms)) / n_slices
                + INT8_SPLIT_WAVES * (n_slices - 1))

    return plan(min(range(1, min(slabs, TAP_MAX_SLICES) + 1), key=lambda s: (waves(s), s)))


def stage_plan(m, k, n, sms, dtype):
    """A chain GEMM's slices: the int8 GEMMs' :func:`int8_plan`, the bf16
    projection's ``temporal_block.k3_plan``."""
    return int8_plan(m, k, n, sms) if dtype == torch.int8 else k3_plan(m, k, n, sms, dtype)


@functools.lru_cache(maxsize=None)
def _layout(kind, accshift, batch, t_in, t_out, c, n_taps, dilation, j3, sms):
    """What a stage's launch takes besides its operands, once per shape: the summed
    columns per slice of the tap GEMM, the 1x1 and the projection (``stage_plan``, as a
    C int array; the accshift taps' GEMM is split at the tap boundaries), the int32
    and float32 split partials' sizes, and its workspace: the bytes and each part's
    offset in them (256-byte aligned; None where the stage has no such part)."""
    shifted = _shifted_taps(n_taps, dilation, accshift)
    gemms = int8_gemms(kind, batch, t_out, c, n_taps=n_taps, dilation=dilation,
                       accshift=accshift, j3=j3)[1 if shifted else 0:]
    plans = [stage_plan(m, k, n, sms, dt) for m, k, n, dt in gemms]
    k_slices = (ctypes.c_int * 3)(*[plan[0][1] for plan in plans] + [0] * (3 - len(plans)))
    split = [len(plan) * m * n if len(plan) > 1 else 0
             for plan, (m, _, n, _) in zip(plans, gemms)]
    part_ints, fpart = max(split[:2]), sum(split[2:])
    m = batch * t_out
    sizes = {"e": batch * t_in * c if kind == "int8_expand" else 0,
             "shifted": 4 * shifted * batch * (t_out + SLACK) * c,
             "real": 4 * m * c, "rmax": 4 * -(-c // TILE) * m, "rs": 4 * m, "hq": m * c,
             "part": 4 * part_ints, "y": 2 * m * c if kind == "int8_shrink" else 0,
             "fpart": 4 * fpart}
    offsets, at = [], 0
    for name in _WORK:
        offsets.append(at if sizes[name] else None)
        at += -(-sizes[name] // 256) * 256
    return k_slices, part_ints, fpart, tuple(offsets), at


def _launch(kind, x, blk: Int8Block, *, t_out, dilation, res_offset, tap_mode,
            w0=None, s0=None, b0=None, ws=None, bs=None, out):
    """Check every operand against the kernels' contract and enqueue the stage's
    chain."""
    _check_mode(tap_mode)
    if x.device.type != "cuda":
        raise ValueError(f"the {kind} kernel runs on CUDA tensors, got {x.device}")
    dev = x.device
    batch, t_in, x_cols = x.shape
    n_taps, c = blk.wq_a.shape[0], blk.wq_a.shape[-1]
    if c % CHANNEL_MULTIPLE:
        raise ValueError(f"channels must be a multiple of {CHANNEL_MULTIPLE}, got {c} "
                         "(forward_dilated_int8 pads other widths)")
    if w0 is not None:
        check("x", x, dev, torch.bfloat16, (batch, t_in, x_cols))
        check("w0", w0, dev, torch.bfloat16, (x_cols, c))
        check("expand_scale", s0, dev, torch.float32, (c,))
        check("expand_shift", b0, dev, torch.float32, (c,))
    else:
        check("x", x, dev, torch.int8, (batch, t_in, c), align=16)
    packed_rows = -(-c // 32) * 8
    check("packed wq_a", blk.pa, dev, torch.int32, (n_taps, packed_rows, c), align=16)
    check("packed wq_b", blk.pb, dev, torch.int32, (packed_rows, c), align=16)
    for name in ("A1", "B1", "A2", "B2", "R"):
        check(name, getattr(blk, name), dev, torch.float32, (c,))
    j3 = 0
    if ws is not None:
        j3 = ws.shape[1]
        if j3 != whole_words(j3, torch.bfloat16):
            raise ValueError(f"w_shrink must have a whole number of 16-byte bf16 words of "
                             f"columns, got {j3} (shrink_operands pads a model's)")
        check("w_shrink", ws, dev, torch.bfloat16, (c, j3), align=16)
        check("b_shrink", bs, dev, torch.float32, (j3,))
        check("out", out, dev, torch.float32, (batch, t_out, j3))
    accshift = int(tap_mode == "accshift")
    k_slices, part_ints, fpart, offsets, size = _layout(
        kind, accshift, batch, t_in, t_out, c, n_taps, dilation, j3, sm_count(dev))
    work = torch.empty(size, dtype=torch.uint8, device=dev)
    base = work.data_ptr()
    ptrs = (ctypes.c_void_p * len(_WORK))(*(None if o is None else base + o
                                            for o in offsets))
    launch("vp3d_int8_block", dev, _VARIANT[kind], accshift, batch, t_in, t_out, c, x,
           x_cols if w0 is not None else 0, w0, s0, b0, blk.pa, blk.A1, blk.B1, n_taps,
           dilation, res_offset, blk.pb, blk.A2, blk.B2, blk.R, ws, bs, j3, ptrs, part_ints,
           fpart, k_slices, out, count=(LAUNCHES, kind + ("_accshift" if accshift else "")))
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
    """Last block + shrink: (B, T, C) int8 -> (B, T - (k-1)*d, J) float32, with
    (C, J) bf16 ``w_shrink`` and (J,) f32 ``b_shrink``; on CUDA, J a whole number
    of 16-byte bf16 words (:func:`shrink_operands`)."""
    if x.device.type == "cpu":
        return int8_shrink_block_plain(x, blk, w_shrink, b_shrink, dilation=dilation,
                                       causal_shift=causal_shift, tap_mode=tap_mode)
    b, t, _ = x.shape
    t_out, off = _geometry(t, blk.wq_a.shape[0], dilation, causal_shift)
    out = torch.empty((b, t_out, w_shrink.shape[1]), dtype=torch.float32, device=x.device)
    return _launch("int8_shrink", x, blk, t_out=t_out, dilation=dilation, res_offset=off,
                   tap_mode=tap_mode, ws=w_shrink, bs=b_shrink, out=out)
