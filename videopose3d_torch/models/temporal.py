"""Dilated temporal convolution model for 2D->3D pose lifting, in PyTorch.

Counterpart of ``videopose3d_tpu/models/temporal.py``.  ``TemporalModel`` is an
``nn.Module`` whose parameter and buffer names are the reference state-dict keys
(``expand_conv.weight``, ``layers_bn.{i}.running_var``, ...), so a ``model_pos``
dict from either package's checkpoints loads with ``load_state_dict(strict=True)``.
Its ``forward`` is the dilated form: input length T, output length
``T - receptive_field + 1``.

``forward_dilated_fused`` is the inference-only form that runs the residual
blocks through the fused kernels of ``ops/kernels/temporal_block.py``, and
``forward_dilated_int8`` the w8a8 int8 serving form through those of
``ops/kernels/temporal_block_int8.py``.
``forward_strided`` is the training form (the reference's
``TemporalModelOptimized1f``): input length = receptive field, one output frame,
strided convolutions as reshape + matmul, train-mode BatchNorm and dropout; its
``pallas`` engine runs the residual blocks through the fused train-block kernels
of ``ops/kernels/train_block.py``.  ``forward_dilated_train`` is the dilated
form in train mode (``--stride > 1``, ``--dense``, ``--disable-optimizations``):
chunks of several output frames, in plain torch.
"""

from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Optional, Tuple

import torch
from torch import nn

from videopose3d_torch.ops.losses import mpjpe_per_sample
from videopose3d_torch.parallel import mesh

BN_EPS = 1e-5  # PyTorch BatchNorm1d default, the JAX package's BN_EPS

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TemporalModelConfig:
    """Static architecture hyperparameters (the JAX package's config, minus its
    training-only knobs)."""

    num_joints_in: int
    in_features: int
    num_joints_out: int
    filter_widths: Tuple[int, ...]
    causal: bool = False
    dropout: float = 0.25
    channels: int = 1024
    dense: bool = False
    # "float32", "bfloat16", or "mixed" (bf16 matmul operands, f32 activations;
    # the fused inference kernels run it as bf16).
    compute_dtype: str = "float32"
    # Engine of the strided train blocks: "xla" is the plain torch block, "pallas"
    # the fused CUDA train-block kernels (the JAX package's names, so one command
    # line runs in both).
    train_engine: str = "xla"

    def __post_init__(self):
        object.__setattr__(self, "filter_widths", tuple(int(f) for f in self.filter_widths))
        for fw in self.filter_widths:
            if fw % 2 == 0:
                raise ValueError("Only odd filter widths are supported")
        if not 0.0 <= self.dropout <= 1.0:
            raise ValueError(f"dropout must be in [0, 1], got {self.dropout}")
        if self.compute_dtype not in ("float32", "bfloat16", "mixed"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.train_engine not in ("xla", "pallas"):
            raise ValueError(f"unknown train_engine {self.train_engine!r}")

    @property
    def matmul_dtype(self) -> torch.dtype:
        """dtype the matmul operands are cast to."""
        return (torch.bfloat16 if self.compute_dtype == "mixed"
                else _DTYPES[self.compute_dtype])

    @property
    def activation_dtype(self) -> torch.dtype:
        """dtype activations are stored in between matmuls ("mixed": float32)."""
        return (torch.float32 if self.compute_dtype == "mixed"
                else _DTYPES[self.compute_dtype])

    @property
    def dilations(self) -> Tuple[int, ...]:
        """dilations[i] = product of filter widths before block i."""
        d = [1]
        for fw in self.filter_widths[:-1]:
            d.append(d[-1] * fw)
        return tuple(d)

    @property
    def pads(self) -> Tuple[int, ...]:
        return tuple((fw - 1) * d // 2 for fw, d in zip(self.filter_widths, self.dilations))

    @property
    def causal_shifts_dilated(self) -> Tuple[int, ...]:
        """Per-block asymmetric shift in input frames (dilated form)."""
        if not self.causal:
            return tuple(0 for _ in self.filter_widths)
        return tuple((fw // 2) * d for fw, d in zip(self.filter_widths, self.dilations))

    @property
    def causal_shifts_strided(self) -> Tuple[int, ...]:
        """Per-block shift in post-stride frames (strided form)."""
        if not self.causal:
            return tuple(0 for _ in self.filter_widths)
        return tuple(fw // 2 for fw in self.filter_widths)


def receptive_field(config: TemporalModelConfig) -> int:
    """Total receptive field in frames: ``1 + 2*sum(pads)``."""
    return 1 + 2 * sum(config.pads)


class TemporalModel(nn.Module):
    """The reference's dilated ``TemporalModel``: expand conv, residual blocks of
    (dilated conv, BN, ReLU, dropout, 1x1 conv, BN, ReLU, dropout), shrink conv.

    Input (B, T, J_in, F) or pre-flattened (B, T, J_in*F); output
    (B, T - receptive_field + 1, J_out, 3).  Weights are float32 and initialised
    by PyTorch's defaults.
    """

    kind = "tcn"

    def __init__(self, config: TemporalModelConfig):
        super().__init__()
        self.config = config
        c = config.channels
        fws = config.filter_widths
        self.expand_conv = nn.Conv1d(config.num_joints_in * config.in_features, c,
                                     fws[0], bias=False)
        self.expand_bn = nn.BatchNorm1d(c, momentum=0.1, eps=BN_EPS)
        layers_conv, layers_bn = [], []
        for i in range(1, len(fws)):
            if config.dense:
                width, dilation = 2 * config.pads[i] + 1, 1
            else:
                width, dilation = fws[i], config.dilations[i]
            layers_conv.append(nn.Conv1d(c, c, width, dilation=dilation, bias=False))
            layers_bn.append(nn.BatchNorm1d(c, momentum=0.1, eps=BN_EPS))
            layers_conv.append(nn.Conv1d(c, c, 1, bias=False))
            layers_bn.append(nn.BatchNorm1d(c, momentum=0.1, eps=BN_EPS))
        self.layers_conv = nn.ModuleList(layers_conv)
        self.layers_bn = nn.ModuleList(layers_bn)
        self.shrink = nn.Conv1d(c, config.num_joints_out * 3, 1)
        self.drop = nn.Dropout(config.dropout)

    def forward(self, x):
        cfg = self.config
        x = _prep_input(cfg, x).permute(0, 2, 1)  # (B, J*F, T)
        x = self.drop(torch.relu(self.expand_bn(self.expand_conv(x))))
        for i in range(len(cfg.filter_widths) - 1):
            pad = cfg.pads[i + 1]
            shift = cfg.causal_shifts_dilated[i + 1]
            res = x[:, :, pad + shift: x.shape[2] - pad + shift]
            y = self.drop(torch.relu(self.layers_bn[2 * i](self.layers_conv[2 * i](x))))
            y = self.drop(torch.relu(
                self.layers_bn[2 * i + 1](self.layers_conv[2 * i + 1](y))))
            x = res + y
        x = self.shrink(x).permute(0, 2, 1)
        return _finish_output(cfg, x)

    def train_forward(self, use_strided: bool):
        """The training forward the trainer calls: the strided form, or the
        dilated one on chunks of several frames."""
        return forward_strided if use_strided else forward_dilated_train

    def per_sample_loss(self, pred, target):
        """(B,) MPJPE of each sample, the reference's training loss."""
        return mpjpe_per_sample(pred, target)


def _prep_input(config: TemporalModelConfig, x):
    """(B, T, J, F) or (B, T, J*F) -> (B, T, J*F)."""
    n_in = config.num_joints_in * config.in_features
    if x.ndim == 3:
        if x.shape[-1] != n_in:
            raise ValueError(f"expected (B, T, {n_in}) input, got {tuple(x.shape)}")
        return x
    if x.ndim != 4 or tuple(x.shape[-2:]) != (config.num_joints_in, config.in_features):
        raise ValueError(f"expected (B, T, {config.num_joints_in}, "
                         f"{config.in_features}) input, got {tuple(x.shape)}")
    return x.reshape(x.shape[0], x.shape[1], n_in)


def _finish_output(config: TemporalModelConfig, x):
    return x.reshape(x.shape[0], x.shape[1], config.num_joints_out, 3)


@torch.no_grad()
def forward_dilated(model: TemporalModel, x):
    """Eval-mode dilated forward (running BN statistics, no dropout), float32.

    The plain path of the evaluator.  The module's train/eval flag is restored
    afterwards.
    """
    was_training = model.training
    model.eval()
    try:
        return model(x.float())
    finally:
        model.train(was_training)


def _conv_matmul(x, weight, dt):
    """Valid width-k conv (dilation 1) over channels-last (B, T, C_in) with a
    (k, C_in, C_out) weight: operands cast to ``dt``, float32 sum, result cast
    to ``dt``."""
    k = weight.shape[0]
    t_out = x.shape[1] - (k - 1)
    xf = x.to(dt).float()
    w = weight.to(dt).float()
    acc = xf[:, :t_out] @ w[0]
    for j in range(1, k):
        acc = acc + xf[:, j: j + t_out] @ w[j]
    return acc.to(dt)


def _channels_last(conv: nn.Conv1d, dt):
    """Conv1d weight (C_out, C_in, k) -> (k, C_in, C_out) in ``dt``."""
    return conv.weight.detach().permute(2, 1, 0).to(dt).contiguous()


def _fold(bn: nn.BatchNorm1d):
    from videopose3d_torch.ops.kernels.temporal_block import fold_batchnorm
    return fold_batchnorm(bn.weight.detach(), bn.bias.detach(), bn.running_mean,
                          bn.running_var, bn.eps)


def tensor_state(model: "TemporalModel"):
    """The state of ``model``'s tensors: each parameter's and buffer's identity,
    version counter (an in-place write bumps it) and storage (a move to another
    device changes it), so that what is made from the tensors is remade when it
    changes.  Walks the modules' own tables: ``parameters()`` costs ~10x as much,
    and the evaluator asks once a video."""
    state, modules = [], [model]
    while modules:
        module = modules.pop()
        for t in itertools.chain(module._parameters.values(), module._buffers.values()):
            if t is not None:
                state.append((id(t), t._version, t.data_ptr()))
        modules.extend(m for m in module._modules.values() if m is not None)
    return tuple(state)


# forward_dilated_fused's operands of each live model: (key, operands).
_FUSED_OPERANDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _fused_operands(model: "TemporalModel", dt):
    """The fused blocks' operands of ``model`` in ``dt``, BatchNorm folded, every
    width padded to a whole 16-byte word of ``dt`` with zeros
    (``temporal_block.pad`` / ``padded_block``): the channels, the expand's
    keypoint columns and the shrink's outputs.  Returns ``(c_in, expand, blocks,
    shrink)``: the padded keypoint columns, (w0, s0, b0), each block's (w_taps,
    s1, b1, w2, s2, b2) and (w_shrink, b_shrink).  Made once for each dtype and
    state of the model's tensors (identity, version counter and storage, so an
    in-place update or a move to another device remakes them), and kept while the
    model lives."""
    from videopose3d_torch.ops.kernels import temporal_block as tb

    key = (dt, tensor_state(model))
    hit = _FUSED_OPERANDS.get(model)
    if hit is not None and hit[0] == key:
        return hit[1]
    c = model.expand_conv.weight.shape[0]
    cp = tb.whole_words(c, dt)
    ci = tb.whole_words(model.expand_conv.weight.shape[1], dt)
    s0, b0 = _fold(model.expand_bn)
    expand = (tb.pad(_channels_last(model.expand_conv, dt), ci, cp), tb.pad(s0, cp),
              tb.pad(b0, cp))
    convs, bns = model.layers_conv, model.layers_bn
    blocks = [tb.padded_block(cp, _channels_last(convs[2 * i], dt), *_fold(bns[2 * i]),
                              _channels_last(convs[2 * i + 1], dt)[0], *_fold(bns[2 * i + 1]))
              for i in range(len(convs) // 2)]
    ws = _channels_last(model.shrink, dt)[0]
    j3 = tb.whole_words(ws.shape[1], dt)
    shrink = (tb.pad(ws, cp, j3), tb.pad(model.shrink.bias.detach().float(), j3))
    ops = (ci, expand, blocks, shrink)
    _FUSED_OPERANDS[model] = (key, ops)
    return ops


@torch.no_grad()
def forward_dilated_fused(config: TemporalModelConfig, model: TemporalModel, x):
    """Inference-only dilated forward through the fused block kernels.

    The first block runs with the expand conv fused in
    (``fused_expand_block``), the middle blocks through ``fused_dilated_block``
    and the last with the shrink projection fused in (``fused_shrink_block``).
    Runs at ``config.matmul_dtype`` ("mixed" runs as bf16); ``config`` is the
    model's architecture with the compute dtype to serve at.  Equal to
    :func:`forward_dilated` up to that dtype.

    Any width, on every device: the blocks run on the model's operands padded to
    whole 16-byte words (``_fused_operands``, made once per model state) and the
    keypoints padded to as many columns; the padded channels stay 0 from block to
    block, and only the poses are cut back to J_out * 3.
    """
    from videopose3d_torch.ops.kernels.temporal_block import (
        fused_dilated_block, fused_expand_block, fused_shrink_block, pad)

    cfg = config
    if cfg.dense:
        raise ValueError("fused path does not support dense convolutions")
    dt = cfg.matmul_dtype
    x = _prep_input(cfg, x)
    n_blocks = len(cfg.filter_widths) - 1
    j3 = model.shrink.weight.shape[0]

    def shrink_plain(h):
        w_shrink = _channels_last(model.shrink, dt)
        out = _conv_matmul(h, w_shrink, dt) + model.shrink.bias.detach().float().to(dt)
        return _finish_output(cfg, out.float())

    if n_blocks == 0:
        # Expand + shrink only: no residual block to fuse.
        s0, b0 = _fold(model.expand_bn)
        e = _conv_matmul(x, _channels_last(model.expand_conv, dt), dt)
        return shrink_plain(torch.relu(e * s0.to(dt) + b0.to(dt)))

    def geometry(i):
        return dict(dilation=cfg.dilations[i + 1],
                    causal_shift=cfg.causal_shifts_dilated[i + 1])

    c_in, expand, blocks, shrink = _fused_operands(model, dt)
    x = fused_expand_block(pad(x.to(dt), c_in), *expand, *blocks[0], **geometry(0))
    if n_blocks == 1:
        # The single block fuses its expand side; the shrink runs plain.
        return shrink_plain(x[..., :model.expand_conv.weight.shape[0]])
    for i in range(1, n_blocks - 1):
        x = fused_dilated_block(x, *blocks[i], **geometry(i))
    x = fused_shrink_block(x, *blocks[-1], *shrink, **geometry(n_blocks - 1))
    return _finish_output(cfg, x[..., :j3])


@torch.no_grad()
def forward_dilated_int8(config: TemporalModelConfig, q, x, *,
                         accshift_min_d: Optional[int] = None):
    """w8a8 int8 inference through the int8 stage kernels of
    ``ops/kernels/temporal_block_int8.py``: expand + block 0, the mid blocks,
    the last block + shrink.

    Any width: a model whose channels are not a multiple of the kernels' 16 runs
    as its zero-padded form (``temporal_block_int8.channel_padded``, on every
    device), which gives the same poses bit for bit.

    Args:
      q: the ``QuantizedModel`` of ``quantize_temporal_model`` (or ``q_from_jax``).
      x: (B, T, J_in, F) or (B, T, J_in*F) keypoints, T >= receptive field.
      accshift_min_d: blocks whose dilation is at least this run the accshift
        tap mode (bit-identical; 0 forces it everywhere); None takes
        ``temporal_block_int8.ACCSHIFT_MIN_DILATION`` (accshift off).

    Returns (B, T - receptive_field + 1, J_out, 3) float32 poses.
    """
    from videopose3d_torch.ops.kernels import temporal_block_int8 as tq

    if accshift_min_d is None:
        accshift_min_d = tq.ACCSHIFT_MIN_DILATION
    cfg = config
    n_blocks = len(cfg.filter_widths) - 1
    if n_blocks < 2:
        raise ValueError("int8 path expects at least 2 residual blocks")
    q = tq.channel_padded(q)
    x = _prep_input(cfg, x)
    rf = receptive_field(cfg)
    if x.shape[1] < rf:
        raise ValueError(
            f"input has {x.shape[1]} frames but the model's receptive field is {rf}; "
            "pad the sequence (UnchunkedBatcher does this) before int8 serving")
    # Pre-tap the raw input: the expand conv becomes one K = k0*J_in*F product.
    k0, c_in, c = q.expand_w.shape
    t_e = x.shape[1] - (k0 - 1)
    x = torch.cat([x[:, j: j + t_e] for j in range(k0)], dim=-1).to(torch.bfloat16)

    def geometry(i):
        d = cfg.dilations[i + 1]
        return dict(dilation=d, causal_shift=cfg.causal_shifts_dilated[i + 1],
                    tap_mode="accshift" if d >= accshift_min_d else "slice")

    stream = tq.int8_expand_block(x, q.expand_w.reshape(k0 * c_in, c), q.expand_scale,
                                  q.expand_shift, q.blocks[0], **geometry(0))
    for i in range(1, n_blocks - 1):
        stream = tq.int8_dilated_block(stream, q.blocks[i], **geometry(i))
    i = n_blocks - 1
    j3 = q.shrink_w.shape[1]
    shrink = (tq.shrink_operands(q) if stream.device.type == "cuda"
              else (q.shrink_w, q.shrink_b))
    out = tq.int8_shrink_block(stream, q.blocks[i], *shrink, **geometry(i))[..., :j3]
    return _finish_output(cfg, out)


# ---------------------------------------------------------------------------
# Training form
# ---------------------------------------------------------------------------


def dropout_mask(rate: float, shape, dtype: torch.dtype, generator):
    """Pre-scaled inverted-dropout mask (values 0 or 1/keep) drawn from
    ``generator`` on its device, or None when dropout is off.

    As the JAX package's ``_dropout_mask``: a keep probability that is exactly
    k/256 (0.75 for the reference's rate 0.25) draws one byte per element, any
    other 16 bits; the scale uses the realised probability, so the expectation
    stays exactly 1.  Both train engines take their masks from here, in the same
    order, so they see identical masks.
    """
    if rate == 0.0 or generator is None:
        return None
    device = generator.device
    if rate >= 1.0:
        return torch.zeros(shape, dtype=dtype, device=device)
    keep_exact = 1.0 - rate
    t8 = round(keep_exact * 256)
    if abs(keep_exact * 256 - t8) < 1e-9 and 0 < t8 < 256:
        threshold, denom, bits_dtype = int(t8), 256, torch.uint8
    else:
        threshold = min(max(int(round(keep_exact * 65536)), 1), 65535)
        denom, bits_dtype = 65536, torch.int32
    bits = torch.randint(0, denom, tuple(shape), generator=generator, device=device,
                         dtype=bits_dtype)
    return (bits < threshold).to(dtype) * (1.0 / (threshold / denom))


def _update_running(bn: nn.BatchNorm1d, mean, var, n: int, momentum: float) -> None:
    """running = (1 - momentum) * running + momentum * batch statistic, with the
    unbiased variance; no gradient."""
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        bn.running_mean.copy_((1.0 - momentum) * bn.running_mean + momentum * mean)
        bn.running_var.copy_((1.0 - momentum) * bn.running_var + momentum * unbiased)


def batchnorm_train(x, bn: nn.BatchNorm1d, momentum: float, shard=None):
    """Train-mode BatchNorm over (B, T, C) with the JAX package's ``_batchnorm``
    semantics: shifted one-pass statistics centred on the running mean (float32),
    the biased variance to normalise, the unbiased one into the running stats
    (updated in place, per-call ``momentum``), and the affine in x's dtype.

    With a ``shard`` (``parallel.BatchShard``, x being this rank's rows of it),
    the statistics are the global batch's: the per-channel sums go through the
    differentiable all-reduce and are divided by the global row count.  The
    shift, the running mean, is the same on every rank, so the ranks' shifted
    sums add up to the global batch's."""
    xf = x.float()
    shift = bn.running_mean.clone()
    centered = xf - shift
    sums = torch.stack([centered.sum(dim=(0, 1)), centered.square().sum(dim=(0, 1))])
    n = xf.shape[0] * xf.shape[1]
    if shard is not None:
        sums = mesh.all_reduce_sum(sums, shard.group)
        n = shard.total * xf.shape[1]
    m1, m2 = sums[0] / n, sums[1] / n
    mean = shift + m1
    var = torch.clamp(m2 - m1.square(), min=0.0)
    _update_running(bn, mean.detach(), var.detach(), n, momentum)
    inv = torch.rsqrt(var + BN_EPS) * bn.weight
    dt = x.dtype
    return (x - mean.to(dt)) * inv.to(dt) + bn.bias.to(dt)


def _matmul(x, w, mdt, adt):
    """x @ w with operands rounded to ``mdt``, a float32 sum, the result in ``adt``."""
    return (x.to(mdt).float() @ w.to(mdt).float()).to(adt)


def _drop(y, mask):
    y = torch.relu(y)
    return y if mask is None else y * mask


def _block_plain(model: TemporalModel, i: int, x, masks, momentum: float, shard=None):
    """Residual block i of the strided form in plain torch (the ``xla`` engine):
    the strided conv is one matmul over the (B, T/fw, fw*C) taps, and the
    residual is their center tap."""
    cfg = model.config
    fw = cfg.filter_widths[i + 1]
    center = cfg.causal_shifts_strided[i + 1] + fw // 2
    mdt, adt = cfg.matmul_dtype, cfg.activation_dtype
    b, t, c = x.shape
    taps = x.reshape(b, t // fw, fw * c)
    res = taps[:, :, center * c:(center + 1) * c]
    wa = model.layers_conv[2 * i].weight.permute(2, 1, 0).reshape(fw * c, c)
    y = _matmul(taps, wa, mdt, adt)
    y = _drop(batchnorm_train(y, model.layers_bn[2 * i], momentum, shard), masks[0])
    y = _matmul(y, model.layers_conv[2 * i + 1].weight[:, :, 0].t(), mdt, adt)
    y = _drop(batchnorm_train(y, model.layers_bn[2 * i + 1], momentum, shard), masks[1])
    return res + y


def _block_fused(model: TemporalModel, i: int, x, masks, momentum: float, shard=None):
    """The same block through the fused train-block kernels (the ``pallas``
    engine), one homogeneous dtype; with a ``shard``, global BatchNorm
    statistics (``fused_train_block``)."""
    from videopose3d_torch.ops.kernels.train_block import fused_train_block
    cfg = model.config
    fw = cfg.filter_widths[i + 1]
    dt = cfg.matmul_dtype
    bn_a, bn_b = model.layers_bn[2 * i], model.layers_bn[2 * i + 1]
    b, t, _ = x.shape
    out, mean_a, var_a, mean_b, var_b = fused_train_block(
        x.to(dt), model.layers_conv[2 * i].weight.permute(2, 1, 0).to(dt).contiguous(),
        model.layers_conv[2 * i + 1].weight[:, :, 0].t().to(dt).contiguous(),
        bn_a.weight, bn_a.bias, bn_b.weight, bn_b.bias, masks[0], masks[1],
        bn_a.running_mean, bn_b.running_mean,
        center=cfg.causal_shifts_strided[i + 1] + fw // 2, fw=fw, shard=shard)
    n = (b if shard is None else shard.total) * (t // fw)
    _update_running(bn_a, mean_a, var_a, n, momentum)
    _update_running(bn_b, mean_b, var_b, n, momentum)
    return out


def _mask_draws(cfg: TemporalModelConfig, generator, shard):
    """``draw(shape, count)``: ``count`` dropout masks of an activation ``shape``
    (this rank's rows), in the activation dtype, in call order from
    ``generator``.  Under a ``shard`` each mask is drawn at the global batch's
    shape and cut to the rank's rows, so the ranks together see the
    single-process masks."""
    def draw(shape, count):
        if shard is not None:
            shape = (shard.total,) + tuple(shape[1:])
        drawn = [dropout_mask(cfg.dropout, shape, cfg.activation_dtype, generator)
                 for _ in range(count)]
        return [m if m is None or shard is None else shard.take(m) for m in drawn]
    return draw


def forward_strided(model: TemporalModel, x, *, momentum: float, generator=None,
                    shard=None):
    """Training forward of the strided form (the reference's
    ``TemporalModelOptimized1f``, the JAX ``forward_strided`` with ``train=True``).

    Input (B, receptive_field, J_in, F) or (B, receptive_field, J_in*F); output
    (B, 1, J_out, 3) float32.  BatchNorm uses batch statistics and updates the
    running statistics in place with ``momentum``; dropout masks are drawn from
    ``generator`` (None: no dropout), in the same order for either engine.
    ``model.config.train_engine`` picks the residual blocks' engine; "mixed"
    compute runs plain, as in the JAX package.

    Data parallel: with a ``shard`` (``parallel.BatchShard``), x holds this
    rank's rows of the global batch; every BatchNorm takes the global batch's
    statistics, and each dropout mask is drawn at the global shape and cut to
    the rank's rows, so the ranks together see the single-process masks.
    """
    cfg = model.config
    if cfg.dense:
        raise ValueError("strided form is incompatible with dense convolutions")
    mdt, adt = cfg.matmul_dtype, cfg.activation_dtype
    x = _prep_input(cfg, x)
    rf = receptive_field(cfg)
    if x.shape[1] != rf:
        raise ValueError(f"strided form expects input length == receptive field "
                         f"({rf}), got {x.shape[1]}")
    fused = cfg.train_engine == "pallas" and cfg.compute_dtype != "mixed"
    block = _block_fused if fused else _block_plain
    masks = _mask_draws(cfg, generator, shard)

    k0 = cfg.filter_widths[0]
    b, t, c_in = x.shape
    w0 = model.expand_conv.weight.permute(2, 1, 0).reshape(k0 * c_in, cfg.channels)
    y = _matmul(x.reshape(b, t // k0, k0 * c_in), w0, mdt, adt)
    y = batchnorm_train(y, model.expand_bn, momentum, shard)
    x = _drop(y, *masks(y.shape, 1))
    for i in range(len(cfg.filter_widths) - 1):
        b, t, c = x.shape
        x = block(model, i, x, masks((b, t // cfg.filter_widths[i + 1], c), 2), momentum,
                  shard)
    ws = model.shrink.weight[:, :, 0].t()
    x = _matmul(x, ws, mdt, adt) + model.shrink.bias.to(adt)
    return _finish_output(cfg, x.float())


class _DilatedConv(torch.autograd.Function):
    """Valid dilated conv over channels-last (B, T, C_in) with a (k, C_in, C_out)
    weight: the sum of the k tap products, operands rounded to ``mdt``, float32
    sums, the result in ``adt`` (the JAX package's ``_conv_matmul``, which sums
    the concatenated taps in one product: float32 sums in another order).

    Only ``x`` and the weight are kept for the backward, which takes each tap's
    rows again: the taps are never held at once, so a dense kernel of 2*pad + 1
    taps costs no more memory than its input.  The gradients are those autograd
    gives the tap products: float32 sums rounded to ``mdt``, then to each
    input's dtype."""

    @staticmethod
    def forward(ctx, x, w, dilation: int, mdt, adt):
        (b, _, c_in), (k, _, c_out) = x.shape, w.shape
        t_out = x.shape[1] - (k - 1) * dilation
        xf, wf = x.to(mdt).float(), w.to(mdt).float()
        # A tap's rows are a strided view that matmul cannot fold into one
        # product (it would broadcast the weight over the batch): each tap is
        # copied to (B * t_out, C_in) and added to the sum by the product itself.
        tap = lambda j: xf[:, j * dilation: j * dilation + t_out].reshape(-1, c_in)
        acc = tap(0) @ wf[0]
        for j in range(1, k):
            acc.addmm_(tap(j), wf[j])
        ctx.save_for_backward(x, w)
        ctx.geometry = (dilation, mdt)
        return acc.view(b, t_out, c_out).to(adt)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d, mdt = ctx.geometry
        k, c_in, c_out = w.shape
        t_out = g.shape[1]
        gf = g.float()
        xf, wf = x.to(mdt).float(), w.to(mdt).float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxf = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for j in range(k):
                dxf[:, j * d: j * d + t_out] += gf @ wf[j].t()
            dx = dxf.to(mdt).to(x.dtype)
        if ctx.needs_input_grad[1]:
            g2 = gf.reshape(-1, c_out)
            dw = torch.stack([xf[:, j * d: j * d + t_out].reshape(-1, c_in).t() @ g2
                              for j in range(k)]).to(mdt).to(w.dtype)
        return dx, dw, None, None, None


def _conv_train(conv: nn.Conv1d, x, dilation: int, mdt, adt):
    """A model conv (no bias) of the dilated form in train mode."""
    w = conv.weight.permute(2, 1, 0)  # (k, C_in, C_out)
    if w.shape[0] == 1:
        return _matmul(x, w[0], mdt, adt)
    return _DilatedConv.apply(x, w, dilation, mdt, adt)


def forward_dilated_train(model: TemporalModel, x, *, momentum: float, generator=None,
                          shard=None):
    """Training forward of the dilated form (the JAX ``forward_dilated`` with
    ``train=True``), taken by ``--stride > 1``, ``--dense`` and
    ``--disable-optimizations``.

    Input (B, T, J_in, F) or (B, T, J_in*F) with T >= receptive field; output
    (B, T - receptive_field + 1, J_out, 3) float32.  Every BatchNorm normalises
    over all B x T_i rows of its layer (T_i frames there) and updates the running
    statistics in place with ``momentum``, the unbiased variance over those rows;
    the dropout masks, drawn from ``generator`` (None: no dropout) at each
    activation's shape, come in the order expand, then each block's conv and
    1x1, both of a block drawn before it runs, as in :func:`forward_strided`.
    Dense models (``config.dense``) run their 2*pad + 1 taps at dilation 1;
    causal models take the residual at the causal shift.  Plain torch in every
    engine: the JAX package runs no train-block kernel on this form.

    Data parallel: with a ``shard``, x holds this rank's rows; the BatchNorm
    statistics are the global batch's (``shard.total * T_i`` rows) and each mask
    is the global draw cut to the rank's rows.
    """
    cfg = model.config
    mdt, adt = cfg.matmul_dtype, cfg.activation_dtype
    x = _prep_input(cfg, x)
    rf = receptive_field(cfg)
    if x.shape[1] < rf:
        raise ValueError(f"dilated form expects at least the receptive field ({rf}) "
                         f"input frames, got {x.shape[1]}")
    masks = _mask_draws(cfg, generator, shard)
    y = _conv_train(model.expand_conv, x, 1, mdt, adt)
    x = _drop(batchnorm_train(y, model.expand_bn, momentum, shard), *masks(y.shape, 1))
    convs, bns = model.layers_conv, model.layers_bn
    for i in range(len(cfg.filter_widths) - 1):
        pad, shift = cfg.pads[i + 1], cfg.causal_shifts_dilated[i + 1]
        b, t, c = x.shape
        mask_a, mask_b = masks((b, t - 2 * pad, c), 2)
        res = x[:, pad + shift: t - pad + shift]
        y = _conv_train(convs[2 * i], x, 1 if cfg.dense else cfg.dilations[i + 1], mdt, adt)
        y = _drop(batchnorm_train(y, bns[2 * i], momentum, shard), mask_a)
        y = _conv_train(convs[2 * i + 1], y, 1, mdt, adt)
        y = _drop(batchnorm_train(y, bns[2 * i + 1], momentum, shard), mask_b)
        x = res + y
    ws = model.shrink.weight[:, :, 0].t()
    x = _matmul(x, ws, mdt, adt) + model.shrink.bias.to(adt)
    return _finish_output(cfg, x.float())
