"""Streaming causal inference: per-frame 2D->3D lifting of many video streams at
once, one pose per frame, with O(receptive field) state per stream.

Counterpart of ``videopose3d_tpu/streaming.py``: the same ring geometry, analytic
warm-up, engines, lifters and CLI (``python -m videopose3d_torch.streaming``).

* Per-layer **ring buffers**, time-major ``(cap, B, C)``: the raw input holds the
  expand conv's ``filter_width`` frames, block ``i`` its ``(k_i - 1) * d_i + 1``
  frames of the previous layer's output.  The rings are updated **in place**
  (the JAX package donates them); a caller that steps two engines from one state
  clones it first.
* State is ``{"bufs": [ring, ...], "ptr": [int, ...]}``: each layer's ring
  position wraps at its own capacity and is kept on the host, so the ring slots
  of an eager step are computed without a device-to-host copy.  The lifter's
  per-frame ``int8_fused`` dispatch on the card keeps a copy of the positions on
  the card too, which its CUDA graph reads and advances (:class:`_Int8StepGraph`).
* **Warm-up** fills every ring with the steady-state activation of the first
  frame: the offline causal model edge-pads the input, and a constant input is
  a fixed point of every layer, so the streamed poses equal the offline causal
  model's from the first frame (up to float summation order).
* Engines: ``bf16`` (per-layer plain torch at the config's compute dtype,
  float32 or bfloat16), ``bf16_fused`` (one kernel, K5, for every residual
  block and the shrink), ``int8`` (per-layer w8a8 of ``quantize_temporal_model``)
  and ``int8_fused`` (K5 int8); each with a k-frames-per-step form on doubled,
  k-aligned rings (K6 for the fused engines).  The raw ring and the expand
  are plain torch in the free step functions, as JAX leaves them to XLA; the
  lifter's per-frame ``int8_fused`` dispatch on the card runs them in one kernel,
  the streaming front (F), and replays F, K5 and the positions' advance as one
  CUDA graph.
  ``ring_impl="dma"`` routes the per-layer engine's block-ring writes through
  the ring-push kernel (K7).

On the card every engine runs with TF32 off (``evaluate.full_float32``): a bf16
product summed in float32 is an upcast-to-float32 matmul, never a bf16 cuBLAS
matmul (which may accumulate partly in bf16).  BatchNorm runs in inference mode.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from videopose3d_torch.evaluate import full_float32
from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                _channels_last, _fold, receptive_field)
from videopose3d_torch.ops.kernels import streaming_fused as sf
from videopose3d_torch.ops.kernels.build import count_replay, recorded_launches
from videopose3d_torch.ops.kernels.temporal_block_int8 import (QuantizedModel, _to_stream,
                                                                quantized_on)
from videopose3d_torch.profiling import count, span

StreamState = Dict[str, Any]


# ---------------------------------------------------------------------------
# Ring geometry and state
# ---------------------------------------------------------------------------


def _buffer_capacities(config: TemporalModelConfig) -> List[int]:
    """Ring-buffer length per layer: raw input, then one per residual block."""
    caps = [config.filter_widths[0]]
    for i in range(1, len(config.filter_widths)):
        caps.append((config.filter_widths[i] - 1) * config.dilations[i] + 1)
    return caps


def _buffer_capacities_multi(config: TemporalModelConfig, frames_per_step: int) -> List[int]:
    """Ring capacity per layer for k-frame steps: ``(ceil(max_lag / k) + 1) * k``,
    k-aligned and at least max_lag + k, so the k rows written never clobber
    history a tap still reads."""
    k = frames_per_step
    return [(-(-(c - 1) // k) + 1) * k for c in _buffer_capacities(config)]


def _check_per_frame_caps(bufs, caps):
    """A per-frame step on a k-frame state (doubled, k-aligned rings) would write
    wrong slots without a shape error."""
    got = tuple(b.shape[0] for b in bufs)
    if got != tuple(caps):
        raise ValueError(
            f"stream state has ring capacities {got}, expected {tuple(caps)}:"
            " this state was built for a different engine (micro-batched"
            " init_*_multi states are not interchangeable with per-frame"
            " steps)")


def _check_multi_alignment(config, caps, k):
    """A state built for another frames_per_step would be silently corrupted:
    every capacity must be a multiple of k and hold the max tap lag plus the k
    rows being written."""
    max_lags = [c - 1 for c in _buffer_capacities(config)]
    if any(cap % k or cap < lag + k for cap, lag in zip(caps, max_lags)):
        raise ValueError(
            f"stream state (caps {caps}) was built for a different "
            f"frames_per_step than the {k} frames passed; re-init with "
            f"frames_per_step={k}")


def _advance_ptrs(ptrs, caps, k: int = 1) -> List[int]:
    """Each layer's ring position advanced by k, modulo its own capacity (a
    shared frame counter would need to wrap at lcm(caps))."""
    return [(p + k) % c for p, c in zip(ptrs, caps)]


def _stream_dtype(config: TemporalModelConfig) -> torch.dtype:
    """The activation dtype the float engines run at; ``"mixed"`` is a training
    scheme with no streaming meaning."""
    if config.compute_dtype == "mixed":
        raise ValueError(
            "streaming engines need a concrete compute_dtype; 'mixed' is a "
            "training scheme — serve with compute_dtype='bfloat16' (same MXU "
            "operand rounding as 'mixed') or 'float32'")
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[config.compute_dtype]


def _check_streamable(config: TemporalModelConfig):
    if not config.causal:
        raise ValueError("streaming inference requires a causal model")
    if config.dense:
        raise ValueError("streaming inference does not support dense convs")


def _slots(config, ptr, caps, *, multi: bool):
    """Per residual block ``[write_slot, tap_slot, ...]`` (older taps oldest
    first), concatenated, and per block the older taps' lags.  ``%`` is a floor
    modulo, so a slot is never negative."""
    idx, lags = [], []
    for i, kw in enumerate(config.filter_widths[1:]):
        p, cap, d = ptr[i + 1], caps[i + 1], config.dilations[i + 1]
        block_lags = [(kw - 1 - j) * d for j in range(kw - 1)]
        idx += [p if multi else p % cap] + [(p - lag) % cap for lag in block_lags]
        lags.append(block_lags)
    return idx, lags


def _raw_taps(buf, ptr: int, cap: int, k0: int, x, *, doubled: bool):
    """Push x (k, B, C_in) into the raw ring and return the expand conv's taps as
    (k*B, k0*C_in): the older frames' slabs oldest first, then x."""
    k, b, _ = x.shape
    sf._push(buf, ptr, x, cap, doubled)
    rows = [buf[(ptr - lag) % cap:][:k].reshape(k * b, -1) for lag in range(k0 - 1, 0, -1)]
    return torch.cat(rows + [x.reshape(k * b, -1)], dim=-1)


def _frames_to_rows(frames, k: Optional[int], dtype):
    """(B, J, F) or, with k, (B, k, J, F) keypoints -> frame-major (k, B, J*F)."""
    x = torch.as_tensor(frames)
    if k is None:
        return x.reshape(1, x.shape[0], -1).to(dtype)
    return x.transpose(0, 1).reshape(k, x.shape[0], -1).to(dtype)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


@torch.no_grad()
def prepare_stream_weights(config: TemporalModelConfig, model: TemporalModel):
    """The float engines' weights, built once per weight set: matrices cast to
    the config's streaming dtype in the JAX layout, BatchNorm folded to float32
    affines.  Keys: ``expand_w`` (k0*C_in, C), ``expand_s``, ``expand_t``; per
    block ``w1`` (k, C, C), ``w2`` (C, C) and ``vecs`` (8, C) rows [s1, t1, s2,
    t2]; ``shrink_w`` (C, J3), ``shrink_b`` (J3,)."""
    dt = _stream_dtype(config)
    n_blocks = len(config.filter_widths) - 1
    w0 = _channels_last(model.expand_conv, dt)
    s0, t0 = _fold(model.expand_bn)

    def vecs(i):
        s1, t1 = _fold(model.layers_bn[2 * i])
        s2, t2 = _fold(model.layers_bn[2 * i + 1])
        return sf.pack_vec_rows([s1, t1, s2, t2])

    return {
        "expand_w": w0.reshape(-1, w0.shape[-1]), "expand_s": s0, "expand_t": t0,
        "w1": [_channels_last(model.layers_conv[2 * i], dt) for i in range(n_blocks)],
        "w2": [_channels_last(model.layers_conv[2 * i + 1], dt)[0] for i in range(n_blocks)],
        "vecs": [vecs(i) for i in range(n_blocks)],
        "shrink_w": _channels_last(model.shrink, dt)[0].contiguous(),
        "shrink_b": model.shrink.bias.detach().float().contiguous(),
    }


def prepare_bf16_fused(config: TemporalModelConfig, model: TemporalModel):
    """:func:`prepare_stream_weights` for the fused bf16 engine."""
    if _stream_dtype(config) != torch.bfloat16:
        raise ValueError("the fused bf16 engine requires compute_dtype='bfloat16'")
    return prepare_stream_weights(config, model)


def prepare_int8_fused(q: QuantizedModel) -> sf.Int8StepWeights:
    """The fused int8 engine's weights: ``q`` and its blocks' weights packed for
    the step kernel (``temporal_block_int8.pack_int8_step``, made once per block:
    K padded to 32, N to 8, so any C runs)."""
    return sf.Int8StepWeights.of(q)


def _expand_float(w, taps, dt):
    """Expand conv + BatchNorm + ReLU on (rows, k0*C_in) taps: float32 (rows, C)."""
    with span("vp3d.stream.expand"):
        act = taps.to(dt).float() @ w["expand_w"].float()
        return torch.relu(act * w["expand_s"] + w["expand_t"])


def _expand_step_i8(q: QuantizedModel, raw_taps):
    """bf16 expand conv over (rows, k0*C_in) raw taps -> int8 expand stream: the
    bf16 products summed in float64 and rounded once to float32, as
    ``temporal_block_int8.int8_expand_block_plain``."""
    with span("vp3d.stream.expand"):
        k0, c_in, c = q.expand_w.shape
        eacc = (raw_taps.to(torch.bfloat16).double()
                @ q.expand_w.reshape(k0 * c_in, c).double()).float()
        return _to_stream(torch.relu(eacc * q.expand_scale + q.expand_shift))


# ---------------------------------------------------------------------------
# Warm-up
# ---------------------------------------------------------------------------


def _steady_acts_bf16(config, model, x):
    """Per-layer steady-state activations (float32) under a constant input x
    (B, C_in): [expand output, block 0 output, ...].  The taps' weights are summed
    in float32 and only then cast to the compute dtype, as the JAX package."""
    dt = _stream_dtype(config)
    mm = lambda a, w: a.to(dt).float() @ w.to(dt).float()
    s, t = _fold(model.expand_bn)
    act = torch.relu(mm(x, _channels_last(model.expand_conv, torch.float32).sum(0)) * s + t)
    acts = [act]
    for i in range(len(config.filter_widths) - 2):
        s1, t1 = _fold(model.layers_bn[2 * i])
        s2, t2 = _fold(model.layers_bn[2 * i + 1])
        w1 = _channels_last(model.layers_conv[2 * i], torch.float32).sum(0)
        h = torch.relu(mm(act, w1) * s1 + t1)
        z = mm(h, _channels_last(model.layers_conv[2 * i + 1], torch.float32)[0])
        act = act + torch.relu(z * s2 + t2)
        acts.append(act)
    return acts


def _steady_acts_int8(config, q, x):
    """int8 counterpart of :func:`_steady_acts_bf16` (x: (B, C_in) bf16)."""
    act_q = _expand_step_i8(q, x.repeat(1, config.filter_widths[0]))
    acts = [act_q]
    for i in range(len(config.filter_widths) - 2):
        kw = config.filter_widths[i + 1]
        act_q = sf.block_step_i8(q.blocks[i], [act_q] * kw, act_q, last=False)
        acts.append(act_q)
    return acts


def _init(caps, x, acts, copies: int):
    """A state whose rings (``copies`` x cap rows) hold x, then each layer's
    steady-state activation, in every row."""
    return {"bufs": [a[None].repeat(copies * cap, 1, 1)
                     for cap, a in zip(caps, [x] + list(acts))],
            "ptr": [0] * len(caps)}


def _first_rows(first_frame):
    x = torch.as_tensor(first_frame)
    if x.ndim != 3:
        raise ValueError(f"expected (B, J, F) first frames, got {tuple(x.shape)}")
    return x.reshape(x.shape[0], -1).float()


@torch.no_grad()
def init_stream_state(config: TemporalModelConfig, model: TemporalModel,
                      first_frame) -> StreamState:
    """Analytic warm-up of the per-frame float engines: every ring filled with the
    steady-state activation of ``first_frame`` (B, J, F), at the compute dtype."""
    _check_streamable(config)
    dt = _stream_dtype(config)
    x = _first_rows(first_frame)
    acts = [a.to(dt) for a in _steady_acts_bf16(config, model, x)]
    return _init(_buffer_capacities(config), x.to(dt), acts, 1)


@torch.no_grad()
def init_stream_state_int8(config: TemporalModelConfig, q: QuantizedModel,
                           first_frame) -> StreamState:
    """Analytic warm-up of the per-frame int8 engines: the raw ring in bf16, the
    block rings the steady-state int8 streams."""
    _check_streamable(config)
    x = _first_rows(first_frame).to(torch.bfloat16)
    return _init(_buffer_capacities(config), x, _steady_acts_int8(config, q, x), 1)


@torch.no_grad()
def init_stream_state_multi(config: TemporalModelConfig, model: TemporalModel,
                            first_frame, frames_per_step: int) -> StreamState:
    """Warm-up of the k-frame float engines: doubled k-aligned rings."""
    _check_streamable(config)
    dt = _stream_dtype(config)
    x = _first_rows(first_frame)
    acts = [a.to(dt) for a in _steady_acts_bf16(config, model, x)]
    return _init(_buffer_capacities_multi(config, frames_per_step), x.to(dt), acts, 2)


@torch.no_grad()
def init_stream_state_int8_multi(config: TemporalModelConfig, q: QuantizedModel,
                                 first_frame, frames_per_step: int) -> StreamState:
    """Warm-up of the k-frame int8 engines: doubled k-aligned rings."""
    _check_streamable(config)
    x = _first_rows(first_frame).to(torch.bfloat16)
    return _init(_buffer_capacities_multi(config, frames_per_step), x,
                 _steady_acts_int8(config, q, x), 2)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def _per_frame(config, stream_state, frame, dtype):
    """Raw-ring push and expand taps of a per-frame step: (bufs, ptr, caps, taps)."""
    with span("vp3d.stream.ring"):
        caps = _buffer_capacities(config)
        bufs = list(stream_state["bufs"])
        _check_per_frame_caps(bufs, caps)
        ptr = list(stream_state["ptr"])
        x = _frames_to_rows(frame, None, dtype)
        taps = _raw_taps(bufs[0], ptr[0], caps[0], config.filter_widths[0], x,
                         doubled=False)
        return bufs, ptr, caps, taps


def _multi(config, stream_state, frames, dtype):
    """The same for a k-frame step: (bufs, ptr, caps, k, taps)."""
    with span("vp3d.stream.ring"):
        bufs = list(stream_state["bufs"])
        ptr = list(stream_state["ptr"])
        caps = [buf.shape[0] // 2 for buf in bufs]
        k = torch.as_tensor(frames).shape[1]
        _check_multi_alignment(config, caps, k)
        x = _frames_to_rows(frames, k, dtype)
        taps = _raw_taps(bufs[0], ptr[0], caps[0], config.filter_widths[0], x,
                         doubled=True)
        return bufs, ptr, caps, k, taps


def _poses(config, flat, b: int, k: Optional[int]):
    """(k*B, J3) frame-major -> (B, J, 3), or with k (B, k, J, 3)."""
    if k is None:
        return flat.reshape(b, config.num_joints_out, 3)
    return flat.reshape(k, b, config.num_joints_out, 3).transpose(0, 1)


@torch.no_grad()
def stream_step(config: TemporalModelConfig, weights, stream_state, frame,
                _ring_impl: str = "dus"):
    """Advance all streams by one frame with the per-layer float engine.

    Args:
      weights: from :func:`prepare_stream_weights`.
      stream_state: from :func:`init_stream_state`; its rings are updated in place.
      frame: (B, J, F) the newest 2D keypoints of each stream.
      _ring_impl: the block rings' write, "dus" (plain torch) or "dma" (the
        ring-push kernel, K7) — bit-identical.

    Returns ((B, J_out, 3) float32 poses, new stream state).
    """
    if _ring_impl not in ("dus", "dma"):
        raise ValueError(f"unknown ring implementation {_ring_impl!r}")
    dt = _stream_dtype(config)
    bufs, ptr, caps, taps = _per_frame(config, stream_state, frame, dt)
    a0 = _expand_float(weights, taps, dt)
    with span("vp3d.stream.blocks"):
        idx, _ = _slots(config, ptr, caps, multi=False)
        push = sf.ring_push if _ring_impl == "dma" else None
        flat = sf.blocks_float_plain(weights, bufs[1:], a0[None], idx, config.filter_widths[1:],
                                     None, False, dt, push)
    return _poses(config, flat, a0.shape[0], None), {"bufs": bufs,
                                                    "ptr": _advance_ptrs(ptr, caps)}


@torch.no_grad()
def stream_step_bf16_fused(config: TemporalModelConfig, prepared, stream_state, frame):
    """Advance all streams one frame with the fused bf16 kernel (K5); same state
    and math as :func:`stream_step` at compute_dtype bfloat16.

    Args:
      prepared: from :func:`prepare_bf16_fused`.
    """
    bufs, ptr, caps, taps = _per_frame(config, stream_state, frame, torch.bfloat16)
    a0 = _expand_float(prepared, taps, torch.bfloat16)
    with span("vp3d.stream.blocks"):
        idx, _ = _slots(config, ptr, caps, multi=False)
        flat, _ = sf.fused_blocks_step_bf16(prepared, bufs[1:], a0, idx,
                                            widths=config.filter_widths[1:])
    return _poses(config, flat, a0.shape[0], None), {"bufs": bufs,
                                                    "ptr": _advance_ptrs(ptr, caps)}


@torch.no_grad()
def stream_step_int8(config: TemporalModelConfig, q: QuantizedModel, stream_state, frame):
    """Advance all streams by one frame with the per-layer w8a8 engine.

    Args:
      q: the ``QuantizedModel`` of ``quantize_temporal_model``.
      stream_state: from :func:`init_stream_state_int8`; updated in place.

    Returns ((B, J_out, 3) float32 poses, new stream state).
    """
    bufs, ptr, caps, taps = _per_frame(config, stream_state, frame, torch.bfloat16)
    eq = _expand_step_i8(q, taps)
    with span("vp3d.stream.blocks"):
        idx, _ = _slots(config, ptr, caps, multi=False)
        flat = sf.blocks_int8_plain(q, bufs[1:], eq[None], idx, config.filter_widths[1:],
                                    None, False)
    return _poses(config, flat, eq.shape[0], None), {"bufs": bufs,
                                                    "ptr": _advance_ptrs(ptr, caps)}


@torch.no_grad()
def stream_step_int8_fused(config: TemporalModelConfig, prepared: sf.Int8StepWeights,
                           stream_state, frame):
    """Advance all streams one frame with the fused int8 kernel (K5) on the
    weights of :func:`prepare_int8_fused`; same state and bits as
    :func:`stream_step_int8`."""
    bufs, ptr, caps, taps = _per_frame(config, stream_state, frame, torch.bfloat16)
    eq = _expand_step_i8(prepared.q, taps)
    with span("vp3d.stream.blocks"):
        idx, _ = _slots(config, ptr, caps, multi=False)
        flat, _ = sf.fused_blocks_step(prepared, bufs[1:], eq, idx,
                                       widths=config.filter_widths[1:])
    return _poses(config, flat, eq.shape[0], None), {"bufs": bufs,
                                                    "ptr": _advance_ptrs(ptr, caps)}


def _step_on_device_positions(config, prepared: sf.Int8StepWeights, w0, lags, bufs, pos,
                              rows, eq):
    """The per-frame ``int8_fused`` step with the ring positions on the device:
    the front (F: ``rows``, (B, C_in) float32, into the raw ring and the expand into
    ``eq``), K5 on ``eq`` and the block rings, then every position one frame on.
    The host passes nothing that changes between frames, so this is what the
    lifter's CUDA graph captures; on the CPU it runs the plain versions.  ``w0`` is
    the expand weights as (k0 * C_in, C) and ``lags`` each block's older taps' lags.
    Returns (B, J3) float32 poses."""
    q = prepared.q
    sf.stream_front(rows, bufs[0], pos, w0, q.expand_scale, q.expand_shift, eq)
    flat, _ = sf.fused_blocks_step(prepared, bufs[1:], eq, None,
                                   widths=config.filter_widths[1:], pos=pos, lags=lags)
    sf.ring_advance(pos, [buf.shape[0] for buf in bufs])
    return flat


@torch.no_grad()
def stream_step_multi(config: TemporalModelConfig, weights, stream_state, frames):
    """Advance all streams by k frames with the per-layer float engine.

    Args:
      stream_state: from :func:`init_stream_state_multi`, aligned to k.
      frames: (B, k, J, F) the newest k keypoint frames of each stream.

    Returns ((B, k, J_out, 3) float32 poses, new stream state).
    """
    dt = _stream_dtype(config)
    bufs, ptr, caps, k, taps = _multi(config, stream_state, frames, dt)
    a0 = _expand_float(weights, taps, dt)
    b = a0.shape[0] // k
    with span("vp3d.stream.blocks"):
        idx, _ = _slots(config, ptr, caps, multi=True)
        flat = sf.blocks_float_plain(weights, bufs[1:], a0.reshape(k, b, -1), idx,
                                     config.filter_widths[1:], caps[1:], True, dt)
    return _poses(config, flat, b, k), {"bufs": bufs, "ptr": _advance_ptrs(ptr, caps, k)}


@torch.no_grad()
def stream_step_bf16_multi_fused(config: TemporalModelConfig, prepared, stream_state,
                                 frames):
    """Advance all streams by k frames with the fused bf16 kernel (K6)."""
    bufs, ptr, caps, k, taps = _multi(config, stream_state, frames, torch.bfloat16)
    a0 = _expand_float(prepared, taps, torch.bfloat16)
    b = a0.shape[0] // k
    with span("vp3d.stream.blocks"):
        idx, lags = _slots(config, ptr, caps, multi=True)
        flat, _ = sf.fused_blocks_step_bf16_multi(
            prepared, bufs[1:], a0.reshape(k, b, -1), idx, widths=config.filter_widths[1:],
            lags=lags, caps=caps[1:], k=k)
    return _poses(config, flat, b, k), {"bufs": bufs, "ptr": _advance_ptrs(ptr, caps, k)}


@torch.no_grad()
def stream_step_int8_multi(config: TemporalModelConfig, q: QuantizedModel, stream_state,
                           frames):
    """Advance all streams by k frames with the per-layer w8a8 engine; the
    dynamic requantization is per (stream, frame) row, as per frame."""
    bufs, ptr, caps, k, taps = _multi(config, stream_state, frames, torch.bfloat16)
    eq = _expand_step_i8(q, taps)
    b = eq.shape[0] // k
    with span("vp3d.stream.blocks"):
        idx, _ = _slots(config, ptr, caps, multi=True)
        flat = sf.blocks_int8_plain(q, bufs[1:], eq.reshape(k, b, -1), idx,
                                    config.filter_widths[1:], caps[1:], True)
    return _poses(config, flat, b, k), {"bufs": bufs, "ptr": _advance_ptrs(ptr, caps, k)}


@torch.no_grad()
def stream_step_int8_multi_fused(config: TemporalModelConfig,
                                 prepared: sf.Int8StepWeights, stream_state, frames):
    """Advance all streams by k frames with the fused int8 kernel (K6) on the
    weights of :func:`prepare_int8_fused`."""
    bufs, ptr, caps, k, taps = _multi(config, stream_state, frames, torch.bfloat16)
    eq = _expand_step_i8(prepared.q, taps)
    b = eq.shape[0] // k
    with span("vp3d.stream.blocks"):
        idx, lags = _slots(config, ptr, caps, multi=True)
        flat, _ = sf.fused_blocks_step_multi(prepared, bufs[1:], eq.reshape(k, b, -1), idx,
                                             widths=config.filter_widths[1:], lags=lags,
                                             caps=caps[1:], k=k)
    return _poses(config, flat, b, k), {"bufs": bufs, "ptr": _advance_ptrs(ptr, caps, k)}


# ---------------------------------------------------------------------------
# Lifters
# ---------------------------------------------------------------------------


def _model_on(model: TemporalModel, device) -> TemporalModel:
    """An eval-mode copy of ``model``'s weights on ``device``."""
    copy = TemporalModel(model.config).to(device)
    copy.load_state_dict(model.state_dict())
    return copy.eval()


ENGINES = ("bf16", "bf16_fused", "int8", "int8_fused")


class _Int8StepGraph:
    """A lifter's per-frame ``int8_fused`` dispatch on the card as one CUDA graph:
    :func:`_step_on_device_positions` (F, K5 and the positions' advance) captured
    once over fixed tensors (the rings of the state it is built on, the positions,
    the frame input, K5's exchange buffer and its output) and replayed for every
    frame.  A dispatch copies the frame into a reused pinned staging tensor (a frame
    already on a card is copied directly), uploads it without blocking, replays, and
    clones the poses so that each dispatch's stay its own: four calls into torch.
    Every ring and pose is bitwise :func:`stream_step_int8_fused`'s."""

    def __init__(self, config, prepared: sf.Int8StepWeights, state: StreamState, device):
        self.bufs = state["bufs"]
        self.caps = [buf.shape[0] for buf in self.bufs]
        self.shape = (self.bufs[0].shape[1], config.num_joints_in, config.in_features)
        self.pos = torch.tensor(state["ptr"], dtype=torch.int32, device=device)
        self.input = torch.zeros(self.shape, device=device)
        self.staging = torch.empty(self.shape, pin_memory=True)
        self._staging_np = self.staging.numpy()
        # Recorded by the graph's first node, so after the upload that precedes each
        # replay: the host waits on it before it overwrites the staging tensor.
        self.uploaded = torch.cuda.Event(external=True)
        k0, c_in, c = prepared.q.expand_w.shape
        w0 = prepared.q.expand_w.reshape(k0 * c_in, c).contiguous()
        _, lags = _slots(config, state["ptr"], self.caps, multi=False)
        rows = self.input.view(self.shape[0], -1)

        def body(bufs, pos):
            eq = torch.empty((self.shape[0], c), dtype=torch.int8, device=device)
            return _step_on_device_positions(config, prepared, w0, lags, bufs, pos, rows, eq)

        # One eager run on copies of the state loads every kernel before the capture.
        body([buf.clone() for buf in self.bufs], self.pos.clone())
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        # A capture runs nothing: its launches are recorded, and counted once a replay.
        with recorded_launches() as self.launches, torch.cuda.graph(self.graph):
            self.uploaded.record()
            self.out = body(self.bufs, self.pos)
        count("stream.graph_captures")

    def reset(self, state: StreamState) -> None:
        """The warm-up ``state`` written into the captured rings and positions."""
        for buf, init in zip(self.bufs, state["bufs"]):
            buf.copy_(init)
        self.pos.copy_(torch.tensor(state["ptr"], dtype=torch.int32))

    def step(self, frame) -> torch.Tensor:
        """One dispatch of a (B, J, F) frame, a NumPy array or a tensor on any
        device: the (B, J3) float32 poses.  Every operation names the graph's
        device, so any device may be the current one."""
        if frame.shape[0] != self.shape[0]:
            raise ValueError(f"expected a {self.shape} frame, got {tuple(frame.shape)}")
        frame = frame.reshape(self.shape)
        with span("vp3d.stream.frames"):
            if isinstance(frame, torch.Tensor) and frame.device.type == "cuda":
                self.input.copy_(frame)
            else:
                self.uploaded.synchronize()  # the last upload has read the staging tensor
                if isinstance(frame, torch.Tensor):
                    self.staging.copy_(frame)
                else:  # one memcpy on this thread (torch's copy_ wakes its CPU pool)
                    np.copyto(self._staging_np, frame)
                self.input.copy_(self.staging, non_blocking=True)
        with span("vp3d.stream.blocks"):
            self.graph.replay()
        count("stream.graph_replays")
        count_replay(self.launches)
        return self.out.clone()


class StreamingCausalLifter:
    """Many concurrent video streams on one device, one pose per frame.

    Example::

        lifter = StreamingCausalLifter(config, model, device="cuda")
        lifter.reset(first_frames)            # (B, J, 2)
        for frame in frames:                  # each (B, J, 2)
            poses = lifter.step(frame)        # (B, J_out, 3), on the device

    With ``engine="int8"`` or ``"int8_fused"`` pass the ``QuantizedModel`` as
    ``quantized``.  ``frames_per_step`` k > 1 takes (B, k, J, F) per step and
    returns (B, k, J_out, 3): k frames of latency for fewer, wider dispatches.
    ``device`` defaults to the card; ``ring_impl="dma"`` writes the per-layer
    ``bf16`` engine's block rings with the ring-push kernel (K7).

    ``mesh=``, a sequence of devices, scales the streams out: the stream batch
    is split into contiguous equal shards, one per device, each with its own
    copy of the weights and its own rings, and the steps exchange nothing;
    ``step`` returns the whole batch on ``mesh[0]``.  The fused engines refuse
    it, as in the JAX package: :class:`MultiDeviceStreamingLifter` runs them on
    independent stream groups.
    """

    def __init__(self, config: TemporalModelConfig, model: TemporalModel = None, *,
                 engine: str = "bf16", quantized: QuantizedModel = None, mesh=None,
                 frames_per_step: int = 1, device=None, ring_impl: str = "dus"):
        if engine not in ENGINES:
            raise ValueError(f"unknown streaming engine {engine!r}")
        if engine in ("int8", "int8_fused") and quantized is None:
            raise ValueError(f"engine={engine!r} requires the quantized pytree")
        if engine in ("bf16", "bf16_fused") and model is None:
            raise ValueError(f"engine={engine!r} requires params and state (the model)")
        if frames_per_step < 1:
            raise ValueError("frames_per_step must be >= 1")
        if engine in ("bf16", "bf16_fused"):
            _stream_dtype(config)  # reject 'mixed' with guidance up front
        if engine == "bf16_fused" and _stream_dtype(config) != torch.bfloat16:
            raise ValueError("engine='bf16_fused' requires compute_dtype='bfloat16'")
        if engine.endswith("_fused") and mesh is not None:
            raise ValueError(f"engine={engine!r} does not support mesh=; use the "
                             "per-layer engines, or MultiDeviceStreamingLifter for "
                             "independent stream groups on several devices")
        if mesh is not None and device is not None:
            raise ValueError("mesh= and device= are mutually exclusive")
        if ring_impl not in ("dus", "dma"):
            raise ValueError(f"unknown ring implementation {ring_impl!r}")
        self.config = config
        self.engine = engine
        self.frames_per_step = frames_per_step
        self.ring_impl = ring_impl
        self._stream_state = None
        self._shards = None
        if mesh is not None:
            self._shards = [StreamingCausalLifter(
                config, model, engine=engine, quantized=quantized,
                frames_per_step=frames_per_step, device=d, ring_impl=ring_impl)
                for d in mesh]
            self.device = self._shards[0].device
            return
        self.device = torch.device("cuda" if device is None else device)
        # The per-frame int8_fused dispatch on a card replays a CUDA graph, made at
        # the first reset(); every other engine, k > 1 and the CPU run eagerly.
        self._graphed = (engine == "int8_fused" and frames_per_step == 1
                         and self.device.type == "cuda")
        self._graph = None
        self.model = None if model is None else _model_on(model, self.device)
        self.quantized = None if quantized is None else quantized_on(quantized, self.device)
        self._weights = self.quantized
        if engine in ("bf16", "bf16_fused"):
            self._weights = prepare_stream_weights(config, self.model)
        elif engine == "int8_fused":
            self._weights = prepare_int8_fused(self.quantized)

    def _split(self, frames):
        """The contiguous equal shards of a stream batch, one per mesh device."""
        n = len(self._shards)
        if frames.shape[0] % n:
            raise ValueError(f"{frames.shape[0]} streams do not split evenly over the "
                             f"mesh's {n} devices")
        g = frames.shape[0] // n
        return [frames[i * g:(i + 1) * g] for i in range(n)]

    def _frames(self, frames):
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.asarray(frames, np.float32))
        return frames.to(self.device, torch.float32)

    def reset(self, first_frames) -> None:
        if self._shards is not None:
            for lifter, part in zip(self._shards, self._split(first_frames)):
                lifter.reset(part)
            self._stream_state = [lifter._stream_state for lifter in self._shards]
            return
        x = self._frames(first_frames)
        k = self.frames_per_step
        with full_float32():
            if self.engine in ("int8", "int8_fused"):
                self._stream_state = (
                    init_stream_state_int8_multi(self.config, self.quantized, x, k) if k > 1
                    else init_stream_state_int8(self.config, self.quantized, x))
            else:
                self._stream_state = (
                    init_stream_state_multi(self.config, self.model, x, k) if k > 1
                    else init_stream_state(self.config, self.model, x))
        if self._graphed:
            self._graph_reset()

    def _graph_reset(self) -> None:
        """Writes the warm-up state into the graph's rings, or captures the graph
        over this state's rings the first time and whenever the batch changes; the
        lifter's state then holds the graph's rings."""
        state = self._stream_state
        with torch.cuda.device(self.device):
            if self._graph is None or self._graph.shape[0] != state["bufs"][0].shape[1]:
                self._graph = None  # frees the old graph's pool first
                self._graph = _Int8StepGraph(self.config, self._weights, state, self.device)
            else:
                self._graph.reset(state)
        self._stream_state = {"bufs": self._graph.bufs, "ptr": list(state["ptr"])}

    def step(self, frame) -> torch.Tensor:
        """One dispatch: frame is (B, J, F), or (B, k, J, F) with k > 1."""
        if self._stream_state is None:
            raise RuntimeError("call reset() first")
        with span("vp3d.stream.step"):
            if self._shards is not None:
                return torch.cat([lifter.step(part).to(self.device)
                                  for lifter, part in zip(self._shards, self._split(frame))])
            if self._graph is not None:
                if not isinstance(frame, torch.Tensor):
                    frame = np.asarray(frame, np.float32)
                flat = self._graph.step(frame)
                self._stream_state["ptr"] = _advance_ptrs(self._stream_state["ptr"],
                                                          self._graph.caps)
                return _poses(self.config, flat, flat.shape[0], None)
            with span("vp3d.stream.frames"):
                x = self._frames(frame)
            multi = self.frames_per_step > 1
            if self.engine == "int8_fused":
                step = stream_step_int8_multi_fused if multi else stream_step_int8_fused
            elif self.engine == "int8":
                step = stream_step_int8_multi if multi else stream_step_int8
            elif self.engine == "bf16_fused":
                step = stream_step_bf16_multi_fused if multi else stream_step_bf16_fused
            elif multi:
                step = stream_step_multi
            else:
                step = lambda c, w, s, f: stream_step(c, w, s, f, _ring_impl=self.ring_impl)
            with full_float32():
                out, self._stream_state = step(self.config, self._weights,
                                               self._stream_state, x)
            return out


class MultiDeviceStreamingLifter:
    """Independent stream groups over local devices: contiguous groups
    ``[i*B/N, (i+1)*B/N)`` live on ``devices[i]``, one
    :class:`StreamingCausalLifter` each, every engine included.  ``step`` returns
    the per-device outputs as a list."""

    def __init__(self, config: TemporalModelConfig, model: TemporalModel = None, *,
                 engine: str = "bf16", quantized: QuantizedModel = None,
                 frames_per_step: int = 1, devices=None):
        if devices:
            self.devices = [torch.device(d) for d in devices]
        else:
            self.devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.lifters = [
            StreamingCausalLifter(config, model, engine=engine, quantized=quantized,
                                  frames_per_step=frames_per_step, device=d)
            for d in self.devices]
        self.frames_per_step = frames_per_step
        self._groups = None

    def _bounds(self, n_streams: int):
        n = len(self.devices)
        if n_streams % n:
            raise ValueError(f"{n_streams} streams do not split evenly over {n} devices")
        g = n_streams // n
        return [(i * g, (i + 1) * g) for i in range(n)]

    def reset(self, first_frames) -> None:
        first_frames = np.asarray(first_frames)
        self._groups = self._bounds(first_frames.shape[0])
        for (lo, hi), lifter in zip(self._groups, self.lifters):
            lifter.reset(first_frames[lo:hi])

    def step(self, frames):
        """frames: (B, J, F), or (B, k, J, F) with k > 1.  Returns the list of
        per-device (B/N, [k,] J_out, 3) outputs."""
        if self._groups is None:
            raise RuntimeError("call reset() first")
        frames = np.asarray(frames)
        return [lifter.step(frames[lo:hi])
                for (lo, hi), lifter in zip(self._groups, self.lifters)]


# ---------------------------------------------------------------------------
# Serving CLI: wild archive -> per-frame streamed poses
# ---------------------------------------------------------------------------


def _load_wild_streams(data_dir: str, keypoints: str):
    """(video names, per-video (T, J, 2) keypoints) of a custom-dataset archive,
    with the screen normalization of the offline runner (load_2d_detections)."""
    from videopose3d_torch.datasets.custom import CustomDataset
    from videopose3d_torch.ops.camera import normalize_screen_coordinates

    archive_path = os.path.join(data_dir, f"data_2d_custom_{keypoints}.npz")
    dataset = CustomDataset(archive_path)
    archive = np.load(archive_path, allow_pickle=True)
    detections = archive["positions_2d"].item()
    videos, streams = [], []
    for video in dataset.subjects():
        kps = detections[video]["custom"][0].astype(np.float32)
        cam = dataset.cameras()[video][0]
        kps[..., :2] = np.asarray(normalize_screen_coordinates(
            kps[..., :2], w=cam["res_w"], h=cam["res_h"]))
        videos.append(video)
        streams.append(kps)
    return videos, streams


def stream_archive(config: TemporalModelConfig, lifter, streams) -> List[np.ndarray]:
    """Serve every video as one stream of a shared batch: a video that ends early
    is fed its last frame (its outputs are cut to length).  Honors the lifter's
    ``frames_per_step``; the poses stay on the device until the last step.

    Returns one (T_i, J_out, 3) float32 array per video."""
    lengths = [s.shape[0] for s in streams]
    k = lifter.frames_per_step
    t_pad = -(-max(lengths) // k) * k
    padded = np.stack([np.concatenate([s, np.repeat(s[-1:], t_pad - n, axis=0)])
                       for s, n in zip(streams, lengths)])         # (B, T_pad, J, F)
    lifter.reset(padded[:, 0])
    steps = []
    for t0 in range(0, t_pad, k):
        poses = lifter.step(padded[:, t0] if k == 1 else padded[:, t0:t0 + k])
        steps.append(poses if isinstance(poses, list) else [poses])
    groups = []
    for g in range(len(steps[0])):
        per_step = torch.stack([s[g] for s in steps], dim=1).cpu().numpy()
        groups.append(per_step.reshape(per_step.shape[0], t_pad, *per_step.shape[-2:]))
    poses = np.concatenate(groups, axis=0)
    return [poses[i, :n] for i, n in enumerate(lengths)]


def main(argv=None):
    import argparse

    from videopose3d_torch.checkpoint import load_any_checkpoint
    from videopose3d_torch.runner import load_model, resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m videopose3d_torch.streaming",
        description="Per-frame streaming 3D lifting over a wild "
                    "(custom-dataset) archive with a causal checkpoint")
    ap.add_argument("-k", "--keypoints", required=True,
                    help="custom archive suffix (data_2d_custom_<k>.npz)")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--checkpoint", required=True,
                    help="path to a causal-model checkpoint (.bin or pickle)")
    ap.add_argument("-arc", "--architecture", default="3,3,3,3,3")
    ap.add_argument("-ch", "--channels", type=int, default=1024)
    ap.add_argument("--engine", choices=ENGINES, default="bf16")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="bf16-engine compute dtype (int8 ignores this)")
    ap.add_argument("--videos", default=None,
                    help="comma-separated subset of video names")
    ap.add_argument("--frames-per-step", type=int, default=1,
                    help="micro-batch k frames per dispatch (higher "
                         "throughput, k frames of added latency)")
    ap.add_argument("--calibration-clips", type=int, default=8,
                    help="int8 engines: max clips sampled for activation "
                         "calibration (evenly spaced across the archive)")
    ap.add_argument("--shard-devices", type=int, default=1,
                    help="split the stream batch into independent groups "
                         "over this many local devices (works with every "
                         "engine incl. the fused kernels; short batches are "
                         "padded with a repeated stream)")
    ap.add_argument("--output", required=True,
                    help="output .npz: one (T, J, 3) pose array per video")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.calibration_clips < 1:
        ap.error("--calibration-clips must be >= 1")
    if args.engine == "bf16_fused" and args.compute_dtype != "bfloat16":
        ap.error("--engine bf16_fused requires --compute-dtype bfloat16")
    filter_widths = tuple(int(x) for x in args.architecture.split(","))
    if args.engine.endswith("_fused") and torch.device(args.device).type == "cuda":
        # The fused step's limits, known before any data loads.
        from videopose3d_torch.ops.kernels.streaming_fused import step_limit_error
        refused = step_limit_error(args.engine, args.channels, filter_widths[1:],
                                   args.frames_per_step)
        if refused:
            raise SystemExit(f"error: {refused}")
    device = resolve_device(args.device)

    videos, streams = _load_wild_streams(args.data_dir, args.keypoints)
    if args.videos:
        wanted = args.videos.split(",")
        missing = [v for v in wanted if v not in videos]
        if missing:
            raise KeyError(f"videos not in archive: {missing}")
        streams = [streams[videos.index(v)] for v in wanted]
        videos = wanted

    checkpoint = load_any_checkpoint(args.checkpoint)
    config = TemporalModelConfig(
        num_joints_in=streams[0].shape[-2], in_features=streams[0].shape[-1],
        num_joints_out=17, filter_widths=filter_widths, causal=True,
        channels=args.channels, compute_dtype=args.compute_dtype)
    model = TemporalModel(config).to(device)
    load_model(model, checkpoint["model_pos"])
    model.eval()
    rf = receptive_field(config)
    print(f"INFO: streaming {len(videos)} video(s), receptive field {rf} "
          f"frames, engine {args.engine}")

    if args.engine in ("int8", "int8_fused"):
        from videopose3d_torch.ops.kernels.temporal_block_int8 import (
            quantize_temporal_model)
        # Calibrate across a bounded number of separate clips: activation ranges
        # need a few hundred representative frames, and separate clips avoid
        # windows that straddle unrelated videos.
        max_clips, max_len = args.calibration_clips, rf + 256
        if len(streams) <= max_clips:
            picked = streams
        elif max_clips == 1:
            picked = [streams[0]]
        else:
            picked = [streams[i * (len(streams) - 1) // (max_clips - 1)]
                      for i in range(max_clips)]
        print(f"INFO: int8 calibration on {len(picked)} of {len(streams)} "
              f"clip(s) (--calibration-clips {max_clips}), up to "
              f"{max_len} frames each")
        t_cal = max(rf, min(max_len, max(s.shape[0] for s in picked)))
        clips = []
        for s in picked:
            s = s[:t_cal]
            if s.shape[0] < t_cal:  # short clip: edge-replicate the tail
                s = np.concatenate([s, np.repeat(s[-1:], t_cal - s.shape[0], axis=0)])
            clips.append(s)
        q = quantize_temporal_model(config, model, torch.from_numpy(np.stack(clips)).to(device))
        lifter_args = (config,)
        lifter_kwargs = dict(engine=args.engine, quantized=q,
                             frames_per_step=args.frames_per_step)
    else:
        lifter_args = (config, model)
        lifter_kwargs = dict(engine=args.engine, frames_per_step=args.frames_per_step)

    if args.shard_devices > 1:
        if device.type == "cuda":
            if args.shard_devices > torch.cuda.device_count():
                ap.error(f"--shard-devices {args.shard_devices} > "
                         f"{torch.cuda.device_count()} local devices")
            devices = [torch.device("cuda", i) for i in range(args.shard_devices)]
        else:
            devices = [device] * args.shard_devices
        # Independent stream groups must split evenly: pad the batch by
        # repeating the last stream (extra outputs are dropped below).
        n_pad = (-len(streams)) % len(devices)
        streams = streams + [streams[-1]] * n_pad
        print(f"INFO: sharding {len(streams)} streams "
              f"({n_pad} padding) over {len(devices)} local devices")
        lifter = MultiDeviceStreamingLifter(*lifter_args, devices=devices, **lifter_kwargs)
    else:
        lifter = StreamingCausalLifter(*lifter_args, device=device, **lifter_kwargs)

    t0 = time.perf_counter()
    all_outputs = stream_archive(config, lifter, streams)
    elapsed = time.perf_counter() - t0
    outputs = all_outputs[:len(videos)]
    n_frames = sum(o.shape[0] for o in outputs)
    n_computed = sum(o.shape[0] for o in all_outputs)
    pad_note = ("" if n_computed == n_frames else
                f"; wall time includes {n_computed - n_frames} "
                f"computed padding frames from --shard-devices")
    print(f"INFO: streamed {n_frames} frames in {elapsed:.2f} s "
          f"({n_frames / max(elapsed, 1e-9):.0f} poses/s end-to-end"
          f"{pad_note})")

    out_dir = os.path.dirname(os.path.abspath(args.output))
    os.makedirs(out_dir, exist_ok=True)
    np.savez(args.output, **dict(zip(videos, outputs)))
    print("Saved streamed poses to", args.output)


if __name__ == "__main__":
    main()
