"""Operations and bytes of the benchmarked work, counted from the model's shapes.

Every count is of the mathematics a layer has to do, not of what an
implementation launches: a multiply-add is two operations, each input byte is
read once and each output byte written once.  A reading against these counts
therefore stays the same whatever implements the layer.  ``cfg`` is a
configuration dict of ``configs/`` (``filter_widths``, ``channels``,
``num_joints_in``, ``in_features``, ``num_joints_out``).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def dilations(cfg):
    d = [1]
    for fw in cfg["filter_widths"][:-1]:
        d.append(d[-1] * fw)
    return d


def receptive_field(cfg):
    return 1 + sum((fw - 1) * d for fw, d in zip(cfg["filter_widths"], dilations(cfg)))


def _widths(cfg):
    c = cfg["channels"]
    return c, cfg["num_joints_in"] * cfg["in_features"], cfg["num_joints_out"] * 3


def dilated_forward_ops(cfg, rows: int, t_in: int) -> int:
    """Operations of the dilated (inference) forward over ``rows`` inputs of
    ``t_in`` frames: every frame each layer computes, padding included."""
    c, c_in, j3 = _widths(cfg)
    fws, ds = cfg["filter_widths"], dilations(cfg)
    t = t_in - (fws[0] - 1)
    ops = 2 * t * fws[0] * c_in * c
    for fw, d in zip(fws[1:], ds[1:]):
        t -= (fw - 1) * d
        ops += 2 * t * (fw + 1) * c * c
    ops += 2 * t * c * j3
    return rows * ops


def dilated_forward_bytes(cfg, rows: int, t_in: int, dtype: str) -> int:
    """Bytes of the same forward: the keypoints read, every weight read once,
    the poses written (float32)."""
    c, c_in, j3 = _widths(cfg)
    fws = cfg["filter_widths"]
    weights = fws[0] * c_in * c + sum((fw + 1) * c * c for fw in fws[1:]) + c * j3
    t_out = t_in - receptive_field(cfg) + 1
    return (DTYPE_BYTES[dtype] * (rows * t_in * c_in + weights) + 4 * rows * t_out * j3)


def ops_per_pose(cfg) -> int:
    """Operations of one output frame of the dilated model at steady state (the
    streaming step computes exactly one new frame of every layer)."""
    c, c_in, j3 = _widths(cfg)
    fws = cfg["filter_widths"]
    return (2 * fws[0] * c_in * c + sum(2 * (fw + 1) * c * c for fw in fws[1:])
            + 2 * c * j3)


def _strided_rows(cfg, batch: int):
    """Rows (batch x frames) of each residual block's output in the strided
    training form (one output frame per sample)."""
    t = receptive_field(cfg) // cfg["filter_widths"][0]
    rows = []
    for fw in cfg["filter_widths"][1:]:
        t //= fw
        rows.append(batch * t)
    return rows


def train_block_ops(cfg, batch: int) -> int:
    """Forward and backward operations of the residual blocks of one strided
    training step: per block the forward's two convolutions, and in the
    backward the gradients of their inputs and of their weights (3x)."""
    c = cfg["channels"]
    return sum(3 * 2 * n * (fw + 1) * c * c
               for n, fw in zip(_strided_rows(cfg, batch), cfg["filter_widths"][1:]))


def train_block_bytes(cfg, batch: int, dtype: str = "float32") -> int:
    """Bytes of the same work: per block its input, weights, two dropout masks,
    output and the output's gradient read or written once, and the gradients of
    its input and weights written once."""
    c = cfg["channels"]
    total = 0
    for n, fw in zip(_strided_rows(cfg, batch), cfg["filter_widths"][1:]):
        x, w = n * fw * c, (fw + 1) * c * c
        total += 2 * x + 2 * w + 2 * n * c + n * c + n * c
    return DTYPE_BYTES[dtype] * total


def train_step_ops(cfg, batch: int) -> int:
    """Model operations of one strided training step: the expand convolution
    forward and its weight gradient (its input needs none), every residual
    block and the shrink forward and backward."""
    c, c_in, j3 = _widths(cfg)
    k0 = cfg["filter_widths"][0]
    t0 = receptive_field(cfg) // k0
    expand = 2 * batch * t0 * k0 * c_in * c
    return 2 * expand + train_block_ops(cfg, batch) + 3 * 2 * batch * c * j3


def stream_blocks_ops(cfg, batch: int) -> int:
    """Operations of one streaming dispatch's residual blocks and shrink (K5's
    work): one new frame of every block for ``batch`` streams."""
    c, _, j3 = _widths(cfg)
    return batch * (sum(2 * (fw + 1) * c * c for fw in cfg["filter_widths"][1:])
                    + 2 * c * j3)


def stream_blocks_bytes(cfg, batch: int) -> int:
    """Bytes of the same: the int8 weights once, each block's taps read from its
    input ring and its new row written, the poses written (float32)."""
    c, _, j3 = _widths(cfg)
    fws = cfg["filter_widths"][1:]
    weights = sum((fw + 1) * c * c for fw in fws) + 2 * c * j3
    rings = batch * sum((fw + 1) * c for fw in fws)
    return weights + rings + 4 * batch * j3


def bound_s(ops: float, n_bytes: float, dtype: str) -> float:
    """The least time an H100 SXM could take: the larger of the operations over
    the dtype's peak and the bytes over the memory's."""
    return max(ops / PEAKS["ops_per_s"][dtype], n_bytes / PEAKS["hbm_bytes_per_s"])
