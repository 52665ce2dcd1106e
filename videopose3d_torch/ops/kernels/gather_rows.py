"""Row-window gather of the training batch assembly: CUDA kernel and its plain
PyTorch version.

Counterpart of ``videopose3d_tpu/ops/pallas/gather_rows.py``:
``stack([flat[r : r + window, :out_cols] for r in row0])`` over a row-major
``(R, C)`` stream.  Each ``row0`` is clamped to ``[0, R - window]`` first (the
``dynamic_slice`` semantics the TPU kernel is bitwise-equal to), so no window
reads past the stream.  The CUDA stream needs no tail margin or lane padding:
the kernel reads exact rows.

Dispatch: a tensor on the CPU takes :func:`gather_windows_plain`; a CUDA
tensor launches the kernel (``csrc/gather_rows.cu``) or raises.  ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from videopose3d_torch.ops.kernels.build import launch

LAUNCHES = {"gather_windows": 0}


def _clamped(row0, rows: int, window: int):
    if window > rows:
        raise ValueError(f"window of {window} rows is longer than the {rows}-row stream")
    return row0.long().clamp(0, rows - window)


def gather_windows_plain(flat, row0, *, window: int, out_cols: Optional[int] = None):
    """(R, C) stream, (B,) first rows -> (B, window, out_cols or C)."""
    rows, cols = flat.shape
    oc = cols if out_cols is None else out_cols
    idx = _clamped(row0, rows, window)[:, None] + torch.arange(window, device=flat.device)
    return flat[idx][:, :, :oc]


def gather_windows(flat, row0, *, window: int, out_cols: Optional[int] = None):
    """The window gather: float32 or bfloat16 ``flat`` (R, C), int ``row0`` (B,)
    on the same device; returns (B, window, out_cols or C) in ``flat.dtype``."""
    if flat.ndim != 2 or row0.ndim != 1:
        raise ValueError(f"gather_windows: flat must be (R, C) and row0 (B,), got "
                         f"{tuple(flat.shape)} and {tuple(row0.shape)}")
    rows, cols = flat.shape
    oc = cols if out_cols is None else out_cols
    if not 0 < oc <= cols:
        raise ValueError(f"out_cols={out_cols} out of range for {cols} columns")
    if flat.device.type == "cpu":
        return gather_windows_plain(flat, row0, window=window, out_cols=out_cols)
    if flat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gather_windows: unsupported dtype {flat.dtype}")
    if not flat.is_contiguous():
        raise ValueError("gather_windows: flat must be contiguous")
    if row0.device != flat.device:
        raise ValueError(f"row0 is on {row0.device}, flat on {flat.device}")
    if not 0 < window <= rows:
        raise ValueError(f"window of {window} rows does not fit the {rows}-row stream")
    row0 = row0.to(torch.int32).contiguous()
    out = torch.empty((row0.shape[0], window, oc), dtype=flat.dtype, device=flat.device)
    if row0.shape[0] == 0:
        return out
    launch("vp3d_gather_rows", flat.device, flat, rows, cols, flat.element_size(), row0,
           row0.shape[0], window, oc, out, count=(LAUNCHES, "gather_windows"))
    return out
