"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started together,
and the objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``.  The build happens at first use, into
``build/torch_kernels/`` at the root of the checkout, under a name keyed by a
hash of the sources and flags, so an edited source is rebuilt and an unchanged
one is not.  Nothing here runs at import time: a machine without ``nvcc`` or a
card can import every module of the package.

Every kernel wrapper launches through :func:`launch`, which owns the calling
convention (the device, the current stream, pointers, the library's error, the
launch counts) and checks its operands with :func:`check`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int

# vp3d_temporal_block(variant, dtype, batch, t_in, t_out, channels, x, x_cols,
#   w0, s0, b0, k0, w_taps, s1, b1, n_taps, dilation, res_offset, w2, s2, b2,
#   ws, bs, j3, e, h, y, part, part_floats, k_slices (host int[]), out, stream)
_BLOCK_ARGTYPES = ([_I] * 6 + [_P, _I] + [_P] * 3 + [_I] + [_P] * 3 + [_I] * 3
                   + [_P] * 3 + [_P] * 2 + [_I] + [_P] * 4 + [ctypes.c_longlong]
                   + [ctypes.POINTER(_I)] + [_P] * 2)

# Argument types of the other entry points (the CUDA stream last, where taken).
_ENTRY_ARGTYPES = {
    # (flat, rows, cols, esize, row0, batch, window, out_cols, out, stream)
    "vp3d_gather_rows": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P],
    # csrc/train_block.cu
    "vp3d_tb_conv_stats": [_I] * 7 + [_P] * 10,
    "vp3d_tb_norm_drop_matmul_stats": [_I] * 5 + [_P] * 12,
    "vp3d_tb_norm_drop_res": [_I] * 3 + [_P] * 6,
    "vp3d_tb_relu_mask_bn_sums": [_I] * 5 + [_P] * 8,
    "vp3d_tb_dz_matmul_dd": [_I] * 5 + [_P] * 9,
    "vp3d_tb_du_dtaps_res": [_I] * 7 + [_P] * 10,
    "vp3d_tb_dw_gemm": [_I] * 7 + [_P] * 6,
    "vp3d_tb_tf32_split": [_I] * 4 + [_P] * 4,
    "vp3d_tb_stats_reduce": [_I] * 2 + [_P] * 5,
    "vp3d_tb_geometry": [_I],
    # csrc/temporal_block_int8.cu: (variant, accshift, batch, t_in, t_out, channels,
    #   x, k_in, w0, s0, b0, wa, a1, b1, n_taps, dilation, res_offset, wb, a2, b2, r,
    #   ws, bs, j3, work (host void*[]), part_ints, fpart_floats, k_slices (host
    #   int[]), out, stream)
    "vp3d_int8_block": [_I] * 6 + [_P, _I] + [_P] * 6 + [_I] * 3 + [_P] * 6 + [_I]
                       + [ctypes.POINTER(_P), ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.POINTER(_I), _P, _P],
    # (frame, ring, pos, batch, c_in, cap, w0, s0, b0, channels, eq, stream)
    "vp3d_stream_front": [_P] * 3 + [_I] * 3 + [_P] * 3 + [_I, _P, _P],
    # csrc/streaming_fused.cu: (act_type, n_blocks, batch, channels, k, doubled, rows,
    #   slices, x, ws, bs, j3, out, xbuf, ptrs (host void*[]), ints (host int[]), pos,
    #   stream)
    "vp3d_stream_step": [_I] * 8 + [_P] * 3 + [_I, _P, _P, ctypes.POINTER(_P),
                                               ctypes.POINTER(_I), _P, _P],
    # (ring, row, offset_bytes, n_bytes, stream)
    "vp3d_ring_push": [_P, _P, ctypes.c_longlong, ctypes.c_longlong, _P],
    # (pos, caps (host int[]), n, stream)
    "vp3d_ring_advance": [_P, ctypes.POINTER(_I), _I, _P],
    # csrc/protocols.cu: (pred, target, n, joints, part, out, stream)
    "vp3d_video_protocols": [_P, _P, _I, _I, _P, _P, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_log: str = ""      # ptxas report of the last build (registers, spills)
build_seconds: float = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvp3d_kernels_{h.hexdigest()[:16]}.so"


def _run_all(commands):
    """Runs the commands in parallel; raises with the output of the first that
    fails, else returns their joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in commands]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, text in zip(commands, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
    return "".join(outs)


def _build(out: Path) -> None:
    global build_log, build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    # Objects in a temporary directory, the library under a temporary name and
    # renamed, so concurrent builds never load a half-written library.
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
        cu = [s for s in sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmp_dir, s.stem + ".o") for s in cu]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o]
                        for s, o in zip(cu, objs)])
        tmp = os.path.join(tmp_dir, out.name)
        log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - start
    build_log = log


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if this source has no build."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    lib.vp3d_temporal_block.argtypes = _BLOCK_ARGTYPES
    lib.vp3d_temporal_block.restype = ctypes.c_int
    lib.vp3d_block_max_smem_bytes.argtypes = []
    lib.vp3d_block_max_smem_bytes.restype = ctypes.c_size_t
    lib.vp3d_error_string.argtypes = [_I]
    lib.vp3d_error_string.restype = ctypes.c_char_p
    for name, argtypes in _ENTRY_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vp3d_stream_smem_bytes.argtypes = [_I] * 2
    lib.vp3d_stream_smem_bytes.restype = ctypes.c_size_t
    for kind in ("bf16", "int8"):
        getattr(lib, f"vp3d_stream_{kind}_smem").argtypes = [_I] * 3
        getattr(lib, f"vp3d_stream_{kind}_smem").restype = ctypes.c_size_t
        getattr(lib, f"vp3d_stream_{kind}_max_clusters").argtypes = [_I] * 3
        getattr(lib, f"vp3d_stream_{kind}_max_clusters").restype = ctypes.c_int
    for name in ("vp3d_stream_max_blocks", "vp3d_stream_max_taps"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    _lib = lib
    return lib


def check(name, t, device, dtype, shape, align: int = 1):
    """Raises a ValueError unless the operand ``name`` is a contiguous ``dtype``
    tensor of ``shape`` on ``device`` whose data is ``align``-byte aligned."""
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


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SM count of the card ``device`` (a tensor's device, so indexed)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# The launch record of this thread's CUDA-graph capture, or None (recorded_launches).
_capture = threading.local()


def launch(name: str, device, *args, count=None) -> None:
    """Launches the library's entry point ``name`` on ``device``'s current stream:
    a tensor in ``args`` passes as its data pointer, None as a null pointer, and the
    stream is appended last.  Raises a RuntimeError naming the kernel (``count``'s
    key, else ``name``) and the library's error string if the launch failed.  A
    launch that succeeded is counted at ``count``, a ``(LAUNCHES dict, key)`` pair
    (None: not counted), or inside :func:`recorded_launches` recorded instead."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
            ctypes.c_void_p(stream))
    if code != 0:
        raise RuntimeError(f"the {name if count is None else count[1]} kernel failed to "
                           f"launch: {lib.vp3d_error_string(code).decode()} ({code})")
    if count is not None:
        record = getattr(_capture, "record", None)
        if record is None:
            count[0][count[1]] += 1
        else:
            record.append(count)


@contextlib.contextmanager
def recorded_launches():
    """Around a CUDA-graph capture: the launches this thread makes inside the block
    run nothing, so they are recorded, not counted.  Yields the record, a list of
    ``(LAUNCHES dict, key)`` in launch order; :func:`count_replay` counts it once a
    replay of the graph."""
    _capture.record = record = []
    try:
        yield record
    finally:
        _capture.record = None


def count_replay(record) -> None:
    """Counts each launch of a :func:`recorded_launches` record once: one replay."""
    for launches, key in record:
        launches[key] += 1
