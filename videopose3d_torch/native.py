"""ctypes binding of the repo's native (C++) data-loader core,
``native/sampler.cpp``.

Counterpart of ``videopose3d_tpu/native.py``, built into a directory of the
port's own (``build/torch_native/``): ``g++`` compiles the source on first use.
It offers a row permutation bit-compatible with numpy's legacy
``RandomState``: the same output and the same post-call RNG state, so a
checkpoint's RNG state resumes on either path.  Callers check
:func:`available` and use the numpy path otherwise (no ``g++``, no source, or a
library that does not load); the two paths give the same permutations.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO_ROOT, "native", "sampler.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libsampler.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _reap_orphans(tmp: str) -> None:
    """Remove temp files of builders that died between ``g++`` and the rename;
    a live builder's (its pid exists, whoever owns it) is left alone."""
    for stale in glob.glob(f"{_LIB_PATH}.*.tmp"):
        if stale == tmp:
            continue
        try:
            os.kill(int(stale.rsplit(".", 2)[-2]), 0)
        except ValueError:
            pass                 # no pid in the name: an orphan
        except ProcessLookupError:
            pass                 # its builder is gone: an orphan
        except OSError:
            continue             # EPERM: alive, another user's builder
        else:
            continue             # alive
        try:
            os.remove(stale)
        except OSError:
            pass


def _build() -> Optional[str]:
    """The library's path, compiled when it is missing or older than the
    source; None when it cannot be built."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_LIB_PATH) and (
            os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return _LIB_PATH
    # A process-unique temp name, then an atomic rename: concurrent builders
    # (pytest workers) and a killed build never leave a half-written library at
    # the final path, where the mtime check would accept it.
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    _reap_orphans(tmp)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
        return _LIB_PATH
    except (OSError, subprocess.CalledProcessError):
        return None
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:  # a corrupt or foreign library: the numpy path
            return None
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.sampler_permute_rows.argtypes = [
            u32p, ctypes.POINTER(ctypes.c_int32), i64p, ctypes.c_int64, ctypes.c_int64]
        lib.sampler_seed.argtypes = [ctypes.c_uint32, u32p, ctypes.POINTER(ctypes.c_int32)]
        lib.sampler_raw_draws.argtypes = [
            u32p, ctypes.POINTER(ctypes.c_int32), u32p, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _mt_state(random_state: np.random.RandomState):
    name, key, pos, has_gauss, cached = random_state.get_state()
    if name != "MT19937":
        raise ValueError(f"the native core runs MT19937, not {name}")
    return (np.ascontiguousarray(key, dtype=np.uint32), ctypes.c_int32(pos),
            (name, has_gauss, cached))


def _set_mt_state(random_state, key, pos, rest):
    name, has_gauss, cached = rest
    random_state.set_state((name, key, int(pos.value), has_gauss, cached))


def permute_rows(random_state: np.random.RandomState, pairs: np.ndarray) -> np.ndarray:
    """``random_state.permutation(pairs)`` for an (N, K) int64 array: the same
    output and the same post-call RNG state."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native sampler is unavailable (see available())")
    if pairs.ndim != 2 or pairs.dtype != np.int64:
        raise ValueError(f"expected (N, K) int64 rows, got {pairs.dtype} {pairs.shape}")
    key, pos, rest = _mt_state(random_state)
    out = np.array(pairs, order="C", copy=True)
    lib.sampler_permute_rows(key, ctypes.byref(pos), out, out.shape[0], out.shape[1])
    _set_mt_state(random_state, key, pos, rest)
    return out


def raw_draws(random_state: np.random.RandomState, n: int) -> np.ndarray:
    """``n`` raw 32-bit MT19937 outputs, advancing ``random_state``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native sampler is unavailable (see available())")
    key, pos, rest = _mt_state(random_state)
    out = np.empty(n, np.uint32)
    lib.sampler_raw_draws(key, ctypes.byref(pos), out, n)
    _set_mt_state(random_state, key, pos, rest)
    return out
