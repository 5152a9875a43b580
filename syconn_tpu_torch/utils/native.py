"""Build and load the port's host kernel library (counterpart of
``syconn_tpu/utils/native.py``).

``ops/csrc/kernels.cpp`` and ``ops/csrc/teasar.cpp`` are compiled with g++
(-O3 -fopenmp) at first use into one library in the build directory of
:mod:`syconn_tpu_torch.ops.build`, under a name keyed by the sources' hash,
and loaded with ctypes. Without a compiler :func:`get_native` returns None
and the callers take their numpy versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..ops.build import build_dir

log = logging.getLogger("syconn_tpu_torch.native")

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ops", "csrc")
_SRCS = [os.path.join(_CSRC, "kernels.cpp"), os.path.join(_CSRC, "teasar.cpp")]
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp", "-march=native"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_failed = False


def _lib_path() -> str:
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    key = h.hexdigest()[:12]
    return os.path.join(build_dir(), f"libhostkernels_{key}.so")


def _build(lib: str) -> bool:
    tmp = f"{lib}.tmp{os.getpid()}_{threading.get_ident()}"
    try:
        subprocess.run(["g++"] + _FLAGS + _SRCS + ["-o", tmp], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, lib)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        err = getattr(e, "stderr", b"")
        log.warning("host kernel build failed (%s): %s", e, err[:2000] if err else "")
        return False


def get_native() -> Optional[ctypes.CDLL]:
    """The host kernel library, built if needed; None when it cannot be."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = _lib_path()
        if not os.path.isfile(path) and not _build(path):
            _failed = True
            return None
        lib = ctypes.CDLL(path)
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.detect_seg_boundaries_u32.argtypes = [u32p, i64, i64, i64, u8p]
        lib.detect_seg_boundaries_u64.argtypes = [u64p, i64, i64, i64, u8p]
        lib.detect_cs_u32.argtypes = [u32p, u8p, i64, i64, i64, i32, i32, i32, u64p]
        lib.detect_contact_partners_u64.argtypes = [u64p, u8p, i64, i64, i64, i32, i32, i32,
                                                    u64p]
        lib.relabel_u32.argtypes = [u32p, i64, u32p, u32p, i64, i32]
        lib.relabel_u64.argtypes = [u64p, i64, u64p, u64p, i64, i32]
        for fn in (lib.detect_seg_boundaries_u32, lib.detect_seg_boundaries_u64,
                   lib.detect_cs_u32, lib.detect_contact_partners_u64, lib.relabel_u32,
                   lib.relabel_u64):
            fn.restype = None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.teasar_grid.argtypes = [
            u8p, i64, i64, i64, f32p, f64p,
            ctypes.c_double, i32, ctypes.c_double, ctypes.c_double, i64,
            i32p, i64, i32p, i64, f32p, i64p, i64p,
        ]
        lib.teasar_grid.restype = i32
        _lib = lib
        return _lib
