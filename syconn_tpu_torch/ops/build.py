"""Build and bind the port's CUDA kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds, not minutes.
Builds happen at first use, never at import; the libraries go to
``SYCONN_TORCH_BUILD_DIR`` (default ``syconn_tpu_torch/ops/_build``, listed
in ``.gitignore``) under a name keyed by the source's hash, so an edited
source rebuilds and concurrent processes never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
    "-lineinfo",
]

_P, _I = ctypes.c_void_p, ctypes.c_int

# source name -> {C function: (argtypes, restype)}
SOURCES: Dict[str, Dict[str, tuple]] = {
    "conv3d": {
        "conv3d_launch": ([_I, _I] + [_P] * 8 + [_I] * 7 + [_P], _I),
        "conv3d_error_string": ([_I], ctypes.c_char_p),
    },
    "conv3d_wgmma": {
        "conv3d_wgmma_launch": ([_I, _I] + [_P] * 8 + [_I] * 7 + [_P], _I),
        "conv3d_wgmma_plan": ([_I, _I, _I, _I], _I),
        "conv3d_wgmma_error_string": ([_I], ctypes.c_char_p),
    },
    "contacts": {
        "detect_cs_columns_launch": ([_P] * 5 + [_I] * 10 + [_P], _I),
        "contacts_error_string": ([_I], ctypes.c_char_p),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_SECONDS: Dict[str, float] = {}


def build_dir() -> str:
    d = os.environ.get("SYCONN_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _paths(name: str) -> Tuple[str, str]:
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        key = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, os.path.join(build_dir(), f"lib{name}_{key}.so")


def _start(name: str):
    """Start the nvcc of one source; returns (popen, tmp, lib) or None when
    the library is already built."""
    src, lib = _paths(name)
    if os.path.isfile(lib):
        return None
    tmp = f"{lib}.tmp{os.getpid()}_{threading.get_ident()}"
    cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, lib


def _finish(name: str, job, t0: float):
    proc, tmp, lib = job
    out, _ = proc.communicate()
    log = out.decode(errors="replace")
    with open(lib[:-3] + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, lib)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def _bind(name: str) -> ctypes.CDLL:
    _, lib = _paths(name)
    dll = ctypes.CDLL(lib)
    for fn, (argtypes, restype) in SOURCES[name].items():
        f = getattr(dll, fn)
        f.argtypes = argtypes
        f.restype = restype
    return dll


def build_all() -> Dict[str, float]:
    """Compile every source not yet loaded, all nvcc processes started
    together, and bind them; returns the build seconds per source (0 for
    one already on disk)."""
    with _LOCK:
        t0 = time.perf_counter()
        jobs = {n: _start(n) for n in SOURCES if n not in _LIBS}
        for n, job in jobs.items():
            if job is None:
                BUILD_SECONDS.setdefault(n, 0.0)
            else:
                _finish(n, job, t0)
            _LIBS[n] = _bind(n)
        return dict(BUILD_SECONDS)


def library(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built on first call."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def ptxas_log(name: str) -> str:
    """What ``nvcc -Xptxas=-v`` printed for the source's last build."""
    _, lib = _paths(name)
    try:
        with open(lib[:-3] + ".log") as f:
            return f.read()
    except OSError:
        return ""
