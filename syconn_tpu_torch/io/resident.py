"""Device-resident volume store (counterpart of ``syconn_tpu/io/resident.py``).

Keeps full volumes in device memory across pipeline steps, so that a step
slices its windows on the card instead of streaming the volume from disk
through the host again, and only compact results cross back.

* keys are ``(volume_path, channel, mag)`` — the coordinates of the chunked
  disk store, so any consumer holding a ``ChunkedVolume`` path can probe for
  a resident copy and otherwise read from disk;
* ``seg`` channels are held as int32 (the device kernels' label space; a
  volume with ids of 2**31 and above is refused — the limit of the packed
  contact codec), ``raw`` as uint8;
* mag pyramid levels are derived on the device (mean pool for raw, stride
  for seg) and cached;
* a byte budget (the ``budget_gb`` argument of :func:`put`; there is no
  configuration layer yet) guards device memory: a put that would exceed it
  is refused and the caller keeps its disk path — nothing is evicted
  mid-pipeline;
* a numpy array is uploaded asynchronously from pinned memory; the first
  consumer on the same stream waits for the copy.

The disk store remains the durability layer.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.device import default_device

log = logging.getLogger("syconn_tpu_torch.resident")

__all__ = ["put", "get", "drop", "clear", "enabled", "total_bytes", "stats", "fetch"]

_REG: Dict[Tuple[str, str, int], torch.Tensor] = {}
_LOCK = threading.Lock()
_DTYPES = {"raw": (np.uint8, torch.uint8), "seg": (np.int32, torch.int32)}


def _key(path: str, channel: str, mag: int) -> Tuple[str, str, int]:
    return (os.path.normpath(os.path.abspath(str(path))), channel, int(mag))


def enabled() -> bool:
    """Resident volumes are on whenever a CUDA card is attached; a put with
    an explicit ``device`` (the tests pass ``"cpu"``) is always taken."""
    return torch.cuda.is_available()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def total_bytes() -> int:
    with _LOCK:
        return sum(_nbytes(t) for t in _REG.values())


def stats() -> Dict[str, float]:
    with _LOCK:
        return {"n_volumes": len(_REG),
                "gb": sum(_nbytes(t) for t in _REG.values()) / (1 << 30)}


def put(path: str, channel: str, arr, mag: int = 1, device=None,
        budget_gb: float = 10.0) -> bool:
    """Register a full volume for ``(path, channel, mag)``.

    ``arr`` may be a numpy array (uploaded asynchronously from pinned
    memory) or a tensor already on its device (kept where it is, cast if
    needed). Returns False, leaving the caller on its disk path, when the
    store is off (no card and no explicit ``device``), a seg id does not
    fit int32, or the store would grow beyond ``budget_gb``.
    """
    if device is None and not isinstance(arr, torch.Tensor) and not enabled():
        return False
    np_dtype, t_dtype = _DTYPES[channel]
    if channel == "seg" and isinstance(arr, np.ndarray):
        mx = int(arr.max(initial=0))
        if mx >= 2**31:
            log.warning("resident put refused: seg ids exceed int32 (%d)", mx)
            return False
    nbytes = int(np.prod(arr.shape)) * np.dtype(np_dtype).itemsize
    budget = int(float(budget_gb) * (1 << 30))
    if total_bytes() + nbytes > budget:
        log.warning("resident put refused: %s would exceed the %.1f GB budget (%.2f GB resident)",
                    _key(path, channel, mag), budget / (1 << 30), total_bytes() / (1 << 30))
        return False
    if isinstance(arr, torch.Tensor):
        dev = arr if device is None else arr.to(default_device(device))
        dev = dev.to(t_dtype)
    else:
        device = default_device(device)
        host = torch.from_numpy(np.ascontiguousarray(arr.astype(np_dtype, copy=False)))
        if device.type == "cuda":
            dev = host.pin_memory().to(device, non_blocking=True)
        else:
            dev = host.clone()
    with _LOCK:
        _REG[_key(path, channel, mag)] = dev
    log.info("resident: registered %s %s mag%d (%.2f GB total)",
             os.path.basename(os.path.normpath(str(path))), channel, mag,
             total_bytes() / (1 << 30))
    return True


def get(path: str, channel: str, mag: int = 1, derive: bool = True) -> Optional[torch.Tensor]:
    """The resident tensor for ``(path, channel, mag)`` or None.

    With ``derive=True`` a missing mag level is computed on the device from
    mag 1 (raw: 2x mean pool per octave; seg: stride sampling — the chunked
    store's pyramid semantics) and cached.
    """
    k = _key(path, channel, mag)
    with _LOCK:
        if k in _REG:
            return _REG[k]
    if not derive or mag == 1:
        return None
    base = get(path, channel, 1, derive=False)
    if base is None or (mag & (mag - 1)) != 0:
        return None
    dev = base
    m = 1
    while m < mag:
        if any(s < 2 for s in dev.shape):
            return None
        ev = tuple((s // 2) * 2 for s in dev.shape)
        dev = dev[:ev[0], :ev[1], :ev[2]]
        if channel == "raw":
            # eight stride-2 slices summed in f32: sums of 8 uint8 values
            # are exact, so this is the mean pool without an 8x temporary
            acc = None
            for di in range(2):
                for dj in range(2):
                    for dk in range(2):
                        s = dev[di::2, dj::2, dk::2].to(torch.float32)
                        acc = s if acc is None else acc + s
            dev = (acc * 0.125).to(torch.uint8)
        else:
            dev = dev[::2, ::2, ::2].contiguous()
        m *= 2
    with _LOCK:
        _REG[k] = dev
    return dev


def drop(path: Optional[str] = None, channel: Optional[str] = None) -> int:
    """Forget resident volumes (all of a path, a (path, channel), or
    everything with ``path=None``). Returns the number dropped."""
    with _LOCK:
        if path is None:
            n = len(_REG)
            _REG.clear()
            return n
        norm = os.path.normpath(os.path.abspath(str(path)))
        keys = [k for k in _REG if k[0] == norm and (channel is None or k[1] == channel)]
        for k in keys:
            del _REG[k]
        return len(keys)


def clear() -> None:
    drop(None)


def fetch(dev: torch.Tensor) -> np.ndarray:
    """Device-to-host copy (what is left of the JAX package's
    ``timed_fetch``: a card on the host's own bus has no link to watch)."""
    return dev.cpu().numpy()
