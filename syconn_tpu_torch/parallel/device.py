"""Device meshes and tensor placement (counterpart of
``syconn_tpu/parallel/device.py``).

The JAX package runs one program over a ``jax.sharding.Mesh``; the port
keeps one process too (a single controller, as JAX's): a
:class:`DeviceMesh` names the ``torch.device`` at every mesh position, and
each shard's work runs on its position's device, one shard after another
from the calling thread. Several positions may name the same device (a
*logical* mesh, the counterpart of XLA's virtual CPU devices): then every
line of the sharded code runs on one card, and shards that name the same
device share its copies.

Placement helpers stand in for ``NamedSharding``: :func:`data_sharding`
splits a tensor along a dim over a mesh axis, :func:`replicated` copies it
to every position, :func:`gather` concatenates shards in mesh order. Every
copy between devices goes through :func:`place`.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["DeviceMesh", "get_device_mesh", "canonical_device", "place", "on_device",
           "data_sharding", "replicated", "gather"]


def canonical_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card, as the
    tensors placed there report it (``cuda:0``), so devices compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceMesh:
    """An object array of ``torch.device``s with one name per axis.

    ``shape`` is an ordered ``{axis: size}``, as ``jax.sharding.Mesh.shape``
    is, so ``mesh.shape.get("sp", 1)`` reads as in the JAX package."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        devs = np.empty(src.shape, dtype=object)
        for ix in np.ndindex(src.shape):
            devs[ix] = canonical_device(src[ix])
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = devs
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str, at: Optional[Dict[str, int]] = None) -> List[torch.device]:
        """The devices along ``axis``, each other axis at its index in
        ``at`` (default 0); a missing axis gives the one device at ``at``."""
        at = dict(at or {})
        ix = []
        for name in self.axis_names:
            ix.append(slice(None) if name == axis else int(at.get(name, 0)))
        return list(np.atleast_1d(self.devices[tuple(ix)]))

    def __repr__(self) -> str:
        names = ", ".join(str(d) for d in self.devices.reshape(-1))
        return f"DeviceMesh({dict(self.shape)}, [{names}])"


def get_device_mesh(n_devices: Optional[int] = None,
                    axis_names: Tuple[str, ...] = ("data", "sp"),
                    mesh_shape: Optional[Sequence[int]] = None,
                    devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh over the given devices, or over every CUDA device.

    Defaults: all devices on the first axis, 1 on the others.
    ``mesh_shape`` may hold one -1, filled with the remaining devices. A
    logical mesh repeats a device: ``devices=[torch.device("cuda:0")] * 4``
    (or ``[torch.device("cpu")] * 8``). Without ``devices`` and without a
    card this raises: there is no CPU default."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device available; pass devices= (e.g. "
                               "[torch.device('cpu')] * 8 for a logical CPU mesh)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = [n] + [1] * (len(axis_names) - 1)
    mesh_shape = list(mesh_shape)
    if -1 in mesh_shape:
        known = int(np.prod([s for s in mesh_shape if s != -1]))
        mesh_shape[mesh_shape.index(-1)] = n // known
    if int(np.prod(mesh_shape)) != n:
        raise ValueError(f"mesh_shape {mesh_shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return DeviceMesh(arr.reshape(mesh_shape), axis_names)


def place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: the tensor itself when it is there already,
    else a copy. A copy between two cards is a peer copy ordered after the
    source device's current stream and before the target's (PyTorch's
    ``copy_``); from pinned host memory it does not block the host. A copy
    to the host blocks, so that the host reads finished data."""
    device = torch.device(device)
    return t.to(device, non_blocking=device.type == "cuda")


def on_device(device: torch.device):
    """Context that makes ``device`` the current CUDA device (no-op on the
    CPU), so that anything a shard allocates lands on its own card."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def data_sharding(t: torch.Tensor, mesh: DeviceMesh, axis: str = "data",
                  dim: int = 0) -> List[torch.Tensor]:
    """Split ``t`` along ``dim`` over ``axis``: shard i on the i-th device
    along ``axis``. The extent must divide over the axis."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if t.shape[dim] % n:
        raise ValueError(f"extent {t.shape[dim]} of dim {dim} must divide over {n} "
                         f"'{axis}' shards")
    return [place(s, d) for s, d in zip(torch.chunk(t, n, dim=dim), devs)]


def replicated(t: torch.Tensor, mesh: DeviceMesh, axis: Optional[str] = None
               ) -> List[torch.Tensor]:
    """``t`` at every position of ``axis`` (every position of the mesh when
    None); positions naming the same device share one copy."""
    devs = mesh.devices.reshape(-1) if axis is None else mesh.axis_devices(axis)
    copies: Dict[torch.device, torch.Tensor] = {}
    out = []
    for d in devs:
        if d not in copies:
            copies[d] = place(t, d)
        out.append(copies[d])
    return out


def gather(shards: Sequence[torch.Tensor], device: torch.device, dim: int = 0
           ) -> torch.Tensor:
    """Concatenate shards in mesh order on ``device``."""
    return torch.cat([place(s, device) for s in shards], dim=dim)
