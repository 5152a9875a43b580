"""Model directories: ``arch.json`` (constructor name + kwargs + meta) and
flax-msgpack ``params.msgpack`` (counterpart of ``syconn_tpu/models/io.py``).

The packaged weights are read in place, by file path, from the JAX
package's ``syconn_tpu/models/pretrained/<name>/`` — data, not an import.
"""

from __future__ import annotations

import json
import os
from typing import Any, Tuple

from .msgpack_io import msgpack_restore

__all__ = ["load_model", "load_model_meta", "model_exists", "packaged_model_path"]


def packaged_model_path(name: str) -> str:
    """Path of a weight set shipped with the repository."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "syconn_tpu", "models", "pretrained", name)


def model_exists(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "arch.json")) and os.path.isfile(
        os.path.join(path, "params.msgpack"))


def _resolve(path: str) -> str:
    """A model dir, else the packaged weights of the same name."""
    if model_exists(path):
        return path
    packaged = packaged_model_path(os.path.basename(os.path.normpath(path)))
    if model_exists(packaged):
        return packaged
    raise FileNotFoundError(f"no model at '{path}' and no packaged weights at '{packaged}'")


def _build(arch: dict):
    if arch["cls"] != "UNet3D":
        raise KeyError(f"model class '{arch['cls']}' is not ported yet")
    from .unet3d import UNet3D

    kw = {k: v for k, v in arch["kwargs"].items() if k != "dtype"}
    # tuples were serialized as lists
    for k, v in list(kw.items()):
        if isinstance(v, list):
            kw[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
    return UNet3D(**kw)


def load_model(path: str) -> Tuple[Any, dict]:
    """Load ``(model, params)``: the port's :class:`UNet3D` (CPU, weights
    loaded) and the flax params tree of numpy arrays."""
    from .convert import module_state_from_flax

    path = _resolve(path)
    with open(os.path.join(path, "arch.json")) as f:
        arch = json.load(f)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        params = msgpack_restore(f.read())
    model = _build(arch)
    model.load_state_dict(module_state_from_flax(params))
    return model, params


def load_model_meta(path: str) -> dict:
    """The meta dict persisted with a model (model dir, then packaged)."""
    try:
        path = _resolve(path)
        with open(os.path.join(path, "arch.json")) as f:
            return json.load(f).get("meta", {})
    except (OSError, ValueError):
        return {}
