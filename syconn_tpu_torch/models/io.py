"""Model directories: ``arch.json`` (constructor name + kwargs + meta) and
flax-msgpack ``params.msgpack`` (counterpart of ``syconn_tpu/models/io.py``).

The packaged weights are read in place, by file path, from the JAX
package's ``syconn_tpu/models/pretrained/<name>/`` — data, not an import.
:func:`get_or_init_model` resolves a model as the JAX package does (the
working-directory model, then the packaged one, then, unless
``require_trained``, a seed initialisation persisted with
``{"initialized_only": true, "seed": seed}`` in its meta). The port draws
that initialisation from a ``torch.Generator`` with flax's default
initialisers (:func:`init_model_params`), so its values are not the JAX
package's ``PRNGKey(seed)`` draws; the files it writes are read by the JAX
package's ``load_model``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Callable, Dict, Optional, Tuple

from .msgpack_io import msgpack_restore, msgpack_serialize

__all__ = ["load_model", "load_model_meta", "model_exists", "packaged_model_path",
           "register_model", "save_model", "init_model_params", "get_or_init_model"]


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


_MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    """Register a module class under ``name``, the ``cls`` of ``arch.json``;
    :func:`load_model` consults the registry before the built-in classes."""

    def deco(cls):
        _MODEL_REGISTRY[name] = cls
        return cls

    return deco


def _get_model_cls(name: str):
    if name in _MODEL_REGISTRY:
        return _MODEL_REGISTRY[name]
    from .cmn import MultiViewCMN, TripletCMN, ViewSemSegNet
    from .pointnet import PointClassNet, PointSegNet
    from .unet3d import UNet3D

    classes = {"UNet3D": UNet3D, "PointClassNet": PointClassNet, "PointSegNet": PointSegNet,
               "MultiViewCMN": MultiViewCMN, "TripletCMN": TripletCMN,
               "ViewSemSegNet": ViewSemSegNet}
    if name not in classes:
        raise KeyError(f"Unknown model class '{name}'.")
    return classes[name]


def _build(arch: dict, params: dict):
    from .cmn import MultiViewCMN, TripletCMN, ViewSemSegNet
    from .pointnet import PointClassNet, PointSegNet

    cls = _get_model_cls(arch["cls"])
    kw = {k: v for k, v in arch["kwargs"].items() if k != "dtype"}
    # tuples were serialized as lists
    for k, v in list(kw.items()):
        if isinstance(v, list):
            kw[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
    # flax infers a layer's input width; the port reads it off the first kernel
    if issubclass(cls, (PointClassNet, PointSegNet)):
        kw["n_in"] = int(params["_PointBackbone_0"]["Dense_0"]["kernel"].shape[0])
    elif issubclass(cls, (MultiViewCMN, TripletCMN)):
        kw["n_in"] = int(params["_ViewTrunk_0"]["Conv_0"]["kernel"].shape[2])
    elif issubclass(cls, ViewSemSegNet):
        kw["n_in"] = int(params["Conv_0"]["kernel"].shape[2])
    return cls(**kw)


def load_model(path: str) -> Tuple[Any, dict]:
    """Load ``(model, params)``: the port's module (:class:`UNet3D`, a point
    net or a view net; CPU, weights loaded) and the flax params tree of numpy
    arrays. A missing model raises ``FileNotFoundError`` (seed
    initialisation is :func:`get_or_init_model`'s)."""
    from .convert import module_state_from_flax

    path = _resolve(path)
    with open(os.path.join(path, "arch.json")) as f:
        arch = json.load(f)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        params = msgpack_restore(f.read())
    model = _build(arch, params)
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


def save_model(path: str, model, params: Optional[dict] = None,
               extra_meta: Optional[dict] = None) -> None:
    """Persist a port module as a model directory the JAX package's
    ``load_model`` reads: ``arch.json`` (``model.arch_kwargs()``: the flax
    module's fields) and ``params.msgpack`` (``params``, else the module's
    state as a flax tree)."""
    from .convert import flax_tree_from_module

    os.makedirs(path, exist_ok=True)
    arch = {"cls": type(model).__name__, "kwargs": model.arch_kwargs(), "meta": extra_meta or {}}
    with open(os.path.join(path, "arch.json"), "w") as f:
        json.dump(arch, f, indent=1)
    tree = params if params is not None else flax_tree_from_module(model)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(msgpack_serialize(tree))


# flax's lecun_normal: a normal truncated to [-2, 2] scaled by
# sqrt(1 / fan_in) / 0.8796..., the std of that truncated normal
_TRUNC_STD = 0.87962566103423978


def init_model_params(model, seed: int = 0) -> dict:
    """Initialise ``model`` in place with flax's default initialisers, drawn
    from ``torch.Generator().manual_seed(seed)`` in the module's parameter
    order, and return its flax params tree: conv and dense kernels
    ``lecun_normal`` (a truncated normal of variance 1 / fan_in, fan_in
    counting the kernel taps), biases 0, norm scales 1."""
    import torch

    from .convert import flax_tree_from_module

    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight":
                fan_in = p[0].numel()  # (O, I, taps...): I x taps
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                p.copy_(torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0, 1.0, -2.0, 2.0,
                                                    generator=gen) * std)
            elif leaf == "scale":
                p.fill_(1.0)
            else:
                p.zero_()
    return flax_tree_from_module(model)


def get_or_init_model(path: str, builder: Callable[[], Any], seed: int = 0,
                      require_trained: bool = False):
    """Load a model directory, or initialise one from ``seed`` and persist it.

    Resolution order as the JAX package's: the model at ``path``, then the
    packaged weights of the same name, then (``require_trained`` False) a
    seed initialisation of ``builder()`` (the port module), saved to ``path``
    with ``{"initialized_only": true, "seed": seed}``; with
    ``require_trained`` a missing model raises ``FileNotFoundError``.
    Returns ``(model, params)`` as :func:`load_model`."""
    if model_exists(path):
        return load_model(path)
    packaged = packaged_model_path(os.path.basename(os.path.normpath(path)))
    if model_exists(packaged):
        return load_model(packaged)
    if require_trained:
        raise FileNotFoundError(
            f"no trained weights at '{path}' (and no packaged fallback at '{packaged}'); this "
            f"inference path refuses seed-initialised weights. For smoke runs only, set "
            f"views.allow_untrained_models: true")
    model = builder()
    params = init_model_params(model, seed=seed)
    save_model(path, model, params, extra_meta={"initialized_only": True, "seed": seed})
    return model, params
