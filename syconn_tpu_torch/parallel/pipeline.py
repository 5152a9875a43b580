"""Pipeline parallelism over a ``pp`` mesh axis (counterpart of
``syconn_tpu/parallel/pipeline.py``).

Stages of a residual trunk live on successive devices along ``pp`` and
microbatches stream through them on GPipe's schedule: with S stages and M
microbatches there are T = M + S - 1 ticks, and at tick t stage s runs
microbatch t - s, its output copied to stage s+1's device. One process
drives every stage (see ``parallel/device.py``); the backward is autograd's
through those copies, so ``loss.backward()`` through :func:`pipeline_loss`
gives the forward+backward pipeline without hand-written bubbles.

Stages share one activation width (residual blocks). Params are a dict
``{"w": (S, L, d, d), "b": (S, L, d)}`` stacked on the stage axis, as in the
JAX package; :func:`make_pipeline_train_step`'s ``place`` turns it into one
``{"w", "b"}`` per stage on that stage's device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .device import DeviceMesh, on_device, place

__all__ = ["init_stage_params", "from_jax", "stack_stage_params", "pipeline_apply",
           "pipeline_loss", "make_pipeline_train_step"]


def init_stage_params(generator: torch.Generator, n_stages: int, width: int,
                      n_layers: int = 2, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Residual-MLP stage params stacked on a leading (n_stages,) axis, the
    axis that splits over ``pp``: per stage ``n_layers`` dense layers of
    constant ``width``, He-normal weights drawn from ``generator`` (JAX's
    draws come from its PRNG key: carry them over with :func:`from_jax`),
    zero biases."""
    w = torch.randn((n_stages, n_layers, width, width), generator=generator, dtype=dtype)
    return {"w": w * np.sqrt(2.0 / width), "b": torch.zeros((n_stages, n_layers, width),
                                                            dtype=dtype)}


def from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's stacked stage params (numpy leaves) as tensors."""
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params.items()}


def stack_stage_params(per_stage: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack a list of per-stage dicts into leading-axis-stacked params."""
    return {k: torch.stack([p[k] for p in per_stage]) for k in per_stage[0]}


def _stage_fn(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """One stage: residual MLP block; params {'w': (L, d, d), 'b': (L, d)}."""
    h = x
    for i in range(params["w"].shape[0]):
        h = torch.clamp_min(h @ params["w"][i] + params["b"][i], 0.0)
    return x + h


def _per_stage(params, n_stages: int) -> List[Dict[str, torch.Tensor]]:
    if isinstance(params, dict):  # stacked: index the stage axis
        return [{k: v[s] for k, v in params.items()} for s in range(n_stages)]
    return list(params)


def pipeline_apply(params, x_mb: torch.Tensor, mesh: DeviceMesh, axis: str = "pp",
                   stage_fn: Callable = _stage_fn) -> torch.Tensor:
    """Run the pipelined trunk. ``params``: stacked (leading axis n_stages)
    or a list of per-stage dicts (as ``place`` gives them; each on its
    stage's device); ``x_mb`` (n_microbatch, mb, d). Returns (n_microbatch,
    mb, d) on ``x_mb``'s device. Differentiable."""
    devs = mesh.axis_devices(axis)
    n_stages = len(devs)
    stages = [{k: place(v, d) for k, v in p.items()}
              for p, d in zip(_per_stage(params, n_stages), devs)]
    m = x_mb.shape[0]
    outs: List[torch.Tensor] = [None] * m
    act: List[torch.Tensor] = [None] * n_stages  # each stage's input for this tick
    for t in range(m + n_stages - 1):
        nxt: List[torch.Tensor] = [None] * n_stages
        for s in range(n_stages):
            mb = t - s
            if not 0 <= mb < m:
                continue  # the bubble: stage s idles at this tick
            inp = place(x_mb[mb], devs[0]) if s == 0 else act[s]
            with on_device(devs[s]):
                out = stage_fn(stages[s], inp)
            if s == n_stages - 1:
                outs[mb] = place(out, x_mb.device)
            else:
                nxt[s + 1] = place(out, devs[s + 1])
        act = nxt
    return torch.stack(outs)


def pipeline_loss(params, x_mb: torch.Tensor, y_mb: torch.Tensor, mesh: DeviceMesh,
                  axis: str = "pp", stage_fn: Callable = _stage_fn) -> torch.Tensor:
    """Mean squared error through the pipeline."""
    out = pipeline_apply(params, x_mb, mesh, axis, stage_fn)
    return torch.mean((out - y_mb.to(out.device)) ** 2)


def make_pipeline_train_step(mesh: DeviceMesh, axis: str = "pp",
                             stage_fn: Callable = _stage_fn, lr: float = 1e-2):
    """SGD train step over the pipeline. Returns ``(step, place)``:
    ``place(params)`` -> a list of per-stage leaf tensors, stage s on the
    s-th ``axis`` device; ``step(stages, x_mb, y_mb) -> (stages, loss)``
    updates them in place (each stage on its own device)."""
    devs = mesh.axis_devices(axis)

    def place_stages(params) -> List[Dict[str, torch.Tensor]]:
        return [{k: place(v.detach(), d).clone().requires_grad_(True) for k, v in p.items()}
                for p, d in zip(_per_stage(params, len(devs)), devs)]

    def step(stages, x_mb, y_mb):
        loss = pipeline_loss(stages, x_mb, y_mb, mesh, axis, stage_fn)
        loss.backward()
        with torch.no_grad():
            for p in stages:
                for v in p.values():
                    v -= lr * v.grad
                    v.grad = None
        return stages, loss.detach()

    return step, place_stages
