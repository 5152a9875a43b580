"""Training harness for the port's models (counterpart of
``syconn_tpu/models/train.py``).

The JAX package trains with a jitted optax chain,
``clip_by_global_norm(1.0)`` then ``adamw(lr, weight_decay)``; here the
same update is PyTorch autograd over the port's modules (the convolutions
and products are PyTorch's, as JAX's are XLA's) and a
``torch.optim.AdamW``:

* *clipping* is optax's formula, written out: with the global norm ``n`` of
  all gradients, every gradient becomes ``(g / n) * max_norm`` when
  ``n >= max_norm`` and stays as it is otherwise (no epsilon;
  ``torch.nn.utils.clip_grad_norm_`` divides by ``n + 1e-6``);
* *weight decay* reaches every parameter (kernels, biases, norm scales), one
  parameter group with no exclusions: optax adds ``wd * p`` to the Adam
  direction before the learning rate scales it, which is AdamW's decoupled
  ``p *= 1 - lr * wd``; eps 1e-8 outside the square root;
* *the schedule* is evaluated at the count of updates applied before this
  one (optax's ``scale_by_schedule``), and each group's ``lr`` is set from
  it before every ``optimizer.step()``.

Labels ``-1`` are ignored by the losses and by ``acc``. The multi-device
forms (``mesh``, ``tensor_axis``, ``state_shardings``) are ROADMAP Queue 1
item 11 and raise here.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, default_device

__all__ = ["TrainState", "make_train_state", "make_train_step", "make_class_train_step",
           "make_triplet_train_step", "train_dense", "softmax_xent_loss", "weighted_xent",
           "triplet_loss", "warmup_cosine_decay_schedule", "clip_by_global_norm_",
           "state_shardings"]

_MULTI_DEVICE = ("multi-device training (mesh, tensor-parallel layouts) is ROADMAP Queue 1 "
                 "item 11 and is not ported yet")


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine over ``decay_steps -
    warmup_steps`` down to ``end_value``, held there. Evaluated in f32, as
    JAX evaluates it."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float((f32(init_value) - f32(peak_value)) * frac + f32(peak_value))
        n = decay_steps - warmup_steps
        c = f32(min(count - warmup_steps, n))
        cos = f32(0.5) * (f32(1) + f32(np.cos(f32(np.pi) * c / f32(n))))
        return float(f32(peak_value) * ((f32(1) - f32(alpha)) * cos + f32(alpha)))

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: ``g -> (g / n) * max_norm``
    for every gradient when the global norm ``n`` is not below
    ``max_norm``. Returns ``n`` (a device scalar: no host synchronisation)."""
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class TrainState:
    """The model (on its device), a ``torch.optim.AdamW`` over all of its
    parameters in one group, the learning-rate schedule (count -> lr), the
    clipping norm (``None``: no clipping) and ``step``, the number of
    updates applied. ``params`` is the model's state as a flax params tree
    (what ``models/io.py::save_model`` writes and the dense predictor takes).
    """

    def __init__(self, model: torch.nn.Module, schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, clip_norm: Optional[float] = 1.0):
        self.model = model
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.step = 0
        self.optimizer = torch.optim.AdamW(list(model.parameters()), lr=schedule(0),
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def params(self) -> dict:
        from .convert import flax_tree_from_module

        return flax_tree_from_module(self.model)

    def apply_gradients(self) -> None:
        """Clip the gradients the last ``backward`` left, take one AdamW
        step at ``schedule(step)`` and clear them."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        if self.clip_norm is not None:
            clip_by_global_norm_([p.grad for p in params], self.clip_norm)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def make_train_state(model, example_shape: Tuple[int, ...], learning_rate: float = 1e-3,
                     weight_decay: float = 1e-4, seed: int = 0,
                     total_steps: Optional[int] = None, device: DeviceLike = None) -> TrainState:
    """Initialise ``model`` from ``seed`` with flax's default initialisers
    (``models/io.py::init_model_params``; the values are not the JAX
    package's ``PRNGKey(seed)`` draws) on ``device`` (the card unless
    ``"cpu"``) and wrap it with the optimizer of the JAX package's
    ``make_train_state``: clip 1.0, AdamW at ``learning_rate``, or with
    ``total_steps`` a 3% linear warmup from lr/10 and a cosine down to
    lr/30. ``example_shape`` is the input flax's ``init`` traces; the port's
    modules take their widths from their constructors, so it is not used."""
    from .io import init_model_params

    del example_shape
    init_model_params(model, seed=seed)
    model.to(default_device(device))
    if total_steps:
        lr = warmup_cosine_decay_schedule(
            init_value=learning_rate / 10.0, peak_value=learning_rate,
            warmup_steps=max(int(total_steps * 0.03), 1), decay_steps=int(total_steps),
            end_value=learning_rate / 30.0)
    else:
        lr = lambda count: learning_rate  # noqa: E731
    return TrainState(model, lr, weight_decay=weight_decay, clip_norm=1.0)


def softmax_xent_loss(logits: torch.Tensor, labels: torch.Tensor,
                      class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels; label -1 = ignore.
    ``class_weights`` re-weights each loss by its label's weight; the
    denominator is ``max(sum(w), 1e-6)``."""
    logits = logits.float()
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    z = logits - logits.detach().amax(-1, keepdim=True)
    losses = torch.log(torch.exp(z).sum(-1)) - z.gather(-1, safe[..., None])[..., 0]
    w = valid.to(losses.dtype)
    if class_weights is not None:
        w = w * class_weights.to(losses.device)[safe]
    return (losses * w).sum() / torch.clamp(w.sum(), min=1e-6)


def weighted_xent(class_weights) -> Callable:
    cw = torch.as_tensor(np.asarray(class_weights, np.float32))

    def loss(logits, labels):
        return softmax_xent_loss(logits, labels, class_weights=cw)

    return loss


def state_shardings(state, mesh, tensor_axis: str = "tp"):
    raise NotImplementedError(_MULTI_DEVICE)


def _input(state: TrainState, x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if isinstance(x, np.ndarray) else x,
                           dtype=torch.float32).to(state.device, non_blocking=True)


def _labels(state: TrainState, y) -> torch.Tensor:
    return torch.as_tensor(np.asarray(y) if isinstance(y, np.ndarray) else y).to(
        state.device, torch.int64, non_blocking=True)


def _acc(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    valid = y >= 0  # ignore-label (-1) points excluded
    hits = ((logits.detach().argmax(-1) == y) & valid).sum()
    return hits.float() / valid.sum().clamp_min(1).float()


def make_train_step(mesh=None, data_axis: str = "data", spatial_axis: Optional[str] = "sp",
                    tensor_axis: Optional[str] = None, loss_fn: Callable = softmax_xent_loss,
                    state_template=None):
    """``step(state, x, y) -> (state, {"loss", "acc"})``: forward, loss,
    backward and one optimizer update (the state is updated in place and
    returned). Metrics stay device scalars."""
    if mesh is not None or tensor_axis is not None:
        raise NotImplementedError(_MULTI_DEVICE)

    def step(state: TrainState, x, y):
        x, y = _input(state, x), _labels(state, y)
        state.model.train()
        logits = state.model(x)
        loss = loss_fn(logits, y)
        loss.backward()
        state.apply_gradients()
        return state, {"loss": loss.detach(), "acc": _acc(logits, y)}

    return step


def make_class_train_step(mesh=None, dict_output: bool = False):
    """Classification step; ``dict_output`` for models that return a dict
    with a ``"logits"`` entry (``PointClassNet``)."""
    if mesh is not None:
        raise NotImplementedError(_MULTI_DEVICE)

    def step(state: TrainState, x, y):
        x, y = _input(state, x), _labels(state, y)
        state.model.train()
        out = state.model(x)
        logits = out["logits"] if dict_output else out
        loss = softmax_xent_loss(logits, y)
        loss.backward()
        state.apply_gradients()
        return state, {"loss": loss.detach(), "acc": _acc(logits, y)}

    return step


def triplet_loss(za: torch.Tensor, zp: torch.Tensor, zn: torch.Tensor,
                 margin: float = 0.2) -> torch.Tensor:
    """Margin triplet loss on normalized embeddings (tCMN training,
    reference: syconn/cnn/cnn_tnet*.py)."""
    d_ap = ((za - zp) ** 2).sum(-1)
    d_an = ((za - zn) ** 2).sum(-1)
    return torch.clamp(d_ap - d_an + margin, min=0.0).mean()


def make_triplet_train_step(embed_key: Optional[str] = "embedding", margin: float = 0.2):
    """Triplet step for embedding models (dict output with ``embedding``,
    or a raw embedding output when ``embed_key`` is None)."""

    def step(state: TrainState, xa, xp, xn):
        state.model.train()

        def emb(x):
            out = state.model(_input(state, x))
            return out[embed_key] if embed_key else out

        loss = triplet_loss(emb(xa), emb(xp), emb(xn), margin)
        loss.backward()
        state.apply_gradients()
        return state, {"loss": loss.detach()}

    return step


def train_dense(model, data_iter: Iterator[Tuple[np.ndarray, np.ndarray]], n_steps: int,
                example_shape: Tuple[int, ...], learning_rate: float = 1e-3, mesh=None,
                log_every: int = 50, state: Optional[TrainState] = None, log=None,
                device: DeviceLike = None):
    """Train on an iterator of (x, y) batches; returns (state, history of
    (step, loss, acc) every ``log_every`` steps and at the last)."""
    if state is None:
        state = make_train_state(model, example_shape, learning_rate, device=device)
    step_fn = make_train_step(mesh)
    history = []
    for i in range(n_steps):
        x, y = next(data_iter)
        state, metrics = step_fn(state, x, y)
        if (i + 1) % log_every == 0 or i == n_steps - 1:
            loss, acc = float(metrics["loss"]), float(metrics["acc"])
            history.append((i + 1, loss, acc))
            if log is not None:
                log.info("step %d loss %.4f acc %.4f", i + 1, loss, acc)
    return state, history
