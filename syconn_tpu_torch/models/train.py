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

Labels ``-1`` are ignored by the losses and by ``acc``.

Multi-device steps (``mesh=``) keep one process, as the JAX package's one
jitted GSPMD step does, and equal the single-device step up to float
summation order:

* *data axis*: the batch splits over the ``data`` positions, each with a
  whole replica of the model on its device; each replica's loss numerator
  is divided by the weight summed over all replicas (the global weighted
  mean) and its gradients are summed onto the first replica in mesh order;
  the clip and the AdamW update run once and the parameters are copied
  back to the other replicas;
* *tensor axis* (``tensor_axis`` and ``state_template``): the parameters
  :func:`state_shardings` picks live as ``tp`` shards, with their AdamW
  moments, on the ``tp`` devices; they are gathered for the forward, each
  gradient shard goes back to its owner, the global norm spans all shards
  and the update runs shard by shard;
* *spatial axis* (``spatial_axis``, a ``UNet3D``): each data shard's z
  splits over the ``sp`` positions (``parallel/spatial.py``: cut at the
  model's z downsampling, a halo exchange inside every convolution), each
  with a replica on its device; one backward runs over the sum of the
  shards' loss numerators, since the halos couple them, and the
  denominator, ``loss`` and ``acc`` sum over every data and sp shard.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..parallel import spatial
from ..parallel.device import gather, on_device, place
from ..utils.device import DeviceLike, default_device

__all__ = ["TrainState", "make_train_state", "make_train_step", "make_class_train_step",
           "make_triplet_train_step", "train_dense", "softmax_xent_loss", "weighted_xent",
           "triplet_loss", "warmup_cosine_decay_schedule", "clip_by_global_norm_",
           "state_shardings", "xent_parts"]


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
    ``max_norm``. Returns ``n`` (a device scalar on the first gradient's
    device: no host synchronisation). Gradients may lie on several devices
    (shards): their squared sums meet on the first one."""
    grads = [g for g in grads if g is not None]
    home = grads[0].device
    norm = torch.sqrt(sum(place((g.float() * g.float()).sum(), home) for g in grads))
    keep = norm < max_norm
    on = {home: (keep, norm)}
    for g in grads:
        if g.device not in on:
            on[g.device] = (place(keep, g.device), place(norm, g.device))
        k, n = on[g.device]
        g.copy_(torch.where(k, g, (g / n) * max_norm))
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
        # set by the first multi-device step (:class:`_MeshPlacement`)
        self.placement = None

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


def xent_parts(logits: torch.Tensor, labels: torch.Tensor,
               class_weights: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of weighted losses, sum of weights) of :func:`softmax_xent_loss`;
    ``logits=None`` gives (None, sum of weights), which depends on the
    labels only. A data-parallel step divides each replica's numerator by
    the weights summed over all replicas."""
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    w = valid.to(torch.float32)
    if class_weights is not None:
        w = w * class_weights.to(labels.device)[safe]
    if logits is None:
        return None, w.sum()
    logits = logits.float()
    z = logits - logits.detach().amax(-1, keepdim=True)
    losses = torch.log(torch.exp(z).sum(-1)) - z.gather(-1, safe[..., None])[..., 0]
    return (losses * w).sum(), w.sum()


def softmax_xent_loss(logits: torch.Tensor, labels: torch.Tensor,
                      class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels; label -1 = ignore.
    ``class_weights`` re-weights each loss by its label's weight; the
    denominator is ``max(sum(w), 1e-6)``."""
    num, den = xent_parts(logits, labels, class_weights)
    return num / torch.clamp(den, min=1e-6)


softmax_xent_loss.parts = xent_parts


def weighted_xent(class_weights) -> Callable:
    cw = torch.as_tensor(np.asarray(class_weights, np.float32))

    def loss(logits, labels):
        return softmax_xent_loss(logits, labels, class_weights=cw)

    loss.parts = lambda logits, labels: xent_parts(logits, labels, class_weights=cw)
    return loss


def state_shardings(state, mesh, tensor_axis: str = "tp") -> Dict[str, Optional[Tuple[int, str]]]:
    """The JAX package's tensor-parallel layout in the port's terms: per
    parameter name, ``(dim, tensor_axis)`` where it splits into ``tp`` shards
    over ``tensor_axis``, else None (replicated). JAX's rule: a leaf with
    ndim >= 2 whose flax output-feature (last) dim divides by ``tp`` and is
    at least ``2 * tp``; a kernel's flax last dim is dim 0 of the port's
    ``weight`` (``models/convert.py``), any other leaf keeps its dims. The
    AdamW moments follow their parameter. ``state``: a :class:`TrainState`
    or a module."""
    model = state.model if isinstance(state, TrainState) else state
    tp = int(mesh.shape.get(tensor_axis, 1))
    out = {}
    for name, p in model.named_parameters():
        dim = 0 if name.endswith(".weight") else p.ndim - 1
        split = tp > 1 and p.ndim >= 2 and p.shape[dim] % tp == 0 and p.shape[dim] >= 2 * tp
        out[name] = (dim, tensor_axis) if split else None
    return out


def _position_devices(mesh, data_axis: str, spatial_axis: Optional[str]
                      ) -> List[List[torch.device]]:
    """``[j][k]``: the device of data position j and spatial position k,
    every other axis at 0 (a missing axis counts as one position)."""
    n_data = int(mesh.shape.get(data_axis, 1))
    n_sp = int(mesh.shape.get(spatial_axis, 1)) if spatial_axis else 1

    def at(j, k):
        return mesh.devices[tuple(j if a == data_axis else k if a == spatial_axis else 0
                                  for a in mesh.axis_names)]

    return [[at(j, k) for k in range(n_sp)] for j in range(n_data)]


class _MeshPlacement:
    """Where a :class:`TrainState` lives on a mesh: one model replica per
    distinct device of the ``data`` x ``sp`` positions (the state's own
    model on the first), the parameters of ``layout`` as shards on the
    ``tp`` devices, and an AdamW over the first replica's other parameters
    and those shards, carrying the state's moments over."""

    def __init__(self, state: TrainState, mesh, data_axis: str, spatial_axis: Optional[str],
                 tensor_axis: Optional[str],
                 layout: Optional[Dict[str, Optional[Tuple[int, str]]]]):
        self.mesh = mesh
        self.positions = _position_devices(mesh, data_axis, spatial_axis)
        self.home = self.positions[0][0]
        if state.device != self.home:
            raise ValueError(f"the state lives on {state.device}; the mesh's first data device "
                             f"is {self.home}")
        self.replicas = {self.home: state.model}
        for row in self.positions:
            for d in row:
                if d not in self.replicas:
                    self.replicas[d] = copy.deepcopy(state.model).to(d)
        self.params = dict(state.model.named_parameters())
        self.layout = {k: v for k, v in (layout or {}).items() if v is not None}
        owners = mesh.axis_devices(tensor_axis) if self.layout else []
        old = state.optimizer
        self.shards: Dict[str, List[torch.nn.Parameter]] = {}
        opt_params = []
        moved = {}
        for name, p in self.params.items():
            if name not in self.layout:
                opt_params.append(p)
                if p in old.state:
                    moved[p] = old.state[p]
                continue
            dim = self.layout[name][0]
            pieces = [torch.nn.Parameter(place(t.detach(), d).clone())
                      for t, d in zip(torch.chunk(p.detach(), len(owners), dim), owners)]
            self.shards[name] = pieces
            opt_params += pieces
            st = old.state.get(p, {})
            for k, piece in enumerate(pieces):
                if st:  # moments sliced like the parameter, the step count copied
                    moved[piece] = {
                        key: (v if not torch.is_tensor(v) else v.clone() if v.dim() == 0
                              else place(torch.chunk(v, len(owners), dim)[k], piece.device).clone())
                        for key, v in st.items()}
        group = old.param_groups[0]
        self.optimizer = torch.optim.AdamW(
            opt_params, **{k: group[k] for k in ("lr", "betas", "eps", "weight_decay",
                                                 "amsgrad", "maximize") if k in group})
        for q, st in moved.items():
            self.optimizer.state[q] = st
        state.optimizer = self.optimizer

    def apply(self, state: TrainState, grads: Dict[str, torch.Tensor]) -> None:
        """Gradients (summed, on the first replica's device) -> shards and
        replicated parameters, clip over all of them, one AdamW step, then
        the full parameters back into every replica."""
        for name, g in grads.items():
            if name in self.shards:
                pieces = self.shards[name]
                for piece, gs in zip(pieces, torch.chunk(g, len(pieces), self.layout[name][0])):
                    piece.grad = place(gs, piece.device).contiguous()
            else:
                self.params[name].grad = g
        opt_params = [q for grp in self.optimizer.param_groups for q in grp["params"]]
        if state.clip_norm is not None:
            clip_by_global_norm_([q.grad for q in opt_params], state.clip_norm)
        lr = state.schedule(state.step)
        for grp in self.optimizer.param_groups:
            grp["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        for p in self.params.values():
            p.grad = None
        state.step += 1
        with torch.no_grad():
            for name, pieces in self.shards.items():
                self.params[name].copy_(gather(pieces, self.home, self.layout[name][0]))
            for d, replica in self.replicas.items():
                if d == self.home:
                    continue
                for name, q in replica.named_parameters():
                    q.copy_(place(self.params[name], d))


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


def _mesh_step(mesh, data_axis: str, spatial_axis: Optional[str], tensor_axis: Optional[str],
               layout, loss_fn: Callable, logits_of: Callable):
    """The multi-device step: per data shard (mesh order) the forward, over
    its z shards where ``spatial_axis`` has several positions
    (:func:`parallel.spatial.unet_forward`), the numerator of
    ``loss_fn.parts`` over the weights summed across all shards, and one
    backward; the gradients of every replica summed onto the first, then
    :meth:`_MeshPlacement.apply`."""
    parts = getattr(loss_fn, "parts", None)
    if parts is None:
        raise ValueError("a multi-device step needs a loss with .parts (numerator, "
                         "denominator), as softmax_xent_loss and weighted_xent have")

    def step(state: TrainState, x, y):
        if state.placement is None:
            state.placement = _MeshPlacement(state, mesh, data_axis, spatial_axis, tensor_axis,
                                             layout)
        pl = state.placement
        if pl.mesh is not mesh:
            raise ValueError("this state was placed on another mesh")
        x = torch.as_tensor(np.asarray(x, np.float32) if isinstance(x, np.ndarray) else x,
                            dtype=torch.float32)
        y = torch.as_tensor(np.asarray(y) if isinstance(y, np.ndarray) else y).to(torch.int64)
        n, n_sp = len(pl.positions), len(pl.positions[0])
        xs = torch.chunk(x, n) if n > 1 else [x]
        ys = torch.chunk(y, n) if n > 1 else [y]
        if len(xs) != n or x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} must divide over {n} data shards")
        if n_sp > 1:
            from .unet3d import UNet3D

            if not isinstance(state.model, UNet3D):
                raise TypeError(f"a spatial mesh axis splits a UNet3D's z, not a "
                                f"{type(state.model).__name__}")
            unit = spatial.z_unit(state.model)
            spatial.split_extents(x.shape[3], n_sp, unit)  # raises before any work
        # the global denominator first: the weights depend on the labels only
        den = torch.clamp(sum(parts(None, ys_)[1] for ys_ in ys), min=1e-6)
        total: Dict[str, torch.Tensor] = {}
        loss_sum = hits = valid = None
        for row, xs_, ys_ in zip(pl.positions, xs, ys):
            models = [pl.replicas[d] for d in row]
            uniq = list({id(m): m for m in models}.values())
            for m in uniq:
                m.train()
            d0 = row[0]
            named = [(k, q) for m in uniq for k, q in m.named_parameters()]
            with on_device(d0):
                if n_sp > 1:  # each z shard on its own device, halos copied there
                    xk = [place(t, d) for t, d in zip(spatial.split_z(xs_, n_sp, unit), row)]
                    yk = [place(t, d) for t, d in zip(spatial.split_z(ys_, n_sp, unit), row)]
                    logits = spatial.unet_forward(models, xk)
                else:
                    yk = [place(ys_, d0)]
                    logits = [logits_of(models[0](place(xs_, d0)))]
                num = sum(place(parts(lg, yy)[0], d0) for lg, yy in zip(logits, yk))
                loss = num / place(den, d0)
                gs = torch.autograd.grad(loss, [q for _, q in named])
            for (k, _), g in zip(named, gs):
                g = place(g, pl.home)
                total[k] = g if k not in total else total[k] + g
            ld = place(loss.detach(), pl.home)
            loss_sum = ld if loss_sum is None else loss_sum + ld
            for lg, yy in zip(logits, yk):
                m = yy >= 0
                h = place(((lg.detach().argmax(-1) == yy) & m).sum(), pl.home)
                v = place(m.sum(), pl.home)
                hits = h if hits is None else hits + h
                valid = v if valid is None else valid + v
        pl.apply(state, total)
        return state, {"loss": loss_sum, "acc": hits.float() / valid.clamp_min(1).float()}

    return step


def make_train_step(mesh=None, data_axis: str = "data", spatial_axis: Optional[str] = "sp",
                    tensor_axis: Optional[str] = None, loss_fn: Callable = softmax_xent_loss,
                    state_template=None):
    """``step(state, x, y) -> (state, {"loss", "acc"})``: forward, loss,
    backward and one optimizer update (the state is updated in place and
    returned). Metrics stay device scalars.

    With a ``mesh`` (``parallel.device.DeviceMesh``): the batch splits over
    ``data_axis`` and a ``UNet3D``'s z over ``spatial_axis``, whose z must
    split by ``parallel.spatial.split_extents`` (else ``ValueError``);
    with ``tensor_axis`` in the mesh and a ``state_template`` (a
    :class:`TrainState` or module, for :func:`state_shardings`), the chosen
    parameters split over it. The first step places the state on the mesh
    (see the module docstring); the state must live on the mesh's first
    data device."""
    if mesh is not None:
        layout = None
        if tensor_axis and tensor_axis in mesh.axis_names and state_template is not None:
            layout = state_shardings(state_template, mesh, tensor_axis)
        return _mesh_step(mesh, data_axis, spatial_axis, tensor_axis, layout, loss_fn,
                          lambda out: out)

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
    with a ``"logits"`` entry (``PointClassNet``). With a ``mesh`` the batch
    splits over its ``data`` axis, parameters replicated (see
    :func:`make_train_step`)."""
    if mesh is not None:
        return _mesh_step(mesh, "data", None, None, None, softmax_xent_loss,
                          (lambda out: out["logits"]) if dict_output else (lambda out: out))

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
    (step, loss, acc) every ``log_every`` steps and at the last). ``mesh``:
    see :func:`make_train_step`."""
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
