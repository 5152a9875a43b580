"""Driver entry points (counterpart of the repository's ``__graft_entry__.py``).

:func:`entry` returns ``(fn, (params, x))``: the organelles U-Net at its
published width, seed-initialised, and a forward ``fn(params, x)`` giving
the argmax and the max of the full-resolution logits. On the card ``fn``
runs the inference engine (``models/unet_engine.py``) through the three
conv kernels of ``ops/csrc/conv3d_wgmma.cu``; a kernel that does not build
or launch raises. On the CPU it runs the plain ``UNet3D.forward``.

:func:`dryrun_multichip` runs the JAX dry run's five checks on a
:class:`..parallel.device.DeviceMesh` of ``n_devices`` positions: one
training step on a data x sp x tp mesh with the parameters split over
``tp`` (finite loss), the halo-exchanged boundary mask, the sharded contact
kernel and property scan (each equal to its serial version) and a GPipe
step (finite loss), with the JAX version's shapes, stencil, halos and
seeds. Without real cards to spread over, the mesh is logical: ``n_devices``
times the one device (``[cuda:0] * n`` on one card, ``[cpu] * n`` here).

``python -m syconn_tpu_torch.tools.entry [--device cpu]`` runs
``dryrun_multichip(8)``, as ``__graft_entry__.py``'s ``__main__`` does.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..models.convert import module_state_from_flax, params_from_flax
from ..models.io import init_model_params
from ..models.unet3d import UNet3D, unet_variants
from ..models.unet_engine import unet_apply_full
from ..utils.device import DeviceLike, default_device

__all__ = ["ENTRY_SHAPE", "entry", "dryrun_multichip", "main"]

ENTRY_SHAPE = (1, 128, 128, 64, 1)


def entry(device: DeviceLike = None) -> Tuple[Callable, Tuple[dict, torch.Tensor]]:
    """``(fn, (params, x))``: ``params`` the organelles U-Net's flax params
    tree (numpy leaves, drawn from seed 0 by ``models/io.py::
    init_model_params``), ``x`` zeros of :data:`ENTRY_SHAPE` on the device,
    ``fn(params, x) -> (argmax, max)`` of the logits over classes. ``fn``
    takes any flax tree of the same structure (the JAX package's, converted
    to numpy leaves, included); it converts a tree once and keeps it while
    it is called with the same tree."""
    dev = default_device(device)
    model = UNet3D(**unet_variants("organelles"))
    params = init_model_params(model, seed=0)
    model.to(dev).eval()
    x = torch.zeros(ENTRY_SHAPE, dtype=torch.float32, device=dev)
    held: Dict[str, object] = {}

    @torch.no_grad()
    def fwd(params: dict, x) -> Tuple[torch.Tensor, torch.Tensor]:
        if held.get("tree") is not params:
            held.clear()
            held["tree"] = params
            if dev.type == "cuda":
                held["engine"] = params_from_flax(params, dev)
            else:
                model.load_state_dict(module_state_from_flax(params))
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        if dev.type == "cuda":
            logits = unet_apply_full(model, held["engine"], x)
        else:
            logits = model(x)
        best = logits.max(dim=-1)
        return best.indices, best.values

    return fwd, (params, x)


def _mesh_shape(n_devices: int) -> Tuple[int, int, int]:
    """data x sp x tp, as the JAX dry run chooses it."""
    if n_devices % 8 == 0:
        return n_devices // 4, 2, 2
    if n_devices % 2 == 0:
        return n_devices // 2, 2, 1
    return n_devices, 1, 1


def _check(ok: bool, what: str) -> None:
    """A dry-run check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """The five checks of the JAX ``dryrun_multichip`` on a logical mesh of
    ``n_devices`` positions, each on ``device`` (the card unless ``"cpu"``).
    Raises ``AssertionError`` on a failed check; prints one summary line and
    returns the mesh shape, the losses and the number of ``tp``-split
    parameters."""
    from ..models.train import make_train_state, make_train_step, state_shardings
    from ..ops.contacts import detect_cs, detect_seg_boundaries
    from ..ops.props import object_properties_arrays
    from ..parallel.device import get_device_mesh
    from ..parallel.halo import sharded_boundary_mask
    from ..parallel.pipeline import init_stage_params, make_pipeline_train_step
    from ..parallel.sharded import detect_cs_slab_sharded, object_properties_sharded

    dev = default_device(device)
    devices = [dev] * n_devices

    # (1) one training step: data parallel x spatial (z over 'sp', halos
    # exchanged in every conv) x tensor parallel (features over 'tp')
    dp, sp, tp = _mesh_shape(n_devices)
    mesh = get_device_mesh(n_devices, axis_names=("data", "sp", "tp"), mesh_shape=(dp, sp, tp),
                           devices=devices)
    model = UNet3D(features=(16, 32), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=3)
    state = make_train_state(model, (1, 16, 16, 16, 1), device=dev)
    n_tp = sum(v is not None for v in state_shardings(state, mesh, "tp").values())
    step = make_train_step(mesh, tensor_axis="tp", state_template=state)

    rng = np.random.default_rng(0)
    batch = max(4, n_devices // sp)
    x = rng.integers(0, 255, (batch, 16, 16, 16, 1)).astype(np.float32)
    y = (x[..., 0] > 127).astype(np.int32)
    state, metrics = step(state, x, y)
    loss = float(metrics["loss"])
    _check(np.isfinite(loss), f"non-finite loss: {loss}")
    _check(tp == 1 or n_tp > 0, "no parameter split over 'tp'")

    # (2) the boundary mask with its x faces exchanged between shards
    halo_axis = "sp" if sp > 1 else "data"
    n_shards = sp if sp > 1 else dp
    vol = rng.integers(0, 4, (16 * n_shards, 8, 8)).astype(np.int32)
    sharded = sharded_boundary_mask(vol, mesh, axis_name=halo_axis)
    serial = detect_seg_boundaries(vol.astype(np.uint32))
    _check(np.array_equal(sharded.astype(bool), serial), "halo-exchange mismatch")

    # (3, 4) the pipeline's contact kernel and property scan, x-sharded over
    # every position, exact against serial
    sp_mesh = get_device_mesh(n_devices, axis_names=("sp",), devices=devices)
    stencil = (5, 5, 3)
    h = (2, 2, 1)
    core = (8 * n_devices, 12, 8)
    seg = rng.integers(0, 5, tuple(core[i] + 2 * h[i] for i in range(3))).astype(np.uint32)
    packed_sh = detect_cs_slab_sharded(seg, sp_mesh, stencil=stencil, tile=(8, 8, 8))
    packed_serial = detect_cs(seg, stencil=np.asarray(stencil, np.int32))
    _check(np.array_equal(packed_sh, packed_serial), "sharded contact kernel mismatch")
    vol2 = rng.integers(0, 7, (8 * n_devices, 8, 8)).astype(np.uint32)
    ids_m, rep_m, bb_m, sz_m = object_properties_sharded(vol2, sp_mesh, max_ids=64)
    ids_s, rep_s, bb_s, sz_s = object_properties_arrays(vol2)
    _check(np.array_equal(ids_m, ids_s.astype(np.uint64)) and np.array_equal(sz_m, sz_s)
           and np.array_equal(rep_m, rep_s) and np.array_equal(bb_m, bb_s),
           "sharded props mismatch")

    # (5) pipeline parallelism: the GPipe schedule over 'pp', one SGD step
    pp, pp_loss = 0, None
    if n_devices >= 2:
        pp = 4 if n_devices % 4 == 0 else 2
        pp_mesh = get_device_mesh(pp, axis_names=("pp",), devices=devices)
        pparams = init_stage_params(torch.Generator().manual_seed(0), pp, width=16)
        pstep, place = make_pipeline_train_step(pp_mesh, lr=1e-2)
        stages = place(pparams)
        xs = torch.from_numpy(rng.normal(size=(4, 8, 16)).astype(np.float32)).to(dev)
        stages, pl = pstep(stages, xs, xs * 0.5)
        pp_loss = float(pl)
        _check(np.isfinite(pp_loss), f"non-finite pp loss: {pp_loss}")

    shape = dict(mesh.shape)
    print(f"dryrun_multichip OK: mesh={shape}, loss={loss:.4f}, halo-exchange boundary kernel "
          f"exact" + (f", pp({pp}-stage) loss={pp_loss:.4f}" if pp_loss is not None else ""),
          flush=True)
    return dict(mesh=shape, loss=loss, tp_params=n_tp, pp_stages=pp, pp_loss=pp_loss)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="'cpu' for a logical CPU mesh")
    args = ap.parse_args(argv)
    return dryrun_multichip(8, device=args.device)


if __name__ == "__main__":
    main()
