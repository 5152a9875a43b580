"""Route ``device``: the on-card half of the resident step 1.

Set-up draws the volume on the card. Each pass takes the volume shifted by
the pass index along x (a new input every pass, so no pass can reuse an
earlier pass's output), registers it in ``io.resident``, predicts it with
``ResidentDensePredictor(...).predict_volume_packed`` (every tile, the
predictor's default tile batch; with a ``data`` mesh each batch splits over
the cards and the outputs are gathered on the first), reassembles each
mapped class on the card with ``class_volume_device`` and registers it with
``io.resident.put``, as ``_predict_resident`` does with one slab.

The judge compares the registered maps of the last pass with the reference
on a sample of tiles drawn from the seed.
"""

from __future__ import annotations

import os

import torch

from perfbench.lib import inputs
from perfbench.lib import judge as jd

_DENSE = "syconn_tpu_torch.inference.dense"
SPANS = [
    (f"{_DENSE}:ResidentDensePredictor.predict_volume_packed", "predict_volume_packed", None),
    (f"{_DENSE}:ResidentDensePredictor.class_volume_device", "class_volume_device", None),
    (f"{_DENSE}:DenseTilePredictor._forward_on", "forward_on",
     lambda a, kw: {"batch": int(a[1].shape[0])}),
    ("syconn_tpu_torch.io.resident:put", "resident_put", None),
    ("syconn_tpu_torch.io.resident:drop", "resident_drop", None),
    (f"{_DENSE}:ResidentDensePredictor.__init__", "predictor_init", None),
    # the host waiting on a card: inside another span the program's own
    # wait, alone the pass's closing wait
    ("torch.cuda:synchronize", "sync", None),
]


def setup(ctx):
    from syconn_tpu_torch.parallel.device import get_device_mesh

    model, params = ctx.family.program_model(ctx.arch, ctx.params, ctx.device)
    mesh_n = int(ctx.traffic.get("data_mesh", 1))
    mesh = None
    if mesh_n > 1:
        mesh = get_device_mesh(mesh_n, axis_names=("data",), devices=ctx.devices[:mesh_n])
    base = inputs.em_volume(ctx.volume, ctx.seed, ctx.device)
    return dict(model=model, params=params, mesh=mesh, base=base, shift=None,
                raw=os.path.join(ctx.work, "raw"),
                maps={n: os.path.join(ctx.work, n) for n in ctx.mapping})


def _volume(state, p: int) -> torch.Tensor:
    # shifted by p along x; past the volume's extent the shift wraps to 1 and
    # never to 0, so no window pass gets the warm-up pass's input back
    x = state["base"].shape[0]
    return torch.roll(state["base"], shifts=(p - 1) % (x - 1) + 1 if p else 0, dims=0)


def run_pass(ctx, state, p: int) -> None:
    from syconn_tpu_torch.inference.dense import ResidentDensePredictor
    from syconn_tpu_torch.io import resident

    for path in state["maps"].values():
        resident.drop(path)
    if not resident.put(state["raw"], "raw", _volume(state, p), mag=1, device=ctx.device):
        raise RuntimeError("io.resident refused the volume")
    vol = resident.get(state["raw"], "raw", 1)
    pred = ResidentDensePredictor(state["model"], state["params"], tile_shape=ctx.tile,
                                  halo=ctx.halo, mode="probs", device=ctx.device,
                                  mesh=state["mesh"])
    packed, grid = pred.predict_volume_packed(vol)
    for name, ch in ctx.mapping.items():
        cls = pred.class_volume_device(packed, grid, ch, tuple(ctx.volume))
        if not resident.put(state["maps"][name], "raw", cls, mag=1, device=ctx.device):
            raise RuntimeError(f"io.resident refused the {name} map")
        del cls
    del packed, pred, vol
    if ctx.device.type == "cuda":
        for d in ctx.card_indices:
            torch.cuda.synchronize(d)
    state["shift"] = p


def judge(ctx, state, control: bool = False):
    from syconn_tpu_torch.io import resident

    maps = {n: resident.get(p, "raw", 1, derive=False) for n, p in state["maps"].items()}
    missing = [n for n, m in maps.items() if m is None or tuple(m.shape) != tuple(ctx.volume)]
    vol = _volume(state, state["shift"])
    resident.clear()
    state["base"] = None

    def program_tile(off, ext):
        if missing:
            return None
        return {n: m[off[0]:off[0] + ext[0], off[1]:off[1] + ext[1], off[2]:off[2] + ext[2]]
                for n, m in maps.items()}

    offsets = jd.sample_offsets(ctx.volume, ctx.tile, int(ctx.traffic["judge_tiles"]),
                                ctx.seed)
    t = jd.compare_tiles(ctx.reference, vol, ctx.tile, ctx.halo, ctx.mapping, offsets,
                         program_tile, control=control)
    return dict(numbers=t.numbers(), missing=missing, tile_max=t.tile_max,
                notes={"shift": state["shift"]})
