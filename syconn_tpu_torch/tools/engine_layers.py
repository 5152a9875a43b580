"""Per-layer comparison of the U-Net engine on one device against its plain
version on the CPU: where the differences of a trained net's output enter.

For every conv layer of :func:`..models.unet_engine.unet_apply_packed`
(names ``enc<i>_conv<j>``, ``down<i>``, ``up<k>``, ``dec<k>_conv<j>``,
``head``) two comparisons with the CPU run:

* ``chained``: both runs end to end, so that a layer's difference includes
  what the layers before it passed on;
* ``alone``: the layer fed the CPU run's input of that layer, so that the
  difference is the layer's own.

Each gives the largest absolute difference, the share of values more than
one bf16 ulp (of the CPU value) apart, and the conv kernels' tolerance
(median relative error, share off by more than 10%). After the engine, the
tensor ops of the dense predictor (softmax over classes x patch voxels and
``round(p * 255)``) run on the CPU's logits on both devices.

``python3 -m syconn_tpu_torch.tools.engine_layers [model]`` prints the table
for a packaged model on the CUDA card (default: organelles).
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List

import numpy as np
import torch

from ..models.convert import params_from_flax
from ..models.io import load_model, packaged_model_path
from ..models.unet_engine import unet_apply_packed

__all__ = ["layer_report", "probs_uint8"]


def _ulp_bf16(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value (8 significant bits)."""
    mag = ref.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _diff(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    g, r = got.float().cpu(), ref.float().cpu()
    d = (g - r).abs()
    rel = d / r.abs().clamp_min(1e-2)
    return {"max_abs": float(d.max()), "share_gt_ulp": float((d > _ulp_bf16(r)).float().mean()),
            "median_rel": float(rel.median()), "share_rel_gt_0.1": float((rel > 0.1).float().mean())}


def probs_uint8(logits: torch.Tensor, n_classes: int) -> torch.Tensor:
    """The dense predictor's tensor ops on packed logits: softmax over the
    classes of each patch voxel, then ``round(p * 255)`` as uint8."""
    pvox = logits.shape[-1] // n_classes
    p = torch.softmax(logits.reshape(logits.shape[:-1] + (n_classes, pvox)), dim=-2)
    return torch.round(p * 255.0).to(torch.uint8)


@torch.no_grad()
def layer_report(model, params_dev: dict, params_cpu: dict, vol: np.ndarray,
                 device) -> List[Dict]:
    """Rows of the per-layer comparison of ``vol`` (uint8, (X, Y, Z)):
    ``layer``, ``chained`` and ``alone`` (see the module docstring), then a
    row ``softmax_round`` with the uint8 maps' largest difference and the
    share of voxels that differ."""
    x = torch.from_numpy(np.ascontiguousarray(vol))[None, ..., None].float()
    cpu_trace: List = []
    dev_trace: List = []
    logits = unet_apply_packed(model, params_cpu, x, trace=cpu_trace)
    unet_apply_packed(model, params_dev, x.to(device), trace=dev_trace)
    rows = []
    for (name, inp, out_cpu), (_, _, out_dev) in zip(cpu_trace, dev_trace):
        alone: List = []
        fed = {name: inp.to(device).contiguous()}
        unet_apply_packed(model, params_dev, x.to(device), feed=fed, trace=alone)
        out_alone = next(o for n, _, o in alone if n == name)
        rows.append({"layer": name, "shape": list(out_cpu.shape),
                     "chained": _diff(out_dev, out_cpu), "alone": _diff(out_alone, out_cpu)})
    pc = probs_uint8(logits, model.n_classes).to(torch.int16)
    pd = probs_uint8(logits.to(device), model.n_classes).cpu().to(torch.int16)
    d = (pc - pd).abs()
    rows.append({"layer": "softmax_round", "shape": list(pc.shape),
                 "max_lsb": int(d.max()), "share_differing": float((d > 0).float().mean())})
    return rows


def main(argv=None) -> int:
    from ..utils.device import default_device

    name = (argv or sys.argv[1:] or ["organelles"])[0]
    dev = default_device()
    model, params = load_model(packaged_model_path(name))
    vol = np.random.default_rng(1).integers(0, 256, (64, 64, 32), dtype=np.uint8)
    for row in layer_report(model, params_from_flax(params, dev), params_from_flax(params, "cpu"),
                            vol, dev):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
