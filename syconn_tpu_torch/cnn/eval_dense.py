"""Held-out voxel metrics of the packaged dense models, as a JSON receipt
(counterpart of ``syconn_tpu/cnn/eval_dense.py``).

Generates never-trained neuron worlds and scores every packaged dense
model (organelles 4-class, myelin binary, and er/golgi where packaged) at
its deployment mag with ``train_pretrained.dense_heldout_iou``, through
the conv kernels on the card unless ``--device cpu``:

    python -m syconn_tpu_torch.cnn.eval_dense [--seeds 777 1901 2718] \
        [--out report.json] [--device cpu]

``main`` returns the report, whose keys are the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def _weights_read(paths) -> str:
    """The model directories read, relative to the checkout, as
    ``<parent>/{a,b,...}``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    rel = [os.path.relpath(p, root) for p in paths]
    parents = {os.path.dirname(r) for r in rel}
    if len(parents) == 1:
        return "%s/{%s}" % (parents.pop(), ",".join(os.path.basename(r) for r in rel))
    return ",".join(rel)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=[777, 1901, 2718])
    p.add_argument("--shape", type=int, nargs=3, default=[160, 160, 80])
    p.add_argument("--n_cells", type=int, default=8)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default=None,
                   help="cpu, or the CUDA card (default; required then)")
    args = p.parse_args(argv)
    from ..utils.device import default_device

    device = default_device(args.device)
    from .. import global_params
    from ..handler.config import generate_default_conf
    from ..models.io import model_exists, packaged_model_path
    from ..utils.testdata_neuro import generate_neuron_world
    from .train_pretrained import dense_heldout_iou

    # activate a wd whose model paths resolve to the packaged weights
    wd = tempfile.mkdtemp(prefix="syconn_eval_dense_")
    generate_default_conf(wd, scaling=(10, 10, 20), force_overwrite=True)
    global_params.wd = wd

    tasks = ["organelles", "myelin"] + [
        t for t in ("er", "golgi") if model_exists(packaged_model_path(t))
    ]
    read = [getattr(global_params.config, f"mpath_{t}") for t in tasks]
    per_seed = {}
    for seed in args.seeds:
        world = generate_neuron_world(
            shape=tuple(args.shape), n_cells=args.n_cells, seed=seed)
        per_seed[seed] = dense_heldout_iou(world, tasks=tuple(tasks), device=device)
        print(f"seed {seed}: {json.dumps(per_seed[seed])}", flush=True)

    mean = {k: float(np.mean([per_seed[s][k] for s in args.seeds]))
            for k in per_seed[args.seeds[0]]}
    report = {
        "seeds": {str(s): per_seed[s] for s in args.seeds},
        "mean": mean,
        "shape": list(args.shape), "n_cells": args.n_cells,
        "driver": "python -m syconn_tpu_torch.cnn.eval_dense",
        "models": _weights_read(read),
        # the myelin score is IoU against the training-target definition
        # (GT sheath mask pooled to deployment mag, then dilated by
        # myelin_dilation(mag)); recorded so that the number reads without
        # the code
        "gt_definition": {
            "organelles_*_iou": "argmax vs GT label at deployment mag",
            "myelin_myelin_iou": "binary IoU vs pooled GT sheath mask "
                                 "dilated by myelin_dilation(mag) "
                                 "(training-target def.)",
            "er_er_iou/golgi_golgi_iou": "binary IoU vs GT mask at "
                                         "deployment mag",
        },
    }
    print("MEAN:", json.dumps(mean), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print("report:", args.out)
    return report


if __name__ == "__main__":
    main()
