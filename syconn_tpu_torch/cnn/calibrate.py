"""Calibrate deployment thresholds of packaged binary dense models
(counterpart of ``syconn_tpu/cnn/calibrate.py``).

Binary heads (myelin/er/golgi) over-fire under the fg-boosted training
sampling (measured: myelin argmax precision 0.15 at recall 0.75). The
trainer now calibrates at packaging time (cnn/toy.calibrate_binary_
threshold); this driver (re)calibrates ALREADY-packaged models without a
retrain — sweep the fg-probability threshold on TRAINING-seed worlds and
write the optimum into the packaged ``arch.json`` meta, which the
consumers read (proc/skeleton.map_myelin2coords, the held-out scorer
train_pretrained.dense_heldout_iou).

Reference analog: the hand-tuned per-task ``probathresholds``
(syconn/handler/config.yml:117).

The sweep's predictions run on the card unless ``--device cpu``.
``--model_dir`` names a directory holding model directories by task name
(a copy of the packaged weights, say); by default the packaged weights are
re-calibrated in place, as the JAX CLI does.

Usage:
    python -m syconn_tpu_torch.cnn.calibrate [--tasks myelin er golgi] \
        [--model_dir <dir>] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# training-seed worlds (train_pretrained.HELD_OUT_SEEDS are excluded)
TRAIN_SEEDS = (0, 1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tasks", type=str, nargs="+",
                   default=["myelin", "er", "golgi"])
    p.add_argument("--shape", type=int, nargs=3, default=[160, 160, 80])
    p.add_argument("--n_cells", type=int, default=8)
    p.add_argument("--model_dir", default=None,
                   help="directory of model dirs by task name (default: the packaged weights)")
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = p.parse_args(argv)

    from ..models.io import load_model, model_exists, packaged_model_path
    from ..utils.testdata_neuro import generate_neuron_world
    from .toy import _pool_any, _pool_mean, calibrate_binary_threshold, myelin_dilation

    worlds = [generate_neuron_world(shape=tuple(args.shape),
                                    n_cells=args.n_cells, seed=s)
              for s in TRAIN_SEEDS]
    for task in args.tasks:
        path = (os.path.join(args.model_dir, task) if args.model_dir
                else packaged_model_path(task))
        if not model_exists(path):
            print(f"{task}: no packaged model, skipping")
            continue
        model, params = load_model(path)
        arch_path = os.path.join(path, "arch.json")
        with open(arch_path) as f:
            arch = json.load(f)
        meta = arch.get("meta", {})
        mag = int(meta.get("mag", 1))
        raws, targets = [], []
        for w in worlds:
            raw = w["raw"] if mag == 1 else _pool_mean(w["raw"], mag)
            if task == "myelin":
                tgt = (w["myelin"] > 0).astype(np.int32)
            else:
                tgt = (w[task] > 0).astype(np.int32)
            if mag != 1:
                tgt = _pool_any(tgt, mag)
            if task == "myelin":
                from scipy import ndimage as _ndi

                tgt = _ndi.binary_dilation(
                    tgt > 0, iterations=myelin_dilation(mag)).astype(np.int32)
            raws.append(raw)
            targets.append(tgt)
        thr, iou = calibrate_binary_threshold(model, params, raws, targets, device=args.device)
        meta.update({"threshold": thr, "calib_train_iou": round(iou, 4)})
        arch["meta"] = meta
        with open(arch_path, "w") as f:
            json.dump(arch, f, indent=1)
        print(f"{task}: threshold {thr} (train IoU {iou:.3f}) -> {arch_path}")


if __name__ == "__main__":
    main()
