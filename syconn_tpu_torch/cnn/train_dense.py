"""Train a dense 3D U-Net task (myelin / syntype / organelles / er / golgi);
counterpart of ``syconn_tpu/cnn/train_dense.py``.

Reference parity: syconn/cnn/cnn_myelin.py, cnn_synapse_type*.py,
cnn_cellorganelles.py, cnn_er.py (elektronn3 trainers) -> one training
loop per task (``models/train.py``). Ground truth: a label volume ('seg'
channel) or thresholded prob maps in the working directory. Trains on the
card unless ``--device cpu``.

Usage:
    python -m syconn_tpu_torch.cnn.train_dense --task organelles --wd <wd> \
        --gt_kd <path-to-label-volume> --steps 2000
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", required=True,
                        choices=["myelin", "syntype", "organelles", "er", "golgi"])
    parser.add_argument("--wd", required=True)
    parser.add_argument("--gt_kd", required=True, help="label volume (seg channel)")
    parser.add_argument("--raw_kd", default=None, help="raw volume (defaults to kd_seg)")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--tile", type=int, nargs=3, default=[64, 64, 32])
    parser.add_argument("--mag", type=int, default=1)
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = parser.parse_args(argv)

    from .. import global_params

    global_params.wd = args.wd
    cfg = global_params.config

    from ..handler.basics import kd_factory
    from ..models.io import save_model
    from ..models.train import make_train_state, make_train_step
    from ..models.traindata import DenseVolumeData
    from ..models.unet3d import UNet3D, unet_variants

    gt_kd = kd_factory(args.gt_kd)

    def label_fn(off, size):
        return gt_kd.load_seg(offset=off, size=size, mag=args.mag).astype(np.int32)

    raw_path = args.raw_kd or cfg.kd_seg_path
    data = iter(DenseVolumeData(raw_path, label_fn, tile_shape=args.tile,
                                batch_size=args.batch, mag=args.mag))
    model = UNet3D(**unet_variants(args.task))
    state = make_train_state(model, (1, *args.tile, 1), learning_rate=args.lr,
                             device=args.device)
    step = make_train_step()
    for i in range(args.steps):
        x, y = next(data)
        state, m = step(state, x, y)
        if (i + 1) % 100 == 0:
            print(f"step {i + 1}: loss {float(m['loss']):.4f} acc {float(m['acc']):.4f}")
    mpath = cfg.model_target(args.task)
    save_model(mpath, model, state.params, extra_meta={"task": args.task, "steps": args.steps})
    print(f"saved model to {mpath}")


if __name__ == "__main__":
    main()
