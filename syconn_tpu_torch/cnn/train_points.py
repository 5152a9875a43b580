"""Train point-cloud tasks: celltype / glia classification, compartment
semseg, triplet morphology embeddings.

Counterpart of ``syconn_tpu/cnn/train_points.py``. Reference parity:
syconn/cnn/cnn_celltype_ptcnv*.py, cnn_glia_ptcnv.py, cnn_semseg_ptcnv.py,
tnet triplet variants. GT labels come from SSV attributes (e.g. a curated
``celltype_gt`` key) or a label csv. Trains on the card unless
``--device cpu``.

Usage:
    python -m syconn_tpu_torch.cnn.train_points --task celltype --wd <wd> \
        --gt_key celltype_gt --steps 1000
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", required=True,
                        choices=["celltype", "glia", "compartment", "tnet"])
    parser.add_argument("--wd", required=True)
    parser.add_argument("--gt_key", default=None, help="SSV attr with the GT label")
    parser.add_argument("--gt_csv", default=None, help="csv: ssv_id,label")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--npoints", type=int, default=1024)
    parser.add_argument("--ctx_nm", type=float, default=15000.0)
    parser.add_argument("--n_classes", type=int, default=None)
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = parser.parse_args(argv)

    from .. import global_params

    global_params.wd = args.wd
    cfg = global_params.config
    from ..models.io import save_model
    from ..models.pointnet import PointClassNet, PointSegNet
    from ..models.train import (
        make_class_train_step,
        make_train_state,
        make_train_step,
        make_triplet_train_step,
    )
    from ..models.traindata import CellCloudData, TripletCloudData
    from ..reps.super_segmentation import SuperSegmentationDataset

    ssd = SuperSegmentationDataset(working_dir=args.wd)
    labels = {}
    if args.gt_csv:
        with open(args.gt_csv) as f:
            for line in f:
                a, b = line.strip().split(",")
                labels[int(a)] = int(b)
    elif args.gt_key:
        for i in ssd.ssv_ids:
            s = ssd.get_super_segmentation_object(int(i))
            v = s.lookup_in_attribute_dict(args.gt_key)
            if v is not None:
                labels[int(i)] = int(v)

    def label_of(ssv_id):
        return labels.get(int(ssv_id), 0)

    if args.task == "tnet":
        ndim = int(cfg["tcmn"]["ndim_embedding"])
        model = PointClassNet(n_classes=2, embed_dim=ndim)
        state = make_train_state(model, (1, args.npoints, 7), learning_rate=args.lr,
                                 device=args.device)
        step = make_triplet_train_step()
        data = iter(TripletCloudData(ssd=ssd, npoints=args.npoints,
                                     ctx_size_nm=args.ctx_nm, batch_size=args.batch))
        for i in range(args.steps):
            xa, xp, xn = next(data)
            state, m = step(state, xa, xp, xn)
            if (i + 1) % 100 == 0:
                print(f"step {i + 1}: triplet loss {float(m['loss']):.4f}")
        save_model(cfg.model_target("tnet_pts"), model, state.params, extra_meta={"task": "tnet"})
        print(f"saved {cfg.model_target('tnet_pts')}")
        return

    n_classes = args.n_classes or {"celltype": 8, "glia": 2, "compartment": 3}[args.task]
    if args.task == "compartment":
        # per-point labels: broadcast the cell label (placeholder GT hookup)
        model = PointSegNet(n_classes=n_classes)
        state = make_train_state(model, (1, args.npoints, 7), learning_rate=args.lr,
                                 device=args.device)
        step = make_train_step()
        data = iter(CellCloudData(ssd=ssd, label_of=label_of, npoints=args.npoints,
                                  ctx_size_nm=args.ctx_nm, batch_size=args.batch))
        for i in range(args.steps):
            x, y = next(data)
            yy = np.repeat(y[:, None], args.npoints, axis=1)
            state, m = step(state, x, yy)
            if (i + 1) % 100 == 0:
                print(f"step {i + 1}: loss {float(m['loss']):.4f}")
        mpath = cfg.model_target("compartment_pts")
    else:
        model = PointClassNet(n_classes=n_classes)
        state = make_train_state(model, (1, args.npoints, 7), learning_rate=args.lr,
                                 device=args.device)
        step = make_class_train_step(dict_output=True)
        data = iter(CellCloudData(ssd=ssd, label_of=label_of, npoints=args.npoints,
                                  ctx_size_nm=args.ctx_nm, batch_size=args.batch))
        for i in range(args.steps):
            x, y = next(data)
            state, m = step(state, x, y)
            if (i + 1) % 100 == 0:
                print(f"step {i + 1}: loss {float(m['loss']):.4f} acc {float(m['acc']):.4f}")
        mpath = cfg.model_target("celltype_pts" if args.task == "celltype" else "glia_pts")
    save_model(mpath, model, state.params, extra_meta={"task": args.task})
    print(f"saved {mpath}")


if __name__ == "__main__":
    main()
