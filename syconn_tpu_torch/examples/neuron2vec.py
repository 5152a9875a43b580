"""Morphology embeddings of a directory of cell archives (counterpart of
``examples/neuron2vec.py``): per cell the triplet point net on 8 random
2048-point contexts, their mean embedding, and the pairwise distances.

Usage::

    python -m syconn_tpu_torch.examples.neuron2vec --kzip_dir cells/
    python -m syconn_tpu_torch.examples.neuron2vec --kzip_dir cells/ --device cpu

The weights are ``<kzip_dir>/models/tnet_pts``, else the packaged ones.
``--device`` is the card unless ``cpu``; without a card and without
``--device cpu`` the script raises before it reads an archive.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["main"]


def main(argv=None) -> dict:
    """Run the example; returns the embeddings by cell id, the pairwise
    distances, and the cells, contexts and dispatches."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--kzip_dir", required=True, help="directory of *.k.zip cells")
    parser.add_argument("--model", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..inference.points import ContextPredictor, extract_contexts, sso2pointcloud
    from ..models.io import get_or_init_model
    from ..models.pointnet import PointClassNet
    from ..proc.ssd_assembly import init_ssd_from_kzips
    from ..utils.device import default_device

    dev = default_device(args.device)
    cells = init_ssd_from_kzips(args.kzip_dir)
    print(f"{len(cells)} cells loaded")
    mpath = args.model or os.path.join(args.kzip_dir, "models", "tnet_pts")
    model, _ = get_or_init_model(mpath, lambda: PointClassNet(n_classes=2, embed_dim=10))
    pred = ContextPredictor(model, npoints=2048, device=dev)
    embeddings = {}
    n_ctx = n_disp = 0
    for ssv in cells:
        coords, types = sso2pointcloud(ssv)
        if len(coords) == 0:
            continue
        ctxs, _ = extract_contexts(coords, types, ctx_size_nm=20000, npoints=2048, n_contexts=8)
        out = pred.predict(ctxs)
        n_ctx += len(ctxs)
        n_disp += -(-len(ctxs) // pred.batch)
        embeddings[ssv.id] = out["embedding"].mean(axis=0)
        print(f"cell {ssv.id}: z = {np.round(embeddings[ssv.id], 3)}")
    ids = sorted(embeddings)
    distances = {}
    for i in range(len(ids)):
        for j in range(i + 1, len(ids)):
            d = np.linalg.norm(embeddings[ids[i]] - embeddings[ids[j]])
            distances[(ids[i], ids[j])] = float(d)
            print(f"  d({ids[i]}, {ids[j]}) = {d:.3f}")
    return dict(embeddings=embeddings, distances=distances, cells=len(cells), contexts=n_ctx,
                dispatches=n_disp)


if __name__ == "__main__":
    main()
