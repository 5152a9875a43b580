"""Spine segmentation of a standalone cell archive (counterpart of
``examples/semseg_spine.py``): the spiness point net on 2048-point contexts
of 8 um, votes per surface point, and optionally the cell mesh as a PLY.

Usage::

    python -m syconn_tpu_torch.examples.semseg_spine --kzip cell.k.zip --out_ply mesh.k.zip
    python -m syconn_tpu_torch.examples.semseg_spine --kzip cell.k.zip --device cpu

The weights are ``<kzip dir>/models/spiness``, else the packaged ones.
``--device`` is the card unless ``cpu``; without a card and without
``--device cpu`` the script raises before it reads the archive.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["main", "CLASSES"]

CLASSES = ["shaft", "head", "neck", "other"]


def main(argv=None) -> dict:
    """Run the example; returns the cell id, its surface labels and per-class
    shares, the contexts and dispatches, and the written path."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--kzip", required=True)
    parser.add_argument("--model", default=None)
    parser.add_argument("--out_ply", default=None, help="mesh colored by spiness")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..inference.points import (ContextPredictor, extract_contexts, sso2pointcloud,
                                    vote_context_labels)
    from ..models.io import get_or_init_model
    from ..models.pointnet import PointSegNet
    from ..proc.ssd_assembly import init_sso_from_kzip
    from ..utils.device import default_device

    dev = default_device(args.device)
    ssv = init_sso_from_kzip(args.kzip)
    coords, types = sso2pointcloud(ssv)
    mpath = args.model or os.path.join(os.path.dirname(args.kzip), "models", "spiness")
    model, _ = get_or_init_model(mpath, lambda: PointSegNet(n_classes=4))
    pred = ContextPredictor(model, npoints=2048, device=dev)
    ctxs, idx_lists = extract_contexts(coords, types, ctx_size_nm=8000, npoints=2048)
    out = pred.predict(ctxs)
    labels = vote_context_labels(out, idx_lists, len(coords))
    shares = {}
    for k, name in enumerate(CLASSES):
        shares[name] = float((labels == k).mean())
        print(f"  {name}: {(labels == k).mean() * 100:.1f}%")
    written = None
    if args.out_ply:
        from ..proc.meshes import write_mesh2kzip

        mesh = ssv.load_mesh("sv")
        write_mesh2kzip(args.out_ply, mesh[0], mesh[1], None, None, "spiness.ply")
        print(f"mesh written to {args.out_ply}")
        written = args.out_ply
    return dict(cell=int(ssv.id), labels=labels, shares=shares, contexts=len(ctxs),
                dispatches=-(-len(ctxs) // pred.batch), out=written)


if __name__ == "__main__":
    main()
