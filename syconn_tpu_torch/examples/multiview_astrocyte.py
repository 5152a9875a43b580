"""Astrocyte or neuron: a standalone cell classified from rendered views
(counterpart of ``examples/multiview_astrocyte.py``): the splat renderer at
the cell's sampled surface locations (128x64, ``--nb_views`` views,
8 um window), the multi-view CMN on all locations, the mean glia
probability.

Usage::

    python -m syconn_tpu_torch.examples.multiview_astrocyte --kzip cell.k.zip
    python -m syconn_tpu_torch.examples.multiview_astrocyte --kzip cell.k.zip --device cpu

No glia view weights are packaged: ``<kzip dir>/models/glia_cmn`` is
loaded where it exists, else seed-initialised at widths (16, 32, 64) and
saved there (as the JAX script does, so either package's weights serve the
other). ``--device`` is the card unless ``cpu``; without a card and without
``--device cpu`` the script raises before it reads the archive.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["main"]


def main(argv=None) -> dict:
    """Run the example; returns the cell id, the glia probability, the view
    locations, and the renderer's and the net's counts."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--kzip", required=True)
    parser.add_argument("--model", default=None)
    parser.add_argument("--nb_views", type=int, default=2)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from ..models.cmn import MultiViewCMN
    from ..models.io import get_or_init_model
    from ..proc.ssd_assembly import init_sso_from_kzip
    from ..render.views import render_sampled_sso
    from ..utils.device import default_device

    dev = default_device(args.device)
    ssv = init_sso_from_kzip(args.kzip)
    render_stats: dict = {}
    views, locs = render_sampled_sso(ssv, ws=(128, 64), nb_views=args.nb_views,
                                     comp_window=8000, device=dev, stats=render_stats)
    print(f"rendered {len(views)} view locations")
    mpath = args.model or os.path.join(os.path.dirname(args.kzip), "models", "glia_cmn")
    model, _ = get_or_init_model(mpath, lambda: MultiViewCMN(n_classes=2, widths=(16, 32, 64)))
    model = model.to(dev).eval()
    # (L, nb_views, C, W, H) -> (L, nb_views, W, H, C)
    x = np.moveaxis(views, 2, -1).astype(np.float32)
    with torch.inference_mode():
        logits = model(torch.from_numpy(np.ascontiguousarray(x)).to(dev)).float().cpu().numpy()
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    glia_proba = float(probs[:, 1].mean())
    print(f"cell {ssv.id}: glia probability {glia_proba:.3f} "
          f"({'astrocyte' if glia_proba > 0.5 else 'neuron'})")
    return dict(cell=int(ssv.id), glia_proba=glia_proba, locations=len(locs),
                views_shape=tuple(x.shape), render=render_stats, dispatches=1)


if __name__ == "__main__":
    main()
