"""Train the multi-view CMN models (celltype + glia) on rendered views of
pipeline-processed synthetic worlds (counterpart of
``syconn_tpu/cnn/train_views.py``).

Reference analog: syconn/cnn/cnn_celltype_cmn.py and cnn_gliaviews_e3.py
(elektronn3 trainers over CelltypeViews/GliaViews, TrainData.py:1198,1623);
here the views come from the port's splat renderer (render/views.py) on
cells reconstructed by the FULL pipeline — the deployment distribution of
``celltype_of_sso_views`` / ``gliapred_sso_views``
(inference/views_infer.py), which refuse seed-initialized weights. The
optimizer is the JAX trainer's ``optax.adamw`` on a warmup-cosine schedule
from 0, without clipping (:func:`make_view_train_state`); the sampled
batches and augmentations are numpy draws, equal to the JAX package's for
one seed. Renders and trains on the card unless ``--device cpu``.

Usage:
    python -m syconn_tpu_torch.cnn.train_views \
        --pipe_dir <dir> --n_worlds 4 --steps 1500 --package

``--pipe_dir`` must hold quality-pipeline working dirs named ``seed<N>``
(produced by ``train_pretrained --pipeline_worlds`` or
``utils.quality_metrics.run_quality_pipeline``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

HELD_OUT_SEEDS = (777, 1901, 2718)


def harvest_view_pools(wds, ws=(128, 64), nb_views=2, device=None):
    """(view stacks (N, V, W, H, C) uint8, celltype labels (N,)) from
    pipeline-processed worlds: every rendering location of every assembled
    cell contributes one stack, labeled with the cell's GT type. Renders on
    ``device`` (the card unless ``"cpu"``)."""
    from .. import global_params
    from ..inference.views_infer import views_to_model_input
    from ..render.views import render_sampled_sso
    from ..reps.super_segmentation import SuperSegmentationDataset
    from ..utils.device import default_device
    from ..utils.quality_metrics import ssv_to_cell

    device = default_device(device)
    prev = global_params.wd
    stacks, labels = [], []
    try:
        for wd in wds:
            from ..handler.basics import clear_kd_cache

            clear_kd_cache()
            global_params.wd = wd
            global_params.config._parse_config()
            gt = np.load(os.path.join(wd, "neuron_gt.npz"))
            ct_gt = gt["celltype_gt"]
            ssd = SuperSegmentationDataset(working_dir=wd)
            for sid in ssd.ssv_ids:
                ssv = ssd.get_super_segmentation_object(int(sid))
                cell = ssv_to_cell(ssv, gt)
                if cell <= 0:
                    continue
                views, _ = render_sampled_sso(ssv, ws=ws, nb_views=nb_views, device=device)
                if len(views) == 0:
                    continue
                x = views_to_model_input(views)  # (L, V, W, H, C)
                stacks.append(np.asarray(x, np.uint8))
                labels.append(np.full(len(x), int(ct_gt[cell]), np.int32))
    finally:
        global_params.wd = prev
        global_params.config._parse_config()
    if not stacks:
        return np.zeros((0,)), np.zeros((0,), np.int32)
    return np.concatenate(stacks), np.concatenate(labels)


def make_view_train_state(model, lr: float, steps: int, seed: int = 0, device=None):
    """The JAX trainer's optimizer: ``optax.adamw`` (weight decay 1e-4) on
    ``warmup_cosine_decay_schedule(0, lr, max(steps // 20, 1), steps)``, no
    clipping; ``model`` initialised from ``seed`` with flax's default
    initialisers on ``device``."""
    from ..models.io import init_model_params
    from ..models.train import TrainState, warmup_cosine_decay_schedule
    from ..utils.device import default_device

    init_model_params(model, seed=seed)
    model.to(default_device(device))
    sched = warmup_cosine_decay_schedule(0.0, lr, max(steps // 20, 1), steps)
    return TrainState(model, sched, weight_decay=1e-4, clip_norm=None)


def train_view_classifier(x, y, n_classes, steps=1500, batch=16, lr=1e-3,
                          widths=(16, 32, 64), seed=0, log_cb=print,
                          val_frac=0.15, device=None):
    """Train a ``MultiViewCMN`` on view stacks; returns (model, params,
    val_acc). Augmentations: per-sample view-order flip + horizontal
    mirror."""
    import torch

    from ..models.cmn import MultiViewCMN
    from ..models.train import make_class_train_step

    rng = np.random.default_rng(seed)
    n = len(x)
    order = rng.permutation(n)
    n_val = max(1, int(n * val_frac))
    val_ix, tr_ix = order[:n_val], order[n_val:]
    model = MultiViewCMN(n_classes=n_classes, widths=tuple(widths), n_in=x.shape[-1])
    state = make_view_train_state(model, lr, steps, seed=seed, device=device)
    # class-balanced sampling: the worlds skew toward non-glia types
    cls_of = y[tr_ix]
    by_cls = [tr_ix[cls_of == c] for c in range(int(y.max()) + 1)
              if (cls_of == c).any()]
    step = make_class_train_step()
    for i in range(steps):
        ix = np.concatenate([
            rng.choice(by_cls[rng.integers(len(by_cls))], 1)
            for _ in range(batch)
        ])
        xb = x[ix].astype(np.float32)
        if rng.random() < 0.5:
            xb = xb[:, ::-1]  # view-order flip
        if rng.random() < 0.5:
            xb = xb[:, :, ::-1]  # mirror W
        state, m = step(state, np.ascontiguousarray(xb), y[ix])
        if (i + 1) % 100 == 0:
            log_cb(f"step {i + 1}/{steps} loss {float(m['loss']):.3f} "
                   f"acc {float(m['acc']):.3f}")
    # validation accuracy (per-stack)
    hits = 0
    model.eval()
    with torch.no_grad():
        for i in range(0, len(val_ix), 32):
            ix = val_ix[i : i + 32]
            xb = torch.from_numpy(x[ix].astype(np.float32)).to(state.device)
            lg = model(xb).float().cpu().numpy()
            hits += int((np.argmax(lg, -1) == y[ix]).sum())
    val_acc = hits / max(len(val_ix), 1)
    log_cb(f"val acc (per view-stack): {val_acc:.3f} (n={len(val_ix)})")
    return model, state.params, val_acc


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pipe_dir", type=str, required=True)
    p.add_argument("--n_worlds", type=int, default=4)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--package", action="store_true")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = p.parse_args(argv)

    import tempfile

    from .. import global_params
    from ..handler.config import generate_default_conf
    from ..models.io import packaged_model_path, save_model

    # activate a scratch wd for the trained models
    scratch = tempfile.mkdtemp(prefix="syconn_train_views_")
    generate_default_conf(scratch, scaling=(10, 10, 20), force_overwrite=True)
    global_params.wd = scratch

    wds = []
    for name in sorted(os.listdir(args.pipe_dir)):
        wd = os.path.join(args.pipe_dir, name)
        if not os.path.isfile(os.path.join(wd, "neuron_gt.npz")):
            continue
        seed = int(name.replace("seed", "")) if name.startswith("seed") else -1
        if seed in HELD_OUT_SEEDS:
            continue
        wds.append(wd)
        if len(wds) >= args.n_worlds:
            break
    if not wds:
        raise FileNotFoundError(f"no pipeline worlds under {args.pipe_dir}")
    print(f"harvesting views from {len(wds)} worlds: {wds}", flush=True)
    x, y = harvest_view_pools(wds, device=args.device)
    print(f"{len(x)} view stacks, label histogram "
          f"{np.bincount(y, minlength=4).tolist()}", flush=True)

    print("=== celltype view CMN ===", flush=True)
    ct_model, ct_params, ct_acc = train_view_classifier(
        x, y, n_classes=8, steps=args.steps, device=args.device)
    print("=== glia view CMN ===", flush=True)
    gl_model, gl_params, gl_acc = train_view_classifier(
        x, (y == 3).astype(np.int32), n_classes=2, steps=args.steps, device=args.device)

    report = {"n_stacks": int(len(x)), "celltype_val_acc": ct_acc,
              "glia_val_acc": gl_acc, "worlds": wds, "steps": args.steps}
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)

    # persist under the active wd's model paths, optionally package
    cfg = global_params.config
    for name, mpath, model, params, meta in (
        ("celltype", cfg.model_target("celltype"), ct_model, ct_params,
         {"task": "celltype_views", "val_acc": ct_acc}),
        ("glia", cfg.model_target("glia"), gl_model, gl_params,
         {"task": "glia_views", "val_acc": gl_acc}),
    ):
        save_model(mpath, model, params,
                   extra_meta=dict(meta, steps=args.steps))
        print(f"saved {mpath}", flush=True)
        if args.package:
            dst = packaged_model_path(name)
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            shutil.copytree(mpath, dst)
            print(f"packaged {name} -> {dst}", flush=True)


if __name__ == "__main__":
    main()
