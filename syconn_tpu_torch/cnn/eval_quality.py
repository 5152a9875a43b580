"""Multi-seed output-quality evaluation of the packaged models (counterpart
of ``syconn_tpu/cnn/eval_quality.py``).

Runs the quality-suite fixture (the port's pipeline driver with dense-model
organelle prediction) on each held-out seed and prints the per-seed and
mean metrics the quality suite asserts on (tests/test_quality.py). Use
while iterating on training (cnn/train_pretrained.py): the suite's
thresholds must hold on the MEAN across these seeds.

Usage:
    python -m syconn_tpu_torch.cnn.eval_quality [--seeds 777 1901 2718] \
        [--keep_wd DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..utils.quality_metrics import run_quality_pipeline, score_all

HELD_OUT_SEEDS = (777, 1901, 2718)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=list(HELD_OUT_SEEDS))
    p.add_argument("--shape", type=int, nargs=3, default=[160, 160, 80])
    p.add_argument("--n_cells", type=int, default=8)
    p.add_argument("--device", type=str, default=None,
                   help="cpu, or the CUDA card (default) for the pipeline runs and scoring")
    p.add_argument("--keep_wd", type=str, default="",
                   help="parent dir for per-seed working dirs (kept); "
                        "default: fresh temp dirs")
    p.add_argument("--skip_run", action="store_true",
                   help="score existing working dirs under --keep_wd only")
    args = p.parse_args(argv)
    from ..utils.device import default_device

    device = default_device(args.device)

    parent = args.keep_wd or tempfile.mkdtemp(prefix="syconn_quality_")
    os.makedirs(parent, exist_ok=True)
    per_seed = {}
    for seed in args.seeds:
        wd = os.path.join(parent, f"seed{seed}")
        t0 = time.time()
        if not args.skip_run:
            run_quality_pipeline(wd, seed, shape=tuple(args.shape),
                                 n_cells=args.n_cells, device=device)
            print(f"seed {seed}: pipeline {time.time() - t0:.0f}s", flush=True)
        per_seed[seed] = score_all(wd, device=device)
        print(f"seed {seed}: {json.dumps(per_seed[seed])}", flush=True)

    # mean over seeds for every numeric leaf
    mean: dict = {}
    for group in next(iter(per_seed.values())):
        mean[group] = {}
        for key in per_seed[args.seeds[0]][group]:
            vals = [per_seed[s][group][key] for s in args.seeds]
            vals = [v for v in vals if np.isfinite(v)]
            mean[group][key] = float(np.mean(vals)) if vals else float("nan")
    report = {"seeds": args.seeds, "per_seed": {str(k): v for k, v in per_seed.items()},
              "mean": mean, "wd_parent": parent}
    out_path = os.path.join(parent, "quality_report.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print("MEAN:", json.dumps(mean), flush=True)
    print("report:", out_path, flush=True)


if __name__ == "__main__":
    main()
