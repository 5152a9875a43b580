#!/usr/bin/env python3
"""Device time of the port's kernel wrappers at the shapes of the main paths:
the three conv wrappers at the dense-prediction shapes, and
``detect_cs_columns`` at the contact shapes of ``chip_smoke.py``, for
whichever ``syconn_tpu_torch`` is first on ``sys.path``.

To compare two commits on one card, unpack the other commit into a directory
and run both from one command, e.g. parent, change, change, parent::

    python3 syconn_tpu_torch/tools/time_kernels.py --root <dir of a checkout>

The inputs (and the contact shapes) come from this checkout's
``chip_smoke.py``, so both trees are timed on the same data.

Each time is the median over 7 timings of 8 calls enqueued back to back
(CUDA events), so that the host's time to launch a call hides behind the
card's work on the call before.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (wrapper, edge, cin, cout, head width, launches per syntype tile)
SHAPES = [
    ("conv3x3x3_ln_gelu", 80, 32, 64, 0, 1), ("conv3x3x3_ln_gelu", 80, 64, 64, 0, 1),
    ("conv3x3x3_ln_gelu", 80, 128, 64, 0, 1), ("conv3x3x3_ln_gelu", 80, 64, 64, 96, 1),
    ("conv3x3x3_ln_gelu", 40, 128, 128, 0, 3), ("conv3x3x3_ln_gelu", 40, 256, 128, 0, 1),
    ("conv3x3x3_ln_gelu", 20, 256, 256, 0, 2), ("conv3x3x3_ln_gelu", 80, 64, 64, 64, 0),
    ("conv_down2x_bias", 80, 64, 128, 0, 1), ("conv_down2x_bias", 40, 128, 256, 0, 1),
    ("conv_transpose2x_bias", 20, 256, 128, 0, 1), ("conv_transpose2x_bias", 40, 128, 64, 0, 1),
]


def smoke_module():
    """This checkout's ``chip_smoke.py`` (standard library at import)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuda_ms(fn, warmup=3, reps=7, inner=8):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return sorted(times)[len(times) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose syconn_tpu_torch is timed")
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("conv", "down", "contacts"), default=None)
    args = ap.parse_args()
    smoke = smoke_module()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from syconn_tpu_torch.ops import conv3d as C

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    tag = dict(tag=args.tag, card=card)
    if args.only != "contacts":
        gen = torch.Generator().manual_seed(0)
        per_tile = {}
        for name, n, cin, cout, nh, tiles in SHAPES:
            if args.only == "down" and name != "conv_down2x_bias":
                continue
            x = torch.randn((1, n, n, n, cin), generator=gen).to(dev, torch.bfloat16)
            w = (torch.randn((27, cin, cout), generator=gen) / (27 * cin) ** 0.5).to(
                dev, torch.bfloat16)
            b = (0.1 * torch.randn((cout,), generator=gen)).to(dev, torch.bfloat16)
            g = (1 + 0.1 * torch.randn((cout,), generator=gen)).to(dev)
            beta = (0.1 * torch.randn((cout,), generator=gen)).to(dev)
            kw = {}
            if nh:
                kw = dict(head_w=(torch.randn((cout, nh), generator=gen) / cout ** 0.5).to(dev),
                          head_b=(0.1 * torch.randn((nh,), generator=gen)).to(dev))
            if name == "conv3x3x3_ln_gelu":
                fn = lambda: C.conv3x3x3_ln_gelu(x, w, b, g, beta, **kw)  # noqa: E731
            elif name == "conv_down2x_bias":
                fn = lambda: C.conv_down2x_bias(x, w, b)  # noqa: E731
            else:
                fn = lambda: C.conv_transpose2x_bias(x, w, b)  # noqa: E731
            ms = cuda_ms(fn)
            per_tile[name] = per_tile.get(name, 0.0) + ms * tiles
            print(json.dumps(dict(tag, name=name, n=n, cin=cin, cout=cout, nh=nh,
                                  per_tile=tiles, ms=ms)), flush=True)
        print(json.dumps(dict(tag, per_syntype_tile_ms=per_tile)), flush=True)
    if args.only in (None, "contacts"):
        from syconn_tpu_torch.ops import contacts_cuda as CC
        from syconn_tpu_torch.ops.contacts_torch import column_tables

        for label, shape, stencil, tile_xy, K, block, _ in smoke.CONTACT_SHAPES:
            seg = smoke.blocky_labels(shape, block, seed=11)
            seg_t = torch.from_numpy(seg.astype(np.int32)).to(dev)
            a = column_tables(seg_t, stencil, tile_xy, K)[:3]
            cands = a[2].cpu().numpy()
            ms = cuda_ms(lambda: CC.detect_cs_columns(*a, stencil, tile_xy))
            live = float((cands != np.iinfo(np.int32).max).sum(axis=1).mean())
            print(json.dumps(dict(tag, name="detect_cs_columns", shape=label, K=K,
                                  live_candidates_per_column=live, ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
