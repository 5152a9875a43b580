#!/usr/bin/env python3
"""Device time of the three conv wrappers at the dense-prediction main-path
shapes, for whichever ``syconn_tpu_torch`` is first on ``sys.path``.

To compare two commits on one card, unpack the other commit into a directory
and run both from one command, e.g. parent, change, change, parent::

    python3 syconn_tpu_torch/tools/time_conv3d.py --root <dir of a checkout>

Each time is the median over 7 timings of 8 calls enqueued back to back
(CUDA events), so that the host's time to launch a call hides behind the
card's work on the call before.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (wrapper, edge, cin, cout, head width, launches per syntype tile)
SHAPES = [
    ("conv3x3x3_ln_gelu", 80, 32, 64, 0, 1), ("conv3x3x3_ln_gelu", 80, 64, 64, 0, 1),
    ("conv3x3x3_ln_gelu", 80, 128, 64, 0, 1), ("conv3x3x3_ln_gelu", 80, 64, 64, 96, 1),
    ("conv3x3x3_ln_gelu", 40, 128, 128, 0, 3), ("conv3x3x3_ln_gelu", 40, 256, 128, 0, 1),
    ("conv3x3x3_ln_gelu", 20, 256, 256, 0, 2), ("conv3x3x3_ln_gelu", 80, 64, 64, 64, 0),
    ("conv_down2x_bias", 80, 64, 128, 0, 1), ("conv_down2x_bias", 40, 128, 256, 0, 1),
    ("conv_transpose2x_bias", 20, 256, 128, 0, 1), ("conv_transpose2x_bias", 40, 128, 64, 0, 1),
]


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
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose syconn_tpu_torch is timed")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from syconn_tpu_torch.ops import conv3d as C

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    per_tile = {}
    for name, n, cin, cout, nh, tiles in SHAPES:
        x = torch.randn((1, n, n, n, cin), generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn((27, cin, cout), generator=gen) / (27 * cin) ** 0.5).to(dev, torch.bfloat16)
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
        print(json.dumps(dict(tag=args.tag, card=card, name=name, n=n, cin=cin, cout=cout, nh=nh,
                              per_tile=tiles, ms=ms)), flush=True)
    print(json.dumps(dict(tag=args.tag, card=card, per_syntype_tile_ms=per_tile)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
