#!/usr/bin/env python3
"""Where the wgmma conv kernel's time goes, inside the kernel.

Builds ``ops/csrc/conv3d_wgmma.cu`` with ``-DCONV3D_TIMING`` (into its own
library: the flag is part of the build key), launches the kernel at the
dense-prediction main-path shapes and prints, for block 0, the clock counts
its two consumer warpgroups spent waiting for a halo slice (or input-phase unit), waiting for weight
stages, starting wgmmas (a start blocks while the tensor cores' queue is
full), waiting for the group before, and in the epilogue, and what the weight
producer spent waiting for a free stage. The counters themselves cost time
(about a tenth of the kernel), so read the shares, not the totals.

Usage, on a machine with a Hopper card::

    python3 -m syconn_tpu_torch.tools.conv3d_breakdown
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

# (kernel, edge, cin, cout, head width)
SHAPES = [
    ("same", 80, 32, 64, 0), ("same", 80, 64, 64, 0), ("same", 80, 128, 64, 0),
    ("same", 80, 64, 64, 96), ("same", 40, 128, 128, 0), ("same", 40, 256, 128, 0),
    ("same", 20, 256, 256, 0), ("down", 80, 64, 128, 0), ("down", 40, 128, 256, 0),
    ("up", 20, 256, 128, 0), ("up", 40, 128, 64, 0),
]
NAMES = ["total", "halo_wait", "weight_wait", "wgmma_start", "group_wait", "epilogue"]


def main() -> int:
    from syconn_tpu_torch.ops import build
    from syconn_tpu_torch.ops import conv3d as C

    build.NVCC_FLAGS.append("-DCONV3D_TIMING")
    lib = build.library("conv3d_wgmma")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    buf = (ctypes.c_longlong * 64)()
    for kind, n, cin, cout, nh in SHAPES:
        x = torch.randn((1, n, n, n, cin), generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn((27, cin, cout), generator=gen) / (27 * cin) ** 0.5).to(dev, torch.bfloat16)
        b = (0.1 * torch.randn((cout,), generator=gen)).to(dev, torch.bfloat16)
        g = torch.ones(cout, device=dev)
        beta = torch.zeros(cout, device=dev)
        hw = hb = None
        if nh:
            hw = torch.randn(cout, nh, generator=gen).to(dev)
            hb = torch.zeros(nh, device=dev)
        for _ in range(2):  # the second launch is the one read
            if kind == "same":
                C.conv3x3x3_ln_gelu(x, w, b, g, beta, head_w=hw, head_b=hb)
            elif kind == "down":
                C.conv_down2x_bias(x, w, b)
            else:
                C.conv_transpose2x_bias(x, w, b)
            torch.cuda.synchronize()
        rc = lib.conv3d_wgmma_debug_read(buf)
        if rc != 0:
            raise RuntimeError(f"reading the counters failed: cudaError {rc}")
        print(f"{kind} {n}^3 {cin}->{cout} head {nh}: weight producer total {buf[20]} "
              f"waiting for a free stage {buf[21]}")
        for wg in (0, 1):
            vals = list(buf[wg * 32: wg * 32 + len(NAMES)])
            rest = vals[0] - sum(vals[1:])
            print(f"  consumer warpgroup {wg}: " + ", ".join(f"{k} {v}" for k, v in zip(NAMES, vals))
                  + f", other {rest} (clocks, block 0)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
