#!/usr/bin/env python3
"""Where the contact kernel's time goes, inside the kernel.

Builds ``ops/csrc/contacts.cu`` with ``-DCONTACTS_TIMING`` (into its own
library: the flag is part of the build key), launches ``detect_cs_columns``
once at each contact shape of ``chip_smoke.py`` and prints the clock counts
that thread 0 of every block spent per stage, summed over the blocks, with
each stage's share; the stages are those the source's ``TOCK`` marks name
(printed by the kernel's ``contacts_debug_names``). Thread 0's clocks include
its waits at the barriers, so a stage's count is the block's time in it. The
counters cost time themselves: read the shares, not the totals.

Usage, on a machine with a Hopper card::

    python3 -m syconn_tpu_torch.tools.contacts_breakdown
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

from syconn_tpu_torch.tools.time_kernels import smoke_module


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    smoke = smoke_module()
    import numpy as np
    import torch

    from syconn_tpu_torch.ops import build
    from syconn_tpu_torch.ops import contacts_cuda as CC

    build.NVCC_FLAGS.append("-DCONTACTS_TIMING")
    lib = build.library("contacts")
    lib.contacts_debug_names.restype = ctypes.c_char_p
    names = lib.contacts_debug_names().decode().split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    buf = (ctypes.c_ulonglong * 16)()
    for label, shape, stencil, tile_xy, K, block, _ in smoke.CONTACT_SHAPES:
        seg = smoke.blocky_labels(shape, block, seed=11)
        seg_p, offs, cands, _, _ = CC._columns_prep(seg, stencil, tile_xy, K)
        a = [torch.from_numpy(t).to(dev) for t in (seg_p, offs, cands)]
        CC.detect_cs_columns(*a, stencil, tile_xy)  # warm-up
        torch.cuda.synchronize()
        if lib.contacts_debug_reset() != 0:
            raise RuntimeError("resetting the counters failed")
        CC.detect_cs_columns(*a, stencil, tile_xy)
        torch.cuda.synchronize()
        if lib.contacts_debug_read(buf) != 0:
            raise RuntimeError("reading the counters failed")
        vals = dict(zip(names, list(buf)[:len(names)]))
        # the stages (load_* are parts of load)
        clocks = {k: v for k, v in vals.items() if not k.startswith("n_") and "_" not in k
                  or k == "y_best"}
        total = clocks.get("total", 0) or 1
        live = float((cands != np.iinfo(np.int32).max).sum(axis=1).mean())
        print(json.dumps(dict(tag=args.tag, card=card, shape=label, K=K,
                              live_candidates_per_column=live, counters=vals,
                              share={k: v / total for k, v in clocks.items() if k != "total"})),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
