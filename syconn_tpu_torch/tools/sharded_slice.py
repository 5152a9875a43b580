#!/usr/bin/env python3
"""``chip_smoke.py``'s last phase, ``slice sharded``, alone: builds the
kernels, writes the inputs the earlier phases leave behind (the seeded
512x512x256 raw, label, sj and blob-probability volumes, and the driver's
run B with ``--no-shard_pipeline`` as the serial reference) and runs
``phase_slice_sharded``: on a logical mesh of 4 positions on the first
card, and again on the real cards where the machine has several. Its line
(h), spatially partitioned training, reports the peak bytes of each card
for a step at the deployment tile (256, 256, 128), batch 1, z over 4
positions, against one card.

Usage, from the root of a checkout on a machine with a card::

    python3 -m syconn_tpu_torch.tools.sharded_slice
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    from syconn_tpu_torch.examples import start
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.ops import build
    from syconn_tpu_torch.utils.device import default_device
    from syconn_tpu_torch.utils.quality_metrics import quality_pipeline_argv

    import torch

    t_all = time.perf_counter()
    dev = default_device()
    cs.log("card: " + cs.smi())
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"build {time.perf_counter() - t0:.3f} s")
    shape = cs.SHARD_SHAPE
    work = tempfile.mkdtemp(prefix="sharded_")
    try:
        t0 = time.perf_counter()
        cs.make_volume(os.path.join(work, "raw"), shape)
        hot = (tuple(s // 5 for s in shape), tuple(max(8, s // 12) for s in shape))
        ChunkedVolume.create(os.path.join(work, "sv_seg"), scale=(10, 10, 20), boundary=shape,
                             chunk_shape=(256, 256, 256)).save_seg(
            cs.blocky_labels(shape, (48, 48, 96), seed=7, hot=hot))
        cs.make_volume(os.path.join(work, "sj"), shape, seed=5, mean=20.0, std=40.0)
        for co in ("mi", "vc"):
            prob, _, _ = cs.blob_map(shape, co)
            ChunkedVolume.create(os.path.join(work, f"{co}_prob"), scale=(10, 10, 20),
                                 boundary=shape, chunk_shape=cs.STEP2_CHUNK).save_raw(prob)
        start.main(quality_pipeline_argv(os.path.join(work, "driver_B"), cs.QUALITY["seed"],
                                         cs.QUALITY["shape"], cs.QUALITY["n_cells"])
                   + ["--device", str(dev), "--no-shard_pipeline"])
        cs.log(f"setup {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        launches = cs.phase_slice_sharded(dev, work)
        cs.log(f"slice sharded phase {time.perf_counter() - t0:.3f} s")
        cs.log("sharded launches " + json.dumps(launches))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.log(f"whole {time.perf_counter() - t_all:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
