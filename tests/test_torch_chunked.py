"""The port's chunk store under concurrent writers: threads that register a
channel or mag of one fresh store at once each dump its metadata."""

import json
import sys
import threading

import numpy as np

from syconn_tpu_torch.io.chunked import ChunkedVolume


def test_concurrent_first_writes_keep_meta(tmp_path):
    tile = (16, 16, 8)
    data = np.random.default_rng(0).integers(0, 255, (8,) + tile, dtype=np.uint8)
    offsets = [(16 * (i % 2), 16 * (i // 2 % 2), 8 * (i // 4)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for run in range(20):
            path = str(tmp_path / f"store{run}")
            cv = ChunkedVolume.create(path, scale=(1, 1, 1), boundary=(32, 32, 16),
                                      chunk_shape=tile, codec="zlib")
            start = threading.Barrier(8)
            errors = []

            def write(i):
                start.wait(timeout=30)
                try:
                    cv.save_raw(data[i], offset=offsets[i], mags=(1, 2))
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=write, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert errors == [], (run, errors)
            with open(f"{path}/meta.json") as f:
                meta = json.load(f)
            assert "raw" in meta["channels"] and meta["mags"] == [1, 2], (run, meta)
            assert np.array_equal(ChunkedVolume.open(path).load_raw(offset=offsets[5], size=tile),
                                  data[5])
    finally:
        sys.setswitchinterval(interval)
