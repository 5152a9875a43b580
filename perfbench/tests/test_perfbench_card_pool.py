"""The reader of the card's share of the mag-2 pooling
(``mag2_card_pooled_share.store``): on synthetic records, and on the records
of a small ``predict_dense_to_kd`` run of the port on the CPU."""

import numpy as np
import pytest

from perfbench.lib import harness, program_spans
from perfbench.lib import trace as tr


class _Ctx:
    """A trace whose [0, span_us] us is host [anchor, anchor + span_us * 1000] ns."""

    def __init__(self, anchor=1_000_000, span_us=100.0):
        self.trace_data = tr.Trace([], 0.0, span_us, host_anchor_ns=anchor)
        self.stretch_passes, self.tiles_per_pass = 1, 8
        self.voxels_per_pass = 10 ** 6


def _rec(name, t0, t1, **attrs):
    return dict(name=name, t0=1_000_000 + t0, t1=1_000_000 + t1, thread=1, id=0, parent=None,
                call=0, attrs=attrs, device_s=None)


CARD = _rec("dense.pool", 1_000, 2_000, device="cuda:0", tiles=4, voxels=300)
HOST = _rec("chunk.downsample", 3_000, 9_000, mag=2, mode="mean", voxels=100)
STRIDE = _rec("chunk.downsample", 3_000, 4_000, mag=2, mode="stride", voxels=50)  # pools nothing
MAG4 = _rec("chunk.downsample", 3_000, 4_000, mag=4, mode="mean", voxels=50)
OLD_HOST = _rec("chunk.downsample", 3_000, 9_000, mag=2, mode="mean")  # a program without voxels
LATE = _rec("dense.pool", 150_000, 160_000, device="cuda:0", tiles=4, voxels=900)  # after it


@pytest.mark.parametrize("records,value", [
    ([CARD, STRIDE, MAG4, LATE], 100.0),
    ([CARD, HOST, STRIDE], 75.0),
    ([HOST, STRIDE, MAG4], 0.0),  # only the host pools
    ([STRIDE, OLD_HOST], None),  # a program whose spans carry no voxel count, as the parent
    (None, None),  # a program older than the tracer
])
def test_card_pooled_share_reader(root, monkeypatch, records, value):
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: None if records is None else [dict(r) for r in records])
    got = harness.Cell(root, "organelles.store").reader("mag2_card_pooled_share.store").read(_Ctx())
    assert got == value


@pytest.mark.parametrize("mode,value", [("probs", 100.0), ("masks", None)])
def test_card_pooled_share_of_a_port_run(root, tmp_path, monkeypatch, mode, value):
    """The port's own spans: probability maps at mags (1, 2) are pooled on
    the device (CPU here: the kernel's plain version), masks take the chunk
    store's stride view, which pools nothing."""
    import torch

    from syconn_tpu_torch.inference import dense
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.models import io as mio
    from syconn_tpu_torch.models.unet3d import UNet3D
    from syconn_tpu_torch.utils import tracing

    model = UNet3D(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=4)
    params = mio.init_model_params(model, 0)
    shape = (64, 64, 32)
    src = str(tmp_path / "raw")
    ChunkedVolume.create(src, scale=(10, 10, 20), boundary=shape, chunk_shape=(32, 32, 16)).save_raw(
        np.random.default_rng(5).integers(0, 255, shape, dtype=np.uint8))
    tracing.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            dense.predict_dense_to_kd(src, {n: str(tmp_path / n) for n in ("mi", "sj")}, model,
                                      params, {"mi": 1, "sj": 3}, tile_shape=(32, 32, 16),
                                      halo=(8, 8, 4), mode=mode, show_progress=False,
                                      device="cpu", io_threads=2)
        recs = tracing.records()
    finally:
        tracing.clear()
    anchor = min(r["t0"] for r in recs) - 1
    span_us = (max(r["t1"] for r in recs) - anchor) / 1e3 + 1
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    got = harness.Cell(root, "organelles.store").reader("mag2_card_pooled_share.store").read(
        _Ctx(anchor, span_us))
    assert got == value
