"""Spine-head volumes of the port against the JAX package on the spine
scene of tests/test_spinehead.py (a dendrite shaft, a thin neck and a
spherical head; the cell mesh is the boundary voxels, labeled by region):
both packages' ``extract_spinehead_volume`` measure the same volume for the
head synapse, within that test's construction tolerance, and skip a synapse
on the shaft."""

import os

import numpy as np
import pytest
from scipy import ndimage

SV_ID = SSV_ID = 7
HEAD_SYN, SHAFT_SYN = 1, 2


def _scene():
    """(seg, head mask, neck mask, head synapse coord) on a 128x128x64 grid."""
    shape = (128, 128, 64)
    x, y, z = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    shaft = (x >= 20) & (x < 110) & (y >= 20) & (y < 44) & (z >= 20) & (z < 44)
    neck = (np.abs(x - 64) <= 2) & (y >= 44) & (y < 58) & (np.abs(z - 32) <= 2)
    head = (x - 64) ** 2 + (y - 66) ** 2 + (z - 32) ** 2 <= 8 ** 2
    seg = np.where(shaft | neck | head, SV_ID, 0).astype(np.uint64)
    return seg, head, neck, np.array([64, 74, 32])


def _build(wd, package, with_shaft_syn):
    if package == "jax":
        from syconn_tpu import backend
        from syconn_tpu.handler.basics import clear_kd_cache
        from syconn_tpu.handler.config import Config, generate_default_conf
        from syconn_tpu.io.chunked import ChunkedVolume
        from syconn_tpu.reps.rep_helper import subfold_from_ix
        from syconn_tpu.reps.segmentation import SegmentationDataset
        from syconn_tpu.reps.super_segmentation import SuperSegmentationObject
    else:
        from syconn_tpu_torch import backend
        from syconn_tpu_torch.handler.basics import clear_kd_cache
        from syconn_tpu_torch.handler.config import Config, generate_default_conf
        from syconn_tpu_torch.io.chunked import ChunkedVolume
        from syconn_tpu_torch.reps.rep_helper import subfold_from_ix
        from syconn_tpu_torch.reps.segmentation import SegmentationDataset
        from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationObject

    clear_kd_cache()
    generate_default_conf(wd, scaling=(10, 10, 10))
    cfg = Config(wd)
    seg, head, neck, syn_coord = _scene()
    ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 10), boundary=seg.shape,
                         chunk_shape=(64, 64, 64)).save_seg(seg)
    mask = seg > 0
    sv_coords = np.argwhere(mask & ~ndimage.binary_erosion(mask))
    labels = np.zeros(len(sv_coords), np.uint8)
    labels[head[tuple(sv_coords.T)]] = 1
    labels[neck[tuple(sv_coords.T)]] = 2
    ssv = SuperSegmentationObject(SSV_ID, working_dir=wd, config=cfg)
    os.makedirs(ssv.ssv_dir, exist_ok=True)
    ms = backend.MeshStorage(ssv.mesh_path("sv"), read_only=False, disable_locking=True)
    ms[SSV_ID] = [np.zeros(0, np.int64), (sv_coords * 10.0).astype(np.float32).reshape(-1),
                  np.zeros(0, np.float32)]
    ms.push()
    syns = {HEAD_SYN: syn_coord}
    if with_shaft_syn:
        syns[SHAFT_SYN] = np.array([40, 32, 32])
    ssv.attr_dict.update(sv_ids=np.array([SV_ID], np.uint64), spiness_vertex_labels=labels,
                         syn_ssv=np.array(sorted(syns), np.uint64))
    ssv.save_attr_dict()
    sd_syn = SegmentationDataset("syn_ssv", working_dir=wd, config=cfg, n_folders_fs=100,
                                 create=True)
    for sid, c in syns.items():
        shard_dir = os.path.join(sd_syn.so_storage_path, subfold_from_ix(sid, 100).strip("/"))
        os.makedirs(shard_dir, exist_ok=True)
        ad = backend.AttributeDict(os.path.join(shard_dir, "attr_dict.pkl"), read_only=False,
                                   disable_locking=True)
        ad[sid] = {"id": sid, "rep_coord": c, "size": 10,
                   "bounding_box": np.array([c - 2, c + 2]),
                   "neuron_partners": np.array([SSV_ID, 999], np.uint64)}
        ad.push()
    return SuperSegmentationObject(SSV_ID, working_dir=wd, config=cfg), head


@pytest.mark.parametrize("with_shaft_syn", [False, True])
def test_spinehead_volume_equal_jax(tmp_path, with_shaft_syn):
    from syconn_tpu.reps.super_segmentation_helper import extract_spinehead_volume as jfn
    from syconn_tpu_torch.reps.super_segmentation_helper import extract_spinehead_volume as tfn

    sj, head = _build(str(tmp_path / "jax"), "jax", with_shaft_syn)
    st, _ = _build(str(tmp_path / "port"), "port", with_shaft_syn)
    vj = jfn(sj, ctx_vol=(40, 40, 24))
    stats = {}
    vt = tfn(st, ctx_vol=(40, 40, 24), stats=stats)
    assert vt == vj and sorted(vt) == [HEAD_SYN]
    assert stats["qualifying"] == 1
    # the construction tolerance of tests/test_spinehead.py
    assert vt[HEAD_SYN] == pytest.approx(head.sum() * 1000.0 / 1e9, rel=0.35)
    assert st.attr_dict["spinehead_vol"] == vt
