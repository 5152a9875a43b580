"""The port's slice as a whole against the JAX package, through each
package's working-directory configuration, on a small seeded toy world
(the JAX package's ``generate_toy_world``, on which the packaged organelles
U-Net was trained; two chunks of 64 x 64 x 32):

1. step 1, ``predict_cellorganelles(mag=1)``: the mi/vc/sj probability maps
   agree within the organelles budget (>= 97.5% of voxels within 2 LSB:
   the JAX package's own two implementations of this net are no closer,
   see tests/test_torch_unet.py::test_organelles_port_within_the_reference_spread),
   and the masks at the configured thresholds, which step 2 extracts,
   flip on < 0.3% of voxels (the trained-mask tolerance);
2. steps 2 and 6a from the same probability maps (the JAX package's step-1
   output copied into the port's working directory, since a 1-LSB
   difference can move a threshold): ``init_cell_subcell_sds``,
   ``run_create_rag`` and contact extraction write equal 'sv', 'mi', 'vc',
   'cs' and 'syn' datasets and an equal pruned graph.
"""

import bz2
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from _torch_helpers import compare_datasets, jax_defaults_isolated, port_wd

SH = (128, 64, 32)
CHUNK = (64, 64, 32)
# the toy world's mitochondria are thin: one erosion and seeds of 10
# voxels (as for vc) leave them seeds, the default four and 50 do not
CONF = [("tpu", {"shard_pipeline": False}), ("min_cc_size_ssv", 300),
        ("cell_objects", {"min_obj_vx": {"mi": 100, "cs": 5, "syn": 5},
                          "min_seed_vx": {"mi": 10},
                          "extract_morph_op": {"mi": ["binary_opening", "binary_closing",
                                                      "binary_erosion"]}})]


@pytest.fixture(autouse=True)
def _jax_defaults():
    """Nested overrides in the JAX working directories leave the JAX
    package's defaults as they were for the rest of the process."""
    with jax_defaults_isolated():
        yield


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _make_wd(wd, package, world):
    if package == "jax":
        from syconn_tpu.handler.config import Config, generate_default_conf
        from syconn_tpu.io.chunked import ChunkedVolume
    else:
        from syconn_tpu_torch.handler.config import Config, generate_default_conf
        from syconn_tpu_torch.io.chunked import ChunkedVolume
    generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=CONF)
    cfg = Config(wd)
    kd = ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=SH, chunk_shape=CHUNK)
    kd.save_raw(world["raw"])
    kd.save_seg(world["seg"])
    with bz2.open(cfg.init_svgraph_path, "wb") as f:
        pickle.dump({"edges": world["rag"], "nodes": None}, f, protocol=4)
    return cfg


def test_slice_through_the_config_equals_jax(tmp_path):
    from syconn_tpu import global_params as jparams
    from syconn_tpu.exec import exec_dense_prediction as jdense
    from syconn_tpu.exec import exec_init as jinit
    from syconn_tpu.extraction.cs_extraction import extract_contact_sites
    from syconn_tpu.handler.basics import clear_kd_cache
    from syconn_tpu.io.chunked import ChunkedVolume as JVolume
    from syconn_tpu.io.graph import load_svgraph as jload
    from syconn_tpu.utils.testdata import generate_toy_world
    from syconn_tpu_torch.exec import exec_dense_prediction as tdense
    from syconn_tpu_torch.exec import exec_init as tinit
    from syconn_tpu_torch.exec.exec_syns import run_syn_generation
    from syconn_tpu_torch.io.chunked import ChunkedVolume as TVolume
    from syconn_tpu_torch.io.chunked import clear_chunk_cache

    world = generate_toy_world(shape=SH, n_cells=4, svs_per_cell=3, seed=4, device=False)
    wj, wt = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = _make_wd(wj, "jax", world)
    tcfg = _make_wd(wt, "port", world)

    # step 1 in both packages
    clear_kd_cache()
    prev = jparams.wd
    jparams.wd = wj
    try:
        jdense.predict_cellorganelles(mag=1)
    finally:
        jparams.wd = prev
    with port_wd(wt):
        stats = tdense.predict_cellorganelles(mag=1, device="cpu", show_progress=False)
    assert stats["n_voxels"] == int(np.prod(SH))
    cell_objects = jcfg["cell_objects"]
    for co in ("mi", "vc", "sj"):
        ref = JVolume.open(getattr(jcfg, f"kd_{co}_path")).load_raw(size=SH)
        got = TVolume.open(getattr(tcfg, f"kd_{co}_path")).load_raw(size=SH)
        d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        assert np.mean(d <= 2) >= 0.975, (co, float(np.mean(d <= 2)), int(d.max()))
        thr = float(cell_objects["probathresholds"][co]) * 255.0
        flips = float(np.mean((got >= thr) != (ref >= thr)))
        assert flips < 3e-3, (co, flips)
        assert int(ref.max()) > 200, co  # the trained net finds this organelle
        # steps 2 and 6a start from the same maps
        shutil.rmtree(getattr(tcfg, f"kd_{co}_path"))
        shutil.copytree(getattr(jcfg, f"kd_{co}_path"), getattr(tcfg, f"kd_{co}_path"))
    clear_chunk_cache()  # the port's decompressed chunks of the replaced maps

    # steps 2 and 6a
    clear_kd_cache()
    jparams.wd = wj
    try:
        jcounts = jinit.init_cell_subcell_sds(chunk_size=CHUNK)
        jinit.run_create_rag()
        jcs = extract_contact_sites(chunk_shape=CHUNK)
    finally:
        jparams.wd = prev
    with port_wd(wt):
        tcounts = tinit.init_cell_subcell_sds(chunk_size=CHUNK, device="cpu")
        pruned = tinit.run_create_rag()
        tcs = run_syn_generation(chunk_size=CHUNK, until="extract_contact_sites", device="cpu")
    assert {k: v for k, v in tcounts.items() if k != "stats"} == jcounts
    assert {k: tcs[k] for k in ("n_cs", "n_syn")} == jcs
    assert min(jcounts.values()) > 0 and min(jcs.values()) > 0, (jcounts, jcs)
    compare_datasets(wj, wt, ["sv", "mi", "vc", "cs", "syn"])
    gj = jload(os.path.join(wj, "pruned_svgraph.bz2"))
    assert set(gj.nodes()) == set(pruned["nodes"].tolist())
    assert {tuple(sorted(e)) for e in gj.edges()} == \
        {tuple(int(x) for x in e) for e in pruned["edges"]}
