"""The view route of steps 7-9 and the rendering steps of the port against
the JAX package, on the view world of tests/test_views_infer.py (two cells
of two SVs, ``use_point_models: False``, seed-initialised view nets): the
same volume and RAG are written into two working directories, each package
runs steps 2, 4 and 5 and then

* ``run_celltype_prediction``, ``run_semsegaxoness_prediction`` (with
  ``compartments.view_scalar_avg``) and ``run_morphology_embedding``, the
  JAX package under ``jax.disable_jit()`` (eager, as the port), the port on
  the CPU with the nets the JAX package seed-initialised and persisted
  (copied into its working directory);
* ``run_neuron_rendering`` and ``run_astrocyte_rendering``.

Held equal: cell types, vertex labels (``axoness_vertex_labels``), the
skeleton's ``axoness``, ``axoness_avg10000`` and ``view_ixs``, the
per-location ``axoness_preds_cnn`` and ``view_locations``,
``average_node_axoness_views``, every depth, index and label view of
``render_sso_coords``/``render_sso_coords_index_views``/
``render_sso_coords_label_views``/``render_sampled_sso``, the stored views
of both rendering steps and ``write_sv_views_chunked``'s caches. Floats
within ``NET_ATOL`` (the port sums in f64 and rounds once, XLA sums in f32
in its own order, and the difference flips some bf16 roundings; measured
on these worlds: celltype logits 3.8e-3, certainty 6e-5, embeddings
3.6e-3, glia probabilities 4.3e-4).

A second world, ``fine_windows``, renders the same cells at finer windows
(``comp_window`` 2000 nm, the semseg's 4000 nm: 7-8 locations a cell in
place of one), which exercises the renderer on many more frames: views,
locations, node labels and cell types are equal there too; of the vertex
labels 0.998 agree (a vertex's votes can tie within a bf16 flip of the
semseg net's logits), held to >= 0.99.

The JAX package's rendering steps store every cell's views under the key
``"raw"`` of its shard's ``views.pkl``, so cells of one shard overwrite
each other (whichever thread writes last); the port keys them by cell, and
the stored views are compared with the JAX package's ``render_sampled_sso``
of each cell. Stores are read through the port's readers.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from _torch_helpers import jax_defaults_isolated, port_wd

jax = pytest.importorskip("jax")

NET_ATOL = {"logits": 2e-2, "certainty": 1e-2, "embedding": 1e-2, "glia": 1e-2}
VERTEX_AGREEMENT = {"view_world": 1.0, "fine_windows": 0.99}

_CONF = [("tpu", {"shard_pipeline": False}),  # both packages run their serial steps
         ("min_cc_size_ssv", 200), ("use_point_models", False), ("process_cell_organelles", []),
         ("skeleton", {"kimimaro_skelgen": {"dust_threshold": 100},
                       "kimimaro_merge": {"dust_threshold": 100, "tick_threshold": 200}})]
WORLDS = {
    "view_world": _CONF + [("views", {"allow_untrained_models": True}),
                           ("compartments", {"view_scalar_avg": True})],
    "fine_windows": _CONF + [
        ("views", {"allow_untrained_models": True,
                   "view_properties": {"comp_window": 2000, "ws": [256, 128], "nb_views": 2}}),
        ("compartments", {"view_scalar_avg": True,
                          "view_properties_semsegax": {"comp_window": 4000, "ws": [1024, 512],
                                                       "nb_views": 3, "verbose": False,
                                                       "semseg_key": "axoness", "k": 0}})],
}
CHUNK = (96, 96, 48)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class _JaxWd:
    """Activate a working directory in the JAX package's global_params."""

    def __init__(self, wd):
        self.wd = wd

    def __enter__(self):
        from syconn_tpu import global_params

        self.prev = global_params.wd
        global_params.wd = self.wd
        return global_params.config

    def __exit__(self, *a):
        from syconn_tpu import global_params

        global_params.wd = self.prev


def _build_jax(wd, conf, world):
    from syconn_tpu.exec import exec_init, exec_skeleton
    from syconn_tpu.handler.basics import clear_kd_cache
    from syconn_tpu.handler.config import generate_default_conf
    from syconn_tpu.io.chunked import ChunkedVolume
    from syconn_tpu.io.graph import save_svgraph
    from syconn_tpu.models.cmn import ViewSemSegNet
    from syconn_tpu.models.io import register_model

    # the JAX package's loader does not name this class: once its semseg
    # net is persisted, a later cell could not read it back
    register_model("ViewSemSegNet")(ViewSemSegNet)
    with jax_defaults_isolated():
        generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=conf, force_overwrite=True)
    clear_kd_cache()
    with _JaxWd(wd) as cfg:
        ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=world["seg"].shape,
                             chunk_shape=CHUNK).save_seg(world["seg"])
        save_svgraph(world["rag"], cfg.init_svgraph_path)
        exec_init.init_cell_subcell_sds(chunk_size=CHUNK, overwrite=True)
        exec_init.run_create_rag()
        exec_init.run_create_neuron_ssd()
        exec_skeleton.run_skeleton_generation(map_myelin=False, cube_size=CHUNK)


def _run_jax_views(wd):
    from syconn_tpu.exec import exec_inference, exec_render

    with _JaxWd(wd), jax.disable_jit():
        exec_inference.run_celltype_prediction()
        exec_inference.run_semsegaxoness_prediction()
        exec_inference.run_morphology_embedding()
        exec_render.run_neuron_rendering()
        exec_render.run_astrocyte_rendering()


def _build_port(wd, conf, world):
    from syconn_tpu_torch.exec import exec_init, exec_skeleton
    from syconn_tpu_torch.handler.basics import clear_kd_cache
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.io.graph import save_svgraph

    generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=conf, force_overwrite=True)
    clear_kd_cache()
    with port_wd(wd) as cfg:
        ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=world["seg"].shape,
                             chunk_shape=CHUNK).save_seg(world["seg"])
        save_svgraph(world["rag"], cfg.init_svgraph_path)
        exec_init.init_cell_subcell_sds(chunk_size=CHUNK, overwrite=True, device="cpu")
        exec_init.run_create_rag()
        exec_init.run_create_neuron_ssd(device="cpu")
        exec_skeleton.run_skeleton_generation(map_myelin=False, cube_size=CHUNK, device="cpu")


def _run_port_views(wd):
    from syconn_tpu_torch.exec import exec_inference, exec_render

    stats = {}
    with port_wd(wd):
        for name, fn in (("celltype", exec_inference.run_celltype_prediction),
                         ("axoness", exec_inference.run_semsegaxoness_prediction),
                         ("embedding", exec_inference.run_morphology_embedding),
                         ("neurons", exec_render.run_neuron_rendering),
                         ("astrocytes", exec_render.run_astrocyte_rendering)):
            stats[name] = {}
            fn(device="cpu", stats=stats[name])
    return stats


@pytest.fixture(scope="module", params=sorted(WORLDS))
def worlds(request, tmp_path_factory):
    from syconn_tpu.utils.testdata import generate_toy_world

    name = request.param
    base = tmp_path_factory.mktemp(name)
    wj, wt = str(base / "jax"), str(base / "torch")
    world = generate_toy_world(shape=(96, 96, 48), n_cells=2, svs_per_cell=2, seed=7)
    _build_jax(wj, WORLDS[name], world)
    _run_jax_views(wj)
    _build_port(wt, WORLDS[name], world)
    shutil.copytree(os.path.join(wj, "models"), os.path.join(wt, "models"))
    stats = _run_port_views(wt)
    return name, wj, wt, stats


def _cells(wd, version=None):
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    ssd = SuperSegmentationDataset(working_dir=wd, version=version)
    out = {}
    for i in ssd.ssv_ids:
        s = ssd.get_super_segmentation_object(int(i))
        s.load_attr_dict()
        s.load_skeleton()
        out[int(i)] = s
    return out


def test_view_route_equal_jax(worlds):
    name, wj, wt, stats = worlds
    cj, ct = _cells(wj), _cells(wt)
    assert sorted(cj) == sorted(ct) and len(ct) == 2
    for i in ct:
        a, b = ct[i].attr_dict, cj[i].attr_dict
        assert a["celltype_cnn_e3"] == b["celltype_cnn_e3"] and 0 <= a["celltype_cnn_e3"] < 8
        np.testing.assert_allclose(a["celltype_cnn_e3_probas"], b["celltype_cnn_e3_probas"],
                                   rtol=0, atol=NET_ATOL["logits"])
        assert abs(a["celltype_cnn_e3_certainty"] - b["celltype_cnn_e3_certainty"]) < \
            NET_ATOL["certainty"]
        np.testing.assert_allclose(a["latent_morph"], b["latent_morph"], rtol=0,
                                   atol=NET_ATOL["embedding"])
        assert a["latent_morph"].shape == (10,)
        vt, vj = a["axoness_vertex_labels"], b["axoness_vertex_labels"]
        assert vt.dtype == vj.dtype and vt.shape == vj.shape == (len(ct[i].mesh[1]) // 3,)
        assert np.mean(vt == vj) >= VERTEX_AGREEMENT[name]
        assert set(np.unique(vt)) <= {0, 1, 2, 3}
        np.testing.assert_array_equal(a["axoness_preds_cnn"], b["axoness_preds_cnn"])
        np.testing.assert_array_equal(a["view_locations"], b["view_locations"])
        for key in ("axoness", "axoness_avg10000", "view_ixs"):
            np.testing.assert_array_equal(ct[i].skeleton[key], cj[i].skeleton[key])
        assert set(np.unique(ct[i].skeleton["axoness"])) <= {0, 1, 2}
    n_loc = sum(len(ct[i].attr_dict["view_locations"]) for i in ct)
    st = stats["celltype"]
    assert st["cells"] == 2 and st["locations"] == n_loc and st["frames"] == 2 * n_loc
    assert st["dispatches"] >= 2 and st["render_calls"] >= 2 and st["forward_seconds"] > 0
    assert stats["axoness"]["predicted"] == 2 and stats["embedding"]["dispatches"] >= 2


def test_average_node_axoness_views_equal_jax(worlds):
    from syconn_tpu.inference.views_infer import average_node_axoness_views as javg
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JSSD
    from syconn_tpu_torch.inference.views_infer import average_node_axoness_views as tavg

    name, wj, wt, _ = worlds
    ct = _cells(wt)
    with _JaxWd(wj):
        jssd = JSSD(working_dir=wj)
        for i, s in ct.items():
            js = jssd.get_super_segmentation_object(i)
            for dist in (2000.0, 10000.0, 1e12):
                with port_wd(wt):
                    got = tavg(s, max_dist=dist, return_res=True, device="cpu")
                np.testing.assert_array_equal(got, javg(js, max_dist=dist, return_res=True))
            preds = s.attr_dict["axoness_preds_cnn"]
            assert set(np.unique(got)) <= set(np.unique(preds))


def test_render_functions_equal_jax(worlds):
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JSSD
    from syconn_tpu.render import views as JV
    from syconn_tpu_torch.render import views as TV

    name, wj, wt, _ = worlds
    ct = _cells(wt)
    with _JaxWd(wj), jax.disable_jit():
        jssd = JSSD(working_dir=wj)
        for i, s in ct.items():
            js = jssd.get_super_segmentation_object(i)
            with port_wd(wt):
                vt, lt = TV.render_sampled_sso(s, ws=(128, 64), nb_views=2, device="cpu")
            vj, lj = JV.render_sampled_sso(js, ws=(128, 64), nb_views=2)
            np.testing.assert_array_equal(lt, lj)
            np.testing.assert_array_equal(vt, vj)
            assert vt.shape == (len(lt), 2, 4, 128, 64) and (vt[:, :, 0] < 255).any()
            coords = np.concatenate([lt, lt[:1] + 250.0])
            with port_wd(wt):
                dt = TV.render_sso_coords(s, coords, device="cpu")
                it = TV.render_sso_coords_index_views(s, coords, ws=(64, 32), nb_views=3,
                                                      comp_window=3000.0, device="cpu")
                labels = s.attr_dict["axoness_vertex_labels"]
                lv = TV.render_sso_coords_label_views(s, labels, coords, ws=(64, 32), nb_views=3,
                                                      comp_window=3000.0, device="cpu")
            np.testing.assert_array_equal(dt, JV.render_sso_coords(js, coords))
            np.testing.assert_array_equal(it, JV.render_sso_coords_index_views(
                js, coords, ws=(64, 32), nb_views=3, comp_window=3000.0))
            np.testing.assert_array_equal(lv, JV.render_sso_coords_label_views(
                js, labels, coords, ws=(64, 32), nb_views=3, comp_window=3000.0))
            assert it.max() < len(s.mesh[1]) // 3 and (it >= 0).any()


def test_rendering_steps_equal_jax(worlds):
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JSSD
    from syconn_tpu.render.views import render_sampled_sso as jrender
    from syconn_tpu_torch.reps.views import ViewContainer

    name, wj, wt, stats = worlds
    with _JaxWd(wj), jax.disable_jit():
        for version, key in ((None, "neurons"), ("gliapred", "astrocytes")):
            ct, cj = _cells(wt, version), _cells(wj, version)
            assert sorted(ct) == sorted(cj)
            jssd = JSSD(working_dir=wj, version=version)
            n_loc = 0
            for i, s in ct.items():
                views = ViewContainer(s.ssv_dir).load_views((i, "raw"))
                ref, locs = jrender(jssd.get_super_segmentation_object(i))
                np.testing.assert_array_equal(views, ref)
                if version is None:
                    np.testing.assert_array_equal(s.attr_dict["view_locations"],
                                                  cj[i].attr_dict["view_locations"])
                    np.testing.assert_array_equal(s.attr_dict["view_locations"], locs)
                n_loc += len(locs)
            assert stats[key]["cells"] == len(ct) and stats[key]["locations"] == n_loc
    np.testing.assert_array_equal(sorted(_cells(wt, "gliapred")), sorted(_cells(wt)))


def test_gliapred_equal_jax(worlds):
    from syconn_tpu.inference.views_infer import gliapred_sso_views as jglia
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JSSD
    from syconn_tpu_torch.inference.views_infer import gliapred_sso_views as tglia

    name, wj, wt, _ = worlds
    ct = _cells(wt)
    with _JaxWd(wj), jax.disable_jit():
        jssd = JSSD(working_dir=wj)
        ref = {i: jglia(jssd.get_super_segmentation_object(i)) for i in ct}
    if not os.path.isdir(os.path.join(wt, "models", "glia")):
        shutil.copytree(os.path.join(wj, "models", "glia"), os.path.join(wt, "models", "glia"))
    st = {}
    with port_wd(wt):
        for i, s in ct.items():
            p = tglia(s, device="cpu", stats=st)
            assert 0.0 <= p <= 1.0 and abs(p - ref[i]) < NET_ATOL["glia"]
            s.attr_dict.clear()
            assert s.lookup_in_attribute_dict("glia_probas") == p
    assert st["cells"] == len(ct) and st["dispatches"] >= len(ct)


def test_write_sv_views_chunked_equal_jax(worlds):
    from syconn_tpu.render.views import write_sv_views_chunked as jwrite
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JSSD
    from syconn_tpu_torch.render.views import write_sv_views_chunked as twrite
    from syconn_tpu_torch.reps.segmentation import SegmentationDataset

    name, wj, wt, _ = worlds
    ct = _cells(wt)
    i = sorted(ct)[0]
    rng = np.random.default_rng(0)
    svs = list(ct[i].svs)
    part = np.concatenate([[0], np.cumsum([int(rng.integers(1, 4)) for _ in svs])])
    views = rng.integers(0, 255, (int(part[-1]), 2, 1, 8, 4), dtype=np.uint8)
    with port_wd(wt):
        twrite(svs, views, part, view_key="raw")
    with _JaxWd(wj):
        jwrite(list(JSSD(working_dir=wj).get_super_segmentation_object(i).svs), views, part,
               view_key="raw")
    for k, sv in enumerate(svs):
        np.testing.assert_array_equal(sv.load_views("raw"), views[part[k]:part[k + 1]])
        jsv = SegmentationDataset("sv", working_dir=wj).get_segmentation_object(int(sv.id))
        np.testing.assert_array_equal(jsv.load_views("raw"), sv.load_views("raw"))
        assert sv.load_views("other") is None
