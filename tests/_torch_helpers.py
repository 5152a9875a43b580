"""Helpers of the port's tests (not a test module): the port's working
directory, exact comparison of the datasets two working directories
hold, and the dense head's logits."""

import contextlib
import glob
import os
import pickle

import numpy as np
import torch

from syconn_tpu_torch import global_params as tparams


@contextlib.contextmanager
def jax_defaults_isolated():
    """The JAX package's ``generate_default_conf`` merges nested overrides
    into its cached packaged defaults (a shallow copy), which every later
    config of the process then falls back to. Inside this context the JAX
    package re-reads its packaged file, and afterwards its cache is what it
    was before."""
    from syconn_tpu.handler import config as jconfig

    prev = jconfig._default_conf_cache
    jconfig._default_conf_cache = None
    try:
        yield
    finally:
        jconfig._default_conf_cache = prev


@contextlib.contextmanager
def port_wd(wd):
    """Activate ``wd`` in the port's ``global_params`` and, afterwards, give
    it a fresh config again: a ``DynConfig`` keeps its last working
    directory when ``wd`` goes back to None, and later tests in the same
    process must see the packaged defaults."""
    prev = tparams.wd
    tparams.wd = wd
    try:
        yield tparams.config
    finally:
        tparams.wd = prev
        tparams.config = None
        tparams._init_config()


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                _same(x, y, f"{path}[{i}]")
        else:
            assert np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _pickles(d):
    out = {}
    for p in sorted(glob.glob(os.path.join(d, "**", "*.pkl"), recursive=True)):
        with open(p, "rb") as f:
            out[os.path.relpath(p, d)] = pickle.load(f)
    return out


def compare_datasets(wj, wt, types, skip=()):
    """Numpy caches, per-shard attribute dicts, meshes and voxel stores of
    each dataset type (``<wd>/<type>s_0``): equal, but for the voxel stores'
    data path (each names its own working directory) and the compressed
    bytes of the mesh payloads (compared decompressed). The attributes named
    in ``skip`` (their numpy caches and their entries in the attribute
    dicts) are left out."""
    from syconn_tpu_torch.backend import MeshStorage

    skip = set(skip)
    for t in types:
        dj, dt = os.path.join(wj, f"{t}s_0"), os.path.join(wt, f"{t}s_0")
        npy = sorted(os.path.basename(p) for p in glob.glob(os.path.join(dj, "*.npy")))
        assert npy == sorted(os.path.basename(p) for p in glob.glob(os.path.join(dt, "*.npy")))
        assert "ids.npy" in npy
        for name in npy:
            if name[:-5] in skip:
                continue
            _same(np.load(os.path.join(dj, name), allow_pickle=True),
                  np.load(os.path.join(dt, name), allow_pickle=True), f"{t}/{name}")
        for p in sorted(glob.glob(os.path.join(dj, "**", "*.npz"), recursive=True)):
            rel = os.path.relpath(p, dj)
            with np.load(p) as zj, np.load(os.path.join(dt, rel)) as zt:
                assert sorted(zj.files) == sorted(zt.files), rel
                for k in zj.files:
                    _same(zj[k], zt[k], f"{t}/{rel}/{k}")
        pj, pt = _pickles(dj), _pickles(dt)
        assert sorted(pj) == sorted(pt), t
        for rel in pj:
            if skip and rel.endswith("attr_dict.pkl"):
                for p in (pj, pt):
                    p[rel] = {i: {k: v for k, v in d.items() if k not in skip}
                              for i, d in p[rel].items()}
            if rel.endswith("voxel_dyn.pkl"):
                for p, w in ((pj, wj), (pt, wt)):
                    meta = p[rel]["meta"]
                    meta["voxeldata_path"] = os.path.relpath(meta["voxeldata_path"], w)
            if rel.endswith("mesh.pkl"):
                ms = [MeshStorage(os.path.join(d, rel), read_only=True) for d in (dj, dt)]
                assert sorted(ms[0].keys()) == sorted(ms[1].keys())
                for k in ms[0].keys():
                    _same(ms[0][k], ms[1][k], f"{t}/{rel}/{k}")
                continue
            _same(pj[rel], pt[rel], f"{t}/{rel}")


def build_jax_sso_world(root, cells_dir=None):
    """The cells of ``tests/test_sso_methods.py::sso_world`` (a 96x96x48
    toy world of 2 cells x 2 SVs, seed 8: SV dataset, graph, SSD, skeletons)
    built by the JAX package in ``<root>/wd``; with ``cells_dir`` every cell
    is also exported there by the JAX package's ``export2kzip``. The JAX
    package's working directory is what it was before. Returns the wd."""
    from syconn_tpu import global_params
    from syconn_tpu.exec.exec_init import (init_cell_subcell_sds, run_create_neuron_ssd,
                                           run_create_rag)
    from syconn_tpu.exec.exec_skeleton import run_skeleton_generation
    from syconn_tpu.handler.basics import clear_kd_cache
    from syconn_tpu.handler.config import generate_default_conf
    from syconn_tpu.io.chunked import ChunkedVolume
    from syconn_tpu.io.graph import save_svgraph
    from syconn_tpu.utils.testdata import generate_toy_world

    wd = os.path.join(str(root), "wd")
    prev = global_params.wd
    clear_kd_cache()
    with jax_defaults_isolated():
        generate_default_conf(
            wd, scaling=(10, 10, 20),
            key_value_pairs=[("min_cc_size_ssv", 200),
                             ("skeleton", {"kimimaro_skelgen": {"dust_threshold": 100},
                                           "kimimaro_merge": {"dust_threshold": 100,
                                                              "tick_threshold": 200}})],
            force_overwrite=True)
        try:
            global_params.wd = wd
            global_params.config._parse_config()
            global_params.config.entries["process_cell_organelles"] = []
            cfg = global_params.config
            world = generate_toy_world(shape=(96, 96, 48), n_cells=2, svs_per_cell=2, seed=8)
            kd = ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20),
                                      boundary=world["seg"].shape, chunk_shape=(96, 96, 48))
            kd.save_seg(world["seg"])
            save_svgraph(world["rag"], cfg.init_svgraph_path)
            init_cell_subcell_sds(chunk_size=(96, 96, 48), overwrite=True)
            run_create_rag()
            ssd = run_create_neuron_ssd()
            run_skeleton_generation(map_myelin=False, cube_size=(96, 96, 48))
            if cells_dir is not None:
                for i in ssd.ssv_ids:
                    ssd.get_super_segmentation_object(int(i)).export2kzip(
                        os.path.join(str(cells_dir), f"{int(i)}.k.zip"))
        finally:
            global_params.wd = prev
            clear_kd_cache()
    return wd


def head_logits(batch, tile_shape, halo, patch, n_classes, seed, kind="normal"):
    """Haloed packed f32 logits of the dense head (``ops/head.py``), as the
    engine writes them, from numpy: normal(0, 4), magnitudes up to 80, equal
    logits across the classes, or logits that put p * 255 on a half (class 0
    at 0, class 1 at ln(p / (1 - p)) with p = (k + 0.5) / 255 for a random k,
    the rest far below: ties to even or rounding on either side of one)."""
    sp = (np.asarray(tile_shape) + 2 * np.asarray(halo)) // np.asarray(patch)
    pvox = int(np.prod(patch))
    rng = np.random.default_rng(seed)
    shape = (batch, *sp, n_classes, pvox)
    if kind == "normal":
        x = 4.0 * rng.standard_normal(shape)
    elif kind == "large":
        x = rng.uniform(-80.0, 80.0, shape)
    elif kind == "equal":
        x = np.broadcast_to(rng.uniform(-80.0, 80.0, shape[:4] + (1, pvox)), shape)
    else:
        p = (rng.integers(1, 254, shape[:4] + (pvox,)) + 0.5) / 255.0
        x = np.full(shape, -200.0)
        x[..., 0, :] = 0.0
        x[..., 1, :] = np.log(p / (1.0 - p))
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).reshape(*shape[:4], -1)
