"""Helpers of the port's tests (not a test module): the port's working
directory, and exact comparison of the datasets two working directories
hold."""

import contextlib
import glob
import os
import pickle

import numpy as np

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
