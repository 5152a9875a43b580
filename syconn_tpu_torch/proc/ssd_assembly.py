"""Standalone cells: import and export through k.zip archives (counterpart
of ``syconn_tpu/proc/ssd_assembly.py``).

A cell archive carries the cell's meshes (one per object type), its
skeleton, its attribute dict and so its sample locations, so the example
scripts run on one cell without a working directory. Two layouts load:

* the package layout that :func:`save_sso_to_kzip` writes (``meta.json``,
  ``attr_dict.pkl``, ``mesh_<type>.npz``, ``skeleton.npz``), the same
  members as the JAX package's, so an archive of either package loads in
  the other;
* the layout of the reference's ``export2kzip`` (``meta.pkl``, binary
  little-endian ``<type>.ply`` meshes, ``skeleton.pkl``,
  ``sample_locations.pkl``, a KNOSSOS ``mergelist.txt``).

A loaded cell has no working directory: it answers from what the archive
held (an object type the archive lacks has an empty mesh).
"""

from __future__ import annotations

import glob
import io
import json
import os
import pickle
import zipfile
from typing import List, Optional

import numpy as np

__all__ = ["save_sso_to_kzip", "init_sso_from_kzip", "init_ssd_from_kzips", "read_ply_bytes"]

_MESH_TYPES = ["sv", "mi", "vc", "sj", "syn_ssv"]


def read_ply_bytes(data: bytes):
    """Binary little-endian PLY (vertex: float x, y, z, ...; face: list uchar
    int vertex_indices, triangles) -> (ind (F*3,) int64, vert (V*3,)
    float32), the flat mesh convention of the package."""
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", "replace").splitlines()
    if "format binary_little_endian 1.0" not in header[1]:
        raise ValueError(f"unsupported ply format: {header[1]!r}")
    n_vert = n_face = 0
    elem = None
    vert_props: List[str] = []
    for line in header[2:]:
        parts = line.split()
        if parts[0] == "element":
            elem = parts[1]
            if elem == "vertex":
                n_vert = int(parts[2])
            elif elem == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and elem == "vertex":
            if parts[1] != "float":
                raise ValueError(f"unsupported vertex property: {line!r}")
            vert_props.append(parts[2])
    nvp = len(vert_props)
    body = data[end:]
    vert = np.frombuffer(body, "<f4", count=n_vert * nvp).reshape(n_vert, nvp)
    xyz = vert[:, :3].astype(np.float32)
    off = n_vert * nvp * 4
    # a face record: the uchar count (3) and three int32, 13 bytes
    face_rec = np.frombuffer(body, np.uint8, count=n_face * 13, offset=off).reshape(n_face, 13)
    if n_face and not (face_rec[:, 0] == 3).all():
        raise ValueError("non-triangle face in ply")
    ind = face_rec[:, 1:].copy().view("<i4").reshape(n_face, 3)
    return ind.astype(np.int64).ravel(), xyz.ravel()


def save_sso_to_kzip(ssv, path: str, mesh_types=("sv", "mi", "vc", "sj")) -> str:
    """Export one cell into a standalone archive; returns ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        meta = {"id": int(ssv.id), "scaling": np.asarray(ssv.scaling).tolist()}
        zf.writestr("meta.json", json.dumps(meta))
        ssv.load_attr_dict()
        zf.writestr("attr_dict.pkl", pickle.dumps(ssv.attr_dict, protocol=4))
        for t in mesh_types:
            try:
                mesh = ssv.load_mesh(t)
            except Exception:
                continue
            if mesh is None or len(mesh[1]) == 0:
                continue
            buf = io.BytesIO()
            np.savez_compressed(
                buf, ind=np.asarray(mesh[0]), vert=np.asarray(mesh[1]),
                norm=np.asarray(mesh[2]) if len(mesh) > 2 else np.zeros(0, np.float32))
            zf.writestr(f"mesh_{t}.npz", buf.getvalue())
        if ssv.load_skeleton():
            buf = io.BytesIO()
            np.savez_compressed(buf, **{k: np.asarray(v) for k, v in ssv.skeleton.items()})
            zf.writestr("skeleton.npz", buf.getvalue())
    return path


def _standalone_sso(ssv_id: int, scaling, sv_ids, attr_dict: dict):
    from ..reps.super_segmentation import SuperSegmentationObject

    ssv = SuperSegmentationObject(ssv_id, working_dir=None, version="kzip", scaling=scaling,
                                  sv_ids=sv_ids)
    ssv.attr_dict = attr_dict
    ssv._standalone = True
    return ssv


def init_sso_from_kzip(path: str, sso_id: Optional[int] = None):
    """A standalone cell from an archive of either layout; needs no working
    directory."""
    with zipfile.ZipFile(path, "r") as zf:
        names = set(zf.namelist())
        if "meta.pkl" in names:
            return _init_sso_from_reference_kzip(zf, names, sso_id)
        meta = json.loads(zf.read("meta.json")) if "meta.json" in names else {}
        ssv_id = sso_id if sso_id is not None else int(meta.get("id", 1))
        scaling = np.asarray(meta.get("scaling", [1, 1, 1]), np.float32)
        attr_dict = pickle.loads(zf.read("attr_dict.pkl")) if "attr_dict.pkl" in names else {}
        ssv = _standalone_sso(ssv_id, scaling, attr_dict.get("sv_ids", [ssv_id]), attr_dict)
        for t in _MESH_TYPES:
            fname = f"mesh_{t}.npz"
            if fname in names:
                with zf.open(fname) as f:
                    data = np.load(io.BytesIO(f.read()))
                    ssv._meshes[t] = [data["ind"], data["vert"], data["norm"]]
        if "skeleton.npz" in names:
            with zf.open("skeleton.npz") as f:
                data = np.load(io.BytesIO(f.read()))
                ssv.skeleton = {k: data[k] for k in data.files}
    return ssv


def _init_sso_from_reference_kzip(zf, names, sso_id=None):
    """A cell of the reference's ``export2kzip`` layout (pickled meta,
    skeleton and sample locations, binary PLY meshes, mergelist.txt)."""
    meta = pickle.loads(zf.read("meta.pkl"))
    ssv_id = sso_id if sso_id is not None else int(meta.get("sso_id", 1))
    scaling = np.asarray(meta.get("scaling", [1, 1, 1]), np.float32)
    sv_ids = [ssv_id]
    if "mergelist.txt" in names:
        first = zf.read("mergelist.txt").split(b"\n", 1)[0].split()
        # KNOSSOS merge list: obj_id todo immutable sv_id sv_id ...
        if len(first) > 3:
            sv_ids = [int(x) for x in first[3:]]
    ssv = _standalone_sso(ssv_id, scaling, sv_ids, {"sv_ids": sv_ids})
    for t in _MESH_TYPES:
        fname = f"{t}.ply"
        if fname in names:
            ind, vert = read_ply_bytes(zf.read(fname))
            ssv._meshes[t] = [ind, vert, np.zeros(0, np.float32)]
    if "skeleton.pkl" in names:
        sk = pickle.loads(zf.read("skeleton.pkl"))
        if sk is not None:
            ssv.skeleton = sk
    if "sample_locations.pkl" in names:
        locs = pickle.loads(zf.read("sample_locations.pkl"))
        ssv.attr_dict["sample_locations"] = [np.asarray(loc, np.float32) for loc in locs]
    return ssv


def init_ssd_from_kzips(dir_path: str):
    """Every ``*.k.zip`` of a directory as a standalone cell, in name order."""
    return [init_sso_from_kzip(p) for p in sorted(glob.glob(os.path.join(dir_path, "*.k.zip")))]
