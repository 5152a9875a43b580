"""KNOSSOS dataset export and import (counterpart of
``syconn_tpu/io/knossos.py``).

Users inspect results in the KNOSSOS viewer; this module moves a channel of
the port's :class:`~syconn_tpu_torch.io.chunked.ChunkedVolume` to and from
the public on-disk format, without external packages:

* ``knossos.conf``: experiment name, boundary, scale, magnification;
* per magnification the cube tree ``mag{m}/x%04d/y%04d/z%04d/`` with
  ``{exp}_mag{m}_x%04d_y%04d_z%04d.raw`` grayscale cubes (uint8, x fastest)
  and ``....seg.sz.zip`` segmentation cubes (a zip holding one snappy block
  of little-endian uint64 voxels, :mod:`syconn_tpu_torch.io.snappy_py`).

For the same volume ``knossos.conf``, the ``.raw`` cubes and the snappy
payloads of the ``.seg.sz.zip`` cubes are byte-equal to the JAX package's
export. An import writes a new ChunkedVolume in the port's chunk codec.
"""

from __future__ import annotations

import os
import re
import zipfile
from typing import Dict, Optional, Sequence

import numpy as np

from . import snappy_py
from .chunked import ChunkedVolume

__all__ = [
    "write_knossos_conf",
    "parse_knossos_conf",
    "export_to_knossos_dataset",
    "import_knossos_dataset",
]

CUBE_EDGE = 128


def write_knossos_conf(path: str, experiment_name: str, boundary, scale,
                       mag: int = 1) -> str:
    """Write ``knossos.conf`` into ``path``; returns the file path."""
    os.makedirs(path, exist_ok=True)
    conf = os.path.join(path, "knossos.conf")
    lines = [f'experiment name "{experiment_name}";']
    for ax, b in zip("xyz", boundary):
        lines.append(f"boundary {ax} {int(b)};")
    for ax, s in zip("xyz", scale):
        lines.append(f"scale {ax} {float(s)};")
    lines.append(f"magnification {int(mag)};")
    with open(conf, "w") as f:
        f.write("\n".join(lines) + "\n")
    return conf


def parse_knossos_conf(conf_path: str) -> Dict:
    """Parse a ``knossos.conf`` (a dataset directory or the file itself)."""
    if os.path.isdir(conf_path):
        conf_path = os.path.join(conf_path, "knossos.conf")
    with open(conf_path) as f:
        txt = f.read()
    out: Dict = {"boundary": [0, 0, 0], "scale": [1.0, 1.0, 1.0]}
    m = re.search(r'experiment\s+name\s+"([^"]*)"', txt)
    out["experiment_name"] = m.group(1) if m else ""
    for i, ax in enumerate("xyz"):
        m = re.search(rf"boundary\s+{ax}\s+(\d+)", txt)
        if m:
            out["boundary"][i] = int(m.group(1))
        m = re.search(rf"scale\s+{ax}\s+([\d.eE+-]+)", txt)
        if m:
            out["scale"][i] = float(m.group(1))
    m = re.search(r"magnification\s+(\d+)", txt)
    out["magnification"] = int(m.group(1)) if m else 1
    return out


def _cube_path(root: str, exp: str, mag: int, cx: int, cy: int, cz: int, seg: bool) -> str:
    d = os.path.join(root, f"mag{mag}", f"x{cx:04d}", f"y{cy:04d}", f"z{cz:04d}")
    base = f"{exp}_mag{mag}_x{cx:04d}_y{cy:04d}_z{cz:04d}"
    return os.path.join(d, base + (".seg.sz.zip" if seg else ".raw"))


def _write_seg_cube(path: str, cube_xyz: np.ndarray):
    """A cube (E, E, E) of uint64 in (x, y, z) index order -> .seg.sz.zip."""
    payload = snappy_py.compress(
        np.ascontiguousarray(cube_xyz.transpose(2, 1, 0)).astype("<u8").tobytes())
    member = os.path.basename(path)[: -len(".zip")]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(member, payload)


def _read_seg_cube(path: str, edge: int) -> np.ndarray:
    with zipfile.ZipFile(path) as zf:
        payload = zf.read(zf.namelist()[0])
    flat = np.frombuffer(snappy_py.decompress(payload), dtype="<u8")
    return flat.reshape(edge, edge, edge).transpose(2, 1, 0)


def export_to_knossos_dataset(
    cv: ChunkedVolume,
    out_dir: str,
    channel: str = "raw",
    mags: Optional[Sequence[int]] = None,
    experiment_name: Optional[str] = None,
    cube_edge: int = CUBE_EDGE,
) -> str:
    """Export a ChunkedVolume channel as a KNOSSOS dataset; returns
    ``out_dir``. Cubes that are all zero are not written: KNOSSOS reads a
    missing cube as empty."""
    assert channel in ("raw", "seg")
    exp = experiment_name or cv.experiment_name or "syconn_tpu"
    mags = list(mags or cv.available_mags)
    write_knossos_conf(out_dir, exp, cv.boundary, cv.scale, mag=mags[0])
    for mag in mags:
        mshape = cv.mag_shape(mag)
        grid = [-(-int(mshape[i]) // cube_edge) for i in range(3)]
        for cx in range(grid[0]):
            for cy in range(grid[1]):
                for cz in range(grid[2]):
                    off = np.array([cx, cy, cz]) * cube_edge
                    size = np.minimum(cube_edge, mshape - off)
                    if channel == "raw":
                        data = cv.load_raw(offset=off, size=size, mag=mag)
                    else:
                        data = cv.load_seg(offset=off, size=size, mag=mag)
                    if not data.any():
                        continue
                    cube = np.zeros((cube_edge,) * 3, data.dtype)
                    cube[: size[0], : size[1], : size[2]] = data
                    p = _cube_path(out_dir, exp, mag, cx, cy, cz, seg=channel == "seg")
                    os.makedirs(os.path.dirname(p), exist_ok=True)
                    if channel == "seg":
                        _write_seg_cube(p, cube)
                    else:
                        with open(p, "wb") as f:
                            f.write(np.ascontiguousarray(cube.transpose(2, 1, 0))
                                    .astype(np.uint8).tobytes())
    return out_dir


def import_knossos_dataset(
    kns_dir: str,
    out_path: str,
    channel: str = "raw",
    mag: int = 1,
    cube_edge: int = CUBE_EDGE,
    chunk_shape: Sequence[int] = (256, 256, 256),
) -> ChunkedVolume:
    """Import one channel at one magnification of a KNOSSOS dataset into a
    new ChunkedVolume at ``out_path``."""
    assert channel in ("raw", "seg")
    conf = parse_knossos_conf(kns_dir)
    boundary = np.asarray(conf["boundary"], np.int64)
    mshape = -(-boundary // mag)
    cv = ChunkedVolume.create(
        out_path, scale=conf["scale"], boundary=[int(b) for b in boundary],
        experiment_name=conf["experiment_name"],
        chunk_shape=tuple(int(c) for c in chunk_shape), mags=(mag,),
    )
    vol = np.zeros(tuple(int(s) for s in mshape), np.uint64 if channel == "seg" else np.uint8)
    magdir = os.path.join(kns_dir, f"mag{mag}")
    pat = re.compile(r"_x(\d+)_y(\d+)_z(\d+)\.(raw|seg\.sz\.zip)$")
    for root, _dirs, files in os.walk(magdir):
        for fn in files:
            m = pat.search(fn)
            if not m:
                continue
            is_seg = m.group(4) != "raw"
            if is_seg != (channel == "seg"):
                continue
            cx, cy, cz = (int(m.group(i)) for i in (1, 2, 3))
            p = os.path.join(root, fn)
            if is_seg:
                cube = _read_seg_cube(p, cube_edge)
            else:
                with open(p, "rb") as f:
                    flat = np.frombuffer(f.read(), np.uint8)
                cube = flat.reshape(cube_edge, cube_edge, cube_edge).transpose(2, 1, 0)
            off = np.array([cx, cy, cz]) * cube_edge
            size = np.minimum(cube_edge, mshape - off)
            if (size <= 0).any():
                continue
            vol[off[0]:off[0] + size[0], off[1]:off[1] + size[1], off[2]:off[2] + size[2]] = \
                cube[: size[0], : size[1], : size[2]]
    if channel == "seg":
        cv.save_seg(vol, mags=[mag], data_mag=mag)
    else:
        cv.save_raw(vol, mags=[mag], data_mag=mag)
    return cv
