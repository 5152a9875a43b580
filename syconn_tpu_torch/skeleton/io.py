"""Skeleton export: a KNOSSOS annotation (NML text) inside a k.zip
(counterpart of ``syconn_tpu/skeleton/io.py``).

The NML text is byte-equal to the JAX package's for the same skeleton:
1-based node ids, radii with two decimals, coordinates (voxels) with one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["skeleton_to_nml", "skeleton_to_kzip", "nml_to_skeleton"]


def skeleton_to_nml(skel: Dict[str, np.ndarray], scaling=(1, 1, 1), comment: str = "") -> str:
    """One ``<thing>`` with the skeleton's nodes (radius = diameter / 2) and
    edges."""
    nodes = np.asarray(skel["nodes"]).reshape(-1, 3)
    edges = np.asarray(skel["edges"]).reshape(-1, 2)
    diam = np.asarray(skel.get("diameters", np.zeros(len(nodes))))
    sx, sy, sz = (float(s) for s in scaling)
    lines = [
        '<?xml version="1.0" encoding="UTF-8"?>',
        "<things>",
        "  <parameters>",
        f'    <scale x="{sx}" y="{sy}" z="{sz}"/>',
        "  </parameters>",
        f'  <thing id="1" comment="{comment}">',
        "    <nodes>",
    ]
    for i, p in enumerate(nodes):
        r = diam[i] / 2.0 if i < len(diam) else 1.0
        lines.append(f'      <node id="{i + 1}" radius="{r:.2f}" '
                     f'x="{p[0]:.1f}" y="{p[1]:.1f}" z="{p[2]:.1f}"/>')
    lines.append("    </nodes>")
    lines.append("    <edges>")
    for a, b in edges:
        lines.append(f'      <edge source="{int(a) + 1}" target="{int(b) + 1}"/>')
    lines.append("    </edges>")
    lines.append("  </thing>")
    lines.append("</things>")
    return "\n".join(lines)


def skeleton_to_kzip(skel: Dict[str, np.ndarray], kzip_path: str, scaling=(1, 1, 1),
                     comment: str = ""):
    """Write the skeleton's NML as ``annotation.xml`` into ``kzip_path``."""
    from ..handler.basics import write_txt2kzip

    nml = skeleton_to_nml(skel, scaling=scaling, comment=comment)
    write_txt2kzip(kzip_path, nml, "annotation.xml")


def nml_to_skeleton(nml_text: str) -> Dict[str, np.ndarray]:
    """Nodes (float32), edges (0-based int64) and diameters of every thing
    of an NML text."""
    import xml.etree.ElementTree as ET

    root = ET.fromstring(nml_text)
    nodes, diam, edges = [], [], []
    id_map = {}
    for thing in root.iter("thing"):
        for node in thing.iter("node"):
            nid = int(node.get("id"))
            id_map[nid] = len(nodes)
            nodes.append([float(node.get("x")), float(node.get("y")), float(node.get("z"))])
            diam.append(2.0 * float(node.get("radius", 1.0)))
        for edge in thing.iter("edge"):
            edges.append([id_map[int(edge.get("source"))], id_map[int(edge.get("target"))]])
    return {
        "nodes": np.asarray(nodes, np.float32).reshape(-1, 3),
        "edges": np.asarray(edges, np.int64).reshape(-1, 2),
        "diameters": np.asarray(diam, np.float32),
    }
