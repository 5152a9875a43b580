"""REST serving layer for reconstructions (counterpart of
``syconn_tpu/analysis/server.py``; stdlib WSGI, host code, no device work).

Routes: ``/`` (the WebGL viewer page ``viewer.html`` beside this module),
``/info``, ``/ssv_list``, ``/ssv_mesh/<id>[?obj_type=]``,
``/ssv_obj_mesh/<id>/<type>``, the mesh component streams ``/ssv_ind``,
``/ssv_vert``, ``/ssv_norm`` ``/<id>`` and ``/ssv_obj_ind|vert|norm/<id>/<type>``
(JSON number lists, or with ``?format=raw`` the array as little-endian bytes:
``ind`` uint32, ``vert``/``norm`` float32), ``/ssv_skeleton/<id>``,
``/svs_of_ssv/<id>``, ``/ssv_of_sv/<sv id>``, ``/ct_of_ssv/<id>``,
``/all_syn_meta``, ``/pull_so_attr/<id>/<type>/<key>`` and
``/push_so_attr/<id>/<type>/<key>`` (POST ``{"value": ...}``).

As in the JAX package, ``ssv_of_sv`` answers ``{"ssv": null}`` on any
failure, any other failing route answers 500 with ``{"error": ...}``, and
``all_syn_meta`` takes its threshold from the active ``global_params.config``
(``main`` activates the served directory). Console script
``syconn.server_torch`` (``python -m syconn_tpu_torch.analysis.server
--working_dir <wd> [--port 10001]``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, Optional
from urllib.parse import parse_qs
from wsgiref.simple_server import WSGIServer, make_server

import numpy as np

from .. import global_params

log = logging.getLogger("syconn_tpu_torch.server")

__all__ = ["SyConnBackend", "make_app", "main", "serve_background"]


class _NumpyJSONEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return super().default(o)


class SyConnBackend:
    """Data access behind the routes."""

    def __init__(self, working_dir: Optional[str] = None):
        from ..reps.segmentation import SegmentationDataset
        from ..reps.super_segmentation import SuperSegmentationDataset

        self.wd = working_dir or global_params.config.working_dir
        self.ssd = SuperSegmentationDataset(working_dir=self.wd)
        self.sd_syn = SegmentationDataset("syn_ssv", working_dir=self.wd)

    def ssv_list(self) -> Dict:
        return {"ssvs": self.ssd.ssv_ids}

    def svs_of_ssv(self, ssv_id: int) -> Dict:
        return {"svs": self.ssd.mapping_dict.get(int(ssv_id), np.zeros(0, np.uint64))}

    def ssv_of_sv(self, sv_id: int) -> Dict:
        try:
            out = self.ssd.sv2ssv_ids(np.array([sv_id], np.uint64))
            return {"ssv": int(out[0])}
        except Exception:
            return {"ssv": None}

    def ssv_mesh(self, ssv_id: int, obj_type: str = "sv") -> Dict:
        ssv = self.ssd.get_super_segmentation_object(int(ssv_id))
        mesh = ssv.load_mesh(obj_type)
        return {
            "ind": np.asarray(mesh[0]).tolist(),
            "vert": np.asarray(mesh[1]).tolist(),
            "norm": np.asarray(mesh[2]).tolist() if len(mesh) > 2 else [],
        }

    def ssv_skeleton(self, ssv_id: int) -> Dict:
        ssv = self.ssd.get_super_segmentation_object(int(ssv_id))
        if not ssv.load_skeleton():
            return {}
        return {k: np.asarray(v) for k, v in ssv.skeleton.items()}

    def ct_of_ssv(self, ssv_id: int) -> Dict:
        ssv = self.ssd.get_super_segmentation_object(int(ssv_id))
        ct = ssv.lookup_in_attribute_dict("celltype_cnn_e3")
        certainty = ssv.lookup_in_attribute_dict("celltype_cnn_e3_certainty")
        return {"ct": ct, "certainty": certainty}

    def ssv_mesh_component(self, ssv_id: int, comp: str, obj_type: str = "sv") -> np.ndarray:
        """One mesh component ('ind' | 'vert' | 'norm') as an array."""
        ssv = self.ssd.get_super_segmentation_object(int(ssv_id))
        mesh = ssv.load_mesh(obj_type)
        ix = {"ind": 0, "vert": 1, "norm": 2}[comp]
        if ix == 2 and len(mesh) < 3:
            return np.zeros(0, np.float32)
        arr = np.asarray(mesh[ix])
        return arr.astype(np.uint32 if comp == "ind" else np.float32)

    def all_syn_meta(self, syn_prob_t: Optional[float] = None) -> Dict:
        if syn_prob_t is None:
            syn_prob_t = float(global_params.config["cell_objects"]["thresh_synssv_proba"])
        ids = self.sd_syn.ids
        prob = self.sd_syn.load_numpy_data("syn_prob")
        prob = np.ones(len(ids)) if prob is None else prob
        sel = prob >= syn_prob_t
        out = {"ids": ids[sel], "syn_prob": prob[sel]}
        for key in [
            "rep_coord", "size", "neuron_partners", "syn_sign",
            "partner_axoness", "partner_spiness", "partner_celltypes",
            "spinehead_vol",
        ]:
            arr = self.sd_syn.load_numpy_data(key)
            if arr is not None:
                out[key] = arr[sel]
        return out

    def pull_so_attr(self, so_id: int, obj_type: str, attr_key: str) -> Dict:
        from ..reps.segmentation import SegmentationDataset

        sd = SegmentationDataset(obj_type, working_dir=self.wd)
        so = sd.get_segmentation_object(int(so_id))
        return {"value": so.lookup_in_attribute_dict(attr_key)}

    def push_so_attr(self, so_id: int, obj_type: str, attr_key: str, value) -> Dict:
        from ..reps.segmentation import SegmentationDataset

        sd = SegmentationDataset(obj_type, working_dir=self.wd)
        so = sd.get_segmentation_object(int(so_id))
        so.attr_dict[attr_key] = value
        so.save_attr_dict()
        return {"ok": True}


def make_app(backend: SyConnBackend):
    def app(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        qs = parse_qs(environ.get("QUERY_STRING", ""))
        parts = [p for p in path.split("/") if p]
        status = "200 OK"
        raw = qs.get("format", [""])[0] == "raw"
        try:
            if not parts:
                # interactive viewer: self-contained WebGL page over the
                # raw-bytes mesh routes
                p = os.path.join(os.path.dirname(__file__), "viewer.html")
                with open(p, "rb") as f:
                    html = f.read()
                start_response("200 OK", [
                    ("Content-Type", "text/html; charset=utf-8"),
                    ("Content-Length", str(len(html))),
                ])
                return [html]
            elif parts[0] == "info":
                cfg = global_params.config
                payload = {
                    "service": "syconn_tpu_torch", "wd": backend.wd,
                    "scaling": [float(s) for s in cfg["scaling"]],
                }
            elif parts[0] == "ssv_list":
                payload = backend.ssv_list()
            elif parts[0] == "ssv_mesh":
                payload = backend.ssv_mesh(int(parts[1]), qs.get("obj_type", ["sv"])[0])
            elif parts[0] == "ssv_obj_mesh":
                payload = backend.ssv_mesh(int(parts[1]), parts[2])
            elif parts[0] in ("ssv_ind", "ssv_vert", "ssv_norm"):
                comp = parts[0].split("_")[1]
                arr = backend.ssv_mesh_component(int(parts[1]), comp)
                payload = arr.tobytes() if raw else {comp: arr.tolist()}
            elif parts[0] in ("ssv_obj_ind", "ssv_obj_vert", "ssv_obj_norm"):
                comp = parts[0].split("_")[2]
                arr = backend.ssv_mesh_component(int(parts[1]), comp, parts[2])
                payload = arr.tobytes() if raw else {comp: arr.tolist()}
            elif parts[0] == "ssv_skeleton":
                payload = backend.ssv_skeleton(int(parts[1]))
            elif parts[0] == "svs_of_ssv":
                payload = backend.svs_of_ssv(int(parts[1]))
            elif parts[0] == "ssv_of_sv":
                payload = backend.ssv_of_sv(int(parts[1]))
            elif parts[0] == "ct_of_ssv":
                payload = backend.ct_of_ssv(int(parts[1]))
            elif parts[0] == "all_syn_meta":
                payload = backend.all_syn_meta()
            elif parts[0] == "pull_so_attr":
                payload = backend.pull_so_attr(
                    int(parts[1]), parts[2], parts[3]
                )
            elif parts[0] == "push_so_attr":
                body_len = int(environ.get("CONTENT_LENGTH") or 0)
                body = json.loads(environ["wsgi.input"].read(body_len) or b"{}")
                payload = backend.push_so_attr(
                    int(parts[1]), parts[2], parts[3], body.get("value")
                )
            else:
                status = "404 Not Found"
                payload = {"error": f"unknown route {path}"}
        except Exception as e:  # pragma: no cover - defensive
            status = "500 Internal Server Error"
            payload = {"error": str(e)}
        if isinstance(payload, bytes):
            start_response(status, [
                ("Content-Type", "application/octet-stream"),
                ("Content-Length", str(len(payload))),
            ])
            return [payload]
        data = json.dumps(payload, cls=_NumpyJSONEncoder).encode()
        start_response(status, [("Content-Type", "application/json"), ("Content-Length", str(len(data)))])
        return [data]

    return app


def serve_background(working_dir: Optional[str] = None, port: int = 0):
    """Start the server on a daemon thread; returns (server, port)."""
    backend = SyConnBackend(working_dir)
    httpd = make_server("127.0.0.1", port, make_app(backend))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, httpd.server_address[1]


def main(argv=None):
    """Console entry point (``syconn.server_torch``): serve ``--working_dir``
    on ``--port`` until interrupted; ``argv`` defaults to ``sys.argv``."""
    import argparse

    parser = argparse.ArgumentParser(description="syconn_tpu_torch REST server")
    parser.add_argument("--working_dir", type=str, required=True)
    parser.add_argument("--port", type=int, default=10001)
    args = parser.parse_args(argv)
    global_params.wd = args.working_dir
    backend = SyConnBackend(args.working_dir)
    httpd = make_server("0.0.0.0", args.port, make_app(backend))
    log.info("serving %s on :%d", args.working_dir, args.port)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
