"""Point-cloud inference over cell reconstructions (counterpart of
``syconn_tpu/inference/points.py``).

Every context is a fixed-size (npoints, 3 + F) cloud, so one forward shape
serves every cell; loader threads build contexts while the main thread
keeps the card fed with full batches (:class:`ContextPipeline`).

Feature channels (one-hot): cell surface, mi, vc, sj/syn_ssv.

This slice drives the glia task (``predict_glia_ssv``, step 3). The
celltype, compartment and embedding drivers (steps 7-9) come with ROADMAP
Queue 1 item 8 and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import spatial

from .. import global_params
from ..utils.device import DeviceLike, default_device

log = logging.getLogger("syconn_tpu_torch.points")

__all__ = [
    "certainty_estimate",
    "sso2pointcloud",
    "global_morph_scalars",
    "append_global_scalars",
    "extract_contexts",
    "ContextPredictor",
    "ContextPipeline",
    "predict_celltype_ssd",
    "predict_glia_ssv",
    "predict_compartments_ssd",
    "infere_cell_morphology_ssd",
]

FEATURE_TYPES = ["sv", "mi", "vc", "sj"]

_STEPS_7_9 = ("steps 7-9 (celltype, compartments, morphology embeddings) are not ported "
              "yet: ROADMAP Queue 1, item 8")


def _tree_map(fn: Callable, *trees):
    """``jax.tree.map`` over the outputs of the point nets: a dict of
    arrays or one array."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def certainty_estimate(logits: np.ndarray, is_logit: bool = True) -> float:
    """1 - normalized entropy of the (averaged) class distribution."""
    arr = np.asarray(logits, np.float64)
    if arr.ndim == 2:
        arr = arr.mean(axis=0)
    if is_logit:
        e = np.exp(arr - arr.max())
        p = e / e.sum()
    else:
        p = arr / max(arr.sum(), 1e-12)
    p = np.clip(p, 1e-12, 1.0)
    ent = -(p * np.log(p)).sum() / np.log(len(p))
    return float(1.0 - ent)


# organelle/synapse vertex budget relative to the cell-surface vertex count
# (the JAX package's TYPE_RATIO_CAP)
TYPE_RATIO_CAP = {"mi": 0.35, "vc": 0.35, "sj": 0.35}


def sso2pointcloud(
    ssv,
    feats: Sequence[str] = FEATURE_TYPES,
    max_points_per_type: int = 200_000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cell -> labeled point cloud: (coords_nm (N, 3), type_index (N,))."""
    coords, types = [], []
    n_cell = None
    for ti, t in enumerate(feats):
        try:
            if t == "sj" and "syn_ssv" not in (ssv.attr_dict or {}):
                ssv.load_attr_dict()
            use_t = t
            if t == "sj" and len(ssv.attr_dict.get("syn_ssv", [])) > 0:
                use_t = "syn_ssv"
            mesh = ssv.load_mesh(use_t)
        except Exception:
            continue
        if mesh is None or len(mesh[1]) == 0:
            continue
        v = np.asarray(mesh[1], np.float32).reshape(-1, 3)
        cap = max_points_per_type
        if t in TYPE_RATIO_CAP and n_cell:
            cap = min(cap, max(int(n_cell * TYPE_RATIO_CAP[t]), 32))
        if len(v) > cap:
            sel = np.linspace(0, len(v) - 1, cap).astype(np.int64)
            v = v[sel]
        if ti == 0:
            n_cell = len(v)
        coords.append(v)
        types.append(np.full(len(v), ti, np.int32))
    if not coords:
        return np.zeros((0, 3), np.float32), np.zeros(0, np.int32)
    return np.concatenate(coords), np.concatenate(types)


N_GLOBAL_MORPH = 12


def global_morph_scalars(ssv) -> np.ndarray:
    """Whole-cell morphology scalars for the celltype head (N_GLOBAL_MORPH):
    size, skeleton calibers and length, myelin fraction, organelle and
    synapse densities, compactness. Raw values; the model meta carries
    their normalization."""
    scale = np.asarray(global_params.config["scaling"], np.float64)
    try:
        ssv.load_attr_dict()
    except Exception:
        pass
    ad = ssv.attr_dict or {}
    try:
        ssv.load_skeleton()
        sk = ssv.skeleton or {}
    except Exception:
        sk = {}
    nodes = np.asarray(sk.get("nodes", np.zeros((0, 3))), np.float64)
    edges = np.asarray(sk.get("edges", np.zeros((0, 2), np.int64)), np.int64)
    dia = np.asarray(sk.get("diameters", np.zeros(0)), np.float64)
    my = np.asarray(sk.get("myelin", np.zeros(0)), np.float64)
    if len(edges) and len(nodes):
        length_nm = float(np.linalg.norm(
            (nodes[edges[:, 0]] - nodes[edges[:, 1]]) * scale, axis=1).sum())
    else:
        length_nm = 0.0
    l10 = length_nm / 1e4 + 1e-9  # in 10 um units, for densities

    def _n(key):
        v = ad.get(key)
        return 0 if v is None else len(np.atleast_1d(v))

    size = float(ad.get("size") or 0)
    n_mi = _n("mapping_mi_ids")
    n_vc = _n("mapping_vc_ids")
    n_syn = _n("syn_ssv")
    bb = np.asarray(ad.get("bounding_box", np.zeros((2, 3))), np.float64)
    diag = float(np.linalg.norm((bb[1] - bb[0]) * scale))
    return np.array([
        np.log10(size + 1.0),
        float(dia.max()) if len(dia) else 0.0,
        float(dia.mean()) if len(dia) else 0.0,
        float(np.percentile(dia, 90)) if len(dia) else 0.0,
        np.log10(length_nm + 1.0),
        float(my.mean()) if len(my) else 0.0,
        n_mi / l10,
        n_vc / l10,
        n_syn / l10,
        diag / (length_nm + 1e-9),
        size / (length_nm / 10.0 + 1e-9),
        float(len(nodes)),
    ], np.float32)


def append_global_scalars(ctxs: np.ndarray, scalars: np.ndarray,
                          norm: Optional[Tuple[np.ndarray, np.ndarray]] = None
                          ) -> np.ndarray:
    """Tile per-cell scalars onto every point of every context as constant
    trailing channels (consumed by ``PointClassNet(n_global=...)``)."""
    s = np.asarray(scalars, np.float32)
    if norm is not None:
        s = (s - np.asarray(norm[0], np.float32)) / (
            np.asarray(norm[1], np.float32) + 1e-9)
    tiled = np.broadcast_to(s, ctxs.shape[:2] + s.shape).astype(np.float32)
    return np.concatenate([ctxs, tiled], axis=-1)


def extract_contexts(
    coords_nm: np.ndarray,
    types: np.ndarray,
    ctx_size_nm: float = 20_000.0,
    npoints: int = 2048,
    n_contexts: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    centers_nm: Optional[np.ndarray] = None,
    n_feat: int = 4,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Fixed-size local contexts from a labeled point cloud: (contexts (M,
    npoints, 3 + n_feat), per-context source indices into ``coords_nm``).
    Contexts with fewer points than ``npoints`` are padded with repeated
    indices."""
    if rng is None:
        rng = np.random.default_rng(0)
    if len(coords_nm) == 0:
        return np.zeros((0, npoints, 3 + n_feat), np.float32), []
    cell_pts = coords_nm[types == 0] if (types == 0).any() else coords_nm
    if centers_nm is None:
        if n_contexts is None:
            # cover the cell surface: one context per ~half context volume
            from ..reps.rep_helper import surface_samples

            centers_nm = surface_samples(
                cell_pts, bin_sizes=(ctx_size_nm / 2,) * 3, max_nb_samples=64
            )
        else:
            sel = rng.choice(len(cell_pts), size=min(n_contexts, len(cell_pts)), replace=False)
            centers_nm = cell_pts[sel]
    tree = spatial.cKDTree(coords_nm)
    ctxs = np.zeros((len(centers_nm), npoints, 3 + n_feat), np.float32)
    idx_lists = []
    for i, c in enumerate(centers_nm):
        ixs = tree.query_ball_point(c, ctx_size_nm / 2)
        if len(ixs) == 0:
            _, nn = tree.query(c, k=min(npoints, len(coords_nm)))
            ixs = np.atleast_1d(nn).tolist()
        ixs = np.asarray(ixs, np.int64)
        if len(ixs) >= npoints:
            ixs = rng.choice(ixs, size=npoints, replace=False)
        else:
            pad = rng.choice(ixs, size=npoints - len(ixs), replace=True)
            ixs = np.concatenate([ixs, pad])
        pts = (coords_nm[ixs] - c[None]) / (ctx_size_nm / 2)
        onehot = np.zeros((npoints, n_feat), np.float32)
        onehot[np.arange(npoints), np.clip(types[ixs], 0, n_feat - 1)] = 1.0
        ctxs[i, :, :3] = pts
        ctxs[i, :, 3:] = onehot
        idx_lists.append(ixs)
    return ctxs, idx_lists


class ContextPredictor:
    """Fixed-shape forward over context batches on one device.

    ``model``: a port point net with its weights (``models/pointnet.py``,
    ``models.io.load_model``). ``device``: None means the CUDA card, which
    must exist (``utils/device.py``); the JAX package's ``mesh`` (batches
    sharded over devices) comes with ROADMAP Queue 1 item 11. Short batches
    are padded with zeros to ``batch``, so every forward has one shape.
    """

    def __init__(self, model, npoints: int = 2048, n_feat: int = 4, batch: int = 8,
                 device: DeviceLike = None):
        self.device = default_device(device)
        self.model = model.to(self.device).eval()
        self.batch = int(batch)
        self.npoints = npoints
        self.n_feat = n_feat

    def forward(self, x: torch.Tensor):
        """One forward of a device batch (B, npoints, C)."""
        with torch.inference_mode():
            return self.model(x)

    def dispatch(self, chunk: np.ndarray):
        """Upload and launch one (possibly short) batch; returns the output
        tree on the device (the launch is asynchronous on the card)."""
        if len(chunk) < self.batch:
            pad = np.zeros((self.batch - len(chunk),) + chunk.shape[1:], chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(self.device)
        return self.forward(x)

    def fetch(self, dev):
        return _tree_map(lambda t: t.cpu().numpy(), dev)

    def predict(self, ctxs: np.ndarray):
        """Run all contexts (padding the last batch); outputs with leading
        dim == len(ctxs)."""
        n = len(ctxs)
        if n == 0:
            return None
        outs = []
        for i in range(0, n, self.batch):
            outs.append(self.fetch(self.dispatch(ctxs[i: i + self.batch])))
        return _tree_map(lambda *xs: np.concatenate(xs)[:n], *outs)


class ContextPipeline:
    """Producer/consumer point inference: loader threads build per-item
    contexts into a bounded staging set, the main thread packs contexts
    ACROSS items into full fixed-shape device batches (asynchronous
    dispatch, at most ``depth`` in flight) and is the only thread that
    touches the card, and writer threads run per-item post-processing as
    soon as an item's last context returns. ``n_dispatches`` / ``n_rows``
    count the batches and the contexts in them."""

    def __init__(self, pred: "ContextPredictor", n_loaders: int = 4,
                 n_writers: int = 4, depth: int = 2, queue_cap: int = 16):
        self.pred = pred
        self.n_loaders = n_loaders
        self.n_writers = n_writers
        self.depth = depth
        self.queue_cap = queue_cap
        self.n_dispatches = 0
        self.n_rows = 0

    def run(self, items: Sequence, load_fn, post_fn) -> List:
        """``load_fn(item) -> (ctxs (M, npoints, F) | None, aux)``;
        ``post_fn(item, out, aux) -> result`` where ``out`` is the model
        output tree with leading dim M (None when the item had no
        contexts). Returns post_fn results in completion order."""
        from collections import deque
        from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

        B = self.pred.batch
        loader = ThreadPoolExecutor(max_workers=self.n_loaders)
        writer = ThreadPoolExecutor(max_workers=self.n_writers)
        pending = deque(items)
        futs = {}
        rows: List = []  # (record, ctx_index) awaiting batching
        inflight: deque = deque()
        write_futs = []

        def refill():
            while pending and len(futs) < self.queue_cap:
                it = pending.popleft()
                futs[loader.submit(load_fn, it)] = it

        def drain_one():
            take, dev = inflight.popleft()
            out = self.pred.fetch(dev)
            for j, (rec, ci) in enumerate(take):
                rec["out"][ci] = _tree_map(lambda a: a[j], out)
                rec["got"] += 1
                if rec["got"] == rec["n"]:
                    merged = _tree_map(lambda *xs: np.stack(xs), *rec["out"])
                    rec["ctxs"] = None
                    write_futs.append(
                        writer.submit(post_fn, rec["item"], merged, rec["aux"]))

        def dispatch_full(force: bool = False):
            while len(rows) >= B or (force and rows):
                take = rows[:B]
                del rows[:B]
                arr = np.stack([r[0]["ctxs"][r[1]] for r in take])
                self.n_dispatches += 1
                self.n_rows += len(take)
                inflight.append((take, self.pred.dispatch(arr)))
                while len(inflight) > self.depth:
                    drain_one()
                if force and not rows:
                    break

        try:
            refill()
            while True:
                # dispatch whatever is already full BEFORE blocking on loaders
                tail = not futs and not pending
                dispatch_full(force=tail)
                if tail:
                    while inflight:
                        drain_one()
                    if not rows and not futs:
                        break
                    continue
                done, _ = wait(set(futs), return_when=FIRST_COMPLETED)
                for f in done:
                    item = futs.pop(f)
                    ctxs, aux = f.result()
                    if ctxs is None or len(ctxs) == 0:
                        write_futs.append(writer.submit(post_fn, item, None, aux))
                        continue
                    rec = {"item": item, "ctxs": ctxs, "aux": aux,
                           "n": len(ctxs), "got": 0, "out": [None] * len(ctxs)}
                    rows.extend((rec, i) for i in range(len(ctxs)))
                refill()
            return [f.result() for f in write_futs]
        finally:
            loader.shutdown()
            writer.shutdown()


# ------------------------------------------------------------ task drivers
def _get_point_model(mpath: str):
    """``(model, params)`` of a model directory, else the packaged weights
    of its name. A missing model raises ``FileNotFoundError``: the JAX
    package seed-initialises and persists one, which the port does not."""
    from ..models.io import load_model

    return load_model(mpath)


def _meta_ctx(mpath: str, npoints: int, ctx_size_nm: float):
    """The context geometry the shipped model was trained at (meta keys
    ``npoints``/``ctx_nm``; the call defaults otherwise)."""
    from ..models.io import load_model_meta

    meta = load_model_meta(mpath)
    return (int(meta.get("npoints", npoints)),
            float(meta.get("ctx_nm", ctx_size_nm)))


def predict_celltype_ssd(*args, **kwargs):
    raise NotImplementedError(_STEPS_7_9)


def predict_glia_ssv(
    ssv_ids=None, ssd=None, npoints: int = 2048, ctx_size_nm: float = 15_000.0,
    device: DeviceLike = None, stats: Optional[dict] = None,
):
    """Per-SV glia probability: the per-point softmax of the glia net
    averaged over the SV's mesh contexts, written as ``glia_probas`` into
    each SV's attribute dict. ``device``: None means the CUDA card.
    ``stats`` (optional dict) receives the contexts, dispatches and
    rows of the run."""
    from ..reps.segmentation import SegmentationDataset
    from ..reps.super_segmentation import SuperSegmentationDataset

    cfg = global_params.config
    if ssd is None:
        ssd = SuperSegmentationDataset(working_dir=cfg.working_dir)
    if ssv_ids is None:
        ssv_ids = ssd.ssv_ids
    npoints, ctx_size_nm = _meta_ctx(cfg.mpath_glia_pts, npoints, ctx_size_nm)
    model, _ = _get_point_model(cfg.mpath_glia_pts)
    pred = ContextPredictor(model, npoints=npoints, batch=16, device=device)
    pipe = ContextPipeline(pred)
    sd_sv = SegmentationDataset("sv", working_dir=cfg.working_dir)
    # flatten to SV-level work items so contexts batch across all cells
    sv_items = []
    for ssv_id in ssv_ids:
        ssv = ssd.get_super_segmentation_object(int(ssv_id))
        sv_items.extend(int(s) for s in ssv.sv_ids)

    def load(sv_id):
        so = sd_sv.get_segmentation_object(int(sv_id))
        mesh = so.mesh
        if mesh is None or len(mesh[1]) == 0:
            return None, None
        v = mesh[1].reshape(-1, 3)
        types = np.zeros(len(v), np.int32)
        ctxs, _ = extract_contexts(
            v, types, ctx_size_nm=ctx_size_nm, npoints=npoints,
            rng=np.random.default_rng(sv_id),
        )
        return ctxs, None

    def post(sv_id, out, aux):
        if out is None:
            p = 0.0
        else:
            probs = np.exp(out) / np.exp(out).sum(-1, keepdims=True)
            p = float(probs[..., 1].mean())
        so = sd_sv.get_segmentation_object(int(sv_id))
        so.load_attr_dict()
        so.attr_dict["glia_probas"] = p
        so.save_attr_dict()
        return 1

    n = sum(pipe.run(sv_items, load, post))
    if stats is not None:
        stats.update(contexts=pipe.n_rows, dispatches=pipe.n_dispatches, svs=len(sv_items),
                     batch=pred.batch, npoints=npoints)
    log.info("glia probas for %d SVs", n)
    return n


def predict_compartments_ssd(*args, **kwargs):
    raise NotImplementedError(_STEPS_7_9)


def infere_cell_morphology_ssd(*args, **kwargs):
    raise NotImplementedError(_STEPS_7_9)


def predict_celltype_sso(*args, **kwargs):
    raise NotImplementedError(_STEPS_7_9)
