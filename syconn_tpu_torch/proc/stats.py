"""Pipeline timing and model-performance helpers (counterpart of
``syconn_tpu/proc/stats.py``).

Reference parity: syconn/proc/stats.py:582 (``FileTimer``) — named wall-clock
step timings persisted to ``<wd>/.timing.pkl``, with dataset-volume
normalization and a human-readable report. ``model_performance`` writes
scikit-learn's classification report and confusion matrix, computed here
with numpy (the card machine has no scikit-learn).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

from ..handler.basics import load_pkl2obj, write_obj2pkl


class FileTimer:
    """Named step timer persisted to a pickle file.

    Usage::

        ftimer = FileTimer(wd + '/.timing.pkl')
        ftimer.start('Preparation')
        ...
        ftimer.stop()
    """

    def __init__(self, path: str, overwrite: bool = False, add_detail_vols: bool = False):
        if os.path.isdir(path):
            path = os.path.join(path, ".timing.pkl")
        self.path = path
        self.timings: Dict[str, float] = {}
        self._start_t: Optional[float] = None
        self._cur_name: Optional[str] = None
        self.dataset_shape = None
        self.dataset_scale = None
        if not overwrite and os.path.isfile(path):
            try:
                stored = load_pkl2obj(path)
                self.timings = stored.get("timings", {})
                self.dataset_shape = stored.get("dataset_shape")
                self.dataset_scale = stored.get("dataset_scale")
            except Exception:
                pass

    def start(self, name: str):
        if self._cur_name is not None:
            raise RuntimeError(f"Timer '{self._cur_name}' still running.")
        self._cur_name = name
        self._start_t = time.perf_counter()

    def stop(self):
        if self._cur_name is None:
            raise RuntimeError("No timer running.")
        dt = time.perf_counter() - self._start_t
        self.timings[self._cur_name] = self.timings.get(self._cur_name, 0.0) + dt
        self._cur_name = None
        self._start_t = None
        self._save()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._cur_name is not None:
            self.stop()

    def _save(self):
        write_obj2pkl(
            self.path,
            {
                "timings": self.timings,
                "dataset_shape": self.dataset_shape,
                "dataset_scale": self.dataset_scale,
            },
        )

    # ------------------------------------------------------------- reporting
    @property
    def dataset_nvoxels(self) -> Optional[float]:
        if self.dataset_shape is None:
            return None
        return float(np.prod(np.array(self.dataset_shape, dtype=np.float64))) / 1e9

    @property
    def dataset_mm3(self) -> Optional[float]:
        if self.dataset_shape is None or self.dataset_scale is None:
            return None
        vx_nm3 = float(np.prod(np.array(self.dataset_scale, dtype=np.float64)))
        return self.dataset_nvoxels * 1e9 * vx_nm3 / 1e18

    def prepare_report(self) -> str:
        total = sum(self.timings.values())
        lines = [f"Total wall-clock: {total:.1f} s"]
        if self.dataset_nvoxels:
            lines[0] += f" ({self.dataset_nvoxels:.3f} GVx)"
        for name, dt in self.timings.items():
            frac = 100.0 * dt / total if total else 0.0
            lines.append(f"  [{name}] {dt:.1f} s ({frac:.1f}%)")
        return "\n".join(lines)


def _scores(tp, n_pred, n_true):
    """Precision, recall and F1 with scikit-learn's ``zero_division=0``."""
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(n_pred > 0, tp / np.maximum(n_pred, 1), 0.0)
        r = np.where(n_true > 0, tp / np.maximum(n_true, 1), 0.0)
        denom = n_pred + n_true
        f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
    return p.astype(np.float64), r.astype(np.float64), f1.astype(np.float64)


def classification_report(labels: np.ndarray, preds: np.ndarray, digits: int = 2) -> str:
    """``sklearn.metrics.classification_report(labels, preds,
    zero_division=0)`` for integer class labels: per class precision,
    recall, F1 and support, then accuracy, macro and weighted averages.

    Where no prediction is right, scikit-learn's ``multilabel_confusion_matrix``
    starts its true-positive counts as float zeros (its "pathological case"),
    the supports it derives from them are floats, and every support of the
    report prints as ``2.0``; so do they here."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    classes = np.unique(np.concatenate([labels, preds]))
    tp = np.array([np.sum((preds == c) & (labels == c)) for c in classes], np.float64)
    n_pred = np.array([np.sum(preds == c) for c in classes], np.float64)
    support = np.array([np.sum(labels == c) for c in classes], np.int64)
    if tp.sum() == 0:
        support = support.astype(np.float64)
    p, r, f1 = _scores(tp, n_pred, support.astype(np.float64))
    names = ["%s" % c for c in classes]
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    headers = ["precision", "recall", "f1-score", "support"]
    report = ("{:>{width}s} " + " {:>9}" * len(headers)).format("", *headers, width=width)
    report += "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(names, p, r, f1, support):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    total = support.sum()
    _, _, acc = _scores(tp.sum(), n_pred.sum(), float(total))
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" + " {:>9}\n").format(
        "accuracy", "", "", float(acc), total, width=width, digits=digits)
    report += row_fmt.format("macro avg", p.mean(), r.mean(), f1.mean(), total, width=width,
                             digits=digits)
    if total > 0:
        w = support / total
        avg = [float(np.sum(v * w)) for v in (p, r, f1)]
    else:
        avg = [0.0, 0.0, 0.0]
    report += row_fmt.format("weighted avg", *avg, total, width=width, digits=digits)
    return report


def confusion_matrix(labels: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """``sklearn.metrics.confusion_matrix``: (n, n) int64 counts, rows the
    true and columns the predicted class, over the sorted union of both."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    classes = np.unique(np.concatenate([labels, preds]))
    ti = np.searchsorted(classes, labels)
    pi = np.searchsorted(classes, preds)
    cm = np.zeros((len(classes), len(classes)), np.int64)
    np.add.at(cm, (ti, pi), 1)
    return cm


def model_performance(
    probas: np.ndarray,
    labels: np.ndarray,
    model_dir: Optional[str] = None,
    prefix: str = "",
    n_labels: Optional[int] = None,
) -> str:
    """Classification report (+ confusion matrix) for model evaluation
    (reference: proc/stats.py ``model_performance``)."""
    probas = np.asarray(probas)
    preds = probas.argmax(axis=1) if probas.ndim == 2 else probas
    rep = classification_report(labels, preds)
    cm = confusion_matrix(labels, preds)
    text = f"{prefix}\n{rep}\nconfusion matrix:\n{cm}\n"
    if model_dir is not None:
        os.makedirs(model_dir, exist_ok=True)
        with open(os.path.join(model_dir, f"{prefix or 'model'}_performance.txt"), "w") as f:
            f.write(text)
    return text
