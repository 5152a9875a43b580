"""Per-item resume for chunked pipeline steps (counterpart of
``syconn_tpu/utils/stepcache.py``).

A :class:`StepCache` holds one atomically written pickle per work item under
``<cache_root>/.stepcache/<step>/``. A rerun loads completed items and
computes only the missing ones; ``overwrite=True`` clears the cache first.
Side effects (chunk writes) happen before the item's result is stored, and
chunk files are written atomically, so a stored item implies durable
outputs. The cache root is an argument: the port has no working-directory
configuration yet.
"""

from __future__ import annotations

import os
import pickle
import shutil
import threading
from typing import Any

__all__ = ["StepCache"]


class StepCache:
    """Per-item resumable result store of one pipeline step."""

    def __init__(self, step: str, cache_root: str, overwrite: bool = False):
        self.dir = os.path.join(str(cache_root), ".stepcache", step)
        if overwrite and os.path.isdir(self.dir):
            shutil.rmtree(self.dir)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.pkl")

    def done(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def load(self, key: str) -> Any:
        with open(self._path(key), "rb") as f:
            return pickle.load(f)

    def store(self, key: str, value: Any) -> None:
        p = self._path(key)
        tmp = f"{p}.tmp{os.getpid()}_{threading.get_ident()}"
        with open(tmp, "wb") as f:
            pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, p)

    # step-level completeness: tells "the step finished" from "outputs exist
    # but the run crashed mid-step"
    @property
    def _complete_path(self) -> str:
        return os.path.join(self.dir, "__complete__")

    def mark_complete(self) -> None:
        with open(self._complete_path, "w") as f:
            f.write("done\n")

    def is_complete(self) -> bool:
        return os.path.isfile(self._complete_path)
