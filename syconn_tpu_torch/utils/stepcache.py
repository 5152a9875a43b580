"""Per-item resume for chunked pipeline steps (counterpart of
``syconn_tpu/utils/stepcache.py``).

A :class:`StepCache` holds one atomically written pickle per work item under
``<cache_root>/.stepcache/<step>/``. A rerun loads completed items and
computes only the missing ones (:func:`cached_map`); ``overwrite=True``
clears the cache first.
Side effects (chunk writes) happen before the item's result is stored, and
chunk files are written atomically, so a stored item implies durable
outputs. The cache root is the working directory for the config-driven
entry points (the active config's when it is None), a target's parent for
the explicit-path ones.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import threading
from typing import Any, Callable, List, Optional, Sequence

log = logging.getLogger("syconn_tpu_torch.stepcache")

__all__ = ["StepCache", "cached_map", "step_cache_dir"]


def step_cache_dir(step: str, working_dir: Optional[str] = None) -> str:
    """Cache directory of a named step, ``<working_dir>/.stepcache/<step>``
    (the active config's working directory when None)."""
    if working_dir is None:
        from .. import global_params

        working_dir = str(global_params.config.working_dir)
    return os.path.join(str(working_dir), ".stepcache", step)


class StepCache:
    """Per-item resumable result store of one pipeline step."""

    def __init__(self, step: str, cache_root: Optional[str] = None, overwrite: bool = False):
        self.dir = step_cache_dir(step, cache_root)
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

    def clear(self) -> None:
        """Drop every stored item (and the completeness mark)."""
        if os.path.isdir(self.dir):
            shutil.rmtree(self.dir)
        os.makedirs(self.dir, exist_ok=True)

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


def cached_map(fn: Callable, params: Sequence, cache: StepCache,
               key_fn: Optional[Callable[[Any], str]] = None,
               n_workers: Optional[int] = None) -> List[Any]:
    """``map_parallel`` with per-item resume through ``cache``: completed
    items load their stored result, the rest run ``fn`` and store it before
    returning."""
    from ..parallel.executor import map_parallel

    if key_fn is None:
        key_fn = lambda p: "_".join(str(int(x)) for x in p)  # noqa: E731
    n_done = sum(1 for p in params if cache.done(key_fn(p)))
    if n_done:
        log.info("resume: %d/%d items already complete in %s — skipping them",
                 n_done, len(params), cache.dir)

    def work(p):
        k = key_fn(p)
        if cache.done(k):
            return cache.load(k)
        v = fn(p)
        cache.store(k, v)
        return v

    return map_parallel(work, params, n_workers=n_workers)
