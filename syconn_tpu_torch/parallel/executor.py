"""Host-side fan-out over threads (counterpart of
``syconn_tpu/parallel/executor.py::map_parallel``).

Device work stays in the calling thread; host work (IO, compression, numpy
and scipy, which release the GIL) fans out over a thread pool.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence

__all__ = ["map_parallel"]


def map_parallel(fn: Callable, params: Sequence, n_workers: Optional[int] = None) -> List[Any]:
    """Apply ``fn`` to each element of ``params`` on a thread pool; results
    in input order, the first exception re-raised."""
    params = list(params)
    if not params:
        return []
    if n_workers is None:
        n_workers = min(32, os.cpu_count() or 8)
    n_workers = max(1, min(int(n_workers), len(params)))
    if n_workers == 1:
        return [fn(p) for p in params]
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        return list(pool.map(fn, params))
