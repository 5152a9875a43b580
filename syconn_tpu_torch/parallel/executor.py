"""Host-side fan-out executor (counterpart of
``syconn_tpu/parallel/executor.py``).

Device work stays in the calling thread; host work (IO, compression, numpy
and scipy, which release the GIL) fans out over a thread pool, or over
processes for pure-Python CPU work.

:func:`map_parallel` returns results in input order. Pooled runs retry only
the items that raised, each in a fresh pool, for at most ``max_retries + 1``
attempts in all; items still failing then raise one ``RuntimeError`` that
names how many failed and carries the first traceback. A retry calls the same
``fn`` on the same item: nothing about the route or the device changes
between attempts, so a persistent fault still raises. The inline forms
(``n_workers == 1``, ``backend="serial"``) do not retry and let the
exception through unchanged.

Progress goes to this module's ``logging`` logger (JAX's executor draws a
tqdm bar; the card machine has no tqdm). Steps are plain functions in a
registry; ``batchjob_script(params, name)`` keeps the reference's call shape
(reference: syconn/mp/batchjob_utils.py:69, syconn/mp/mp_utils.py) and
dispatches in process.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import traceback
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor, as_completed
from typing import Any, Callable, Dict, List, Optional, Sequence

log = logging.getLogger("syconn_tpu_torch.parallel")

__all__ = [
    "batchjob_enabled",
    "batchjob_script",
    "get_step",
    "map_parallel",
    "register_step",
    "start_multiprocess",
    "start_multiprocess_imap",
    "start_multiprocess_obj",
]

_STEP_REGISTRY: Dict[str, Callable] = {}


def register_step(name: str):
    """Register a function as a named pipeline step (worker entry point)."""

    def deco(fn):
        _STEP_REGISTRY[name] = fn
        return fn

    return deco


def get_step(name: str) -> Callable:
    if name not in _STEP_REGISTRY:
        raise KeyError(
            f"Unknown step '{name}'. Registered: {sorted(_STEP_REGISTRY)}"
        )
    return _STEP_REGISTRY[name]


def batchjob_enabled() -> bool:
    """Whether an external batch system drives the fan-out: always False,
    the executor is in-process."""
    return False


def _default_workers(backend: str) -> int:
    n = os.cpu_count() or 8
    return min(32, n) if backend == "thread" else max(1, n - 1)


class _Progress:
    """Logs ``desc: done/total items`` at every tenth of ``total`` and at the
    end; silent unless enabled."""

    def __init__(self, total: int, desc: str, enabled: bool):
        self.total, self.desc, self.enabled = total, desc or "map_parallel", enabled
        self.step = max(1, total // 10)
        self.done = 0

    def update(self) -> None:
        self.done += 1
        if self.enabled and (self.done % self.step == 0 or self.done == self.total):
            log.info("%s: %d/%d items", self.desc, self.done, self.total)


def map_parallel(
    fn: Callable,
    params: Sequence,
    n_workers: Optional[int] = None,
    backend: str = "thread",
    show_progress: bool = False,
    desc: str = "",
    max_retries: int = 2,
) -> List[Any]:
    """Apply ``fn`` to each element of ``params`` with bounded retries.

    Results are returned in input order; an item that fails on every attempt
    raises (no silently dropped work). ``backend`` is ``"thread"``,
    ``"process"`` (spawned workers: ``fn`` must pickle by import path) or
    ``"serial"``.
    """
    params = list(params)
    if len(params) == 0:
        return []
    if n_workers is None:
        n_workers = _default_workers(backend)
    n_workers = max(1, min(int(n_workers), len(params)))
    if n_workers == 1 or backend == "serial":
        prog = _Progress(len(params), desc, show_progress)
        out = []
        for p in params:
            out.append(fn(p))
            prog.update()
        return out

    pool_cls, pool_kw = ThreadPoolExecutor, {}
    if backend != "thread":
        # spawned, not forked: a forked child of a process with threads (or
        # an initialised CUDA context) can deadlock or lose the card
        pool_cls = ProcessPoolExecutor
        pool_kw = {"mp_context": multiprocessing.get_context("spawn")}
    results: List[Any] = [None] * len(params)
    pending = list(range(len(params)))
    attempt = 0
    while pending and attempt <= max_retries:
        failed: List[int] = []
        errors: List[str] = []
        prog = _Progress(len(pending), desc, show_progress)
        with pool_cls(max_workers=n_workers, **pool_kw) as pool:
            futs = {pool.submit(fn, params[i]): i for i in pending}
            for fut in as_completed(futs):
                i = futs[fut]
                try:
                    results[i] = fut.result()
                except Exception:
                    failed.append(i)
                    errors.append(traceback.format_exc())
                prog.update()
        if failed and attempt == max_retries:
            raise RuntimeError(
                f"Step failed for {len(failed)}/{len(params)} items after "
                f"{max_retries + 1} attempts. First error:\n{errors[0]}"
            )
        if failed:
            log.warning(
                "Retrying %d failed items (attempt %d).", len(failed), attempt + 2
            )
        pending = failed
        attempt += 1
    return results


# ----------------------------------------------------- reference-shaped API
def start_multiprocess(
    func: Callable, params: Sequence, nb_cpus: Optional[int] = None, debug: bool = False, **kw
) -> List[Any]:
    """Pool.map equivalent (reference: mp_utils.py:93)."""
    backend = "serial" if debug else "thread"
    return map_parallel(func, params, n_workers=nb_cpus, backend=backend)


def start_multiprocess_imap(
    func: Callable,
    params: Sequence,
    nb_cpus: Optional[int] = None,
    show_progress: bool = True,
    debug: bool = False,
    desc: str = "",
    **kw,
) -> List[Any]:
    """Ordered parallel map with progress (reference: mp_utils.py:138)."""
    backend = "serial" if debug else "thread"
    return map_parallel(
        func, params, n_workers=nb_cpus, backend=backend, show_progress=show_progress, desc=desc
    )


def start_multiprocess_obj(
    func_name: str, params: Sequence, nb_cpus: Optional[int] = None, debug: bool = False
) -> List[Any]:
    """Call ``obj.func_name(*args)`` for each ``[obj, *args]`` in params
    (reference: mp_utils.py:203)."""

    def call(p):
        obj = p[0]
        return getattr(obj, func_name)(*p[1:])

    backend = "serial" if debug else "thread"
    return map_parallel(call, params, n_workers=nb_cpus, backend=backend)


def batchjob_script(
    params: Sequence,
    name: str,
    n_cores: int = 1,
    n_max_co_processes: Optional[int] = None,
    suffix: str = "",
    remove_jobfolder: bool = True,
    show_progress: bool = True,
    log=None,
    **kw,
) -> List[Any]:
    """Run registered step ``name`` over ``params`` (reference call shape:
    batchjob_utils.py:69). Returns the per-item results in order."""
    fn = get_step(name)
    return map_parallel(
        fn,
        params,
        n_workers=n_max_co_processes,
        backend="thread",
        show_progress=show_progress,
        desc=name,
    )
