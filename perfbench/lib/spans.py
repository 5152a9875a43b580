"""Host spans around the program's calls, installed from the benchmark in
traced runs only.

A span target is ``"module:Class.method"`` or ``"module:function"``; the
wrapper records (name, start, end, thread, attributes) on the host's
monotonic clock, from every thread that calls it.
"""

from __future__ import annotations

import importlib
import threading
import time
from typing import Callable, Dict, List, Optional


class Spans:
    def __init__(self):
        self.items: List[Dict] = []
        self._lock = threading.Lock()
        self._undo: List[Callable[[], None]] = []

    def record(self, name: str, t0: int, t1: int, attrs: Optional[Dict] = None) -> None:
        with self._lock:
            self.items.append(dict(name=name, t0=t0, t1=t1, thread=threading.get_ident(),
                                   **(attrs or {})))

    def clear(self) -> None:
        with self._lock:
            self.items = []

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self.items)

    def install(self, target: str, name: str, attrs: Optional[Callable] = None) -> None:
        """Wrap ``target``; ``attrs(args, kwargs)`` may give a dict kept with
        each span."""
        mod_name, _, attr_path = target.partition(":")
        owner = importlib.import_module(mod_name)
        *parents, attr = attr_path.split(".")
        for p in parents:
            owner = getattr(owner, p)
        fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        spans = self

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.record(name, t0, time.perf_counter_ns(),
                             attrs(args, kwargs) if attrs is not None else None)

        wrapper.__wrapped__ = fn
        setattr(owner, attr, wrapper)
        self._undo.append(lambda: setattr(owner, attr, fn))

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()


def thread_seconds(spans: List[Dict], name: str) -> float:
    """Sum of the durations of ``name``'s spans over all threads."""
    return sum(s["t1"] - s["t0"] for s in spans if s["name"] == name) / 1e9
