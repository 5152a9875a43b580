"""Spans inside the port, recorded while a ``torch.profiler`` session records.

An operator traces a run by wrapping it in ``torch.profiler.profile``::

    from syconn_tpu_torch.utils import tracing

    tracing.clear()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        predict_dense_to_kd(...)            # step 1 and its spans
    prof.export_chrome_trace("trace.json")  # the spans above the kernels
    for r in tracing.records():             # after the call has synchronised
        print(r["name"], (r["t1"] - r["t0"]) / 1e9, r["device_s"], r["attrs"])

There is no other switch: recording is on exactly while the profiler
records (``torch.autograd.profiler._is_profiler_enabled``), and off it costs
a span site one check and a no-op context, with no ``record_function`` and
no CUDA event.

Each record is a dict: ``name``; ``t0`` and ``t1`` in
``time.perf_counter_ns()``, read just before the span's annotation opens
and just after it closes; ``thread`` (the native id, the chrome trace's
``tid``); ``id``; ``parent`` (the enclosing span's id, or None); ``call``
(the id of the outermost span of the call, shared by the spans of the
loader and writer threads it submits work to through :func:`carry`);
``attrs``; ``device_s`` (seconds between the CUDA event pair of a span
opened with a CUDA ``device``: the device's time from the span's first
enqueued operation to its last, idle time between them included; None
otherwise). Each span also opens ``torch.profiler.record_function(name)``,
so the exported trace carries it on the profiler's clock. The profiler
records annotations of the thread that started it only; pass
``experimental_config=torch._C._profiler._ExperimentalConfig(
profile_all_threads=True)`` to see the worker threads' as well.

The buffer keeps the first ``CAP`` records and counts the rest in
:func:`dropped`; :func:`clear` empties both.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "traced", "annotate", "carry", "records", "dropped", "clear", "CAP"]

CAP = 1_000_000

_lock = threading.Lock()
_records: List[Dict] = []
_dropped = 0
_ids = itertools.count(1)
_tls = threading.local()


class _Off:
    """The span of a site while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _context():
    """(innermost open span id, call id) of this thread, else what
    :func:`carry` handed it, else (None, None)."""
    st = getattr(_tls, "stack", None)
    if st:
        return st[-1].id, st[-1].call
    return getattr(_tls, "base", (None, None))


class _Span:
    __slots__ = ("name", "device", "attrs", "id", "parent", "call", "rf", "events", "t0")

    def __init__(self, name: str, device, attrs: Dict):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self):
        self.parent, call = _context()
        self.id = next(_ids)
        self.call = self.id if call is None else call
        st = getattr(_tls, "stack", None)
        if st is None:
            st = _tls.stack = []
        st.append(self)
        # the span's interval encloses its annotation's even where the thread
        # is preempted between the two clocks' readings
        self.rf = torch.profiler.record_function(self.name)
        self.t0 = time.perf_counter_ns()
        self.rf.__enter__()
        self.events = None
        dev = self.device
        if dev is not None and dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        return None

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self.rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        _tls.stack.pop()
        _append({"name": self.name, "t0": self.t0, "t1": t1,
                  "thread": threading.get_native_id(), "id": self.id, "parent": self.parent,
                  "call": self.call, "attrs": self.attrs, "events": self.events})
        return False


def _append(rec: Dict) -> None:
    global _dropped
    with _lock:
        if len(_records) < CAP:
            _records.append(rec)
        else:
            _dropped += 1


def span(name: str, device: Optional[torch.device] = None, **attrs):
    """Context manager of one span. ``device``: with a CUDA device, also a
    CUDA event pair on that device's current stream (``device_s``)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, attrs)


def traced(name: str, **attrs):
    """Decorator form of :func:`span`: each call of the function is a span."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, **attrs):
                return fn(*args, **kwargs)

        return wrapper

    return wrap


def annotate(**attrs) -> None:
    """Add attributes to this thread's innermost open span (no-op when no
    span is open or nothing records)."""
    if not _profiler._is_profiler_enabled:
        return
    st = getattr(_tls, "stack", None)
    if st:
        st[-1].attrs.update(attrs)


def carry(fn):
    """``fn`` with this thread's span context: spans it opens in another
    thread (an executor's) get this thread's innermost span as parent and
    share its call id. ``fn`` itself while nothing records."""
    if not _profiler._is_profiler_enabled:
        return fn
    ctx = _context()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prev = getattr(_tls, "base", (None, None))
        _tls.base = ctx
        try:
            return fn(*args, **kwargs)
        finally:
            _tls.base = prev

    return wrapper


def records() -> List[Dict]:
    """Copies of the kept records, each with ``device_s`` (waits for a
    span's end event where the device has not reached it)."""
    with _lock:
        for r in _records:
            ev = r.pop("events", None)
            if ev is not None:
                ev[1].synchronize()
                r["device_s"] = ev[0].elapsed_time(ev[1]) / 1e3
            else:
                r.setdefault("device_s", None)
        return [dict(r, attrs=dict(r["attrs"])) for r in _records]


def dropped() -> int:
    """Records refused since the last :func:`clear` because the buffer held
    ``CAP``."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
