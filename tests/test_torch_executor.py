"""The port's host executor (``syconn_tpu_torch/parallel/executor.py``)
against the JAX package's (``syconn_tpu/parallel/executor.py``): each case
runs on both packages with a fresh function of the same behaviour and
compares results, raised errors and the number of calls per item (the
retries) exactly."""

import logging
import sys
import threading

import pytest

from syconn_tpu.parallel import executor as jexec
from syconn_tpu_torch.parallel import executor as texec

PACKAGES = {"jax": jexec, "port": texec}


def _square(p):
    """Module level, so that a process pool can pickle it."""
    return p * p


class _Flaky:
    """``fn(p) = 2 * p + 1``, raising ``IOError`` on the first ``fail_first``
    calls of each item and on every call of the items in ``always``;
    ``calls[p]`` lists the argument objects it was called with."""

    def __init__(self, fail_first=0, always=()):
        self.fail_first, self.always = fail_first, set(always)
        self.calls = {}
        self._lock = threading.Lock()

    def __call__(self, p):
        with self._lock:
            seen = self.calls.setdefault(p, [])
            seen.append(p)
            n = len(seen)
        if p in self.always or n <= self.fail_first:
            raise IOError(f"transient failure of item {p} (call {n})")
        return 2 * p + 1


@pytest.mark.parametrize("n_workers", [4, None])
def test_each_item_failing_once_is_retried(n_workers):
    """A function that fails once per item: both packages return the same
    list, in input order, after one retry of every item."""
    out, calls = {}, {}
    for name, mod in PACKAGES.items():
        fn = _Flaky(fail_first=1)
        out[name] = mod.map_parallel(fn, list(range(10)), n_workers)
        calls[name] = {p: len(c) for p, c in fn.calls.items()}
    assert out["jax"] == out["port"] == [2 * p + 1 for p in range(10)]
    assert calls["jax"] == calls["port"] == {p: 2 for p in range(10)}


@pytest.mark.parametrize("max_retries", [2, 0])
def test_persistent_failures_raise_with_the_count(max_retries):
    """Three of ten items always fail: both raise ``RuntimeError`` naming
    3/10 items after ``max_retries + 1`` attempts, having called each failing
    item that often with the same argument, and each other item once."""
    msgs, calls = {}, {}
    for name, mod in PACKAGES.items():
        fn = _Flaky(always=(2, 5, 7))
        with pytest.raises(RuntimeError) as err:
            mod.map_parallel(fn, list(range(10)), 4, max_retries=max_retries)
        msgs[name] = str(err.value).split("First error:")[0]
        calls[name] = {p: len(c) for p, c in fn.calls.items()}
        assert all(all(a is c[0] for a in c) for c in fn.calls.values())
        assert "IOError" in str(err.value) or "OSError" in str(err.value)
    n = max_retries + 1
    assert msgs["jax"] == msgs["port"] == f"Step failed for 3/10 items after {n} attempts. "
    assert calls["jax"] == calls["port"] == {p: n if p in (2, 5, 7) else 1 for p in range(10)}


def test_max_retries_zero_gives_one_attempt():
    """``max_retries=0``: an item failing once is not retried."""
    msgs = {}
    for name, mod in PACKAGES.items():
        with pytest.raises(RuntimeError) as err:
            mod.map_parallel(_Flaky(fail_first=1), list(range(6)), 3, max_retries=0)
        msgs[name] = str(err.value).split("First error:")[0]
    assert msgs["jax"] == msgs["port"] == "Step failed for 6/6 items after 1 attempts. "


@pytest.mark.parametrize("form", [dict(n_workers=1), dict(n_workers=4, backend="serial")])
def test_inline_forms_let_the_exception_through(form):
    """``n_workers=1`` and ``backend="serial"`` run inline: no retry, the
    original exception unchanged; otherwise the same results."""
    for mod in PACKAGES.values():
        fn = _Flaky(fail_first=1)
        with pytest.raises(IOError, match="item 0 \\(call 1\\)"):
            mod.map_parallel(fn, list(range(5)), **form)
        assert {p: len(c) for p, c in fn.calls.items()} == {0: 1}
        assert mod.map_parallel(_square, list(range(5)), **form) == [0, 1, 4, 9, 16]


def test_process_backend_and_empty_params():
    out = {name: mod.map_parallel(_square, list(range(7)), 2, backend="process")
           for name, mod in PACKAGES.items()}
    assert out["jax"] == out["port"] == [p * p for p in range(7)]
    assert jexec.map_parallel(_square, []) == texec.map_parallel(_square, []) == []
    assert texec._default_workers("thread") == jexec._default_workers("thread")
    assert texec._default_workers("process") == jexec._default_workers("process")


class _Cell:
    def __init__(self, k):
        self.k = k

    def scaled(self, a, b=0):
        return self.k * a + b


def test_reference_shaped_names():
    """``start_multiprocess``/``_imap``/``_obj`` and ``batchjob_script``
    through ``register_step``/``get_step``: the same results on both."""
    params = list(range(8))
    objs = [[_Cell(k), k + 1, 3] for k in range(8)]
    out = {}
    for name, mod in PACKAGES.items():
        step = f"torch_executor_test_{name}"
        mod.register_step(step)(_square)
        assert mod.get_step(step) is _square and mod.batchjob_enabled() is False
        out[name] = (mod.start_multiprocess(_square, params, nb_cpus=3),
                     mod.start_multiprocess(_square, params, debug=True),
                     mod.start_multiprocess_imap(_square, params, nb_cpus=3, show_progress=False),
                     mod.start_multiprocess_obj("scaled", objs, nb_cpus=3),
                     mod.start_multiprocess_obj("scaled", objs, debug=True),
                     mod.batchjob_script(params, step, n_max_co_processes=3,
                                         show_progress=False))
        with pytest.raises(KeyError, match="Unknown step"):
            mod.get_step("no_such_step")
    assert out["jax"] == out["port"]
    assert out["port"][3] == [k * (k + 1) + 3 for k in range(8)]


def test_progress_without_tqdm(monkeypatch, caplog):
    """``show_progress`` (on by default in ``start_multiprocess_imap`` and
    ``batchjob_script``) logs through the module's logger: with ``tqdm``
    blocked the port runs, and reports every tenth of the items and the
    last one."""
    monkeypatch.setitem(sys.modules, "tqdm", None)
    texec.register_step("torch_executor_test_progress")(_square)
    with caplog.at_level(logging.INFO, logger="syconn_tpu_torch.parallel"):
        assert texec.start_multiprocess_imap(_square, list(range(25)), nb_cpus=4,
                                             desc="squares") == [p * p for p in range(25)]
        assert texec.batchjob_script(list(range(3)), "torch_executor_test_progress") == [0, 1, 4]
        assert texec.map_parallel(_square, list(range(4)), 1, show_progress=True) == [0, 1, 4, 9]
    lines = [r.getMessage() for r in caplog.records if r.name == "syconn_tpu_torch.parallel"]
    assert [m for m in lines if m.startswith("squares:")] == [
        f"squares: {k}/25 items" for k in (2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 25)]
    assert [m for m in lines if m.startswith("torch_executor_test_progress:")] == [
        f"torch_executor_test_progress: {k}/3 items" for k in (1, 2, 3)]
    assert [m for m in lines if m.startswith("map_parallel:")] == [
        f"map_parallel: {k}/4 items" for k in (1, 2, 3, 4)]
