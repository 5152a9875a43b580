"""Which rate a cell reports: a device cell of a configuration without a rate
of its own runs a traffic file whose ``rate_metric`` is the shared
``device_mvox_s``, and reports it; a cell whose rate no end-to-end entry
lists fails when it is resolved, instead of printing a result line with
set-up alone; the cells that ``BENCHMARK.json`` had before the shared rate
report the names they reported then."""

import copy
import json
import os
import re
import shutil

import pytest
import torch

from _perfbench_names import BENCH
from perfbench.lib import harness

NEW = "scratchnet"          # a configuration that BENCHMARK.json does not have
NEW_CELL = NEW + ".device"
SHARED = "device_shared"    # the device traffic, reporting the shared rate
# the shared rate's entry, which comes with the first cell that reports it:
# an end-to-end entry lists at least one cell
SHARED_RATE = {"name": "device_mvox_s", "unit": "MVx/s", "better": "higher", "bound": 0.08,
               "source": "host_clock"}


def _scratch_root(tmp_path, monkeypatch, listed=True, names_shared=True):
    """A checkout under ``tmp_path``: ``BENCHMARK.json`` with a device cell of
    ``organelles`` copied under another name (and, where it is ``listed``,
    the shared rate's entry listing it), and the harness reading a copy
    of ``perfbench/``'s files with that cell's own added: its configuration,
    its limits and, where it ``names_shared``, a copy of the device traffic
    whose rate is ``device_mvox_s``."""
    bench = copy.deepcopy(BENCH)
    src = {c["name"]: c for c in bench["configs"]}["organelles"]
    bench["configs"].append(dict(src, name=NEW, file=f"perfbench/configs/{NEW}.json"))
    bench["workloads"].append({"name": NEW_CELL, "config": NEW,
                               "traffic": SHARED if names_shared else "device", "chips": 1,
                               "why": "a configuration with no rate of its own"})
    if listed:
        bench["end_to_end"].insert(-1, dict(SHARED_RATE, workloads=[NEW_CELL]))
    pb = tmp_path / "perfbench"
    for sub in ("traffic", "routes", "metrics", "limits", "families"):
        shutil.copytree(os.path.join(harness.BENCH_DIR, sub), pb / sub)
    (pb / "configs").mkdir()
    shutil.copy(os.path.join(harness.BENCH_DIR, "configs", "organelles.json"),
                pb / "configs" / f"{NEW}.json")
    shutil.copy(os.path.join(harness.BENCH_DIR, "limits", "organelles.device.json"),
                pb / "limits" / f"{NEW_CELL}.json")
    if names_shared:
        traffic = json.loads((pb / "traffic" / "device.json").read_text())
        traffic["rate_metric"] = "device_mvox_s"
        (pb / "traffic" / f"{SHARED}.json").write_text(json.dumps(traffic))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "BENCH_DIR", str(pb))
    return str(tmp_path)


def _run(root, workload, small):
    torch.set_num_threads(2)
    return harness.run(root, workload, 2**31 + 17, 0.3, False, device="cpu", overrides=small,
                       log=lambda m: None)


def test_new_configuration_reports_the_shared_device_rate(tmp_path, monkeypatch, small):
    root = _scratch_root(tmp_path, monkeypatch)
    assert harness.Cell(root, NEW_CELL).rate_metric == "device_mvox_s"
    r = _run(root, NEW_CELL, small)
    assert set(r["metrics"]) == {"device_mvox_s", "setup_s"}
    assert r["metrics"]["device_mvox_s"]["unit"] == "MVx/s"
    assert r["correct"] and r["failed"] == 0, r["limits"]


@pytest.mark.parametrize("listed, names_shared", [(False, True), (True, False)],
                         ids=["shared_rate_not_listed", "own_rate_missing"])
def test_unlisted_rate_fails_at_resolution(tmp_path, monkeypatch, listed, names_shared):
    root = _scratch_root(tmp_path, monkeypatch, listed=listed, names_shared=names_shared)
    rate = "device_mvox_s" if names_shared else f"device_mvox_s.{NEW}"
    message = re.escape(repr(NEW_CELL)) + ".*" + re.escape(repr(rate))
    with pytest.raises(ValueError, match=message):
        harness.Cell(root, NEW_CELL)


# the untraced result line's metrics of each cell before the shared rate
PARENT_NAMES = {"syntype.device": {"device_mvox_s.syntype", "setup_s"},
                "organelles.store": {"store_mvox_s", "setup_s"},
                "organelles.device": {"device_mvox_s.organelles", "setup_s"}}


@pytest.mark.parametrize("workload", sorted(PARENT_NAMES))
def test_existing_cells_keep_their_metric_names(root, small, workload):
    assert set(_run(root, workload, small)["metrics"]) == PARENT_NAMES[workload]
