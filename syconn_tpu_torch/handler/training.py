"""Tiny training launcher (counterpart of ``syconn_tpu/handler/training.py``):
queue training runs as subprocesses, one after the other on one card."""

from __future__ import annotations

import subprocess
from typing import List, Sequence

__all__ = ["start_training", "worker_train"]


def worker_train(cmd: Sequence[str]) -> int:
    res = subprocess.run(list(cmd), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"training failed:\n{res.stderr[-3000:]}")
    return res.returncode


def start_training(train_cmds: Sequence[Sequence[str]]) -> List[int]:
    """Run training commands sequentially (one accelerator)."""
    return [worker_train(c) for c in train_cmds]
