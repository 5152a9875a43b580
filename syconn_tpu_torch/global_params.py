"""Process-global state: the active working directory and its config
(counterpart of ``syconn_tpu/global_params.py``). Assigning
``global_params.wd = <path>`` activates the dynamic config, which re-reads
``<wd>/config.yml`` whenever the working directory changes (also picked up
from the ``syconn_wd`` environment variable so that spawned workers inherit
the active dataset).
"""

from __future__ import annotations

# Mutable module attribute: the current working directory. ``DynConfig``
# re-checks this (and the ``syconn_wd`` env var) on every access.
wd = None

# Object types processed as sub-cellular structures by default.
existing_cell_organelles = ["mi", "sj", "vc"]

# Lazily constructed singleton config (avoids import cycle).
config = None


def _init_config():
    global config
    if config is None:
        from .handler.config import DynConfig

        config = DynConfig()
    return config


_init_config()
