"""Layered YAML configuration with a dynamic working directory
(counterpart of ``syconn_tpu/handler/config.py``).

* ``Config(working_dir)`` loads ``<wd>/config.yml``; missing keys fall back
  per-key to the packaged defaults (``default_config.yml``).
* ``DynConfig`` re-reads the config whenever ``global_params.wd`` or the
  ``syconn_wd`` environment variable changes, so spawned workers pick up the
  active dataset automatically.
* ``generate_default_conf`` writes an initial ``config.yml`` with
  nested key/value overrides.
* ``initialize_logging`` builds per-module loggers with optional per-step
  file logs under ``<wd>/logs/``.

YAML is read and written by :mod:`.yamlio`; the port does not need PyYAML.
Model paths (``mpath_*``) name ``<wd>/models/<name>`` where a model was
saved there, else the packaged weights of that name
(:func:`..models.io.packaged_model_path`), which is where the JAX package's
loader falls back to as well.
"""

from __future__ import annotations

import copy
import datetime
import logging
import os
import sys
from typing import Any, Optional

import numpy as np

from . import yamlio

__all__ = [
    "Config",
    "DynConfig",
    "generate_default_conf",
    "initialize_logging",
    "TimeFilter",
]

_DEFAULT_CONF_PATH = os.path.join(os.path.dirname(__file__), "default_config.yml")
_default_conf_cache: Optional[dict] = None


def _load_default_entries() -> dict:
    """A deep copy of the packaged defaults: callers merge nested overrides
    into what they get (the JAX package's shallow copy lets
    ``generate_default_conf`` change the defaults of the whole process)."""
    global _default_conf_cache
    if _default_conf_cache is None:
        with open(_DEFAULT_CONF_PATH) as f:
            _default_conf_cache = yamlio.load(f.read())
    return copy.deepcopy(_default_conf_cache)


class Config:
    """Dict-like access to a working directory's ``config.yml``.

    Keys missing from the working-dir config fall back to the packaged
    defaults. ``config[key]`` raises ``KeyError`` only if the key exists in
    neither.
    """

    def __init__(self, working_dir: Optional[str], verbose: bool = False):
        self._working_dir = working_dir
        self._verbose = verbose
        self._entries: dict = {}
        self.initialized = False
        if working_dir is not None:
            self._parse_config()

    @property
    def working_dir(self) -> Optional[str]:
        return self._working_dir

    @property
    def path_config(self) -> str:
        return os.path.join(str(self._working_dir), "config.yml")

    @property
    def entries(self) -> dict:
        if not self.initialized and self._working_dir is not None:
            self._parse_config()
        return self._entries

    def _parse_config(self):
        self._entries = {}
        if self._working_dir is not None and os.path.isfile(self.path_config):
            with open(self.path_config) as f:
                loaded = yamlio.load(f.read())
            if loaded:
                self._entries.update(loaded)
        self.initialized = True

    def __getitem__(self, key: str) -> Any:
        try:
            return self.entries[key]
        except KeyError:
            return _load_default_entries()[key]

    def __setitem__(self, key: str, value: Any):
        self.entries[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.entries or key in _load_default_entries()

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def write_config(self, target_dir: Optional[str] = None):
        target = target_dir or self._working_dir
        if target is None:
            raise ValueError("No working directory set; cannot write config.")
        os.makedirs(target, exist_ok=True)
        entries = dict(self.entries)
        entries["config_time"] = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        with open(os.path.join(target, "config.yml"), "w") as f:
            f.write(yamlio.dump(entries))

    # ---------------------------------------------------------------- paths
    def _kd_path(self, key: str, default_name: str) -> str:
        p = (self["paths"] or {}).get(key)
        if p:
            return p
        return os.path.join(str(self.working_dir), "knossosdatasets", default_name)

    @property
    def kd_seg_path(self) -> str:
        return self._kd_path("kd_seg", "seg")

    @property
    def kd_sym_path(self) -> str:
        return self._kd_path("kd_sym", "sym")

    @property
    def kd_asym_path(self) -> str:
        return self._kd_path("kd_asym", "asym")

    @property
    def kd_sj_path(self) -> str:
        return self._kd_path("kd_sj", "sj")

    @property
    def kd_vc_path(self) -> str:
        return self._kd_path("kd_vc", "vc")

    @property
    def kd_mi_path(self) -> str:
        return self._kd_path("kd_mi", "mi")

    @property
    def kd_er_path(self) -> str:
        return self._kd_path("kd_er", "er")

    @property
    def kd_golgi_path(self) -> str:
        return self._kd_path("kd_golgi", "golgi")

    @property
    def kd_myelin_path(self) -> str:
        return self._kd_path("kd_myelin", "myelin")

    @property
    def kd_organelle_seg_paths(self) -> dict:
        """Segmentation volumes of extracted sub-cellular structures."""
        return {
            co: os.path.join(str(self.working_dir), "knossosdatasets", f"{co}_seg")
            for co in self["process_cell_organelles"]
        }

    @property
    def kd_organelle_proba_paths(self) -> dict:
        return {co: self._kd_path(f"kd_{co}", co) for co in self["process_cell_organelles"]}

    @property
    def init_svgraph_path(self) -> str:
        p = (self["paths"] or {}).get("init_svgraph")
        return p or os.path.join(str(self.working_dir), "rag.bz2")

    @property
    def pruned_svgraph_path(self) -> str:
        return os.path.join(str(self.working_dir), "pruned_svgraph.bz2")

    @property
    def neuron_svgraph_path(self) -> str:
        return os.path.join(str(self.working_dir), "neuron_svgraph.bz2")

    @property
    def astrocyte_svgraph_path(self) -> str:
        return os.path.join(str(self.working_dir), "astrocyte_svgraph.bz2")

    @property
    def temp_path(self) -> str:
        return os.path.join(str(self.working_dir), "tmp")

    @property
    def use_new_subfold(self) -> bool:
        v = (self["paths"] or {}).get("use_new_subfold")
        return True if v is None else bool(v)

    # ------------------------------------------------------------- shortcuts
    @property
    def prior_astrocyte_removal(self) -> bool:
        return bool(self["glia"]["prior_astrocyte_removal"])

    @property
    def use_point_models(self) -> bool:
        return bool(self["use_point_models"])

    @property
    def use_onthefly_views(self) -> bool:
        return bool(self["views"]["use_onthefly_views"])

    @property
    def use_new_renderings_locs(self) -> bool:
        return bool(self["views"]["use_new_renderings_locs"])

    @property
    def use_kimimaro(self) -> bool:
        return bool(self["skeleton"]["use_kimimaro"])

    @property
    def allow_ssv_skel_gen(self) -> bool:
        return bool(self["skeleton"]["allow_ssv_skel_gen"])

    @property
    def allow_mesh_gen_cells(self) -> bool:
        return bool(self["meshes"]["allow_mesh_gen_cells"])

    @property
    def use_new_meshing(self) -> bool:
        return bool(self["meshes"]["use_new_meshing"])

    @property
    def syntype_available(self) -> bool:
        return bool(self["syntype_avail"])

    @property
    def sign_thresh(self) -> float:
        return float(self["cell_objects"]["sym_thresh"])

    @property
    def ncore_total(self) -> int:
        return int(self["ncores_per_node"]) * int(self["nnodes_total"])

    @property
    def ngpu_total(self) -> int:
        return int(self["ngpus_per_node"]) * int(self["nnodes_total"])

    # ------------------------------------------------------------ model paths
    @property
    def model_dir(self) -> str:
        return os.path.join(str(self.working_dir), "models")

    def _mpath(self, name: str) -> str:
        from ..models.io import model_exists, packaged_model_path

        path = os.path.join(self.model_dir, name)
        return path if model_exists(path) else packaged_model_path(name)

    @property
    def mpath_spiness(self) -> str:
        return self._mpath("spiness")

    @property
    def mpath_axonsem(self) -> str:
        return self._mpath("axoness_semseg")

    @property
    def mpath_celltype_e3(self) -> str:
        return self._mpath("celltype")

    @property
    def mpath_celltype_pts(self) -> str:
        return self._mpath("celltype_pts")

    @property
    def mpath_compartment_pts(self) -> str:
        return self._mpath("compartment_pts")

    @property
    def mpath_glia_e3(self) -> str:
        return self._mpath("glia")

    @property
    def mpath_glia_pts(self) -> str:
        return self._mpath("glia_pts")

    @property
    def mpath_myelin(self) -> str:
        return self._mpath("myelin")

    @property
    def mpath_syntype(self) -> str:
        return self._mpath("syntype")

    @property
    def mpath_organelles(self) -> str:
        return self._mpath("organelles")

    @property
    def mpath_axoness_views(self) -> str:
        return self._mpath("axoness_views")

    @property
    def mpath_tnet(self) -> str:
        return self._mpath("tnet")

    @property
    def mpath_tnet_pts(self) -> str:
        return self._mpath("tnet_pts")

    @property
    def mpath_syn_rfc(self) -> str:
        return self._mpath("syn_rfc.pkl")

    @property
    def mpath_er(self) -> str:
        return self._mpath("er")

    @property
    def mpath_golgi(self) -> str:
        return self._mpath("golgi")

    def __repr__(self):
        return f"Config(wd={self._working_dir!r})"


class DynConfig(Config):
    """Config bound to the *current* global working directory.

    Every attribute access first checks whether ``global_params.wd`` or the
    ``syconn_wd`` environment variable changed and re-parses if so
    (reference: syconn/handler/config.py:238 ``_check_actuality``).
    """

    def __init__(self, wd: Optional[str] = None):
        super().__init__(wd)
        self._lazy_wd = wd is None

    def _check_actuality(self):
        from .. import global_params

        new_wd = None
        env_wd = os.environ.get("syconn_wd")
        if env_wd and env_wd.strip() not in ("", "None"):
            new_wd = env_wd
        if global_params.wd is not None:
            new_wd = global_params.wd
        if new_wd is not None and new_wd != self._working_dir:
            self._working_dir = new_wd
            self._parse_config()
        elif new_wd is not None and not self.initialized:
            self._parse_config()

    @property
    def working_dir(self):
        self._check_actuality()
        return self._working_dir

    @property
    def entries(self):
        self._check_actuality()
        return self._entries


def _update_key_value_pair_rec(key, value, entries: dict):
    """Override ``entries[key]``; dict values are merged recursively."""
    if isinstance(value, dict) and isinstance(entries.get(key), dict):
        for k, v in value.items():
            _update_key_value_pair_rec(k, v, entries[key])
    else:
        entries[key] = value


def generate_default_conf(
    working_dir: str,
    scaling,
    key_value_pairs=None,
    force_overwrite: bool = False,
    **kwargs,
):
    """Write an initial ``config.yml`` into ``working_dir``.

    Args:
        working_dir: Target dataset directory.
        scaling: Voxel size (x, y, z) in nm.
        key_value_pairs: list of ``(key, value)`` overrides; dict values merge
            recursively into nested sections.
        force_overwrite: Replace an existing config.
    """
    entries = _load_default_entries()
    if isinstance(scaling, np.ndarray):
        scaling = scaling.tolist()
    entries["scaling"] = list(int(s) for s in scaling)
    if key_value_pairs:
        for k, v in key_value_pairs:
            _update_key_value_pair_rec(k, v, entries)
    for k, v in kwargs.items():
        _update_key_value_pair_rec(k, v, entries)
    conf_path = os.path.join(working_dir, "config.yml")
    if os.path.isfile(conf_path) and not force_overwrite:
        raise ValueError(
            f"Config file already exists at {conf_path}; pass force_overwrite=True to replace."
        )
    os.makedirs(working_dir, exist_ok=True)
    with open(conf_path, "w") as f:
        f.write(yamlio.dump(entries))
    return conf_path


class TimeFilter(logging.Filter):
    """Adds relative elapsed minutes since the last record (``%(relmin)s``)."""

    def filter(self, record):
        try:
            last = self.last
        except AttributeError:
            last = record.relativeCreated
        delta = datetime.datetime.fromtimestamp(
            record.relativeCreated / 1000.0
        ) - datetime.datetime.fromtimestamp(last / 1000.0)
        record.relmin = f"{delta.total_seconds() / 60.0:.2f}min"
        self.last = record.relativeCreated
        return True


def initialize_logging(log_name: str, log_dir: Optional[str] = None, overwrite: bool = True):
    """Create a logger; optionally attach a file handler under ``log_dir``."""
    from .. import global_params

    if log_dir is None:
        try:
            if global_params.config.working_dir is not None and not bool(
                global_params.config["disable_file_logging"]
            ):
                log_dir = global_params.config["default_log_dir"] or os.path.join(
                    str(global_params.config.working_dir), "logs"
                )
        except Exception:
            log_dir = None
    level = logging.INFO
    try:
        if global_params.config.working_dir is not None:
            level = int(global_params.config["log_level"])
    except Exception:
        pass
    logger = logging.getLogger(log_name)
    logger.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setLevel(level)
        sh.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S")
        )
        logger.addHandler(sh)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, log_name + ".log")
        if overwrite and os.path.isfile(log_path):
            os.remove(log_path)
        if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
            fh = logging.FileHandler(log_path)
            fh.setLevel(level)
            fh.setFormatter(
                logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
            )
            logger.addHandler(fh)
    logger.propagate = False
    return logger
