"""The port's working-directory configuration (``handler/config.py``,
``handler/yamlio.py``, ``global_params.py``) against the JAX package's, on
the inputs of tests/test_config.py: every key equal, each package reading
the other's ``config.yml``, and the YAML reader and writer against PyYAML."""

import math
import os
import random
import string

import numpy as np
import pytest
import yaml

from syconn_tpu import global_params as jparams
from syconn_tpu.handler import config as jconfig
from syconn_tpu_torch import global_params as tparams
from syconn_tpu_torch.handler import config as tconfig
from syconn_tpu_torch.handler import yamlio
from syconn_tpu_torch.models.io import packaged_model_path

from _torch_helpers import jax_defaults_isolated, port_wd

OVERRIDES = [("use_point_models", True), ("glia", {"prior_astrocyte_removal": True}),
             ("cell_objects", {"cs_gap_nm": 123, "min_obj_vx": {"cs": 1e-06}}),
             ("paths", {"kd_seg": "/data/with space/seg"})]
PATH_PROPS = ["kd_seg_path", "kd_sym_path", "kd_asym_path", "kd_sj_path", "kd_vc_path",
              "kd_mi_path", "kd_er_path", "kd_golgi_path", "kd_myelin_path",
              "kd_organelle_seg_paths", "kd_organelle_proba_paths", "init_svgraph_path",
              "pruned_svgraph_path", "neuron_svgraph_path", "astrocyte_svgraph_path",
              "temp_path", "use_new_subfold", "prior_astrocyte_removal", "use_point_models",
              "use_onthefly_views", "use_new_renderings_locs", "use_kimimaro",
              "allow_ssv_skel_gen", "allow_mesh_gen_cells", "use_new_meshing",
              "syntype_available", "sign_thresh", "ncore_total", "ngpu_total", "model_dir"]


def _keys(wd):
    with open(os.path.join(wd, "config.yml")) as f:
        return set(yaml.safe_load(f)) | set(jconfig._load_default_entries())


@pytest.mark.parametrize("pairs", [None, OVERRIDES], ids=["default", "overrides"])
def test_every_key_equals_jax(tmp_path, pairs):
    with jax_defaults_isolated():
        _every_key_equals_jax(tmp_path, pairs)


def _every_key_equals_jax(tmp_path, pairs):
    wj, wt = str(tmp_path / "j"), str(tmp_path / "t")
    jconfig.generate_default_conf(wj, scaling=np.array([10, 10, 20]), key_value_pairs=pairs)
    tconfig.generate_default_conf(wt, scaling=np.array([10, 10, 20]), key_value_pairs=pairs)
    cj, ct = jconfig.Config(wj), tconfig.Config(wt)
    for key in _keys(wj) | _keys(wt):
        assert ct[key] == cj[key], key
        # each package reads the other's config.yml
        assert tconfig.Config(wj)[key] == cj[key], key
        assert jconfig.Config(wt)[key] == cj[key], key
    with open(os.path.join(wt, "config.yml")) as f:
        t_yaml = yaml.safe_load(f)
    with open(os.path.join(wj, "config.yml")) as f:
        assert t_yaml == yaml.safe_load(f)
    assert ct["cell_objects"]["cs_filtersize"] == [13, 13, 7]
    for prop in PATH_PROPS:
        got, ref = getattr(ct, prop), getattr(cj, prop)
        if isinstance(ref, str):
            got, ref = got.replace(wt, "<wd>"), ref.replace(wj, "<wd>")
        elif isinstance(ref, dict):
            got = {k: v.replace(wt, "<wd>") for k, v in got.items()}
            ref = {k: v.replace(wj, "<wd>") for k, v in ref.items()}
        assert got == ref, prop


def test_write_config_floats_and_timestamp_read_by_pyyaml(tmp_path):
    """``1e-06`` must be written as ``1.0e-06``: YAML 1.1 reads the former as
    a string."""
    wd = str(tmp_path / "wd")
    tconfig.generate_default_conf(wd, scaling=(10, 10, 20))
    c = tconfig.Config(wd)
    c["tiny"] = 1e-06
    c["huge"] = 2.5e20
    c["neg"] = [-1e-06, 0.5, -3]
    c.write_config()
    with open(os.path.join(wd, "config.yml")) as f:
        text = f.read()
    assert "1.0e-06" in text
    loaded = yaml.safe_load(text)
    assert loaded["tiny"] == 1e-06 and isinstance(loaded["tiny"], float)
    assert loaded["huge"] == 2.5e20 and loaded["neg"] == [-1e-06, 0.5, -3]
    assert isinstance(loaded["config_time"], str)
    assert tconfig.Config(wd)["config_time"] == loaded["config_time"]
    assert jconfig.Config(wd)["tiny"] == 1e-06


def test_dynconfig_tracks_wd(tmp_path):
    wd_a, wd_b = str(tmp_path / "a"), str(tmp_path / "b")
    tconfig.generate_default_conf(wd_a, scaling=(1, 1, 1), key_value_pairs=[("ncores_per_node", 11)])
    tconfig.generate_default_conf(wd_b, scaling=(2, 2, 2), key_value_pairs=[("ncores_per_node", 22)])
    with port_wd(wd_a):
        assert tparams.config.working_dir == wd_a
        assert tparams.config["ncores_per_node"] == 11
        tparams.wd = wd_b
        assert tparams.config["ncores_per_node"] == 22
        assert tparams.config["scaling"] == [2, 2, 2]
        # the JAX package's global state is its own
        assert jparams.config.working_dir != wd_b
    assert tparams.config.working_dir is None
    with pytest.raises(ValueError, match="already exists"):
        tconfig.generate_default_conf(wd_a, scaling=(1, 1, 1))


def test_default_fallback_and_model_paths(tmp_path):
    wd = str(tmp_path / "wd2")
    os.makedirs(wd)
    with open(os.path.join(wd, "config.yml"), "w") as f:
        f.write("scaling: [1, 2, 3]   # a comment\n")
    conf = tconfig.Config(wd)
    assert conf["scaling"] == [1, 2, 3]
    assert conf["cell_objects"]["cs_filtersize"] == [13, 13, 7]
    assert "versions" in conf and conf.get("no such key", 5) == 5
    # no model in the working directory: the packaged weights, read in place
    assert conf.mpath_organelles == packaged_model_path("organelles")
    saved = os.path.join(wd, "models", "myelin")
    os.makedirs(saved)
    for name in ("arch.json", "params.msgpack"):
        with open(os.path.join(saved, name), "w") as f:
            f.write("{}")
    assert conf.mpath_myelin == saved


def test_initialize_logging_writes_under_the_wd(tmp_path):
    wd = str(tmp_path / "wd")
    tconfig.generate_default_conf(wd, scaling=(10, 10, 20),
                                  key_value_pairs=[("disable_file_logging", False)])
    with port_wd(wd):
        lg = tconfig.initialize_logging("torch_config_test")
    try:
        lg.info("hello")
        for h in lg.handlers:
            h.flush()
        assert os.path.isfile(os.path.join(wd, "logs", "torch_config_test.log"))
    finally:
        for h in list(lg.handlers):
            h.close()
            lg.removeHandler(h)


def _random_doc(rng):
    chars = string.ascii_letters + string.digits + " /._-:#'\"" + "äü"

    def node(depth):
        c = rng.random()
        if depth < 3 and c < 0.2:
            return {"".join(rng.choices(string.ascii_letters + " :#'-_", k=rng.randint(1, 6))):
                    node(depth + 1) for _ in range(rng.randint(0, 4))}
        if depth < 3 and c < 0.35:
            return [node(depth + 1) for _ in range(rng.randint(0, 4))]
        if c < 0.5:
            return rng.randint(-10**6, 10**6)
        if c < 0.65:
            return rng.choice([rng.random() * 10 ** rng.randint(-8, 25), 1e-06, 1.0, -2.5])
        if c < 0.7:
            return rng.choice([True, False, None])
        return "".join(rng.choices(chars, k=rng.randint(0, 30)))

    return {f"k{i}": node(0) for i in range(5)}


@pytest.mark.parametrize("seed", [0, 1])
def test_yamlio_round_trips_through_pyyaml(seed):
    """Seeded random documents: PyYAML's output (with wrapped flow lists and
    folded quoted strings) reads back through the port, and the port's
    output reads back through PyYAML and the port."""
    rng = random.Random(seed)
    for _ in range(300):
        doc = _random_doc(rng)
        assert yamlio.load(yaml.safe_dump(doc, default_flow_style=None, sort_keys=False)) == doc
        text = yamlio.dump(doc)
        assert yaml.safe_load(text) == doc
        assert yamlio.load(text) == doc


def test_yamlio_scalars_resolve_as_pyyaml():
    plain = ["1.", ".5", "1.0e-06", "1e-06", "0x1F", "017", "0b101", "1_000", "-.inf", ".nan",
             "yes", "Off", "~", "null", "NULL", "True", "FS", "2026-10-17", "12:30", "a#b"]
    for s in plain:
        ref = yaml.safe_load(f"v: {s}\n")["v"]
        got = yamlio.load(f"v: {s}\n")["v"]
        if isinstance(ref, float) and math.isnan(ref):
            assert math.isnan(got)
        elif s in ("2026-10-17", "12:30"):  # timestamp / sexagesimal: kept as strings
            assert got == s
        else:
            assert got == ref and type(got) is type(ref), s
    text = open(os.path.join(os.path.dirname(tconfig.__file__), "default_config.yml")).read()
    assert yamlio.load(text) == yaml.safe_load(text)


def test_nested_overrides_leave_the_packaged_defaults(tmp_path):
    """``generate_default_conf`` with a nested override changes that working
    directory only, not the defaults every later config falls back to."""
    tconfig.generate_default_conf(str(tmp_path / "a"), scaling=(1, 1, 1),
                                  key_value_pairs=[("tpu", {"shard_pipeline": False})])
    assert tconfig.Config(str(tmp_path / "a"))["tpu"]["shard_pipeline"] is False
    assert tconfig._load_default_entries()["tpu"]["shard_pipeline"] is True
    assert tconfig.Config(None)["tpu"]["shard_pipeline"] is True
