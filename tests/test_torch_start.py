"""The port's pipeline driver (``syconn_tpu_torch.examples.start``) against
the JAX package's (``examples/start.py``) on the CPU, on a Voronoi world and
on a neuron world with the quality fixture's two ``--kv`` overrides.

The JAX package runs in a subprocess on one CPU device
(``JAX_PLATFORMS=cpu``, without the suite's 8 virtual devices, so that its
driver runs serially, as the port's does): its driver
``examples/start.py`` up to step 6 (``--until_step 6``), then
its steps 7-9 and the export under ``jax.disable_jit()``, as ``start.py``
calls them (the port follows flax's eager ``apply``, which the jitted nets
differ from by a median relative 1e-3, ROADMAP Queue 3 item 7); meanwhile
the port's driver runs in this process with ``--device cpu``. (A fault of
the JAX side fails the test instead of taking the test process down.) Both
working directories are read through the port's readers (the JAX readers
cannot read zlib stores).

Compared: the configs read back; the ``timing.json`` step names; the world
(raw at mags 1, 2, 4, seg at mags 1, 2, every organelle map, the RAG, and
the neuron world's ``neuron_gt.npz``): equal; step 1's myelin masks: apart
on < ``MYELIN_TOL`` of the voxels (the trained-mask tolerance of
tests/test_torch_pipeline.py); the datasets of steps 2, 4, 6 and 6.5 and
the skeletons' nodes and edges: equal. Steps 5-9 (skeleton myelin and
labels, vertex labels, spine-head volumes, cell types, the partner
properties and the matrix): where the two myelin masks are equal, equal,
and the nets' floats within ``NET_ATOL``; where they are not, the labels
agree on >= ``LABEL_AGREEMENT`` and the floats stay within ``NET_ATOL``.
The test prints which branch it took.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_helpers import _same, compare_datasets, port_wd

pytest.importorskip("jax")  # for the subprocess

from test_torch_cells import NET_ATOL, _attr_dicts, _canonical  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = {
    "voronoi": ["--shape", "96", "96", "48", "--n_cells", "3", "--seed", "0"],
    "neuron": ["--world", "neuron", "--shape", "96", "96", "48", "--n_cells", "3",
               "--seed", "777", "--kv", "compartments.dist_axoness_averaging=500",
               "--kv", "spines.semseg2coords_spines.k=20"],
}
STEPS_0_6 = ["Preparation", "Dense predictions", "SD generation", "SSD generation",
             "Skeleton generation", "Synapse detection", "Contact detection"]
STEPS_7_9 = ["Compartment predictions", "Morphology extraction", "Celltype analysis",
             "Matrix export"]
MYELIN_TOL = 3e-3
LABEL_AGREEMENT = 0.98
# attributes of a cell that steps 7-9 write, and of a syn_ssv that the
# export writes; step 4 writes the others
CELL_STEP_7_9 = {"axoness_vertex_labels", "spiness_vertex_labels", "spinehead_vol",
                 "latent_morph", "celltype_cnn_e3", "celltype_cnn_e3_probas",
                 "celltype_cnn_e3_certainty"}
SYN_STEP_7_9 = {"partner_axoness", "partner_celltypes", "partner_spiness", "spinehead_vol"}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# the JAX side: examples/start.py's main up to step 6, then steps 7-9 and
# the export as start.py:363-388 runs them, the point-net steps eager
_JAX_SIDE = """
import sys
sys.path.insert(0, {root!r})
sys.argv = ["start.py"] + {argv!r}
from syconn_tpu.examples.start import main
main()
import jax
from syconn_tpu import global_params
from syconn_tpu.exec import exec_inference, exec_syns
from syconn_tpu.handler.basics import clear_kd_cache
clear_kd_cache()
global_params.wd = {wd!r}
with jax.disable_jit():
    exec_inference.run_semsegaxoness_prediction()
    exec_inference.run_semsegspiness_prediction()
exec_syns.run_spinehead_volume_calc()
with jax.disable_jit():
    exec_inference.run_morphology_embedding()
    exec_inference.run_celltype_prediction()
exec_syns.run_matrix_export()
"""


def _start_jax_side(wd, args, log):
    """The JAX package's pipeline in a subprocess on the CPU, its output
    into the file ``log``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", SYCONN_TPU_PLATFORM="cpu")
    env.pop("syconn_wd", None)
    # one CPU device, as the port has: with the suite's 8 virtual devices
    # (tests/conftest.py) the JAX driver shards its steps over them, and
    # XLA:CPU aborts the process when the threads of a collective do not all
    # arrive within 40 s, which happens on a loaded machine
    env["XLA_FLAGS"] = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                                if not f.startswith("--xla_force_host_platform_device_count"))
    argv = ["--working_dir", wd, *args, "--overwrite", "--until_step", "6"]
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-c", _JAX_SIDE.format(root=ROOT, argv=argv, wd=wd)],
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT)


def _volume(cfg, attr, channel, mag):
    from syconn_tpu_torch.io.chunked import ChunkedVolume

    cv = ChunkedVolume.open(getattr(cfg, attr))
    return cv.load_raw(mag=mag) if channel == "raw" else cv.load_seg(mag=mag)


def _skeletons(wd):
    from syconn_tpu_torch.backend import SkeletonStorage

    out = {}
    for p in sorted(glob.glob(os.path.join(wd, "ssv_0", "so_storage", "**", "skeletons.pkl"),
                              recursive=True)):
        st = SkeletonStorage(p, read_only=True)
        out.update({k: dict(st[k]) for k in st.keys()})
    return out


def _step_7_9_outputs(wd):
    """(labels, floats): every output of steps 5-9 that the myelin map can
    move, flattened per name; floats are the nets' outputs of ``NET_ATOL``."""
    labels, floats = {}, {}
    for k, sk in _skeletons(wd).items():
        for key, v in sk.items():
            if key not in ("nodes", "edges", "diameters"):
                labels[f"skeleton {k} {key}"] = np.asarray(v).ravel()
    for k, attrs in _attr_dicts(os.path.join(wd, "ssv_0")).items():
        for key in CELL_STEP_7_9 & set(attrs):
            v = attrs[key]
            if key == "spinehead_vol":
                v = [v[s] for s in sorted(v)]
            (floats if key in NET_ATOL else labels)[f"ssv {k} {key}"] = np.asarray(v).ravel()
    for key in SYN_STEP_7_9:
        labels[f"syn_ssv {key}"] = np.load(os.path.join(wd, "syn_ssvs_0", f"{key}s.npy")).ravel()
    with open(os.path.join(wd, "connectivity_matrix", "conn_mat.csv")) as f:
        labels["conn_mat.csv"] = np.asarray([c for row in f.read().splitlines()
                                             for c in row.split(",")])
    return labels, floats


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_driver_equals_jax(tmp_path, name, capsys):
    from syconn_tpu_torch.examples import start
    from syconn_tpu_torch.handler import yamlio
    from syconn_tpu_torch.handler.config import Config
    from syconn_tpu_torch.io.graph import load_svgraph

    args = WORLDS[name]
    wj, wt = str(tmp_path / "jax"), str(tmp_path / "port")
    log = str(tmp_path / "jax.log")
    proc = _start_jax_side(wj, args, log)
    try:
        with port_wd(None):
            stats = {}
            start.main(["--working_dir", wt, *args, "--overwrite", "--device", "cpu"],
                       stats=stats)
    finally:
        proc.wait(timeout=1200)
    assert proc.returncode == 0, open(log).read()[-5000:]
    assert stats["world"]["route"] == "host" and stats["myelin"]["route"] == "stream"
    assert stats["syn"]["n_syn_ssv"] > 0

    # the configs read back, and the step names
    conf = [yamlio.load(open(os.path.join(w, "config.yml")).read()) for w in (wj, wt)]
    for c in conf:
        c.pop("config_time", None)
    assert conf[0] == conf[1]
    steps = [list(json.load(open(os.path.join(w, "timing.json")))["steps_s"]) for w in (wj, wt)]
    assert steps[0] == STEPS_0_6 and steps[1] == STEPS_0_6 + STEPS_7_9

    # the world
    cj, ct = Config(wj), Config(wt)
    for attr, channel, mags in (("kd_seg_path", "raw", (1, 2, 4)), ("kd_seg_path", "seg", (1, 2)),
                                ("kd_mi_path", "raw", (1, 2)), ("kd_vc_path", "raw", (1, 2)),
                                ("kd_sj_path", "raw", (1, 2)), ("kd_sym_path", "raw", (1, 2)),
                                ("kd_asym_path", "raw", (1, 2))):
        for mag in mags:
            a, b = _volume(cj, attr, channel, mag), _volume(ct, attr, channel, mag)
            assert a.dtype == b.dtype and np.array_equal(a, b), (attr, channel, mag)
    gj, gt = load_svgraph(cj.init_svgraph_path), load_svgraph(ct.init_svgraph_path)
    assert np.array_equal(gj["edges"], gt["edges"])
    if name == "neuron":
        with np.load(os.path.join(wj, "neuron_gt.npz")) as zj, \
                np.load(os.path.join(wt, "neuron_gt.npz")) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                _same(zj[k], zt[k], k)
    else:
        assert not os.path.exists(os.path.join(wt, "neuron_gt.npz"))

    # step 1: the myelin masks
    mj, mt = _volume(cj, "kd_myelin_path", "raw", 1), _volume(ct, "kd_myelin_path", "raw", 1)
    apart = float(np.mean((mj > 0) != (mt > 0)))
    assert apart < MYELIN_TOL, apart
    masks_equal = apart == 0

    # steps 2, 4, 6 and 6.5
    compare_datasets(wj, wt, ["sv", "mi", "vc", "cs", "syn", "syn_ssv", "cs_ssv"],
                     skip=SYN_STEP_7_9)
    dj, dt = os.path.join(wj, "ssv_0"), os.path.join(wt, "ssv_0")
    for f in ("ids.npy", "sizes.npy", "bounding_boxs.npy", "rep_coords.npy", "sv_ids.npy"):
        _same(np.load(os.path.join(dj, f), allow_pickle=True),
              np.load(os.path.join(dt, f), allow_pickle=True), f)
    aj, at = _attr_dicts(dj), _attr_dicts(dt)
    _same({k: {x: v for x, v in a.items() if x not in CELL_STEP_7_9} for k, a in aj.items()},
          {k: {x: v for x, v in a.items() if x not in CELL_STEP_7_9} for k, a in at.items()},
          "ssv attribute dicts of step 4")
    sj, st = _skeletons(wj), _skeletons(wt)
    assert sorted(sj) == sorted(st) and len(st) == len(at) > 0
    for k in sj:
        rj, ej = _canonical(sj[k])
        rt, et = _canonical(st[k])
        assert np.array_equal(rj[:, :4], rt[:, :4]) and ej == et, f"skeleton {k}"

    # steps 5-9
    lj, fj = _step_7_9_outputs(wj)
    lt, ft = _step_7_9_outputs(wt)
    assert sorted(lj) == sorted(lt) and sorted(fj) == sorted(ft)
    for k in fj:
        atol = NET_ATOL[k.split()[-1]]
        np.testing.assert_allclose(ft[k].astype(np.float64), fj[k].astype(np.float64), rtol=0,
                                   atol=atol, err_msg=k)
    assert all(lj[k].shape == lt[k].shape for k in lj)
    same = sum(int(np.sum(lj[k] == lt[k])) for k in lj)
    total = sum(lj[k].size for k in lj)
    with capsys.disabled():
        print(f"\n{name}: myelin masks apart on {apart:.3g} of the voxels; branch "
              f"{'exact' if masks_equal else 'agreement'}: steps 5-9 labels equal on "
              f"{same}/{total}")
    if masks_equal:
        for k in lj:
            assert np.array_equal(lj[k], lt[k]), k
        with open(os.path.join(wj, "connectivity_matrix", "conn_mat.csv"), "rb") as a, \
                open(os.path.join(wt, "connectivity_matrix", "conn_mat.csv"), "rb") as b:
            assert a.read() == b.read()
        with np.load(os.path.join(wj, "connectivity_matrix", "conn_mat.npz")) as zj, \
                np.load(os.path.join(wt, "connectivity_matrix", "conn_mat.npz")) as zt:
            for k in zj.files:
                _same(zj[k], zt[k], k)
    else:
        assert same >= LABEL_AGREEMENT * total, (same, total)
