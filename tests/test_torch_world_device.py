"""The port's device world generator (``utils/testdata_device.py`` and the
device route of ``utils/testdata.py``) against the JAX package's on the CPU.

* ``generate_dense_fields_device`` on the JAX generator's own inputs, at two
  shapes (one x extent not a multiple of ``chunk_x``), and the whole device
  world (cells, supervoxels, organelles, ER, golgi, sym/asym, the RAG): equal,
  but for vc on the ellipsoid surface lattice points where the exact value
  of the ellipsoid test is 1. There the JAX package's float32 answer depends
  on which square XLA:CPU contracts into a fused multiply-add, which differs
  between its compiled programs; the port evaluates the test exactly and
  counts those voxels inside.
* The raw image (noise from a ``torch.Generator``, not JAX's draws): for
  every combination of membrane, mi, vc and sj with >= ``MIN_CLASS`` voxels,
  the mean within 1 grey level and the standard deviation within 2% of the
  JAX package's. (A class of n voxels has a sampling error of its standard
  deviation of ~1/sqrt(2n): 0.7% at 10000.)
* The ``device="auto"`` rule: the host below 32 MVx or without a card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

MIN_CLASS = 10000


def _jax_device_world(monkeypatch, shape, n_cells, seed):
    """The JAX device world and the inputs and result of its
    ``generate_dense_fields_device`` call."""
    import syconn_tpu.utils.testdata_device as JD
    from syconn_tpu.utils import testdata as J

    cap = {}
    orig = JD.generate_dense_fields_device

    def record(*a, **kw):
        cap["args"], cap["kw"] = a, kw
        cap["res"] = orig(*a, **kw)
        return cap["res"]

    monkeypatch.setattr(JD, "generate_dense_fields_device", record)
    world = J._generate_toy_world_device(shape, n_cells, 3, seed, (10, 10, 20))
    return world, cap


def _vc_surface(shape, vc_blobs, cells):
    """Voxels where the vc ellipsoid test is exactly 1: (dx, dy) of
    (+-3, +-4) or (+-4, +-3) and dz 0 from a center, rxy 5, inside its cell."""
    out = np.zeros(shape, bool)
    for b in np.asarray(vc_blobs, np.float64):
        assert b[3] == 5 and b[4] == 2
        for dx, dy in ((3, 4), (4, 3)):
            for sx in (1, -1):
                for sy in (1, -1):
                    p = b[:3].astype(np.int64) + (sx * dx, sy * dy, 0)
                    if np.all(p >= 0) and np.all(p < shape) and cells[tuple(p)] == int(b[5]):
                        out[tuple(p)] = True
    return out


@pytest.mark.parametrize("shape,n_cells,seed", [((150, 64, 32), 4, 7), ((128, 96, 48), 9, 3)])
def test_device_world_equals_jax(monkeypatch, shape, n_cells, seed):
    from syconn_tpu_torch.utils import testdata as T
    from syconn_tpu_torch.utils.testdata_device import generate_dense_fields_device

    wj, cap = _jax_device_world(monkeypatch, shape, n_cells, seed)
    args = cap["args"]
    vc_blobs = args[5]
    dj = cap["res"]
    dt = generate_dense_fields_device(*args, device="cpu")
    assert dt["seg"].dtype == np.uint16 and np.array_equal(dt["seg"], dj["seg"])
    assert dt["_device"] == {}
    wt = T.generate_toy_world(shape, n_cells, 3, seed, (10, 10, 20), device="cpu")
    surface = _vc_surface(shape, vc_blobs, wj["cells"])
    assert surface.any()
    for d, w, on in ((dj, dt, True), (wj, wt, 255)):
        for k in ("mi", "sj"):
            assert np.array_equal(d[k], w[k]), k
        apart = d["vc"] != w["vc"]
        assert not np.any(apart & ~surface)
        assert np.all(w["vc"][surface] == on)
    for k in ("seg", "cells", "er", "golgi", "sym", "asym", "rag"):
        assert wj[k].dtype == wt[k].dtype and np.array_equal(wj[k], wt[k]), k
    assert wj["sv2cell"] == wt["sv2cell"]


def test_device_raw_statistics_match_jax(monkeypatch):
    from syconn_tpu_torch.utils.testdata_device import generate_dense_fields_device

    _, cap = _jax_device_world(monkeypatch, (160, 160, 80), 24, 5)
    args, dj = cap["args"], cap["res"]
    dt = generate_dense_fields_device(*args, device="cpu")
    cells = np.concatenate([[0], args[3]])[dj["seg"]]
    code = (cells == 0) * 1 + dj["mi"] * 2 + dj["vc"] * 4 + dj["sj"] * 8
    agree = dj["vc"] == dt["vc"]
    tested = 0
    for c in np.unique(code):
        m = (code == c) & agree
        if m.sum() < MIN_CLASS:
            continue
        a, b = dj["raw"][m].astype(np.float64), dt["raw"][m].astype(np.float64)
        assert abs(a.mean() - b.mean()) <= 1.0, (c, a.mean(), b.mean())
        assert abs(b.std() / a.std() - 1) <= 0.02, (c, a.std(), b.std())
        tested += 1
    assert tested >= 5  # cytoplasm, membrane, mi, vc, sj and sj on membrane


def test_auto_rule(monkeypatch):
    from syconn_tpu_torch.utils.testdata import AUTO_DEVICE_MVX, _generator_device, \
        auto_world_device

    big = (512, 256, 256)
    assert np.prod(big) >= AUTO_DEVICE_MVX * 1e6 > np.prod((256, 256, 128))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _generator_device("auto", big) is None
    assert _generator_device(False, big) is None
    assert _generator_device("cpu", (8, 8, 8)) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        _generator_device(True, (8, 8, 8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _generator_device("auto", (256, 256, 128)) is None
    assert _generator_device("auto", big) == torch.device("cuda")
    # the driver hands the rule the card it resolved
    assert auto_world_device(big, torch.device("cuda:1")) == torch.device("cuda:1")
    assert auto_world_device((256, 256, 128), torch.device("cuda:1")) is None
    assert auto_world_device(big, None) is None
