"""The port's splat renderer (``syconn_tpu_torch/render/raster.py``) against
the JAX package's (``syconn_tpu/render/raster.py``) on the CPU.

Depth and index views are held EQUAL to the JAX renderer's, run eagerly
(``jax.disable_jit()``) and jitted (the two agree), on seeded vertex clouds
with occlusion, equal-depth ties (grid-snapped vertices under identity
rotations), vertices outside the view box and an empty mesh, under identity
and PCA rotations (``calc_rot_matrices``, a verbatim copy of the JAX
package's), at the inference functions' 128x64 and the config's 256x128 view sizes and
one to three views a location. The JAX package's own renderer tests
(``tests/test_render.py``, ``tests/test_render_golden.py``) run against the
port's renderer with their thresholds, and ``semseg2mesh_via_views`` equals
the JAX function.

Equality rests on the view transform's float order
(``raster.fused_columns``): ``test_fused_columns_follow_xla`` holds the rule
against XLA:CPU's own product.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from syconn_tpu.render import raster as J  # noqa: E402
from syconn_tpu_torch.render import raster as T  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cloud(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "blob":
        v = rng.normal(size=(6000, 3)) * [2500, 1200, 800] + 5000
    elif kind == "grid":  # equal depths everywhere under identity rotations
        v = np.round((rng.normal(size=(6000, 3)) * 1500 + 5000) / 40) * 40
    elif kind == "walls":  # two parallel walls: occlusion
        xs, ys = np.meshgrid(np.linspace(-1900, 1900, 90), np.linspace(-900, 900, 45))
        near = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, -500.0)], 1)
        far = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 700.0)], 1)
        v = np.concatenate([near, far]) + 5000
    elif kind == "outside":  # most vertices outside the box
        v = rng.uniform(-40000, 40000, size=(5000, 3))
    else:
        v = np.zeros((0, 3))
    return np.asarray(v, np.float32)


def _locs(v, n, seed):
    rng = np.random.default_rng(seed + 100)
    if len(v) == 0:
        return rng.normal(size=(n, 3)).astype(np.float32) * 1000 + 5000
    return (v[rng.choice(len(v), n)] + rng.normal(size=(n, 3)) * 60).astype(np.float32)


CASES = {  # cloud, locations, rotations, comp_window, ws, nb_views
    "blob_pca_128": ("blob", 20, "pca", 8000.0, (128, 64), 2),
    "blob_pca_256": ("blob", 5, "pca", 8000.0, (256, 128), 2),
    "blob_identity_1view": ("blob", 7, "identity", 4000.0, (128, 64), 1),
    "grid_ties_identity": ("grid", 18, "identity", 8000.0, (128, 64), 2),
    "grid_ties_pca_3views": ("grid", 9, "pca", 40960.0, (128, 64), 3),
    "walls_occlusion": ("walls", 3, "identity", 6000.0, (256, 128), 2),
    "outside": ("outside", 17, "pca", 8000.0, (128, 64), 2),
    "empty_mesh": ("empty", 4, "identity", 8000.0, (128, 64), 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_views_equal_jax(name):
    from syconn_tpu_torch.proc.meshes import calc_rot_matrices

    kind, n_loc, rot, cw, ws, nv = CASES[name]
    seed = sorted(CASES).index(name)
    v = _cloud(kind, seed)
    locs = _locs(v, n_loc, seed)
    rots = calc_rot_matrices(locs, v, cw) if rot == "pca" else None
    with jax.disable_jit():
        dj, ij = J.render_views_splat(v, locs, rots, cw, ws, nv)
    dt, it = T.render_views_splat(v, locs, rots, cw, ws, nv, device="cpu")
    assert dt.shape == dj.shape == (n_loc, nv) + ws and dt.dtype == np.uint8
    assert it.dtype == np.int32
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(it, ij)
    if kind == "empty":
        assert (dt == 255).all() and (it == -1).all()
    else:
        assert (it >= 0).any() and it.max() < len(v)
        assert ((dt == 255) == (it == -1)).all()
    if name == "blob_pca_128":  # jitted JAX renders the same frames
        dj2, ij2 = J.render_views_splat(v, locs, rots, cw, ws, nv)
        np.testing.assert_array_equal(dj2, dj)
        np.testing.assert_array_equal(ij2, ij)


def test_rotations_equal_jax():
    from syconn_tpu.proc.meshes import calc_rot_matrices as jrot
    from syconn_tpu_torch.proc.meshes import calc_rot_matrices as trot

    v = _cloud("blob", 3)
    locs = _locs(v, 30, 3)
    r = trot(locs, v, 8000.0)
    np.testing.assert_array_equal(r, jrot(locs, v, 8000.0))
    for nv in (1, 2, 3):
        np.testing.assert_array_equal(T.view_rotations(r[0], nv), J.view_rotations(r[0], nv))


@pytest.mark.parametrize("nb_views", [1, 2, 3, 4])
def test_fused_columns_follow_xla(nb_views):
    """Per output column of one location's (V, 3) x (3, 3 nb_views) view
    transform, XLA:CPU's result equals either the multiply-then-add chain or
    the fused chain, as ``fused_columns`` says (the renderer's vertex buffer
    holds at least 1024 vertices)."""
    rng = np.random.default_rng(nb_views)
    verts = (rng.normal(size=(1024, 3)) * 3000 + 5000).astype(np.float32)
    centers = (rng.normal(size=(3, 3)) * 1000 + 5000).astype(np.float32)
    rots = np.linalg.qr(rng.normal(size=(3, nb_views, 3, 3)))[0].astype(np.float32)

    def one(c, r):
        return jax.vmap(lambda rot: (verts - c[None]) @ rot.T)(r)

    with jax.disable_jit():
        pj = np.asarray(jax.vmap(one)(jnp.asarray(centers), jnp.asarray(rots)))
    d = torch.from_numpy(verts)[None] - torch.from_numpy(centers)[:, None]
    fused = torch.from_numpy(T.fused_columns(nb_views))
    pt = T._view_frame(d, torch.from_numpy(rots), fused).numpy()
    np.testing.assert_array_equal(pt, pj)


def test_equal_depths_keep_the_largest_index():
    # four vertices on one pixel at one depth, one nearer vertex elsewhere
    v = np.array([[10, 10, 0], [10.2, 10.1, 0], [10.1, 10.3, 0], [10.3, 10.2, 0],
                  [500, 300, -100]], np.float32)
    dj, ij = J.render_views_splat(v, np.zeros((1, 3), np.float32), None, 4000.0, (128, 64), 1)
    dt, it = T.render_views_splat(v, np.zeros((1, 3), np.float32), None, 4000.0, (128, 64), 1,
                                  device="cpu")
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    assert set(np.unique(it)) == {-1, 3, 4}


def test_renderer_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.SplatRenderer(ws=(64, 32), nb_views=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.render_views_splat(np.zeros((4, 3), np.float32), np.zeros((1, 3), np.float32),
                             device="cuda")


def test_render_stats():
    v = _cloud("blob", 5)
    st = {}
    r = T.SplatRenderer(ws=(64, 32), nb_views=2, device="cpu")
    r.render(v, _locs(v, 21, 5), np.tile(np.eye(3, dtype=np.float32), (21, 1, 1)), 8000.0,
             stats=st)
    assert st["render_calls"] == 1 and st["render_frames"] == 42 and st["render_seconds"] > 0


# --- the JAX package's renderer tests, on the port's renderer ---------------

def _splat(*a, **kw):
    return T.render_views_splat(*a, device="cpu", **kw)


def test_reference_depth_view_sphere():
    from test_render import _sphere_points

    center = np.array([5000.0, 5000.0, 5000.0])
    pts = _sphere_points(center, 2000.0)
    depth, index = _splat(pts, center[None], comp_window=8000.0, ws=(128, 64), nb_views=1)
    d = depth[0, 0]
    fg = d < T.BACKGROUND
    assert fg.mean() > 0.1
    assert d[64, 32] < np.percentile(d[fg], 80)
    assert d[0, 0] == T.BACKGROUND
    assert index[0, 0][~fg].max() == -1


def test_reference_zbuffer_occlusion():
    xs, ys = np.meshgrid(np.linspace(-900, 900, 60), np.linspace(-450, 450, 30))
    near = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, -500.0)], 1)
    far = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 500.0)], 1)
    depth, index = _splat(np.concatenate([near, far]), np.zeros((1, 3)), comp_window=2000.0,
                          ws=(64, 32), nb_views=1)
    ix = index[0, 0]
    covered = ix >= 0
    assert covered.mean() > 0.5
    assert ix[covered].max() < len(near)


def test_reference_deterministic_and_rotating():
    from test_render import _sphere_points

    pts = _sphere_points(np.zeros(3), 1000.0)
    locs = np.array([[0.0, 0, 0], [200.0, 0, 0]])
    d1, i1 = _splat(pts, locs, comp_window=4000.0, ws=(64, 32), nb_views=2)
    d2, i2 = _splat(pts, locs, comp_window=4000.0, ws=(64, 32), nb_views=2)
    assert np.array_equal(d1, d2) and np.array_equal(i1, i2)
    ys = np.linspace(-1500, 1500, 5000)
    bar = np.stack([np.zeros_like(ys), ys, np.zeros_like(ys)], 1)
    bar += np.random.default_rng(0).normal(scale=30, size=bar.shape)
    depth, _ = _splat(bar, np.zeros((1, 3)), comp_window=4000.0, ws=(64, 32), nb_views=2)
    assert not np.array_equal(depth[0, 0], depth[0, 1])


def _golden_splat(verts):
    from test_render_golden import WINDOW, WS

    depth, _ = _splat(np.asarray(verts, np.float32), np.zeros((1, 3), np.float32),
                      comp_window=WINDOW, ws=WS, nb_views=1)
    return depth[0, 0]


def test_reference_golden_flat_quad():
    from test_render_golden import WINDOW, WS, _compare, _tessellated_quad, triangle_raster_golden

    z = -20.0
    verts, faces = _tessellated_quad(z)
    splat = _golden_splat(verts)
    golden = triangle_raster_golden(verts, faces, (0.0, 0.0, 0.0), WINDOW, WS)
    expected = int(round((z / WINDOW + 0.5) * 254.0))
    fg = splat != T.BACKGROUND
    assert fg.sum() > 1000 and np.all(splat[fg] == expected)
    _compare(splat, golden)


def test_reference_golden_two_quads():
    from test_render_golden import WINDOW, WS, _compare, _tessellated_quad, triangle_raster_golden

    v1, f1 = _tessellated_quad(-30.0, extent=30.0)
    v2, f2 = _tessellated_quad(10.0, extent=45.0)
    verts = np.concatenate([v1, v2])
    faces = np.concatenate([f1, f2 + len(v1)])
    splat = _golden_splat(verts)
    _compare(splat, triangle_raster_golden(verts, faces, (0.0, 0.0, 0.0), WINDOW, WS))
    assert splat[WS[0] // 2, WS[1] // 2] == int(round((-30.0 / WINDOW + 0.5) * 254.0))


def test_reference_golden_sphere_mesh():
    from test_render_golden import WINDOW, WS, _compare, triangle_raster_golden

    from syconn_tpu_torch.mesh.surface_nets import surface_net_mesh

    r_vx = 24
    n = 2 * r_vx + 8
    g = np.arange(n) - n / 2
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    ind, vert, _ = surface_net_mesh(gx ** 2 + gy ** 2 + gz ** 2 <= r_vx ** 2, scale=(1, 1, 1))
    verts = vert.reshape(-1, 3) - n / 2
    splat = _golden_splat(verts)
    golden = triangle_raster_golden(verts, ind.reshape(-1, 3), (0.0, 0.0, 0.0), WINDOW, WS)
    _compare(splat, golden, max_disagree=0.05, med_tol=3, affected_tol=0.08)
    expected = (-(r_vx) / WINDOW + 0.5) * 254.0
    assert abs(int(splat[WS[0] // 2, WS[1] // 2]) - expected) <= 6


@pytest.mark.parametrize("seed", [0, 1])
def test_semseg2mesh_via_views_equal_jax(seed):
    from syconn_tpu.render.views import semseg2mesh_via_views as jf
    from syconn_tpu_torch.render.views import semseg2mesh_via_views as tf

    index_views = np.array([[0, 1, 2, -1], [0, 0, 1, 2]])
    label_views = np.array([[1, 0, 2, 0], [1, 1, 0, 2]])
    got = tf(index_views, label_views, n_vertices=4, n_classes=3, unpredicted_label=9,
             device="cpu")
    np.testing.assert_array_equal(got, [1, 0, 2, 9])
    rng = np.random.default_rng(seed)
    ix = rng.integers(-1, 300, size=(6, 2, 64, 32)).astype(np.int32)
    lab = rng.integers(0, 3, size=ix.shape)  # many equal counts: first class wins
    for unp in (None, 3):
        np.testing.assert_array_equal(
            tf(ix, lab, 320, 3, unpredicted_label=unp, device="cpu"),
            jf(ix, lab, 320, 3, unpredicted_label=unp))
