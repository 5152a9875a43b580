"""Contact-site detection of the port against the JAX package, on the CPU.

Every output is an integer label or count, so every comparison is
``array_equal`` (tolerance 0). The Pallas kernel runs in interpret mode, as
the JAX package's own tests run it on the CPU; on CPU tensors the port's
kernel wrapper takes its plain PyTorch version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syconn_tpu.ops import contacts as J
from syconn_tpu.ops import contacts_jax as JJ
from syconn_tpu.ops import contacts_pallas as JP
from syconn_tpu_torch.ops import contacts as T
from syconn_tpu_torch.ops import contacts_cuda as TC
from syconn_tpu_torch.ops import contacts_torch as TT


def _blocky(seed, n_labels, grid, block):
    rng = np.random.default_rng(seed)
    return np.kron(rng.integers(0, n_labels, size=grid).astype(np.uint32),
                   np.ones(block, np.uint32))


def _two_cubes():
    seg = np.zeros((40, 40, 24), np.uint32)
    seg[4:18, 10:30, 4:20] = 4
    seg[20:36, 10:30, 4:20] = 9  # 2-voxel gap along x
    return seg


# (segmentation, stencil, tile, K): the inputs of tests/test_kernels_device.py
CASES = {
    "blocky0": (lambda: _blocky(0, 4, (6, 6, 4), (6, 6, 6)), (5, 5, 3), (16, 16, 8), 16),
    "blocky1": (lambda: _blocky(1, 4, (6, 6, 4), (6, 6, 6)), (5, 5, 3), (16, 16, 8), 16),
    "two_cubes": (_two_cubes, (13, 13, 7), (16, 16, 8), 16),
    "overflow_random": (lambda: np.random.default_rng(2).integers(0, 60, size=(24, 24, 16))
                        .astype(np.uint32), (5, 5, 3), (16, 16, 8), 8),
    "blocky3_default_stencil": (lambda: _blocky(3, 5, (10, 10, 6), (6, 6, 6)), (13, 13, 7),
                                (16, 16, 8), 16),
    "overflow_columns": (lambda: _blocky(4, 24, (12, 12, 6), (4, 4, 6)), (13, 13, 7),
                         (16, 16, 8), 8),
}


def _case(name):
    make, stencil, tile, K = CASES[name]
    return make(), stencil, tile, K


@pytest.mark.parametrize("name", ["blocky0", "overflow_random", "blocky3_default_stencil",
                                  "overflow_columns"])
def test_plain_version_matches_pallas_kernel(name):
    """The plain version of the CUDA kernel == ``_detect_cs_pallas`` in
    interpret mode, fed the very triple the JAX ``_pallas_prep`` builds (z
    padded to 128 lanes, windows rounded to 8); compared over the un-padded
    z range, overflow columns (first K labels only) included."""
    seg, stencil, tile, K = _case(name)
    seg_p, offs, cands, overflow, _ = JP._pallas_prep(seg, stencil, tile[:2], K)
    lo_j, hi_j = JP._detect_cs_pallas(jnp.asarray(seg_p), jnp.asarray(offs), jnp.asarray(cands),
                                      stencil, tile[:2], K, True)
    lo_t, hi_t = TC.detect_cs_columns(torch.from_numpy(seg_p), torch.from_numpy(offs),
                                      torch.from_numpy(cands), stencil, tile[:2])
    z = seg.shape[2]
    assert name != "overflow_columns" or overflow.any()
    assert np.array_equal(np.asarray(lo_j)[..., :z], lo_t.numpy()[..., :z])
    assert np.array_equal(np.asarray(hi_j)[..., :z], hi_t.numpy()[..., :z])
    assert lo_t.numpy().any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_detect_cs_cuda_and_torch_match_host_kernels(name):
    """Both device formulations (CPU tensors) == the JAX package's host
    kernel and the port's copy of it, halo gate and overflow patches
    included."""
    seg, stencil, tile, K = _case(name)
    host = J.detect_cs(seg, stencil=np.asarray(stencil, np.int32))
    assert np.array_equal(host, T.detect_cs(seg, stencil=stencil))
    assert np.array_equal(host, TC.detect_cs_cuda(seg, stencil, tile[:2], K, device="cpu"))
    assert np.array_equal(host, TT.detect_cs_torch(seg, stencil, tile, K, device="cpu"))
    assert host.any()


@pytest.mark.parametrize("name", ["blocky3_default_stencil", "overflow_columns"])
def test_detect_cs_cuda_matches_detect_cs_pallas(name):
    seg, stencil, tile, K = _case(name)
    pal = JP.detect_cs_pallas(seg, stencil=stencil, tile_xy=tile[:2], K=K)
    assert np.array_equal(pal, TC.detect_cs_cuda(seg, stencil, tile[:2], K, device="cpu"))


def test_two_cubes_partners():
    packed = TC.detect_cs_cuda(_two_cubes(), (13, 13, 7), (16, 16), 16, device="cpu")
    lo, hi = T.cs_pair_unpack(packed[packed != 0])
    assert set(lo.tolist()) == {4} and set(hi.tolist()) == {9}
    assert np.array_equal(T.cs_pair_pack(lo, hi), packed[packed != 0])


@pytest.mark.parametrize("kernel", ["cuda", "torch", "auto"])
def test_cs_dispatcher_matches_host(kernel):
    """Dispatch/fetch round trip on the K=8 overflow input of
    ``test_cs_dispatcher_pallas_path``; two handles in flight."""
    seg, stencil, tile, K = _case("overflow_columns")
    host = J.detect_cs(seg)
    d = TT.CsDispatcher(stencil=stencil, tile=tile, K=K, kernel=kernel, device="cpu")
    assert d.kernel == ("torch" if kernel == "auto" else kernel)
    h1, h2 = d.dispatch(seg), d.dispatch(seg[:, ::-1].copy())
    assert np.array_equal(host, d.fetch(h1))
    assert np.array_equal(J.detect_cs(seg[:, ::-1].copy()), d.fetch(h2))
    assert 0 < d.n_overflow <= d.n_columns
    with pytest.raises(ValueError, match="2\\*\\*31"):
        d.dispatch(np.full((16, 16, 8), 2**31, np.uint64))


@pytest.mark.parametrize("name", ["blocky0", "two_cubes", "overflow_random"])
def test_detect_cs_device_matches_jax(name):
    """The per-tile formulation: partners and overflow flags."""
    seg, stencil, tile, K = _case(name)
    p_j, o_j = JJ.detect_cs_device(jnp.asarray(seg.astype(np.int32)), stencil, tile, K)
    p_t, o_t = TT.detect_cs_device(torch.from_numpy(seg.astype(np.int32)), stencil, tile, K)
    assert np.array_equal(np.asarray(o_j), o_t.numpy())
    assert name != "overflow_random" or o_t.any()
    assert np.array_equal(np.asarray(p_j), p_t.numpy())  # overflowing tiles included
    assert p_t.numpy().any()


@pytest.mark.parametrize("cap_divisor", [8, 10**9])
def test_resident_cs_detector_matches_jax(cap_divisor):
    """Sparse readback, and (with a huge divisor on a small chunk: cap 1024
    < contact voxels) the dense route; boundary chunks included."""
    seg = np.zeros((70, 40, 30), np.int32)
    seg[2:33, 3:37, 2:28] = 7
    seg[35:68, 3:37, 2:28] = 9
    seg[20:50, 3:37, 2:6] = 11
    chunk, stencil, tile = (32, 40, 30), (5, 5, 3), (16, 16, 8)
    dj = JJ.ResidentCsDetector(jnp.asarray(seg), chunk, stencil, tile, K=8, cap_divisor=cap_divisor)
    dt = TT.ResidentCsDetector(torch.from_numpy(seg), chunk, stencil, tile, K=8,
                               cap_divisor=cap_divisor)
    assert dj.cap == dt.cap and dj.grid == dt.grid
    dense = 0
    for cix in [(0, 0, 0), (1, 0, 0), (2, 0, 0)]:
        pj, oj = dj.fetch(dj.dispatch(cix))
        pt, ot = dt.fetch(dt.dispatch(cix))
        assert oj == (ot > 0) and pj.shape == pt.shape
        assert np.array_equal(pj, pt)
        dense += int((pt != 0).sum() > dt.cap)
    assert (dense > 0) == (cap_divisor > 8)


@pytest.mark.parametrize("name", sorted(CASES))
def test_columns_device_prep_matches_host_prep(name):
    """The column tables built in tensor ops == each column window's
    ascending labels from numpy (the first K, overflow where more), and the
    column route == the host kernel outside the overflowing columns."""
    seg, stencil, tile, K = _case(name)
    seg_p, offs, cands, overflow = TT.column_tables(torch.from_numpy(seg.astype(np.int32)),
                                                    stencil, tile[:2], K)
    h = [s // 2 for s in stencil]
    out_shape = np.array(seg.shape) - 2 * np.array(h)
    grid = -(-out_shape[:2] // np.array(tile[:2]))
    assert tuple(seg_p.shape) == (grid[0] * tile[0] + 2 * h[0], grid[1] * tile[1] + 2 * h[1],
                                  seg.shape[2])
    want_offs = [(i * tile[0], j * tile[1]) for i in range(grid[0]) for j in range(grid[1])]
    assert offs.tolist() == [list(o) for o in want_offs]
    sp = seg_p.numpy()
    for g, (x0, y0) in enumerate(want_offs):
        u = np.unique(sp[x0:x0 + tile[0] + 2 * h[0], y0:y0 + tile[1] + 2 * h[1]])
        u = u[u != 0]
        want = np.full(K, 2**31 - 1, np.int32)
        want[:min(K, len(u))] = u[:K]
        assert bool(overflow[g]) == (len(u) > K)
        assert np.array_equal(cands[g].numpy(), want)
    p, o = TT.detect_cs_columns_device(torch.from_numpy(seg.astype(np.int32)), stencil,
                                       tile[:2], K)
    assert np.array_equal(o.numpy().reshape(-1), overflow.numpy())
    assert tuple(p.shape) == tuple(out_shape) + (2,)
    got = TT._pack(p.numpy())
    host = J.detect_cs(seg, stencil=np.asarray(stencil, np.int32))
    keep = ~np.kron(o.numpy(), np.ones(tile[:2], bool))[:out_shape[0], :out_shape[1]]
    assert np.array_equal(got[keep], host[keep])
    assert name != "overflow_columns" or o.any()


@pytest.mark.parametrize("K", [8, 2])
def test_resident_cs_detector_column_route(K):
    """``kernel="cuda"`` (on CPU tensors the kernel's plain version) reads
    back what the per-tile route does, its overflowing columns recomputed by
    the host kernel from the chunk's window."""
    seg = np.zeros((70, 40, 30), np.int32)
    seg[2:33, 3:37, 2:28] = 7
    seg[35:68, 3:37, 2:28] = 9
    seg[20:50, 3:37, 2:6] = 11
    chunk, stencil, tile = (32, 40, 30), (5, 5, 3), (16, 16, 8)
    dc = TT.ResidentCsDetector(torch.from_numpy(seg), chunk, stencil, tile, K=K, kernel="cuda")
    dt = TT.ResidentCsDetector(torch.from_numpy(seg), chunk, stencil, tile, K=8)
    assert dc.kernel == "cuda" and dt.kernel == "torch"
    flagged = contacts = 0
    for cix in [(0, 0, 0), (1, 0, 0), (2, 0, 0)]:
        pc, oc = dc.fetch(dc.dispatch(cix))
        pt, ot = dt.fetch(dt.dispatch(cix))
        flagged += oc
        contacts += int((pt != 0).sum())
        assert ot == 0 and np.array_equal(pc, pt)
    assert contacts > 0 and (flagged > 0) == (K == 2)
    assert dc.n_overflow == flagged and dc.n_columns == 3 * 6


def test_host_helpers_match_jax_package():
    """The copied numpy/scipy helpers: boundaries, properties, pair counts,
    merges, morphology and the per-contact synapse statistics."""
    from syconn_tpu.ops import morphology as JM
    from syconn_tpu.ops import props as JPr
    from syconn_tpu_torch.ops import morphology as TM
    from syconn_tpu_torch.ops import props as TP

    rng = np.random.default_rng(5)
    seg = _blocky(5, 6, (5, 5, 4), (6, 6, 5))
    assert np.array_equal(J.detect_seg_boundaries(seg), T.detect_seg_boundaries(seg))
    assert np.array_equal(J._detect_seg_boundaries_np(seg), T._detect_seg_boundaries_np(seg))
    for a, b in zip(JPr.object_properties_arrays(seg), TP.object_properties_arrays(seg)):
        assert np.array_equal(a, b)
    other = rng.integers(0, 3, seg.shape).astype(np.uint32)
    for a, b in zip(JPr.pair_counts(seg, other), TP.pair_counts(seg, other)):
        assert np.array_equal(a, b)
    parts = [JPr.object_properties_arrays(seg[:15]), JPr.object_properties_arrays(seg[15:])]
    offs = [(0, 0, 0), (15, 0, 0)]
    for a, b in zip(JPr.merge_prop_arrays(parts, offs), TP.merge_prop_arrays(parts, offs)):
        assert np.array_equal(a, b)
    assert JPr.find_object_properties(seg)[2] == TP.find_object_properties(seg)[2]

    struct = JM.get_aniso_struct((10, 10, 20))
    assert np.array_equal(struct, TM.get_aniso_struct((10, 10, 20)))
    cs = J.detect_cs(seg, stencil=np.asarray((5, 5, 3), np.int32))
    for op in ("binary_closing", "binary_dilation"):
        assert np.array_equal(JM.multi_mop_backgroundonly(op, cs, 2, struct),
                              TM.multi_mop_backgroundonly(op, cs, 2, struct))
    mask = rng.random((20, 20, 12)) < 0.4
    ops = ["binary_opening", "binary_closing"]
    assert np.array_equal(JM.apply_morphological_operations(mask, ops, struct=struct),
                          TM.apply_morphological_operations(mask, ops, struct=struct))

    sj = (rng.random(cs.shape) < 0.5).astype(np.uint8)
    sym = (rng.random(cs.shape) < 0.3).astype(np.uint8)
    rj = J.extract_cs_syntype(cs, sj, sym, 1 - sym, offset=(3, 4, 5))
    rt = T.extract_cs_syntype(cs, sj, sym, 1 - sym, offset=(3, 4, 5))
    for (a_rep, a_bb, a_sz), (b_rep, b_bb, b_sz) in zip(rj[:2], rt[:2]):
        assert a_sz == b_sz and a_sz
        assert all(np.array_equal(a_rep[k], b_rep[k]) and np.array_equal(a_bb[k], b_bb[k])
                   for k in a_sz)
    assert rj[2] == rt[2] and rj[3] == rt[3]
    assert rj[4].keys() == rt[4].keys()
    assert all(np.array_equal(rj[4][k], rt[4][k]) for k in rj[4])


def test_kernel_wrapper_rejects_what_it_does_not_take():
    seg = torch.zeros((20, 20, 8), dtype=torch.int32)
    offs = torch.zeros((1, 2), dtype=torch.int32)
    cands = torch.full((1, 4), 2**31 - 1, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        TC.detect_cs_columns(seg.long(), offs, cands, (5, 5, 3), (16, 16))
    with pytest.raises(ValueError, match="odd"):
        TC.detect_cs_columns(seg, offs, cands, (4, 5, 3), (16, 16))
    with pytest.raises(ValueError, match="cands"):
        TC.detect_cs_columns(seg, offs, cands[0], (5, 5, 3), (16, 16))
    lo, hi = TC.detect_cs_columns(seg, offs, cands, (5, 5, 3), (16, 16))
    assert lo.shape == (1, 16, 16, 8) and not lo.any() and not hi.any()


@pytest.mark.parametrize("stencil,ok", [((13, 13, 7), True), ((5, 5, 3), True),
                                        ((17, 17, 9), False), ((37, 3, 7), False)])
def test_kernel_wrapper_guards_the_packed_lane_widths(stencil, ok):
    """The packed kernel sums z then x in byte lanes (sz*sx <= 255) and the
    whole window in 16-bit lanes beside a 5-bit slot (sx*sy*sz <= 2047): the
    wrapper rejects a stencil past either, on every device, and the C
    launcher states the same limits."""
    import os
    import re

    seg = torch.zeros((48, 48, 12), dtype=torch.int32)
    seg[:20] = 5
    seg[20:] = 9
    offs = torch.zeros((1, 2), dtype=torch.int32)
    cands = torch.tensor([[5, 9, 2**31 - 1, 2**31 - 1]], dtype=torch.int32)
    if ok:
        lo, hi = TC.detect_cs_columns(seg, offs, cands, stencil, (8, 8))
        assert lo.shape == (1, 8, 8, 12)
    else:
        with pytest.raises(ValueError, match="packed counters"):
            TC.detect_cs_columns(seg, offs, cands, stencil, (8, 8))
    src = open(os.path.join(os.path.dirname(TC.__file__), "csrc", "contacts.cu")).read()
    for name, value in (("MAX_K", TC.MAX_K), ("MAX_TILE", TC.MAX_TILE),
                        ("MAX_BYTE", TC.MAX_ZX_SUM), ("MAX_COUNT", TC.MAX_COUNT)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert TC.MAX_COUNT << 5 < 1 << 16 and TC.MAX_K <= 32
