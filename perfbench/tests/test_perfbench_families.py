"""Model families: the ``unet3d`` family gives the weights, counts and
reference bytes that the harness had before model families; a stand-in
family with keys, weights, reference and counts of its own
(``standin_family.py``) runs a whole cell through the harness, and a fault
planted in its program side fails the check; an unknown family fails when
the cell is resolved; outside the families and the files that define the
U-Net's code, the harness names none of it."""

import ast
import copy
import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from _perfbench_names import BENCH, CONFIG, CONFIGS, FAMILY, UNET3D_CELLS, UNET3D_CONFIGS
from perfbench.lib import frozen, harness, inputs, readers
from perfbench.lib import trace as tr
from perfbench.reference import dense as ref_dense
from perfbench.reference import unet as ref_unet

HERE = os.path.dirname(os.path.abspath(__file__))

# SHA-256 of the weight tree that ``inputs.make_params`` drew on the CPU at
# each seed before model families existed
PINNED_SEEDS = (2**31 + 29, 5)
PINNED = {
    "syntype": ("b9525a0c6a6bdf5a0eea089e431312191bbc4f7db94c78da4fea38c037f90d96",
                "3fe187981396a862d944ea552c2a74e50162d4dd114f3b3940c7557dd2fd426c"),
    "organelles": ("897e66541ba3f6622f71f7d56f0caf456d53d63d61c824e2ca4ac5d9d9b137ad",
                   "2faaebf4ead7a36521f5294fac5e58e281ca347f7d8650a52f07b89a03c616ec"),
}


def tree_sha(tree) -> str:
    h = hashlib.sha256()

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                h.update("/".join(path + (k,)).encode())
                h.update(repr(tuple(v.shape)).encode())
                h.update(v.detach().cpu().contiguous().numpy().tobytes())

    walk(tree, ())
    return h.hexdigest()


def _family(root, config):
    cell = next(w["name"] for w in BENCH["workloads"] if w["config"] == config)
    return harness.Cell(root, cell).family


@pytest.mark.parametrize("config", CONFIGS)
def test_weights_keep_their_draw(root, config):
    family = _family(root, config)
    arch = CONFIG[config]["arch"]
    shas = [tree_sha(family.make_params(arch, s, "cpu")) for s in PINNED_SEEDS]
    assert shas[0] != shas[1]
    assert tree_sha(family.make_params(arch, PINNED_SEEDS[0], "cpu")) == shas[0]
    if FAMILY[config] == "unet3d":
        assert shas == [tree_sha(inputs.make_params(arch, s, "cpu")) for s in PINNED_SEEDS]
    if config in PINNED:
        assert tuple(shas) == PINNED[config]


def _window(root, workload):
    cell = harness.Cell(root, workload)
    return [int(t) + 2 * int(h) for t, h in zip(cell.config["tile"], cell.config["halo"])]


@pytest.mark.parametrize("workload", UNET3D_CELLS)
def test_unet3d_counts_are_the_frozen_yardstick(root, workload, unet3d):
    cell = harness.Cell(root, workload)
    win = _window(root, workload)
    for b in (1, 4):
        assert cell.family.flops(cell.arch, [b] + win) == frozen.unet_flops(cell.arch, [b] + win)
        assert cell.family.conv_launches(cell.arch, [b] + win) == \
            frozen.conv_launches(cell.arch, [b] + win)
    assert cell.family.CONV_KERNELS == frozen.CONV_KERNELS
    assert cell.family.reference_forward is unet3d.reference_forward


def _old_predict_tile(arch, params, vol, offset, tile, halo, precision):
    """``reference/dense.py::predict_tile`` before model families: the
    U-Net's logits, cut to the tile in packed coordinates, then the
    probabilities."""
    ref_unet.set_precision()
    patch = [int(p) for p in arch["patch"]]
    lg = ref_unet.logits_packed(arch, params, ref_dense.window(vol, offset, tile, halo),
                                precision)
    hp = [int(h) // p for h, p in zip(halo, patch)]
    tp = [int(t) // p for t, p in zip(tile, patch)]
    lg = lg[:, hp[0]:hp[0] + tp[0], hp[1]:hp[1] + tp[1], hp[2]:hp[2] + tp[2]]
    probs = ref_unet.probs_u8(arch, lg)
    ext = tuple(min(int(t), int(n) - int(o)) for t, n, o in zip(tile, vol.shape, offset))
    return ext, probs[:, :ext[0], :ext[1], :ext[2]]


def _same_bytes_as_before(family, arch, vol, tile, halo, offsets, device):
    params = family.make_params(arch, 2**31 + 31, device)
    for off in offsets:
        for precision in ("f32", "fp8"):
            ext, new = ref_dense.predict_tile(
                lambda w, p: family.reference_forward(arch, params, w, p), vol, off, tile, halo,
                precision)
            old_ext, old = _old_predict_tile(arch, params, vol, off, tile, halo, precision)
            assert ext == old_ext and new.dtype == torch.uint8
            assert torch.equal(new, old), (off, precision)


@pytest.mark.parametrize("config", UNET3D_CONFIGS)
def test_reference_through_the_family_gives_the_earlier_bytes(config, unet3d, small):
    torch.set_num_threads(2)
    tile, halo = small["config"]["tile"], small["config"]["halo"]
    vol = inputs.em_volume(small["traffic"]["volume"], 3, "cpu")
    # an inner tile and the corner that the volume cuts
    offsets = [(32, 0, 0), ref_dense.tile_offsets(vol.shape, tile)[-1]]
    _same_bytes_as_before(unet3d, CONFIG[config]["arch"], vol, tile, halo, offsets, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", UNET3D_CELLS)
def test_reference_through_the_family_gives_the_earlier_bytes_at_the_cells_size(
        root, workload, unet3d, card):
    cell = harness.Cell(root, workload)
    vol = inputs.em_volume([int(v) for v in cell.traffic["volume"]], 2**31 + 37, card)
    offsets = ref_dense.tile_offsets(vol.shape, cell.config["tile"])
    _same_bytes_as_before(unet3d, cell.arch, vol, cell.config["tile"], cell.config["halo"],
                          [offsets[0], offsets[len(offsets) // 2], offsets[-1]], card)


# ------------------------------------------------------------- the stand-in

STANDIN = "standin"
STANDIN_ARCH = {"width": 8, "fold": [2, 2, 2], "classes": 4}


def _standin_root(tmp_path, monkeypatch):
    """A checkout under ``tmp_path`` whose ``families/`` also holds the
    stand-in, with the harness reading it."""
    pb = tmp_path / "perfbench"
    for sub in ("traffic", "routes", "metrics", "limits", "families", "configs"):
        shutil.copytree(os.path.join(harness.BENCH_DIR, sub), pb / sub)
    shutil.copy(os.path.join(HERE, "standin_family.py"), pb / "families" / f"{STANDIN}.py")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    monkeypatch.setattr(harness, "BENCH_DIR", str(pb))
    return str(tmp_path)


def _standin_overrides(small, family=STANDIN):
    ov = copy.deepcopy(small)
    ov["config"].update(family=family, arch=dict(STANDIN_ARCH))
    return ov


def _run(root, workload, overrides):
    torch.set_num_threads(2)
    return harness.run(root, workload, 2**31 + 41, 0.3, False, device="cpu",
                       overrides=overrides, log=lambda m: None)


def test_standin_reference_agrees_with_the_port(root, tmp_path, monkeypatch):
    """The stand-in's own reference against its program side: the port's
    one-level U-Net on the weights ``program_model`` converts."""
    from syconn_tpu_torch.models.convert import module_state_from_flax

    fam = harness.Cell(_standin_root(tmp_path, monkeypatch), "organelles.device",
                       _standin_overrides({"config": {}})).family
    params = fam.make_params(STANDIN_ARCH, 7, "cpu")
    model, tree = fam.program_model(STANDIN_ARCH, params, "cpu")
    model.load_state_dict(module_state_from_flax(tree))
    x = inputs.em_volume((16, 16, 8), 5, "cpu")
    with torch.no_grad():
        lg = model(x[None, ..., None], full_res=False)[0].float()    # (sx, sy, sz, C * pvox)
    p = torch.softmax(lg.reshape(8, 8, 4, 4, 8), dim=3)
    port = torch.round(p * 255.0).to(torch.uint8).reshape(8, 8, 4, 4, 2, 2, 2)
    port = port.permute(3, 0, 4, 1, 5, 2, 6).reshape(4, 16, 16, 8)
    ref = fam.reference_forward(STANDIN_ARCH, params, x, "f32")
    gap = (port.int() - ref.int()).abs()
    assert int(gap.max()) <= 3 and float(gap.float().mean()) < 0.5
    low = fam.reference_forward(STANDIN_ARCH, params, x, "fp8")
    assert float((low.int() - ref.int()).abs().float().mean()) > 2 * float(gap.float().mean())


@pytest.mark.parametrize("workload", ["organelles.device", "organelles.store"])
def test_standin_family_runs_a_whole_cell(tmp_path, monkeypatch, small, workload):
    root = _standin_root(tmp_path, monkeypatch)
    cell = harness.Cell(root, workload, _standin_overrides(small))
    assert cell.family.__name__ == f"perfbench_family_{STANDIN}"
    assert not {"features", "strides", "patch", "n_classes"} & set(cell.arch)
    r = _run(root, workload, _standin_overrides(small))
    assert r["correct"] and r["failed"] == 0, r["limits"]
    assert r["window"]["tiles_compared"] == 12


def test_standin_fault_in_its_program_side_fails(tmp_path, monkeypatch, small):
    """The stand-in's conversion swaps the in and out channels of its second
    conv's kernel (both 8 wide, so the program runs)."""
    root = _standin_root(tmp_path, monkeypatch)
    real = harness.load_module

    def load(path, name):
        mod = real(path, name)
        if name == f"perfbench_family_{STANDIN}":
            sound = mod.program_model

            def swapped(arch, params, device):
                model, tree = sound(arch, params, device)
                conv = tree["ConvBlock_0"]["Conv_1"]
                conv["kernel"] = np.ascontiguousarray(conv["kernel"].swapaxes(3, 4))
                return model, tree

            mod.program_model = swapped
        return mod

    monkeypatch.setattr(harness, "load_module", load)
    r = _run(root, "organelles.device", _standin_overrides(small))
    assert not r["correct"]


def test_unknown_family_fails_at_resolution(root, small):
    with pytest.raises(ValueError, match=r"'nosuchnet'.*perfbench/families/nosuchnet\.py"):
        harness.Cell(root, "organelles.device", _standin_overrides(small, "nosuchnet"))


class _Ctx:
    """A synthetic stretch of one pass of two forwards of batch 2 and 1."""

    def __init__(self, family, arch, trace):
        self.family, self.arch, self.trace_data = family, arch, trace
        self.window_shape = [48, 48, 24]
        self.stretch_spans = [dict(name="forward_on", t0=0, t1=1, batch=b) for b in (2, 1)]
        self.stretch_passes, self.tiles_per_pass = 1, 3
        self.card_indices, self.n_cards = [0], 1
        self.pass_seconds, self.traced_passes = [0.5, 0.9, 0.5], [1]
        self.device = torch.device("cuda", 0)


def test_readers_take_the_families_counts(tmp_path, monkeypatch, small):
    root = _standin_root(tmp_path, monkeypatch)
    fam = harness.Cell(root, "organelles.device", _standin_overrides(small)).family
    launches = [x for b in (2, 1) for x in fam.conv_launches(STANDIN_ARCH, [b, 48, 48, 24])]
    assert len(launches) == 4 and all(x["flops"] > 0 and x["bytes"] > 0 for x in launches)
    ev = [dict(name="conv3d_wgmma_kernel", cat="kernel", ts=float(i), dur=2.0, device=0)
          for i in range(0, 8, 2)]
    ctx = _Ctx(fam, STANDIN_ARCH, tr.Trace(ev, 0.0, 100.0, 0))
    bound = sum(frozen.launch_bound_s(x) for x in launches)
    assert readers.conv_roofline(ctx) == pytest.approx(100.0 * bound / 8e-6)
    mfu = fam.flops(STANDIN_ARCH, [1, 48, 48, 24]) * 3 * 2 / 1.0 / frozen.PEAK_FLOPS * 100
    assert readers.step_mfu(ctx) == pytest.approx(mfu)
    # the U-Net's plan has other launches: the stand-in's trace does not fit it
    ctx.family = harness.Cell(root, "organelles.device").family
    ctx.arch = CONFIG["organelles"]["arch"]
    assert readers.conv_roofline(ctx) is None


# ------------------------------------------------------ no U-Net code outside

UNET_NAMES = {"UNet3D", "make_params", "param_leaves", "unet_flops", "conv_launches",
              "logits_packed", "probs_u8", "host_tree"}
UNET_MODULES = {"unet", "unet3d", "unet_engine"}
# the files that define the U-Net's weights, counts and reference
DEFINING = {"lib/inputs.py", "lib/frozen.py", "reference/unet.py", "reference/unet3d.py"}


def _unet_uses(path):
    """Each use of the U-Net's names in ``path``'s code (docstrings and
    comments aside) that is not a call through a model family."""
    out = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Name) and node.id in UNET_NAMES:
            out.append((node.lineno, node.id))
        elif isinstance(node, ast.Attribute) and node.attr in UNET_NAMES:
            owner = node.value
            owner = owner.attr if isinstance(owner, ast.Attribute) else getattr(owner, "id", "")
            if owner != "family":
                out.append((node.lineno, node.attr))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            base = getattr(node, "module", None) or ""
            for a in node.names:
                full = f"{base}.{a.name}" if base else a.name
                if a.name in UNET_NAMES or set(full.split(".")) & UNET_MODULES:
                    out.append((node.lineno, full))
    return out


def test_only_the_families_name_the_unets_code():
    found = {}
    for d, _, files in os.walk(harness.BENCH_DIR):
        rel = os.path.relpath(d, harness.BENCH_DIR)
        if rel.split(os.sep)[0] in ("families", "tests"):
            continue
        for f in files:
            path = os.path.join(d, f)
            name = os.path.normpath(os.path.join(rel, f)).replace(os.sep, "/")
            if f.endswith(".py") and name not in DEFINING and _unet_uses(path):
                found[name] = _unet_uses(path)
    assert not found, found
    # the scan does see a direct use
    assert _unet_uses(os.path.join(HERE, "test_perfbench_reference.py"))
