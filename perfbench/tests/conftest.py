"""perfbench's own tests: the harness, the reference, the control and the
faults the check must catch, at sizes a CPU holds."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# small shapes for CPU runs of a cell: tile and halo keep every U-Net
# extent divisible by its patch and strides
SMALL = {"config": {"tile": [32, 32, 16], "halo": [8, 8, 4]},
         "traffic": {"volume": [72, 40, 24], "judge_tiles": 0}}


@pytest.fixture()
def small():
    return SMALL


@pytest.fixture()
def root():
    return ROOT


@pytest.fixture()
def unet3d():
    """The ``unet3d`` model family's module."""
    from perfbench.lib import harness

    return harness.load_module(os.path.join(harness.BENCH_DIR, "families", "unet3d.py"),
                               "perfbench_family_unet3d")


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
