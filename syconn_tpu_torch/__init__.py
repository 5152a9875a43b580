"""PyTorch/CUDA port of syconn_tpu for NVIDIA Hopper.

Mirrors the JAX package's module layout; every Pallas kernel on a ported
path has a hand-written CUDA counterpart under ``ops/csrc``. The package
imports torch, numpy, scipy and the standard library only.
"""

__version__ = "0.1.0"

from . import global_params  # noqa: F401,E402
