"""Device selection for the port (counterpart of ``syconn_tpu/utils/jaxcfg.py``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a card and without an explicit CPU request they raise instead of quietly
running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_reference_precision() -> None:
    """Full-f32 matmuls and convolutions for reference runs: cuDNN convs
    default to TF32 (about three decimal digits)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def default_device(device: DeviceLike = None) -> torch.device:
    """Resolve ``device``: ``None`` means the (single) CUDA card, which must
    exist; an explicit device is checked and returned."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        device = torch.device("cuda")
    else:
        device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        set_reference_precision()
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
