"""Model family ``unet3d``: the port's patchified 3D U-Net
(``syconn_tpu_torch.models.unet3d.UNet3D``, run by ``models/unet_engine.py``
on the kernels of ``ops/csrc/conv3d_wgmma.cu`` and ``conv3d.cu``).

A configuration's ``arch`` holds ``features``, ``strides``, ``patch`` and
``n_classes``. The yardstick stays where it was: the weights of
``lib/inputs.py`` (a flax-layout tree), the plain U-Net of
``reference/unet.py`` and the counts of ``lib/frozen.py``.
"""

from __future__ import annotations

from perfbench.lib import frozen, inputs
from perfbench.reference import unet3d as reference

make_params = inputs.make_params
reference_forward = reference.forward
flops = frozen.unet_flops
conv_launches = frozen.conv_launches
CONV_KERNELS = frozen.CONV_KERNELS


def program_model(arch: dict, params: dict, device):
    """The port's ``UNet3D`` and its weights as the flax tree of numpy arrays
    that the dense predictors and the step-1 entries take."""
    from syconn_tpu_torch.models.unet3d import UNet3D

    model = UNet3D(features=arch["features"], strides=arch["strides"], patch=arch["patch"],
                   n_classes=arch["n_classes"])
    return model, inputs.host_tree(params)
