"""nnU-Net's 3d_fullres network, ``PlainConvUNet`` (Isensee et al., *nnU-Net*,
Nat. Methods 18:203-211, 2021; MIC-DKFZ ``dynamic_network_architectures``),
as a model of the port's dense step.

The network, per encoder stage s with width f_s and stride t_s:
``h = LReLU(IN(conv3(h, stride t_s, pad 1) + b))``, then ``h =
LReLU(IN(conv3(h, stride 1, pad 1) + b))``, kept as the skip. Up the decoder,
per level s from the deepest: ``u = ConvTranspose3d(h, kernel 2, stride 2) +
b``, ``h = cat(u, skip_s)``, then two conv-IN-LReLU at width f_s. A 1x1x1 conv
to the classes is the head (deep supervision is training-only). IN is
``InstanceNorm3d(affine=True, eps)``, LReLU has ``slope``.

The input is the raw uint8 window, z-scored with the dataset's intensity
mean and std (nnU-Net's ``ZScoreNormalization`` of a whole image, held as
constants). A window whose extents are not multiples of the total stride
(``divisor``) is zero-padded on the high side after normalisation and the
logits cropped back, as nnU-Net's predictor pads an image smaller than its
patch.

:class:`NNUNet` plays the part :class:`~.unet3d.UNet3D` plays for the dense
predictor: ``n_classes``, ``patch`` (1, 1, 1: one logit a class and voxel)
and the parameter layout its engine (``models/nnunet_engine.py``) takes. Its
parameters are a flat dict of float32 arrays named as PlainConvUNet's state
dict (without its ``all_modules`` and ``decoder.encoder`` aliases, and of the
deep-supervision heads only the last, the one inference uses), in PyTorch's
layouts: conv weights (out, in, 3, 3, 3), transposed conv weights (in, out,
2, 2, 2), the head (classes, f_0, 1, 1, 1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["NNUNet"]


class NNUNet:
    """nnU-Net's ``PlainConvUNet`` of one configuration.

    Args:
        features: widths of the stages, (32, 64, 128, 256, 320, 320) in the
            3d_fullres plan of an isotropic dataset.
        strides: each stage's stride, (1, 1, 1) then (2, 2, 2); the engine
            runs strides 1 and 2.
        n_classes: output classes.
        norm_eps, leaky_slope: InstanceNorm's eps, LeakyReLU's slope.
        intensity_mean, intensity_std: the z-score of the input voxels.

    Every stage has two convs, as in every nnU-Net plan, of 3x3x3 kernels;
    the input is the one EM raw channel.
    """

    patch: Tuple[int, int, int] = (1, 1, 1)
    in_channels = 1

    def __init__(self, features: Sequence[int] = (32, 64, 128, 256, 320, 320),
                 strides: Sequence[Sequence[int]] = ((1, 1, 1),) + ((2, 2, 2),) * 5,
                 n_classes: int = 4, norm_eps: float = 1e-5, leaky_slope: float = 0.01,
                 intensity_mean: float = 0.0, intensity_std: float = 1.0):
        self.features = tuple(int(f) for f in features)
        self.strides = tuple(tuple(int(s) for s in st) for st in strides)
        self.n_classes = int(n_classes)
        self.norm_eps = float(norm_eps)
        self.leaky_slope = float(leaky_slope)
        self.intensity_mean = float(intensity_mean)
        self.intensity_std = float(intensity_std)
        if len(self.strides) != len(self.features):
            raise ValueError("one stride a stage")
        if self.intensity_std <= 0:
            raise ValueError("intensity_std must be positive")

    @classmethod
    def from_arch(cls, arch: dict) -> "NNUNet":
        """From a configuration's ``arch`` (the keys of
        ``perfbench/configs/nnunet_fullres.json``), which must name what the
        class fixes: 3x3x3 kernels, two convs a stage, one input channel."""
        if int(arch.get("kernel", 3)) != 3:
            raise ValueError("the engine runs 3x3x3 kernels")
        if (int(arch.get("convs_per_stage", 2)), int(arch.get("convs_per_stage_decoder", 2))) \
                != (2, 2):
            raise ValueError("the engine runs two convs a stage")
        if int(arch.get("in_channels", 1)) != cls.in_channels:
            raise ValueError("the dense step feeds one raw channel")
        return cls(features=arch["features"], strides=arch["strides"],
                   n_classes=arch["n_classes"], norm_eps=arch.get("norm_eps", 1e-5),
                   leaky_slope=arch.get("leaky_slope", 0.01),
                   intensity_mean=arch.get("intensity_mean", 0.0),
                   intensity_std=arch.get("intensity_std", 1.0))

    @property
    def depth(self) -> int:
        return len(self.features)

    @property
    def divisor(self) -> Tuple[int, int, int]:
        """Per axis the product of the strides: the extents the network takes
        without padding."""
        return tuple(int(np.prod([s[a] for s in self.strides])) for a in range(3))

    def padded_shape(self, shape: Sequence[int]) -> Tuple[int, int, int]:
        """Spatial extents rounded up to multiples of :attr:`divisor`."""
        return tuple(-(-int(n) // d) * d for n, d in zip(shape, self.divisor))

    def param_shapes(self) -> List[Tuple[str, Tuple[int, ...], str]]:
        """Every parameter: (name, shape, kind), kind one of ``conv``,
        ``bias``, ``norm_weight``, ``norm_bias``, ``transpconv``, ``head``."""
        out: List[Tuple[str, Tuple[int, ...], str]] = []
        f = self.features

        def block(prefix, cin, cout):
            for j in range(2):
                c = f"{prefix}.convs.{j}"
                out.append((f"{c}.conv.weight", (cout, cin if j == 0 else cout, 3, 3, 3), "conv"))
                out.append((f"{c}.conv.bias", (cout,), "bias"))
                out.append((f"{c}.norm.weight", (cout,), "norm_weight"))
                out.append((f"{c}.norm.bias", (cout,), "norm_bias"))

        cin = self.in_channels
        for s, c in enumerate(f):
            block(f"encoder.stages.{s}.0", cin, c)
            cin = c
        for k in range(self.depth - 1):
            s = self.depth - 2 - k
            out.append((f"decoder.transpconvs.{k}.weight", (f[s + 1], f[s], 2, 2, 2),
                        "transpconv"))
            out.append((f"decoder.transpconvs.{k}.bias", (f[s],), "bias"))
            block(f"decoder.stages.{k}", 2 * f[s], f[s])
        k = self.depth - 2
        out.append((f"decoder.seg_layers.{k}.weight", (self.n_classes, f[0], 1, 1, 1), "head"))
        out.append((f"decoder.seg_layers.{k}.bias", (self.n_classes,), "bias"))
        return out

    def init_params(self, seed: int = 0):
        """Seeded float32 weights in the layout of :meth:`param_shapes`: conv
        and transposed-conv kernels He normal (std sqrt(2 / fan-in), nnU-Net's
        LeakyReLU init), the head lecun normal, biases and norm shifts
        N(0, 0.1), norm scales 1 + N(0, 0.1). Stands in for a trained
        checkpoint (``checkpoint_final.pth``'s ``network_weights``)."""
        rng = np.random.default_rng(seed)
        out = {}
        for name, shape, kind in self.param_shapes():
            v = rng.standard_normal(shape, dtype=np.float32)
            if kind == "conv":
                v *= np.float32(np.sqrt(2.0 / np.prod(shape[1:])))
            elif kind == "transpconv":
                v *= np.float32(np.sqrt(2.0 / (shape[0] * 8)))
            elif kind == "head":
                v *= np.float32(1.0 / np.sqrt(shape[1]))
            elif kind == "norm_weight":
                v = np.float32(1.0) + np.float32(0.1) * v
            else:
                v *= np.float32(0.1)
            out[name] = v
        return out
