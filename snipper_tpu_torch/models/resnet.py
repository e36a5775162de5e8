"""ResNet backbone with frozen BatchNorm, multi-scale taps.

Counterpart of ``snipper_tpu/models/resnet.py``: torchvision's ResNet-50
with frozen BatchNorm, returning the layer2/3/4 features at strides 8, 16
and 32 with 512, 1024 and 2048 channels. Module names follow the flax tree
(``conv1``, ``bn1``, ``layer{s}_{b}.conv{1,2,3}``, ``downsample_conv``,
``downsample_bn``). The stem is the plain 7x7/2 convolution; the JAX
package's space-to-depth stem is a TPU experiment that is off by default.
Tensors are NCHW in logical order; an input permuted from NHWC keeps
channels-last memory through the convolutions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from snipper_tpu_torch.models.init import fill_


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine parameters, applied in
    scale/shift form (``snipper_tpu/models/resnet.py:42-44``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, torch.empty(features))

    def init_own_weights(self, generator):
        for name, kind in (("weight", "ones"), ("bias", "zeros"),
                           ("running_mean", "zeros"),
                           ("running_var", "ones")):
            fill_(getattr(self, name), kind, generator)

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        # in the statistics' dtype, then the activation's: bf16 under the
        # bf16 recipe (models/snipper.py::bf16_params), as in JAX
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + residual."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _conv(cin, planes * 4, 1, stride)
            self.downsample_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet trunk returning the layer2/3/4 taps (strides 8/16/32)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if stage == 0 else 2
            for blk in range(self.layers[stage]):
                setattr(self, f"layer{stage + 1}_{blk}", Bottleneck(
                    cin, planes, stride if blk == 0 else 1,
                    downsample=(blk == 0)))
                cin = planes * 4

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        # x: [N, 3, H, W]
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        taps = []
        for stage in range(4):
            for blk in range(self.layers[stage]):
                x = getattr(self, f"layer{stage + 1}_{blk}")(x)
            if stage >= 1:
                taps.append(x)
        return tuple(taps)           # strides 8, 16, 32


RESNET_SPECS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    # one bottleneck per stage: unit tests only (same strides/channels)
    "resnet_test": (1, 1, 1, 1),
}
