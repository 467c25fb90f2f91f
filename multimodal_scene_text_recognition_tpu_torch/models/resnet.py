"""ResNet-31 backbone (JAX counterpart: models/resnet.py), on [B, C, H, W]
tensors, which the model hands over in the channels-last memory format.

Stage widths [128, 256, 512, 512], blocks [1, 2, 5, 3], with the asymmetric
width-preserving reductions (max-pool stride (2,1) pad (0,1); conv 2x2
stride (2,1) pad (0,1)) that turn a 32x100 crop into a 1x26 map of 512
channels.  Convs and BN run in ``dtype``; ``train`` puts every BatchNorm
in train mode.  Module names follow the JAX parameter tree (``stem0_conv``,
``block3_4``, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv2d


class BasicBlock(nn.Module):
    """3x3-3x3 residual block with a 1x1 projection when the width changes."""

    def __init__(self, cin: int, planes: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, padding=1, dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, dtype=dtype)
        self.bn2 = BatchNorm2d(planes)
        self.project = cin != planes
        if self.project:
            self.downsample_conv = Conv2d(cin, planes, 1, dtype=dtype)
            self.downsample_bn = BatchNorm2d(planes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        residual = (self.downsample_bn(self.downsample_conv(x), train)
                    if self.project else x)
        return torch.relu(out + residual)


class ResNet31(nn.Module):
    def __init__(self, in_ch: int = 1, output_channels: int = 512,
                 layers: Sequence[int] = (1, 2, 5, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        oc = output_channels
        ch = (oc // 4, oc // 2, oc, oc)
        self.layers = tuple(layers)

        def conv_bn(name, cin, cout, kernel=3, stride=1, padding=1):
            self.add_module(f"{name}_conv", Conv2d(cin, cout, kernel, stride, padding, dtype=dtype))
            self.add_module(f"{name}_bn", BatchNorm2d(cout))

        conv_bn("stem0", in_ch, oc // 16)
        conv_bn("stem1", oc // 16, oc // 8)
        cin = oc // 8
        for s in range(4):
            for i in range(layers[s]):
                self.add_module(f"block{s + 1}_{i}", BasicBlock(cin, ch[s], dtype))
                cin = ch[s]
        conv_bn("trans1", ch[0], ch[0])
        conv_bn("trans2", ch[1], ch[1])
        conv_bn("trans3", ch[2], ch[2])
        conv_bn("trans4a", ch[3], ch[3], 2, (2, 1), (0, 1))
        conv_bn("trans4b", ch[3], ch[3], 2, 1, 0)

    def _cbr(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = getattr(self, f"{name}_conv")(x)
        return torch.relu(getattr(self, f"{name}_bn")(x, train))

    def _stage(self, s: int, x: torch.Tensor, train: bool) -> torch.Tensor:
        for i in range(self.layers[s - 1]):
            x = getattr(self, f"block{s}_{i}")(x, train)
        return x

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x [B, C, 32, W] -> [B, oc, 1, W/4+1] in ``dtype``."""
        x = self._cbr("stem1", self._cbr("stem0", x, train), train)
        x = self._cbr("trans1", self._stage(1, F.max_pool2d(x, 2, 2), train), train)
        x = self._cbr("trans2", self._stage(2, F.max_pool2d(x, 2, 2), train), train)
        # height-only pool, width padded by one on each side
        x = self._cbr("trans3", self._stage(3, F.max_pool2d(x, 2, (2, 1), (0, 1)), train),
                      train)
        x = self._stage(4, x, train)
        return self._cbr("trans4b", self._cbr("trans4a", x, train), train)


def to_column_sequence(features: torch.Tensor) -> torch.Tensor:
    """[B, C, H', W'] -> [B, W', C] float32, averaging the height axis."""
    return features.mean(dim=2).float().transpose(1, 2)
