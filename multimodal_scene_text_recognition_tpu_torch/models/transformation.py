"""TPS rectification (JAX counterpart: models/transformation.py).

Images enter and leave as [B, H, W, 1] (the JAX layout); the localization
network runs on [B, C, H, W] tensors in the channels-last memory format
inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import tps
from ..ops.grid_sample import grid_sample
from .layers import BatchNorm2d, Conv2d, nchw_channels_last


class LocalizationNetwork(nn.Module):
    """Predict fiducial points C' [B, F, 2]: four 3x3 conv+BN+ReLU stages
    (64/128/256/512, 2x2 max-pool between), global average pool, fc 512->256,
    ReLU, fc 256->2F.  Convs and BN run in ``dtype``; the head is float32."""

    def __init__(self, num_fiducial: int = 20, in_ch: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_fiducial = num_fiducial
        cin = in_ch
        for ch in (64, 128, 256, 512):
            setattr(self, f"conv{ch}", Conv2d(cin, ch, 3, padding=1, dtype=dtype))
            setattr(self, f"bn{ch}", BatchNorm2d(ch))
            cin = ch
        self.fc1 = nn.Linear(512, 256)
        self.fc2 = nn.Linear(256, 2 * num_fiducial)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: [B, C, H, W] -> [B, F, 2]."""
        for ch in (64, 128, 256, 512):
            x = getattr(self, f"conv{ch}")(x)
            x = torch.relu(getattr(self, f"bn{ch}")(x, train))
            if ch != 512:
                x = F.max_pool2d(x, 2, 2)
        x = x.float().mean(dim=(2, 3))
        x = torch.relu(self.fc1(x))
        return self.fc2(x).reshape(-1, self.num_fiducial, 2)

    @torch.no_grad()
    def init_identity_head(self) -> None:
        """The fiducial head starts at the identity warp: zero weights and
        the identity bias."""
        self.fc2.weight.zero_()
        self.fc2.bias.copy_(torch.from_numpy(tps.build_identity_bias(self.num_fiducial)))


class TPSTransform(nn.Module):
    """Predict fiducials, solve the TPS system, warp the crop."""

    def __init__(self, num_fiducial: int = 20, out_h: int = 32, out_w: int = 100,
                 in_ch: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_h, self.out_w = out_h, out_w
        self.loc_net = LocalizationNetwork(num_fiducial, in_ch, dtype)
        self.use_kernels = True

    def forward(self, img: torch.Tensor, train: bool = False) -> torch.Tensor:
        """img: [B, H, W, 1] float32 -> rectified [B, out_h, out_w, 1] float32.

        The warp runs the float32 kernel in every compute type (see
        ops/grid_sample.py); in training its backward is the plain version's
        VJP."""
        c_prime = self.loc_net(nchw_channels_last(img), train)
        grid = tps.build_sampling_grid(c_prime, self.out_h, self.out_w)
        return grid_sample(img.float().contiguous(), grid.contiguous(),
                           plain=not self.use_kernels)
