"""Building blocks shared by the models (JAX counterpart: models/layers.py).

Parameter names follow PyTorch's habit (``weight``/``bias``, ``running_mean``
/``running_var``, ``in_proj_weight``); ``convert.py`` maps the JAX package's
names onto them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attend, qkv_projections
from ..ops.batchnorm import bn_train

EPS = 1e-5  # torch's LayerNorm/BatchNorm default, used throughout
BN_MOMENTUM = 0.9  # running statistic = 0.9 * old + 0.1 * batch


def nchw_channels_last(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] images -> [B, C, H, W] in the channels-last memory
    format: the same memory (a view, no copy, where the image is
    contiguous).  The convs of the backbone and the loc-net keep this
    format (cuDNN's tensor-core layout on the card), and so the BatchNorm
    backward kernel reads it."""
    return img.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def layer_norm(E: int) -> nn.LayerNorm:
    return nn.LayerNorm(E, eps=EPS)


class BatchNorm2d(nn.Module):
    """BatchNorm over [B, C, H, W] in float32, output cast back to the input's type.

    Eval: ``(x - running_mean) * (rsqrt(running_var + eps) * scale) + bias``.
    Train: :func:`ops.batchnorm.bn_train` over the batch, then the running
    statistics move to ``0.9 * old + 0.1 * batch`` with the *biased* batch
    variance (the JAX package's rule; ``nn.BatchNorm2d`` would take the
    unbiased one).  ``use_kernels`` picks the backward reduction on CUDA
    tensors: the kernel, or its plain version.
    """

    def __init__(self, C: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(C))
        self.bias = nn.Parameter(torch.empty(C))
        self.register_buffer("running_mean", torch.empty(C))
        self.register_buffer("running_var", torch.empty(C))
        self.use_kernels = True

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            y, mean, var = bn_train(x, self.weight, self.bias, EPS,
                                    plain=not self.use_kernels)
            with torch.no_grad():
                for stat, batch in ((self.running_mean, mean), (self.running_var, var)):
                    stat.copy_(BN_MOMENTUM * stat + (1.0 - BN_MOMENTUM) * batch)
            return y
        mul = torch.rsqrt(self.running_var + EPS) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """Keep each element with probability ``1 - p`` and scale it by
    ``1 / (1 - p)`` (flax's ``nn.Dropout``), drawing the mask from
    ``generator``, which lies on ``x``'s device."""
    if p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class Conv2d(nn.Conv2d):
    """Bias-free convolution run in the model's compute type (weights are
    kept in float32 and cast at use, as flax's ``dtype`` does)."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=False)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.compute_dtype), self.weight.to(self.compute_dtype),
                        None, self.stride, self.padding)


class MultiHeadAttention(nn.Module):
    """Packed-projection multi-head attention (``key is value``)."""

    def __init__(self, E: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * E, E))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * E))
        self.out_proj = nn.Linear(E, E)

    def forward(self, query, key, mask=None):
        q, k, v = qkv_projections(query, key, self.in_proj_weight, self.in_proj_bias)
        return self.out_proj(attend(q, k, v, self.num_heads, mask))


@functools.lru_cache(maxsize=None)
def positional_rows(max_len: int, d_model: int, device: torch.device) -> torch.Tensor:
    """:func:`sinusoidal_table` as a float32 tensor on ``device``."""
    return torch.from_numpy(sinusoidal_table(max_len, d_model)).to(device)


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal positional-encoding table [max_len, d_model]."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe
