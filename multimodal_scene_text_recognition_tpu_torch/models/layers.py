"""Building blocks shared by the models (JAX counterpart: models/layers.py).

Parameter names follow PyTorch's habit (``weight``/``bias``, ``running_mean``
/``running_var``, ``in_proj_weight``); ``convert.py`` maps the JAX package's
names onto them.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attend, qkv_projections
from ..ops.batchnorm import bn_train
from ..ops.int8 import int8_linear

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
    unbiased one), unless ``update_stats`` is off (a recomputed forward).
    ``use_kernels`` picks the backward reduction on CUDA tensors: the
    kernel, or its plain version.  ``reducer`` (set by
    ``parallel.tensor.parallelize``: the sum over a mesh's data group) makes
    the statistics those of the batch split across its processes.
    """

    def __init__(self, C: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(C))
        self.bias = nn.Parameter(torch.empty(C))
        self.register_buffer("running_mean", torch.empty(C))
        self.register_buffer("running_var", torch.empty(C))
        self.use_kernels = True
        self.update_stats = True
        self.reducer = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            y, mean, var = bn_train(x, self.weight, self.bias, EPS,
                                    plain=not self.use_kernels, reducer=self.reducer)
            if not self.update_stats:
                return y
            with torch.no_grad():
                for stat, batch in ((self.running_mean, mean), (self.running_var, var)):
                    stat.copy_(BN_MOMENTUM * stat + (1.0 - BN_MOMENTUM) * batch)
            return y
        mul = torch.rsqrt(self.running_var + EPS) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


@dataclass(frozen=True)
class BatchRows:
    """A generator that draws for a whole batch of ``total`` rows and keeps
    the ``start``-th row on: what a rank of a mesh passes where one process
    passes its ``torch.Generator``, so that its random values are its rows
    of the single process's (as a jitted JAX step's are, however sharded)."""

    generator: torch.Generator
    start: int
    total: int


def uniform(shape, generator, device,
            columns: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """U[0, 1) values of ``shape`` drawn from ``generator`` (a
    ``torch.Generator`` on ``device``, or :class:`BatchRows` of one).
    ``columns=(start, total)``: the draw is ``total`` wide in the last
    dimension, of which ``shape[-1]`` from ``start`` are kept (an activation
    split by columns over a mesh's model axis)."""
    full = list(shape)
    if columns is not None:
        full[-1] = columns[1]
    start = None
    if isinstance(generator, BatchRows):
        start, full[0] = generator.start, generator.total
        generator = generator.generator
    u = torch.rand(full, generator=generator, device=device)
    if start is not None:
        u = u.narrow(0, start, shape[0])
    return u if columns is None else u.narrow(-1, columns[0], shape[-1])


def dropout(x: torch.Tensor, p: float, generator, columns=None) -> torch.Tensor:
    """Keep each element with probability ``1 - p`` and scale it by
    ``1 / (1 - p)`` (flax's ``nn.Dropout``), drawing the mask from
    ``generator``, which lies on ``x``'s device (``columns``: see
    :func:`uniform`)."""
    if p == 0.0:
        return x
    keep = 1.0 - p
    mask = uniform(x.shape, generator, x.device, columns) < keep
    return torch.where(mask, x / keep, 0.0)


def feed_forward(lin1: nn.Module, lin2: nn.Module, act: Callable, x: torch.Tensor,
                 drop: Callable = None) -> torch.Tensor:
    """``lin2(drop(act(lin1(x))))``, the FF block.  Where a mesh split the
    pair (``parallel.tensor``: ``lin1`` by columns, ``lin2`` by rows), the
    hidden activation stays split between the two, as Megatron's."""
    pair = getattr(lin1, "parallel_pair", None)
    if pair is not None:
        return pair(lin2, act, x, drop)
    h = act(lin1(x))
    return lin2(h if drop is None else drop(h))


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

    def forward(self, query, key, mask=None, int8: bool = False):
        """``int8`` runs the four projections through the int8 matmul
        (inference only; the attention itself stays float)."""
        q, k, v = qkv_projections(query, key, self.in_proj_weight, self.in_proj_bias, int8)
        out = attend(q, k, v, self.num_heads, mask)
        if int8:
            return int8_linear(out, self.out_proj.weight.t(), self.out_proj.bias).to(query.dtype)
        return self.out_proj(out)


class FusionMLP(nn.Module):
    """The semantic fusion MLP (JAX ``layers.MLP`` in eval mode, where its
    dropout is off, and its weight-container twin ``layers.MLPP``):
    ``num_layers`` linear layers ``fc0..``, ``hidden_dim`` wide but the last
    (``out_dim``), with ReLU between them."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"fc{i}", nn.Linear(in_dim if i == 0 else hidden_dim,
                                                out_dim if i == num_layers - 1 else hidden_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.after_first(self.fc0(x))

    def after_first(self, h: torch.Tensor) -> torch.Tensor:
        """The layers after ``fc0``, from its output ``h``."""
        for i in range(1, self.num_layers):
            h = getattr(self, f"fc{i}")(torch.relu(h))
        return h


def relevance_fusion(feats: torch.Tensor, sem: torch.Tensor, mlp: FusionMLP,
                     return_scores: bool = False):
    """Per-position soft selection of semantic vectors (JAX
    ``layers.relevance_fusion``): feats [B, T, Df], sem [B, O, Ds] ->
    ``sum_o softmax_o(mlp([feats[b, t]; sem[b, o]])) * sem[b, o]``
    [B, T, Ds], the scores ``mlp`` gives being [B, T, O, 1]; with
    ``return_scores`` also the softmax [B, T, O].

    The pair tensor [B, T, O, Df + Ds] is never copied together: the first
    layer's product splits over the concat, feats times its first Df input
    columns once per position plus sem times the rest once per object,
    summed by broadcast into [B, T, O, hidden].  Pad objects (id 0) are not
    masked: they take part in the softmax, as in the JAX package."""
    fc0, Df = mlp.fc0, feats.shape[-1]
    h = (F.linear(feats, fc0.weight[:, :Df])[:, :, None]
         + F.linear(sem, fc0.weight[:, Df:], fc0.bias)[:, None])
    scores = torch.softmax(mlp.after_first(h)[..., 0], dim=2)  # [B, T, O]
    return (scores @ sem, scores) if return_scores else scores @ sem


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
