"""Train-mode BatchNorm over [B, C, H, W] with a hand-written backward reduction
(JAX counterpart: ops/batchnorm.py).

Forward, as flax's train-mode BatchNorm: statistics in float32 with the
fast-variance form ``E[x^2] - E[x]^2`` clipped at 0 (biased), normalisation
in float32, output cast to the input's type.

Backward: two passes over (x, dy).  The reduction pass gives

    dgamma = sum over (b, h, w) of dy * (x - mean) * rstd,   dbeta = sum of dy

per channel, in two versions of one function:

* :func:`bn_bwd_sums_plain`, plain PyTorch.  The CPU path and the oracle of
  the kernel.
* :func:`bn_bwd_sums_cuda`, the CUDA kernel ``kernels/bn_bwd_reduce.cu``,
  which replaces the TPU kernel ``ops/batchnorm.py::_bn_bwd_reduce_kernel``.
  It reads x and dy as the convs and autograd hand them over on the card:
  [B, C, H, W] tensors in torch's channels-last memory format, i.e.
  [B*H*W, C] rows, the JAX kernel's own layout.  It refuses any other
  layout rather than copying.

The elementwise ``dx`` pass is plain PyTorch.  The JAX package runs its
kernel only for C >= 128, a rule about the TPU's 128-lane vector width; on
the card the kernel takes every C, the 32- and 64-channel stems included.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..kernels import build

# the kernel's CTA: 256 threads over up to 64 16-byte columns of a row;
# its chunking aims at 8 CTAs per SM with at least 16 rows per thread
_THREADS, _MAX_COLS, _CTAS_PER_SM, _MIN_ROWS_PER_THREAD = 256, 64, 8, 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def bn_bwd_sums_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dgamma, dbeta) float32 [C] from x, dy [B, C, H, W] (any memory
    format) and float32 mean, rstd [C]."""
    dyf = dy.float()
    xhat = (x.float() - _per_channel(mean)) * _per_channel(rstd)
    return (dyf * xhat).sum(dim=(0, 2, 3)), dyf.sum(dim=(0, 2, 3))


def _lib():
    fn = build.load("bn_bwd_reduce").bn_bwd_reduce
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bn_bwd_sums_cuda(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                     rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: x, dy [B, C, H, W] CUDA tensors of one type (float32
    or bfloat16) in the channels-last memory format, mean, rstd float32 [C]
    on the same device.  Any other layout raises: the wrapper copies
    nothing."""
    if x.device.type != "cuda" or any(t.device != x.device for t in (dy, mean, rstd)):
        raise ValueError("bn_bwd_sums_cuda takes CUDA tensors on one device")
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"bn_bwd_sums_cuda takes float32 or bfloat16 x and dy of "
                        f"one type, got {x.dtype}/{dy.dtype}")
    if x.dim() != 4 or dy.shape != x.shape or x.numel() == 0:
        raise ValueError(f"bn_bwd_sums_cuda: bad shapes {tuple(x.shape)}, {tuple(dy.shape)}")
    B, C, H, W = x.shape
    if mean.dtype != torch.float32 or rstd.dtype != torch.float32 or \
            mean.shape != (C,) or rstd.shape != (C,):
        raise ValueError("bn_bwd_sums_cuda: mean and rstd must be float32 [C]")
    if not (x.is_contiguous(memory_format=torch.channels_last)
            and dy.is_contiguous(memory_format=torch.channels_last)
            and mean.is_contiguous() and rstd.is_contiguous()):
        raise ValueError("bn_bwd_sums_cuda: x and dy must be channels-last contiguous")
    N = B * H * W
    vec_n = 16 // x.element_size()
    vec = C % vec_n == 0 and x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    lanes_rows = _THREADS // min(_MAX_COLS, C // vec_n if vec else C)
    groups = -(-(C // vec_n if vec else C) // _MAX_COLS)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    target = max(1, -(-_CTAS_PER_SM * sms // groups))
    rows_per_chunk = max(_MIN_ROWS_PER_THREAD * lanes_rows, -(-N // target))
    chunks = -(-N // rows_per_chunk)
    if chunks > 65535:
        raise ValueError(f"bn_bwd_sums_cuda: {N} rows make {chunks} chunks (at most 65535)")
    partial = torch.empty(chunks, 2, C, dtype=torch.float32, device=x.device)
    dgamma = torch.empty(C, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(C, dtype=torch.float32, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):  # the launcher uses the current device
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                partial.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                N, C, chunks, rows_per_chunk, _DTYPES[x.dtype], int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"bn_bwd_reduce kernel launch failed: CUDA error {rc}")
    bn_bwd_sums_cuda.launches += 1
    return dgamma, dbeta


bn_bwd_sums_cuda.launches = 0


def bn_bwd_sums(x, dy, mean, rstd, plain: bool = False):
    """The plain version for CPU tensors (or ``plain=True``), the CUDA
    kernel for CUDA tensors."""
    if plain or x.device.type == "cpu":
        return bn_bwd_sums_plain(x, dy, mean, rstd)
    return bn_bwd_sums_cuda(x, dy, mean, rstd)


class _BatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps, plain):
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        y = (xf - _per_channel(mean)) * _per_channel(rstd * weight) + _per_channel(bias)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.plain = plain
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        dgamma, dbeta = bn_bwd_sums(x, dy, mean, rstd, plain=ctx.plain)
        xhat = (x.float() - _per_channel(mean)) * _per_channel(rstd)
        dx = _per_channel(weight * rstd) * (
            dy.float() - _per_channel(dbeta / n) - xhat * _per_channel(dgamma / n))
        return dx.to(x.dtype), dgamma, dbeta, None, None


def bn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-5, plain: bool = False):
    """Train-mode BatchNorm of x [B, C, H, W] with float32 weight, bias [C].

    Returns (y, mean, var): y in x's type; the batch mean and biased
    variance float32 [C], for the caller's running-average update (no
    gradient flows through them).  The backward's (dgamma, dbeta) come from
    the CUDA kernel on CUDA tensors unless ``plain``."""
    return _BatchNormTrain.apply(x, weight, bias, eps, plain)
