"""Train-mode BatchNorm over [B, C, H, W] with a hand-written backward
(JAX counterpart: ops/batchnorm.py).

Forward, as flax's train-mode BatchNorm: statistics in float32 with the
fast-variance form ``E[x^2] - E[x]^2`` clipped at 0 (biased), normalisation
in float32, output cast to the input's type.

Backward, as the JAX package's ``_bn_bwd``: the per-channel sums

    dgamma = sum over (b, h, w) of dy * xhat,   dbeta = sum of dy,
    xhat = (x - mean) * rstd,

then ``dx = (w * rstd) * (dy - dbeta / n - xhat * (dgamma / n))`` in
float32, in that order, cast once to x's type.  Two versions of it:

* :func:`bn_bwd_plain`, plain PyTorch.  The CPU path and the oracle of the
  kernel.  Its sums are :func:`bn_bwd_sums_plain`, the function of the TPU
  kernel ``ops/batchnorm.py::_bn_bwd_reduce_kernel`` (the JAX package
  leaves the dx pass to XLA).
* :func:`bn_bwd_cuda`, the CUDA kernel ``kernels/bn_backward.cu``: the sums
  and dx in one cooperative launch (:func:`bn_bwd_plan` is its geometry).
  It reads x and dy as the convs and autograd hand them over on the card:
  [B, C, H, W] tensors in torch's channels-last memory format, i.e.
  [B*H*W, C] rows, the JAX kernel's own layout, and writes dx in that
  layout.  It refuses any other layout rather than copying.

The JAX package runs its kernel only for C >= 128, a rule about the TPU's
128-lane vector width; on the card the kernel takes every C, the 32- and
64-channel stems included.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from ..kernels import build
from .int8 import div

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# kernels/bn_backward.cu: threads a CTA, 16-byte rows each thread keeps in
# flight (kAhead; a ring that wraps must hold two rows more), and the shared
# memory one CTA may take on the H100 (227 KB)
_THREADS, _AHEAD, _SMEM_MAX = 256, 12, 232448
_L2_BYTES = 50 * 2 ** 20


@dataclass(frozen=True)
class BnBwdPlan:
    """The launch of ``kernels/bn_backward.cu`` for N rows of C channels.

    Each thread owns ``V`` channels (one 16-byte column; one channel on
    the scalar path) of every ``lanes``-th row of its CTA's span.  The
    spans split the N rows among ``spans`` CTAs for each of ``groups``
    channel groups of at most ``_THREADS`` columns (``ctas`` = spans *
    groups, one an SM).  A thread keeps the last ``slots`` of its rows in
    shared memory (``smem_bytes`` a CTA with the reduction buffer);
    ``rows_kept`` rows in all are not read again.  Bytes, all x and dy
    together unless named: ``bound_bytes`` is x and dy read once and dx
    written once; ``reread_bytes`` what pass 2 reads again from global
    memory, of which ``l2_bytes`` are expected from L2 (an LRU model of the
    50 MB L2: it holds the newest reads of pass 1, and dx's stores, marked
    evict-first, displace none of them) and the rest from DRAM
    (``dram_bytes``: both passes' reads and dx)."""

    N: int
    C: int
    itemsize: int
    vec: bool
    V: int
    groups: int
    lanes: int
    spans: int
    ctas: int
    rows_per_span: int
    rows_per_thread: int
    slots: int
    rows_kept: int
    smem_bytes: int
    bound_bytes: int
    reread_bytes: int
    l2_bytes: int
    dram_bytes: int


def _kept(length: int, lanes: int, slots: int) -> int:
    """Rows a span of ``length`` rows keeps: each of its ``lanes`` threads
    walks every lanes-th row and keeps its last ``slots``."""
    q, r = divmod(length, lanes)
    return r * min(q + 1, slots) + (lanes - r) * min(q, slots)


@functools.lru_cache(maxsize=256)
def bn_bwd_plan(N: int, C: int, itemsize: int, sms: int, vec: bool = True) -> BnBwdPlan:
    """The geometry of the kernel for N rows of C channels of ``itemsize``
    bytes on a card of ``sms`` SMs, on the 16-byte path (``vec``: C a
    multiple of 16 / itemsize) or the scalar one.  Raises ValueError where
    it cannot launch."""
    if N < 1 or C < 1:
        raise ValueError(f"bn_bwd_plan: no rows or channels ({N}, {C})")
    V = 16 // itemsize if vec else 1
    if C % V:
        raise ValueError(f"bn_bwd_plan: C={C} is not a multiple of {V} on the 16-byte path")
    ncols = C // V
    groups = -(-ncols // _THREADS)
    if groups > sms:
        raise ValueError(f"bn_bwd_plan: C={C} needs {groups} channel groups, more than "
                         f"the {sms} CTAs of one wave")
    lanes = _THREADS // min(ncols, _THREADS)  # the widest group's; a narrower last one has more
    spans = max(1, min(sms // groups, -(-N // lanes)))
    rows_per_span = -(-N // spans)
    rows_per_thread = -(-rows_per_span // lanes)
    red = 2 * _THREADS * V * 4
    slots = min((_SMEM_MAX - red) // (32 * _THREADS), rows_per_thread) if vec else 0
    if vec and slots < rows_per_thread and slots <= _AHEAD + 1:
        raise ValueError("bn_bwd_plan: the ring holds no more rows than are in flight")
    # spans hold N // spans rows, N % spans of them one more; every group
    # keeps the same rows (a narrower group's threads keep more, not counted)
    short, extra = divmod(N, spans)
    rows_kept = min(N, (spans - extra) * _kept(short, lanes, slots)
                    + extra * _kept(short + 1, lanes, slots))
    elems = N * C
    xdy = 2 * elems * itemsize
    kept_bytes = 2 * rows_kept * C * itemsize
    reread = xdy - kept_bytes
    l2 = min(reread, max(0, min(xdy, _L2_BYTES) - kept_bytes))
    return BnBwdPlan(N=N, C=C, itemsize=itemsize, vec=vec, V=V, groups=groups, lanes=lanes,
                     spans=spans, ctas=spans * groups,
                     rows_per_span=rows_per_span, rows_per_thread=rows_per_thread,
                     slots=slots, rows_kept=rows_kept, smem_bytes=32 * _THREADS * slots + red,
                     bound_bytes=3 * elems * itemsize, reread_bytes=reread, l2_bytes=l2,
                     dram_bytes=xdy + reread - l2 + elems * itemsize)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def bn_bwd_sums_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dgamma, dbeta) float32 [C] from x, dy [B, C, H, W] (any memory
    format) and float32 mean, rstd [C]: the TPU kernel's function."""
    dyf = dy.float()
    xhat = (x.float() - _per_channel(mean)) * _per_channel(rstd)
    return (dyf * xhat).sum(dim=(0, 2, 3)), dyf.sum(dim=(0, 2, 3))


def bn_bwd_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                 weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's type, dgamma, dbeta float32 [C]) from x, dy [B, C, H, W]
    (any memory format) and float32 mean, rstd, weight [C]."""
    n = x.numel() // x.shape[1]
    dgamma, dbeta = bn_bwd_sums_plain(x, dy, mean, rstd)
    xhat = (x.float() - _per_channel(mean)) * _per_channel(rstd)
    dx = _per_channel(weight * rstd) * (
        dy.float() - _per_channel(div(dbeta, n)) - xhat * _per_channel(div(dgamma, n)))
    return dx.to(x.dtype), dgamma, dbeta


def _lib():
    fn = build.load("bn_backward").bn_backward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bn_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel: x, dy [B, C, H, W] CUDA tensors of one type (float32
    or bfloat16) in the channels-last memory format, mean, rstd, weight
    float32 [C] on the same device -> (dx channels-last in x's type,
    dgamma, dbeta float32 [C]).  Any other layout raises: the wrapper
    copies nothing."""
    if x.device.type != "cuda" or any(t.device != x.device for t in (dy, mean, rstd, weight)):
        raise ValueError("bn_bwd_cuda takes CUDA tensors on one device")
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"bn_bwd_cuda takes float32 or bfloat16 x and dy of one type, "
                        f"got {x.dtype}/{dy.dtype}")
    if x.dim() != 4 or dy.shape != x.shape or x.numel() == 0:
        raise ValueError(f"bn_bwd_cuda: bad shapes {tuple(x.shape)}, {tuple(dy.shape)}")
    B, C, H, W = x.shape
    if any(t.dtype != torch.float32 or t.shape != (C,) or not t.is_contiguous()
           for t in (mean, rstd, weight)):
        raise ValueError("bn_bwd_cuda: mean, rstd and weight must be contiguous float32 [C]")
    cl = torch.channels_last
    if not (x.is_contiguous(memory_format=cl) and dy.is_contiguous(memory_format=cl)):
        raise ValueError("bn_bwd_cuda: x and dy must be channels-last contiguous")
    vec = C % (16 // x.element_size()) == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, dy, mean, rstd, weight))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = bn_bwd_plan(B * H * W, C, x.element_size(), sms, vec)
    dx = torch.empty_like(x, memory_format=cl)
    dgamma = torch.empty(C, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(C, dtype=torch.float32, device=x.device)
    # the CTAs' partial sums, then dbeta / N and dgamma / N
    partial = torch.empty(plan.spans + 1, 2, C, dtype=torch.float32, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):  # the launcher uses the current device
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                weight.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                partial.data_ptr(), plan.N, C, plan.spans, plan.groups, plan.slots,
                plan.smem_bytes, _DTYPES[x.dtype], int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"bn_backward kernel launch failed: CUDA error {rc}")
    bn_bwd_cuda.launches += 1
    return dx, dgamma, dbeta


bn_bwd_cuda.launches = 0


def bn_bwd(x, dy, mean, rstd, weight, plain: bool = False):
    """The plain version for CPU tensors (or ``plain=True``), the CUDA
    kernel for CUDA tensors."""
    if plain or x.device.type == "cpu":
        return bn_bwd_plain(x, dy, mean, rstd, weight)
    return bn_bwd_cuda(x, dy, mean, rstd, weight)


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
        dx, dgamma, dbeta = bn_bwd(x, dy, mean, rstd, weight, plain=ctx.plain)
        return dx, dgamma, dbeta, None, None


def bn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-5, plain: bool = False):
    """Train-mode BatchNorm of x [B, C, H, W] with float32 weight, bias [C].

    Returns (y, mean, var): y in x's type; the batch mean and biased
    variance float32 [C], for the caller's running-average update (no
    gradient flows through them).  The backward (dx, dgamma, dbeta) is the
    CUDA kernel on CUDA tensors unless ``plain``."""
    return _BatchNormTrain.apply(x, weight, bias, eps, plain)
