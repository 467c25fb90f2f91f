"""Bilinear grid sampling with border padding and align_corners
(JAX counterpart: ops/grid_sample.py).

Two versions of one function:

* :func:`grid_sample_plain`, the hat-weight form of the JAX ``grid_sample``:
  ``out[n] = sum_r sum_c wy[n, r] * wx[n, c] * I[r, c]`` with
  ``w = relu(1 - |src - idx|)``.  The CPU path and the oracle of the kernel.
* :func:`grid_sample_cuda`, the CUDA kernel ``kernels/grid_sample.cu`` (one
  CTA a crop, the crop's image staged in shared memory, four taps a pixel,
  four pixels a thread), which replaces the TPU kernel
  ``ops/grid_sample.py::_grid_sample_kernel``.

:func:`grid_sample` picks by device: the plain version for CPU tensors, the
kernel for CUDA tensors, with the plain version's VJP as its backward (the
JAX package's ``grid_sample_hybrid``).

The model runs the kernel in both its float32 and bfloat16 modes.  The JAX
bf16 path samples with a single bf16 matrix pass instead; the kernel is
float32 throughout and so no less precise than that form.  The CPU parity
tests compare in float32.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build


def _source_coords(g: torch.Tensor, size: int) -> torch.Tensor:
    # align_corners=True maps [-1, 1] to [0, size-1]; border padding clamps
    return torch.clamp((g + 1.0) * 0.5 * (size - 1), 0.0, size - 1.0)


def _hat_weights(src: torch.Tensor, size: int) -> torch.Tensor:
    idx = torch.arange(size, dtype=torch.float32, device=src.device)
    return torch.relu(1.0 - torch.abs(src[..., None] - idx))


def grid_sample_plain(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C], grid [B, Ho, Wo, 2] (x, y) in [-1, 1] ->
    [B, Ho, Wo, C] float32."""
    B, H, W, C = img.shape
    _, Ho, Wo, _ = grid.shape
    N = Ho * Wo
    g = grid.float().reshape(B, N, 2)
    wx = _hat_weights(_source_coords(g[..., 0], W), W)  # [B, N, W]
    wy = _hat_weights(_source_coords(g[..., 1], H), H)  # [B, N, H]
    rows = torch.einsum("bnh,bhwc->bnwc", wy, img.float())
    out = torch.einsum("bnw,bnwc->bnc", wx, rows)
    return out.reshape(B, Ho, Wo, C)


# the shared memory one CTA may take on the H100 (227 KB): the crop's image
_SMEM_MAX = 232448


def _lib():
    lib = build.load("grid_sample")
    fn = lib.grid_sample_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grid_sample_cuda(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on single-channel float32 CUDA tensors:
    img [B, H, W, 1], grid [B, Ho, Wo, 2] -> [B, Ho, Wo, 1].  A crop's
    image must fit one CTA's shared memory (H * W at most 58108 pixels)."""
    B, H, W, C = img.shape
    _, Ho, Wo, two = grid.shape
    if img.device.type != "cuda" or grid.device != img.device:
        raise ValueError("grid_sample_cuda takes CUDA tensors on one device")
    if img.dtype != torch.float32 or grid.dtype != torch.float32:
        raise TypeError(f"grid_sample_cuda takes float32, got {img.dtype}/{grid.dtype}")
    if C != 1 or two != 2 or grid.shape[0] != B:
        raise ValueError(f"grid_sample_cuda: bad shapes {tuple(img.shape)}, {tuple(grid.shape)}")
    if not (img.is_contiguous() and grid.is_contiguous()):
        raise ValueError("grid_sample_cuda: image and grid must be contiguous")
    if H * W * 4 + 16 > _SMEM_MAX:  # the CTA's mbarrier takes the rest
        raise ValueError(f"grid_sample_cuda: a {H}x{W} image does not fit a CTA's shared memory")
    N = Ho * Wo
    out = torch.empty(B, Ho, Wo, 1, dtype=torch.float32, device=img.device)
    quad = N % 4 == 0 and grid.data_ptr() % 16 == 0
    bulk = (H * W) % 4 == 0 and img.data_ptr() % 16 == 0
    fn = _lib()
    with torch.cuda.device(img.device):  # the launcher uses the current device
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = fn(img.data_ptr(), grid.data_ptr(), out.data_ptr(), B, H, W, N, int(quad),
                int(bulk), stream)
    if rc != 0:
        raise RuntimeError(f"grid_sample kernel launch failed: CUDA error {rc}")
    grid_sample_cuda.launches += 1
    return out


grid_sample_cuda.launches = 0


class _GridSampleKernel(torch.autograd.Function):
    """Kernel forward, plain-form VJP backward."""

    @staticmethod
    def forward(ctx, img, grid):
        ctx.save_for_backward(img, grid)
        return grid_sample_cuda(img, grid)

    @staticmethod
    def backward(ctx, g):
        img, grid = ctx.saved_tensors
        with torch.enable_grad():
            img_ = img.detach().requires_grad_(ctx.needs_input_grad[0])
            grid_ = grid.detach().requires_grad_(ctx.needs_input_grad[1])
            out = grid_sample_plain(img_, grid_)
            wrt = [t for t in (img_, grid_) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(grads) if t.requires_grad else None
                     for t in (img_, grid_))


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
    """Sample ``img`` [B, H, W, C] at ``grid`` [B, Ho, Wo, 2]: the plain
    version for CPU tensors (or ``plain=True``), the CUDA kernel for CUDA
    tensors."""
    if plain or img.device.type == "cpu":
        return grid_sample_plain(img, grid)
    return _GridSampleKernel.apply(img, grid)
