"""The int8-vs-bf16 in-kernel GEMM probe (JAX counterpart:
scripts/probe_int8_pallas.py).

The probe asks one question: inside one kernel that keeps its operands on
chip, does an int8 x int8 -> int32 product run faster than a bf16 product
with float32 accumulation?  Each side runs a chain of ``iters`` dependent
products of x [B, E] by a fixed weight [E, F]: every step adds its output
to a float32 accumulator and feeds the output's first E columns back as
the next x, so no step can start before the last one ends.

* P1, :func:`int8_chain`: each step quantizes x with one scale for the
  whole tensor (``127 / max|x|``, rounded half to even, clipped to +-127),
  multiplies by the int8 weight exactly in int32 and dequantizes with the
  weight's per-column scale: ``a32 * (ws / inv)``.
* P2, :func:`bf16_chain`: each step rounds x to bf16 and multiplies by the
  bf16 weight, summing in float32.

Each comes in two versions: the plain PyTorch one (``*_plain``, the CPU
path and the card's reference) and the CUDA kernel
``kernels/gemm_probe.cu`` (``*_cuda``), which replaces the Pallas kernels
``kern_int8`` and ``kern_bf16`` and runs the whole chain in one launch on
the tensor cores.  The dispatchers take the plain version for CPU tensors
and the kernel for CUDA tensors.

The chain grows by about sqrt(E) = 16 a step, so in float32 it overflows
after some 32 steps and the probe's own 200-step output is all NaN (in
JAX and here); only a chain of 30 steps or fewer has numbers to compare.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import build
from .int8 import div
from .precision import full_fp32

B, E, F = 192, 256, 2048
ITERS = 200  # chained products inside the kernel, to amortize its launch

# the kernels' CTA: 32 rows of x by 128 output columns; their E is fixed at
# the probe's 256
_ROWS, _COLS = 32, 128

# P2's kernel against its plain version on probe_inputs(0), max |diff| over
# max |plain acc|, by the chain's steps.  Both sum the same exact bf16
# products in float32 in other orders; from the second step on, a bf16
# rounding of x that lands the other way feeds back.  On an H100 the kernel
# read 5.5e-7 / 1.57e-3 / 7.55e-3 at 1 / 4 / 30 steps, and a copy that
# rounds x to bf16 toward zero 4.9e-3 / 1.22e-2 / 8.36e-2, so each limit
# sits between the two.
BF16_CHAIN_TOL = {1: 1e-5, 4: 5e-3, 30: 3e-2}


def probe_inputs(seed: int = 0, device="cuda"):
    """(x f32 [B, E], wq int8 [E, F], ws f32 [1, F], wbf bf16 [E, F]) on
    ``device``, made as the JAX probe makes them: normal x and w from
    ``np.random.default_rng(seed)``, the weight scale ``max|w| / 127`` per
    column (no floor), ``wq`` rounded half to even and clipped, ``wbf``
    rounded to nearest even."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, E)).astype(np.float32)
    w = rng.normal(size=(E, F)).astype(np.float32)
    ws = np.abs(w).max(axis=0) / 127.0
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    tensors = (torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ws[None, :]),
               torch.from_numpy(w).to(torch.bfloat16))
    return tuple(t.to(device) for t in tensors)


def tie_input(seed: int = 0, device="cuda") -> torch.Tensor:
    """x f32 [B, E] on which P1's first quantization lands on half-way
    ties: one element is 127, so ``inv`` is exactly 1.0, and every other
    is k + 0.5 for an integer k in [-127, 126].  Half to even and half
    away from zero differ on all of them."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-127, 127, size=(B, E)) + 0.5).astype(np.float32)
    x[0, 0] = 127.0
    return torch.from_numpy(x).to(device)


def _int_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 ``xq`` and ``wq``: an int32 matmul on
    the CPU; on the card a float32 one with TF32 off, exact because every
    partial sum is an integer below 127 * 127 * E < 2**24."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ wq.to(torch.int32)
    with full_fp32():
        return (xq.float() @ wq.float()).to(torch.int32)


def int8_chain_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                     iters: int = ITERS) -> torch.Tensor:
    """P1 in plain PyTorch -> acc f32 [B, F], each step in the JAX order
    and with its roundings: the quotients through ``ops/int8.div`` (IEEE on
    every device), the NaN-propagating clamp of the abs-max."""
    x = x.float()
    acc = torch.zeros(x.shape[0], wq.shape[1], dtype=torch.float32, device=x.device)
    for _ in range(iters):
        ax = x.abs().amax()
        inv = div(127.0, torch.clamp(ax, min=1e-12))
        xq = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
        out = _int_product(xq, wq).float() * div(ws, inv)
        acc = acc + out
        x = out[:, :x.shape[1]]
    return acc


def bf16_chain_plain(x: torch.Tensor, wbf: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """P2 in plain PyTorch -> acc f32 [B, F]: x rounded to bf16, the product
    of the bf16 values in float32 (TF32 off), then the same feedback."""
    x = x.float()
    w = wbf.float()
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32, device=x.device)
    with full_fp32():
        for _ in range(iters):
            out = x.bfloat16().float() @ w
            acc = acc + out
            x = out[:, :x.shape[1]]
    return acc


def _check(what: str, x: torch.Tensor, w: torch.Tensor, w_dtype: torch.dtype,
           iters: int, ws=None) -> None:
    tensors = (x, w) + (() if ws is None else (ws,))
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if x.dtype != torch.float32 or w.dtype != w_dtype or (
            ws is not None and ws.dtype != torch.float32):
        raise TypeError(f"{what}: x float32, w {w_dtype}"
                        + ("" if ws is None else ", ws float32")
                        + f", got {[t.dtype for t in tensors]}")
    nb, ne = x.shape if x.dim() == 2 else (0, 0)
    nf = w.shape[1] if w.dim() == 2 else 0
    if (x.dim() != 2 or w.shape != (ne, nf) or ne != E or nb == 0
            or nb % _ROWS or nf % _COLS or nf < ne
            or (ws is not None and ws.shape != (1, nf))):
        raise ValueError(f"{what}: x [B, {E}] with B a multiple of {_ROWS}, w "
                         f"[{E}, F] with F >= {E} a multiple of {_COLS}"
                         + ("" if ws is None else ", ws [1, F]")
                         + f"; got {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if iters < 0:
        raise ValueError(f"{what}: iters must be >= 0, got {iters}")


def _launch(fn_name: str, what: str, ptrs, nb: int, nf: int, iters: int,
            device: torch.device) -> None:
    fn = getattr(build.load("gemm_probe"), fn_name)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):  # the launcher uses the current device
        rc = fn(*ptrs, nb, nf, iters, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def int8_chain_cuda(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                    iters: int = ITERS) -> torch.Tensor:
    """Launch P1 on x f32 [B, 256], wq int8 [256, F], ws f32 [1, F] (CUDA,
    contiguous; B a multiple of 32, F >= 256 a multiple of 128) -> acc f32
    [B, F].  One launch runs the whole chain; the launch is refused (and
    this raises) if its B/32 x F/128 CTAs cannot all be resident."""
    _check("int8_chain_cuda", x, wq, torch.int8, iters, ws)
    nb, nf = x.shape[0], wq.shape[1]
    out = torch.empty(nb, nf, dtype=torch.float32, device=x.device)
    xbuf = torch.empty(2, nb, E, dtype=torch.float32, device=x.device)
    slots = torch.empty(2, nb // _ROWS * (E // _COLS), dtype=torch.int32,
                        device=x.device)
    _launch("gemm_probe_int8", "int8 chain",
            [t.data_ptr() for t in (x, wq, ws, out, xbuf, slots)], nb, nf, iters, x.device)
    int8_chain_cuda.launches += 1
    return out


int8_chain_cuda.launches = 0


def bf16_chain_cuda(x: torch.Tensor, wbf: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """Launch P2 on x f32 [B, 256] and wbf bf16 [256, F] (the shapes and
    the refusal of :func:`int8_chain_cuda`) -> acc f32 [B, F]."""
    _check("bf16_chain_cuda", x, wbf, torch.bfloat16, iters)
    nb, nf = x.shape[0], wbf.shape[1]
    out = torch.empty(nb, nf, dtype=torch.float32, device=x.device)
    xbuf = torch.empty(2, nb, E, dtype=torch.float32, device=x.device)
    _launch("gemm_probe_bf16", "bf16 chain",
            [t.data_ptr() for t in (x, wbf, out, xbuf)], nb, nf, iters, x.device)
    bf16_chain_cuda.launches += 1
    return out


bf16_chain_cuda.launches = 0


def int8_chain(x, wq, ws, iters: int = ITERS) -> torch.Tensor:
    """P1: the plain version for CPU tensors, the kernel for CUDA ones."""
    if x.device.type == "cpu":
        return int8_chain_plain(x, wq, ws, iters)
    return int8_chain_cuda(x, wq, ws, iters)


def bf16_chain(x, wbf, iters: int = ITERS) -> torch.Tensor:
    """P2: the plain version for CPU tensors, the kernel for CUDA ones."""
    if x.device.type == "cpu":
        return bf16_chain_plain(x, wbf, iters)
    return bf16_chain_cuda(x, wbf, iters)
