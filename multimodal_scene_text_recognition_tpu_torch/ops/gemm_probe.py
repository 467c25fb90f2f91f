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
the tensor cores: chain CTAs carry the first E columns from step to step
(P1's in one thread-block cluster, which shares the abs-max), wide CTAs
trail them over the other columns (:func:`probe_plan`).  The dispatchers
take the plain version for CPU tensors and the kernel for CUDA tensors.

The chain grows by about sqrt(E) = 16 a step, so in float32 it overflows
after some 32 steps and the probe's own 200-step output is all NaN (in
JAX and here); only a chain of 30 steps or fewer has numbers to compare.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import build
from .int8 import div
from .precision import full_fp32

B, E, F = 192, 256, 2048
ITERS = 200  # chained products inside the kernel, to amortize its launch

# the kernels' geometry (kernels/gemm_probe.cu): a chain CTA owns 16 rows
# of x, a wide CTA a tile of 128 of the columns past E by 64 rows (P1) or
# 32 (P2) and a ring of 4 A operands; P1's chain CTAs form one cluster of
# at most 16; E is fixed at the probe's 256; 288 threads a CTA (8 warps
# that multiply, one that signals); P1's inv history keeps 4 floats a step
# and chain CTA
_CHAIN_ROWS, _WIDE_COLS, _MAX_CLUSTER, _STAGES = 16, 128, 16, 4
_INV_STRIDE = 4
_STATIC_SMEM = 1328  # the kernel's `Shared`: abs-max slots, mbarriers, inv by ring buffer
_CHAIN_RING = 8      # a chain CTA's ring of A operands
SMEM_LIMIT = 232_448  # bytes of shared memory a CTA may have on an H100

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


@dataclass(frozen=True)
class ProbePlan:
    """The launch of P1 (``int8``) or P2 for x [B, E] and w [E, F]."""

    chain_ctas: int    # B / 16, each 16 rows of x through every step
    rows: int          # rows of x a chain CTA owns
    cluster: int       # CTAs a cluster: P1's chain CTAs, 1 for P2
    wide_ctas: int     # tiles of columns E..F
    wide_tile: tuple   # (rows, columns) of a wide tile
    grid: int          # CTAs of the cooperative launch (P1: whole clusters)
    smem_bytes: int    # shared memory a CTA (dynamic and static)
    scratch_bytes: int  # the history of A operands (P1 and inv) and the step counts


def probe_plan(B: int, F: int, int8: bool, iters: int = ITERS) -> ProbePlan:
    """The kernels' geometry for x [B, 256] and w [256, F] (the C launcher
    computes the same).  Raises ValueError where the kernel refuses the
    shape: B not a positive multiple of 32, F not a multiple of 128 from
    256 up, or, for P1, more than 16 chain CTAs (B > 256) for its cluster.
    Whether the grid can be resident is checked at the launch."""
    if B <= 0 or B % 32 or F < E or F % _WIDE_COLS:
        raise ValueError(f"the probe's kernels take x [B, {E}] with B a positive multiple of "
                         f"32 and w [{E}, F] with F >= {E} a multiple of {_WIDE_COLS}; got "
                         f"B={B}, F={F}")
    chain = B // _CHAIN_ROWS
    if int8 and chain > _MAX_CLUSTER:
        raise ValueError(f"the int8 chain's cluster holds at most {_MAX_CLUSTER} CTAs of "
                         f"{_CHAIN_ROWS} rows: B <= {_MAX_CLUSTER * _CHAIN_ROWS}, got B={B}")
    wide_rows = 64 if int8 else 32
    wide = -(-B // wide_rows) * ((F - E) // _WIDE_COLS)
    es, ld = (1, E + 16) if int8 else (2, E + 8)
    smem = (max(E + _CHAIN_RING * _CHAIN_ROWS, _WIDE_COLS + _STAGES * wide_rows) * ld * es
            + _STATIC_SMEM)
    cluster = chain if int8 else 1
    steps = max(iters, 1)
    scratch = chain * 4 + (steps * B * E * es + (steps * chain * _INV_STRIDE * 4 if int8 else 0)
                           if wide else 0)
    return ProbePlan(chain, _CHAIN_ROWS, cluster, wide, (wide_rows, _WIDE_COLS),
                     -(-(chain + wide) // cluster) * cluster, smem, scratch)


def _shape(what: str, x: torch.Tensor, w: torch.Tensor, ws=None,
           iters: int = ITERS) -> ProbePlan:
    """The plan for the wrappers' operands, through :func:`probe_plan`'s
    refusals (ValueError)."""
    tensors = (x, w) + (() if ws is None else (ws,))
    nb, ne = x.shape if x.dim() == 2 else (0, 0)
    nf = w.shape[1] if w.dim() == 2 else 0
    if (x.dim() != 2 or w.shape != (ne, nf) or ne != E
            or (ws is not None and ws.shape != (1, nf))):
        raise ValueError(f"{what}: x [B, {E}], w [{E}, F]" + ("" if ws is None else ", ws [1, F]")
                         + f"; got {[tuple(t.shape) for t in tensors]}")
    try:
        return probe_plan(nb, nf, ws is not None, iters)
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None


def _check(what: str, x: torch.Tensor, w: torch.Tensor, w_dtype: torch.dtype,
           iters: int, ws=None) -> ProbePlan:
    tensors = (x, w) + (() if ws is None else (ws,))
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if x.dtype != torch.float32 or w.dtype != w_dtype or (
            ws is not None and ws.dtype != torch.float32):
        raise TypeError(f"{what}: x float32, w {w_dtype}"
                        + ("" if ws is None else ", ws float32")
                        + f", got {[t.dtype for t in tensors]}")
    plan = _shape(what, x, w, ws, iters)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: inputs must start on 16-byte boundaries")
    if iters < 0:
        raise ValueError(f"{what}: iters must be >= 0, got {iters}")
    return plan


def _scratch(x: torch.Tensor, plan: ProbePlan, iters: int, int8: bool):
    """The history of A operands [iters, B, E] (int8 or bf16; empty where
    no wide CTA reads it), P1's inv history [iters, B/16, 4] and the zeroed
    step counts [B/16]."""
    nb = x.shape[0]
    steps = max(iters, 1) if plan.wide_ctas else 0
    hist = torch.empty(steps, nb, E, dtype=torch.int8 if int8 else torch.bfloat16,
                       device=x.device)
    inv = torch.empty(steps if int8 else 0, plan.chain_ctas, _INV_STRIDE, dtype=torch.float32,
                      device=x.device)
    ready = torch.zeros(plan.chain_ctas, dtype=torch.int32, device=x.device)
    return hist, inv, ready


def _launch(fn_name: str, what: str, ptrs, nb: int, nf: int, iters: int,
            device: torch.device) -> None:
    fn = getattr(build.load("gemm_probe"), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):  # the launcher uses the current device
        rc = fn(*ptrs, nb, nf, iters, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def int8_chain_cuda(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                    iters: int = ITERS) -> torch.Tensor:
    """Launch P1 on x f32 [B, 256], wq int8 [256, F], ws f32 [1, F] (CUDA,
    contiguous; B a multiple of 32 up to 256, F >= 256 a multiple of 128)
    -> acc f32 [B, F].  One cooperative launch runs the whole chain
    (:func:`probe_plan`); it is refused (and this raises) if its CTAs
    cannot all be resident."""
    plan = _check("int8_chain_cuda", x, wq, torch.int8, iters, ws)
    nb, nf = x.shape[0], wq.shape[1]
    out = torch.empty(nb, nf, dtype=torch.float32, device=x.device)
    hist, inv, ready = _scratch(x, plan, iters, True)
    _launch("gemm_probe_int8", "int8 chain",
            [t.data_ptr() for t in (x, wq, ws, out, hist, inv, ready)], nb, nf, iters, x.device)
    int8_chain_cuda.launches += 1
    return out


int8_chain_cuda.launches = 0


def bf16_chain_cuda(x: torch.Tensor, wbf: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """Launch P2 on x f32 [B, 256] and wbf bf16 [256, F] (the shapes of
    :func:`int8_chain_cuda` with any B a multiple of 32, and its refusal of
    a grid that cannot be resident) -> acc f32 [B, F]."""
    plan = _check("bf16_chain_cuda", x, wbf, torch.bfloat16, iters)
    nb, nf = x.shape[0], wbf.shape[1]
    out = torch.empty(nb, nf, dtype=torch.float32, device=x.device)
    hist, _, ready = _scratch(x, plan, iters, False)
    _launch("gemm_probe_bf16", "bf16 chain",
            [t.data_ptr() for t in (x, wbf, out, hist, ready)], nb, nf, iters, x.device)
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
