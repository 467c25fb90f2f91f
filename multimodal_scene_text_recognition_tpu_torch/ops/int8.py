"""Int8 post-training quantization: the building blocks of int8 serving
(JAX counterpart: ops/int8.py).

The recipe the int8 paths share (the encoder's matmuls here, the convs of
models/resnet_int8.py and the fused decode's projections in
ops/fused_decode.py):

* weights: symmetric per-output-channel int8, scale ``max(absmax, 1e-12)
  / 127``, quantized from the float32 parameters;
* activations: int8 with a scale per row (the matmuls here and in the
  decode) or a static one per tensor (the convs), rounded half to even
  and clipped to +-127;
* the product int8 x int8 -> int32, exact; dequantized in float32 as
  ``acc * ((absmax / 127) * w_scale) + bias``, in that order.

:func:`int_mm` forms the exact int32 product: on the card through
``torch._int_mm`` (cuBLASLt; the JAX package leaves these products to XLA,
outside any Pallas kernel), zero-padding the sizes it refuses; on the CPU as
a float64 product, exact for these ranges (|acc| <= 127 * 127 * K < 2**53).
A float32 product would not be: 127 * 127 * 2048 > 2**24.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def div(a, b) -> torch.Tensor:
    """``a / b`` correctly rounded on every device, for tensors and Python
    numbers.  PyTorch computes ``tensor / number`` on the card as a product
    with the number's reciprocal, and ``number / tensor`` everywhere as the
    tensor's reciprocal times the number: either can miss the quotient by
    an ulp, and the quantizers round as the JAX package's divisions do."""
    if not isinstance(a, torch.Tensor):
        a = b.new_full((), a)
    if not isinstance(b, torch.Tensor):
        b = a.new_full((), b)
    return torch.div(a, b)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[D_in, D_out] float32 -> (int8 table [D_in, D_out], per-channel scale
    [1, D_out] float32)."""
    w = w.float()
    scale = div(torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-12), 127.0)
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row quantization of ``x`` [..., D] (float32 values):
    (int8 [..., D], row abs-max [..., 1] float32)."""
    x = x.float()
    ax = x.abs().amax(dim=-1, keepdim=True)
    inv = div(127.0, torch.clamp(ax, min=1e-12))
    return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8), ax


def _pad_to(n: int, m: int) -> int:
    return -n % m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 ``a`` [M, K] and ``b`` [K, N].

    CUDA tensors: ``torch._int_mm`` with M raised above 16 and K and N to
    multiples of 8 by zero rows and columns (exact: they add nothing), ``b``
    handed over column-major.  CPU tensors: a float64 product.
    """
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int_mm takes int8 operands, got {a.dtype} and {b.dtype}")
    M, K = a.shape
    N = b.shape[1]
    if a.device.type == "cpu":
        return (a.double() @ b.double()).to(torch.int32)
    pm, pk, pn = max(0, 17 - M), _pad_to(K, 8), _pad_to(N, 8)
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    bt = b.t()
    if pk or pn:
        bt = F.pad(bt, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return out[:M, :N] if (pm or pn) else out


def dequantize(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``acc.f32 * (x_scale * w_scale) + bias`` in float32, the JAX order."""
    out = acc.float() * (x_scale * w_scale)
    return out + bias if bias is not None else out


def int8_linear(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., D_in] @ w [D_in, D_out] (+ b) through int8: weights quantized
    per output channel, activations per row -> float32 [..., D_out]."""
    wq, ws = quantize_weight(w)
    xq, ax = quantize_rows(x)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(*xq.shape[:-1], wq.shape[1])
    return dequantize(acc, div(ax, 127.0), ws, None if b is None else b.float())
