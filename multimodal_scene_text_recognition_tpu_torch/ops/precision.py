"""Full float32 on the card: TF32 off for cuBLAS matmuls, cuDNN
convolutions and cuDNN RNNs (the LSTMs) within a block, whatever the caller
set, and the caller's switches restored afterwards.

PyTorch lets a caller allow TF32 (about three decimal digits) for float32
matmuls, convolutions and RNNs through two APIs: the older ``allow_tf32``
flags (cuDNN's covers its convolutions and RNNs alike) and, where it
exists, ``fp32_precision``, which the older flags also set and which holds
cuDNN's convolutions and RNNs apart.  The block saves and restores the
newer one where there is one, so a caller's state comes back exactly as it
was, whichever API set it.
"""

from __future__ import annotations

import contextlib

import torch


def _switches():
    """(object, attribute, value meaning full float32) for matmuls, convs
    and, where the newer API sets them apart, RNNs."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    if hasattr(matmul, "fp32_precision") and hasattr(cudnn, "conv"):
        out = ((matmul, "fp32_precision", "ieee"), (cudnn.conv, "fp32_precision", "ieee"))
        if hasattr(cudnn, "rnn"):
            out += ((cudnn.rnn, "fp32_precision", "ieee"),)
        return out
    return ((matmul, "allow_tf32", False), (cudnn, "allow_tf32", False))


@contextlib.contextmanager
def full_fp32():
    """Run the block's float32 matmuls, convolutions and RNNs in full
    float32."""
    switches = _switches()
    saved = [getattr(obj, name) for obj, name, _ in switches]
    try:
        for obj, name, value in switches:
            setattr(obj, name, value)
        yield
    finally:
        for (obj, name, _), value in zip(switches, saved):
            setattr(obj, name, value)

