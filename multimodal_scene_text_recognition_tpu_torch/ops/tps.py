"""Thin-plate-spline grid generation (JAX counterpart: ops/tps.py).

The TPS system depends only on static shapes and is solved once in numpy;
the per-batch work is one small matmul kept in true float32, forward and
backward: it produces sample coordinates, and a reduced-precision pass
(TF32 on the card) would move them by a sizeable fraction of a pixel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .precision import full_fp32


def build_fiducial_grid(F: int) -> np.ndarray:
    """Canonical fiducial points on the top/bottom edges: [F, 2] float64."""
    half = F // 2
    x = np.linspace(-1.0, 1.0, half)
    top = np.stack([x, -np.ones(half)], axis=1)
    bottom = np.stack([x, np.ones(half)], axis=1)
    return np.concatenate([top, bottom], axis=0)


def build_identity_bias(F: int) -> np.ndarray:
    """Localization-net output bias that produces the identity warp: [2F]."""
    half = F // 2
    x = np.linspace(-1.0, 1.0, half)
    top = np.stack([x, np.linspace(0.0, -1.0, half)], axis=1)
    bottom = np.stack([x, np.linspace(1.0, 0.0, half)], axis=1)
    return np.concatenate([top, bottom], axis=0).reshape(-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def tps_weights(F: int, I_r_height: int, I_r_width: int) -> np.ndarray:
    """TPS interpolation weights M [n, F] float32 with
    ``grid = M @ C'`` for the n = I_r_height * I_r_width output pixels.

    The JAX package solves in two float32 matmuls, ``P_hat @ (inv_delta_C @
    C')``, whose entries (up to ~18 in inv_delta_C) cancel and leave ~3e-5 of
    coordinate error.  Here ``M = P_hat @ inv_delta_C`` is formed once in
    float64 (the three rows of C' padding are zero, so only F columns
    remain); its entries are below 1 and the one float32 matmul left is
    accurate to ~4e-7.
    """
    C = build_fiducial_grid(F)
    hat_C = np.linalg.norm(C[:, None, :] - C[None, :, :], axis=2)
    np.fill_diagonal(hat_C, 1.0)
    hat_C = (hat_C**2) * np.log(hat_C)
    delta_C = np.concatenate(
        [
            np.concatenate([np.ones((F, 1)), C, hat_C], axis=1),
            np.concatenate([np.zeros((2, 3)), C.T], axis=1),
            np.concatenate([np.zeros((1, 3)), np.ones((1, F))], axis=1),
        ],
        axis=0,
    )
    inv_delta_C = np.linalg.inv(delta_C)

    # output pixel centres normalised to (-1, 1), row-major over (y, x)
    gx = (np.arange(-I_r_width, I_r_width, 2) + 1.0) / I_r_width
    gy = (np.arange(-I_r_height, I_r_height, 2) + 1.0) / I_r_height
    P = np.stack(np.meshgrid(gx, gy), axis=2).reshape(-1, 2)  # [n, 2]
    rbf_norm = np.linalg.norm(P[:, None, :] - C[None, :, :], axis=2)
    rbf = (rbf_norm**2) * np.log(rbf_norm + 1e-6)
    P_hat = np.concatenate([np.ones((P.shape[0], 1)), P, rbf], axis=1)
    return (P_hat @ inv_delta_C)[:, :F].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tps_matrix(F: int, I_r_height: int, I_r_width: int,
                device: torch.device) -> torch.Tensor:
    """:func:`tps_weights` as a float32 tensor on ``device``, uploaded once."""
    return torch.from_numpy(tps_weights(F, I_r_height, I_r_width)).to(device)


class _Fp32Matmul(torch.autograd.Function):
    """``M @ c`` for a constant ``M``, forward and backward in full float32
    (no TF32 on the card, whatever the caller set)."""

    @staticmethod
    def forward(ctx, M, c):
        ctx.save_for_backward(M)
        with full_fp32():
            return torch.matmul(M, c)

    @staticmethod
    def backward(ctx, grad):
        (M,) = ctx.saved_tensors
        with full_fp32():
            return None, torch.matmul(M.t(), grad)


def build_sampling_grid(batch_C_prime: torch.Tensor, I_r_height: int,
                        I_r_width: int) -> torch.Tensor:
    """Evaluate the TPS warp grid.

    batch_C_prime: [B, F, 2] predicted fiducials.  Returns the normalised
    (x, y) sample grid [B, I_r_height, I_r_width, 2] in float32.
    """
    B, F, _ = batch_C_prime.shape
    M = _tps_matrix(F, I_r_height, I_r_width, batch_C_prime.device)
    grid = _Fp32Matmul.apply(M, batch_C_prime.float())  # [B, n, 2]
    return grid.reshape(B, I_r_height, I_r_width, 2)
