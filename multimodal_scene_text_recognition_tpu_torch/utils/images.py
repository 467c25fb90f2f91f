"""Writing model-input crops back out as image files (JAX counterpart:
utils/images.py, which saves with PIL): :func:`array_to_image` and
:func:`save_image`, whose PNG writer is this module's own (``zlib``)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def array_to_image(arr: np.ndarray) -> np.ndarray:
    """A float crop [H, W, C] or [H, W] normalized to [0, 1] or [-1, 1]
    (where it has a negative value) -> uint8 [H, W] or [H, W, C]."""
    arr = np.asarray(arr)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.min() < 0:
        arr = (arr + 1.0) / 2.0
    return np.clip(arr * 255.0, 0, 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit PNG of ``img`` uint8 [H, W] (grey) or [H, W, C] with C of 1
    to 4 (grey, grey + alpha, RGB, RGBA), rows unfiltered, not interlaced."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPES or h == 0 or w == 0:
        raise ValueError(f"encode_png takes a non-empty [H, W, 1-4] image, got {img.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (PNG_MAGIC
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_image(arr: np.ndarray, path: str) -> None:
    """Write the crop ``arr`` (see :func:`array_to_image`) to ``path`` as a
    PNG; another extension raises NotImplementedError."""
    if not path.lower().endswith(".png"):
        raise NotImplementedError(f"save_image writes PNG files only, not {path!r}")
    with open(path, "wb") as f:
        f.write(encode_png(array_to_image(arr)))
