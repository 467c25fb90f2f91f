"""Resizing crops to the model's input size on the host (JAX counterpart:
``utils/native.crop_resize_gray_batch`` and the PIL mode-F bicubic resize
of ``eval/serve.Recognizer._prepare``).

* uint8 crops: :func:`crop_resize_gray_batch`, the C++ crop + bilinear
  resize of ``native/imgproc.cpp`` beside this package, built at first use
  with ``g++`` into ``native/_build/`` (listed in ``.gitignore``) under a
  name keyed by a hash of the source and the flags, and bound through
  ctypes.  A failed build raises: there is no quiet fallback.
  :func:`crop_resize_gray_plain` is its numpy mirror.
* float crops: :func:`resize_float`, bicubic with antialiasing in float64
  (``F.interpolate``), PIL's mode-F ``BICUBIC`` filter to within ~1e-7.
"""

from __future__ import annotations

import ctypes
import shutil  # noqa: F401  (tests patch shutil.which through this module)
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import native

SOURCE = native.NATIVE_DIR / "imgproc.cpp"
BUILD_DIR = native.BUILD_DIR
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    return native.library_path(SOURCE, CXX_FLAGS, BUILD_DIR)


def _library() -> ctypes.CDLL:
    """The built library, compiled on first use (``utils.native``); raises
    RuntimeError if it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    lib = native.load_library(SOURCE, CXX_FLAGS, "the crop resize of uint8 crops", BUILD_DIR)
    lib.crop_resize_gray_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.crop_resize_gray_batch.restype = None
    _lib = lib
    return lib


def crop_resize_gray_batch(images: Sequence[np.ndarray], boxes: np.ndarray, out_h: int = 32,
                           out_w: int = 100, threads: int = 8) -> np.ndarray:
    """Crop each uint8 grayscale image [H_i, W_i] to its xywh box (boxes
    float32 [N, 4]) and resize it bilinearly to (out_h, out_w): float32
    [N, out_h, out_w, 1] in [0, 1], by the C++ library on ``threads``
    threads."""
    n = len(images)
    boxes = np.ascontiguousarray(boxes, np.float32)
    if boxes.shape != (n, 4):
        raise ValueError(f"boxes {boxes.shape} for {n} images: expected [{n}, 4]")
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    if any(im.ndim != 2 or im.size == 0 for im in images):
        raise ValueError("crop_resize_gray_batch takes non-empty 2-D grayscale images")
    lib = _library()
    srcs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in images])
    hs = (ctypes.c_int * n)(*[im.shape[0] for im in images])
    ws = (ctypes.c_int * n)(*[im.shape[1] for im in images])
    out = np.empty((n, out_h, out_w), np.float32)
    lib.crop_resize_gray_batch(srcs, hs, ws, boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               out_h, out_w, threads)
    return out[..., None]


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once (the C++'s ``std::fmaf``), from
    float64, where the product of two float32 values is exact."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def crop_resize_gray_plain(images: Sequence[np.ndarray], boxes: np.ndarray, out_h: int = 32,
                           out_w: int = 100) -> np.ndarray:
    """The numpy mirror of :func:`crop_resize_gray_batch`: the same clamped
    half-pixel-centre bilinear sampling, the same five fused multiply-adds
    (in float64, rounded once to float32)."""
    n = len(images)
    out = np.empty((n, out_h, out_w), np.float32)
    oy = np.arange(out_h, dtype=np.float32) + np.float32(0.5)
    ox = np.arange(out_w, dtype=np.float32) + np.float32(0.5)
    one = np.float32(1.0)
    for i in range(n):
        img = np.asarray(images[i], np.uint8).astype(np.float32)
        h, w = img.shape
        bx, by, bw, bh = np.asarray(boxes[i], np.float32)
        bw = bw if bw > 0 else one
        bh = bh if bh > 0 else one
        fy = _fma32(oy, np.float32(bh / np.float32(out_h)), by) - np.float32(0.5)
        fy = np.minimum(np.maximum(fy, by), by + bh - one)
        fy = np.minimum(np.maximum(fy, np.float32(0.0)), np.float32(h - 1))
        fx = _fma32(ox, np.float32(bw / np.float32(out_w)), bx) - np.float32(0.5)
        fx = np.minimum(np.maximum(fx, bx), bx + bw - one)
        fx = np.minimum(np.maximum(fx, np.float32(0.0)), np.float32(w - 1))
        y0 = fy.astype(np.int32)
        y1 = np.minimum(y0 + 1, h - 1)
        x0 = fx.astype(np.int32)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (fy - y0.astype(np.float32))[:, None]
        wx = (fx - x0.astype(np.float32))[None, :]
        top = _fma32(img[y0][:, x0], one - wx, img[y0][:, x1] * wx)
        bot = _fma32(img[y1][:, x0], one - wx, img[y1][:, x1] * wx)
        out[i] = _fma32(top, one - wy, bot * wy) * np.float32(1.0 / 255.0)
    return out[..., None]


def resize_float(img: np.ndarray, out_h: int = 32, out_w: int = 100) -> np.ndarray:
    """A float grayscale crop [H, W] resized to (out_h, out_w) float32:
    bicubic (a = -0.5) with antialiasing, half-pixel centres, computed in
    float64 and cast once, as PIL's mode-F ``BICUBIC`` resize filters."""
    x = torch.from_numpy(np.asarray(img, np.float64))[None, None]
    y = F.interpolate(x, size=(out_h, out_w), mode="bicubic", antialias=True,
                      align_corners=False)
    return y[0, 0].numpy().astype(np.float32)
