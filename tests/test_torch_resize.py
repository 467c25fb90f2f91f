"""Crop resizing of the PyTorch port (ops/resize.py and
``Recognizer.prepare``) against the JAX package's two routes on the CPU:
``utils/native.crop_resize_gray_batch`` for uint8 crops (its native
library, and its numpy mirror) and PIL's mode-F bicubic resize for float
crops, then the whole prepared batch against JAX ``Recognizer._prepare``."""

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_scene_text_recognition_tpu.core.config import Config as JConfig
from multimodal_scene_text_recognition_tpu.eval.serve import Recognizer as JRecognizer
from multimodal_scene_text_recognition_tpu.utils import native as jnative
from multimodal_scene_text_recognition_tpu_torch import api
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig
from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
from multimodal_scene_text_recognition_tpu_torch.ops import resize
from test_torch_model import SMALL

RNG = np.random.default_rng(51)
# (image shape, xywh box): whole crops of the sizes served, a 1-pixel-wide
# crop, a sub-box on whole pixels and one on fractional ones
CASES = {
    "20x60": ((20, 60), None), "47x213": ((47, 213), None), "64x90": ((64, 90), None),
    "13x400": ((13, 400), None), "1 wide": ((30, 1), None),
    "sub-box": ((100, 300), (10.0, 7.0, 150.0, 40.0)),
    "fractional sub-box": ((100, 300), (17.5, 9.25, 120.3, 40.7)),
}
IMAGES = {k: RNG.integers(0, 256, shape, dtype=np.uint8) for k, (shape, _) in CASES.items()}


def _box(name):
    shape, box = CASES[name]
    return np.array([box or (0, 0, shape[1], shape[0])], np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_uint8_resize_matches_jax_native(name):
    """The port's C++ copy against JAX ``crop_resize_gray_batch`` through
    its native library (built with -march=native, where GCC fuses five
    multiply-adds; the copy writes them as fmaf): bit-equal.  Within 1e-6
    of the port's numpy mirror (measured 0) and of JAX's numpy mirror
    (``force_numpy``, measured 1.2e-7), which rounds every product apart:
    on the fractional sub-box its sample coordinates round differently, and
    it is held to JAX's own limit between its two routes, 1e-4
    (tests/test_native.py; measured 1.0e-5)."""
    img, box = IMAGES[name], _box(name)
    assert jnative.have_native()
    got = resize.crop_resize_gray_batch([img], box)
    assert got.shape == (1, 32, 100, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative.crop_resize_gray_batch([img], box))
    np.testing.assert_allclose(got, resize.crop_resize_gray_plain([img], box), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got, jnative.crop_resize_gray_batch([img], box, force_numpy=True),
                               atol=1e-4 if name == "fractional sub-box" else 1e-6, rtol=0)


def test_uint8_resize_batch_threads_and_sizes():
    """Every case in one call, on 1 and 8 threads, equals the cases one at a
    time; other output sizes and boxes reaching past the image equal JAX's
    native library too."""
    imgs = [IMAGES[k] for k in CASES]
    boxes = np.concatenate([_box(k) for k in CASES])
    one = resize.crop_resize_gray_batch(imgs, boxes, threads=1)
    np.testing.assert_array_equal(one, resize.crop_resize_gray_batch(imgs, boxes, threads=8))
    for i, name in enumerate(CASES):
        np.testing.assert_array_equal(one[i:i + 1],
                                      resize.crop_resize_gray_batch([imgs[i]], _box(name)))
    boxes = np.array([[-3.0, -2.0, 80.0, 30.0], [5.0, 1.0, 0.0, -1.0]], np.float32)
    imgs = [IMAGES["64x90"], IMAGES["20x60"]]
    for oh, ow in ((16, 48), (40, 7)):
        np.testing.assert_array_equal(resize.crop_resize_gray_batch(imgs, boxes, oh, ow),
                                      jnative.crop_resize_gray_batch(imgs, boxes, oh, ow))


def test_uint8_resize_raises_when_it_cannot_be_built(monkeypatch, tmp_path):
    """No quiet fallback: a source that does not compile, or no compiler,
    raises; so does an empty crop, before any pointer is passed."""
    with pytest.raises(ValueError, match="non-empty"):
        resize.crop_resize_gray_batch([np.zeros((0, 5), np.uint8)], _box("20x60"))
    bad = tmp_path / "imgproc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(resize, "_lib", None)
    monkeypatch.setattr(resize, "SOURCE", bad)
    monkeypatch.setattr(resize, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed"):
        resize.crop_resize_gray_batch([IMAGES["20x60"]], _box("20x60"))
    monkeypatch.setattr(resize.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        resize.crop_resize_gray_batch([IMAGES["20x60"]], _box("20x60"))
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("shape", [(20, 60), (47, 213), (64, 90), (13, 400), (30, 1), (1, 50)])
def test_float_resize_matches_pil_bicubic(shape):
    """Float crops: bicubic with antialiasing in float64 against PIL's
    mode-F ``BICUBIC`` resize, the JAX package's float route: within 1e-6
    (measured 1.2e-7, a float32 ulp)."""
    crop = np.random.default_rng(52).random(shape, dtype=np.float32)
    want = np.asarray(Image.fromarray(crop, mode="F").resize((100, 32), Image.BICUBIC),
                      np.float32)
    got = resize.resize_float(crop)
    assert got.shape == (32, 100) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def mixed_crops():
    """One list of every kind ``_prepare`` tells apart: uint8 crops of other
    sizes (one 1 wide, one whose maximum is 1, which JAX does not scale and
    so takes back to bytes as 255), float crops in [0, 1] and of uint8
    range, [H, W, 1] crops, and 32x100 crops of both types."""
    rng = np.random.default_rng(53)
    u8 = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)  # noqa: E731
    return [u8(20, 60), u8(47, 213), rng.random((64, 90), dtype=np.float32),
            (rng.random((13, 400)) * 255).astype(np.float32), u8(30, 1),
            rng.integers(0, 2, (24, 80), dtype=np.uint8), u8(40, 120)[..., None],
            rng.random((50, 70, 1)), u8(32, 100), rng.random((32, 100), dtype=np.float32)]


def test_prepare_matches_jax_prepare():
    """``Recognizer.prepare`` against JAX ``Recognizer._prepare`` on the
    mixed list, bucket 12 (two pad rows): the uint8 crops bit-equal, the
    float crops within 1e-6 (PIL against the float64 bicubic), the 32x100
    crops and the pad rows bit-equal."""
    crops = mixed_crops()
    want = np.asarray(JRecognizer(None, None, JConfig())._prepare(crops, 12)["image"])
    rec = Recognizer(api.get_model(cfg=ModelConfig(**SMALL, decode_fused=True), device="cpu"))
    got = rec.prepare(crops, 12)[0].numpy()
    assert got.shape == want.shape == (12, 32, 100, 1)
    floats = [i for i, c in enumerate(crops) if np.asarray(c).dtype != np.uint8]
    exact = [i for i in range(12) if i not in floats]
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got[floats], want[floats], atol=1e-6, rtol=0)
    assert got[5].max() == 1.0  # its 1s taken to 255, as JAX does


def test_recognizer_serves_resized_crops_as_prepared():
    """``recognize`` on crops of other sizes gives the strings of the same
    crops resized first by the plain routes (the numpy mirror, the float
    bicubic) and served at 32x100."""
    crops = mixed_crops()[:4]
    rec = Recognizer(api.get_model(cfg=ModelConfig(**SMALL, decode_fused=True), device="cpu"),
                     batch_sizes=(4,))
    resized = [resize.crop_resize_gray_plain([c], np.array([[0, 0, c.shape[1], c.shape[0]]],
                                                          np.float32))[0, ..., 0]
               if c.dtype == np.uint8 else
               resize.resize_float(c / 255.0 if c.max() > 1.5 else c) for c in crops]
    assert rec.recognize(crops) == rec.recognize(resized)
    image = rec.prepare(crops, 4)[0]
    torch.testing.assert_close(image, rec.prepare(resized, 4)[0], atol=1e-6, rtol=0)
