"""Int8 serving of the port against the JAX package on the CPU: the whole
int8 model (int8 loc-net, backbone, encoder and K1q's plain version) against
JAX ``make_int8_eval_step`` at a small config, the trained bundle with its
committed scales, and the Recognizer's handling of activation scales
(JAX tests/test_serve.py)."""

import dataclasses
import functools
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.core.charset import AttnCodec as JAttnCodec
from multimodal_scene_text_recognition_tpu.core.config import ModelConfig as JModelConfig
from multimodal_scene_text_recognition_tpu.data.synthetic import make_dataset
from multimodal_scene_text_recognition_tpu.models import resnet_int8 as jri
from multimodal_scene_text_recognition_tpu.models.model import build_model
from multimodal_scene_text_recognition_tpu_torch import api, convert
from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP, ModelConfig
from multimodal_scene_text_recognition_tpu_torch.eval import serve
from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
from multimodal_scene_text_recognition_tpu_torch.models import resnet_int8 as ri
from multimodal_scene_text_recognition_tpu_torch.models.model import (SceneTextModel,
                                                                      make_int8_eval_step)
from test_torch_model import BUNDLE, SMALL, _crops, _jax_batch, trained_jax_variables  # noqa: F401
from test_torch_modules import flatten, randomize
import torch_threads

torch_threads.limit()

SCALES = BUNDLE.replace(".params.npz", ".scales.npz")
INT8 = dict(decode_fused=True, decode_int8=True, encoder_int8=True, tps_int8=True)
# the word crops the trained bundle reads here, and on the card in
# tests/test_torch_cuda.py::test_served_int8_reads_the_words_on_the_card
WORDS = dict(size=8, seed=77)


def test_small_int8_model_matches_jax_int8_eval_step():
    """A small flagship-shaped model (TPS and ResNet-31 at full depth, 2+2
    layers, widths 64/32) with seeded random weights, every int8 switch on,
    float32, on 3 crops with the same persisted-style scales (JAX's
    calibration, ``tps/`` keys included): the port's int8 step gives
    exactly the ids of JAX's ``make_int8_eval_step`` (the int8 products are
    exact in both; K1q's plain version against the interpreted Pallas
    kernel)."""
    jcfg = JModelConfig(**SMALL, **INT8)
    jm = build_model(jcfg)
    crops = _crops(3, 7)
    img, ov, sc, io = _jax_batch(crops)
    rng = jax.random.PRNGKey(0)
    init = jax.jit(functools.partial(jm.init, train=True))  # jitted: 4x quicker than eager
    v = randomize(init({"params": rng, "dropout": rng, "semantics": rng}, img,
                       jnp.zeros((3, 26), jnp.int32), ov, sc, io), 12)
    rectified = jax.jit(lambda v, x: jm.apply(v, x, method=type(jm).rectify))(v, img)
    absmax = jri.calibrate_resnet(v, rectified, output_channels=jcfg.hidden_dim)
    absmax.update({f"tps/{k}": x for k, x in jri.calibrate_tps(v, img).items()})
    jstep, jq = jri.make_int8_eval_step(jm, v, x_absmax=absmax)
    want = np.asarray(jstep(v, jq, {"image": img, "overlap": ov, "scene": sc, "ious": io}))

    model = SceneTextModel(ModelConfig(**SMALL, **INT8))
    model.load_state_dict(convert.bundle_to_state_dict(flatten(v)), strict=True)
    model.eval().requires_grad_(False)
    step, qsites = make_int8_eval_step(model, x_absmax=absmax)
    assert sum(k.startswith("tps/") for k in qsites) == 4
    got = step(torch.from_numpy(np.asarray(img)), torch.zeros(3, 15, dtype=torch.long))
    assert got.shape == want.shape == (3, 25)
    np.testing.assert_array_equal(got.numpy(), want)


def test_trained_bundle_int8_matches_jax_and_labels(trained_jax_variables):
    """The trained flagship at full width, float32, B=8, on the WORDS crops
    rendered by the JAX package's renderer, served through the int8 loc-net,
    backbone and encoder with the committed scales (found beside the
    bundle): the port's strings equal those of JAX's ``make_int8_eval_step``
    (float decoder, the XLA scan) and the labels.  With K1q's plain version
    as the decoder too (``decode_int8``) they still equal the labels."""
    samples = make_dataset(**WORDS)
    crops = [s.image[..., 0] for s in samples]
    img, ov, sc, io = _jax_batch(crops)
    jcfg = JModelConfig(compute_dtype="float32", decode_fused=False, tps_int8=True,
                        encoder_int8=True)
    jstep, jq = jri.make_int8_eval_step(build_model(jcfg), trained_jax_variables,
                                        x_absmax=jri.load_activation_scales(SCALES))
    want = np.asarray(jstep(trained_jax_variables, jq,
                            {"image": img, "overlap": ov, "scene": sc, "ious": io}))
    jtexts = JAttnCodec(jcfg.chars).decode(want)

    cfg = dataclasses.replace(FLAGSHIP, compute_dtype="float32", tps_int8=True,
                              encoder_int8=True)
    model = api.get_model(BUNDLE, cfg, device="cpu")
    rec = Recognizer(model, batch_sizes=(8,), int8_backbone=True)
    assert rec.int8_scales_path == SCALES and rec._int8_absmax is not None
    texts = rec.recognize(crops)
    assert texts == jtexts == [s.label for s in samples]
    model_q = SceneTextModel(dataclasses.replace(cfg, decode_int8=True))
    model_q.load_state_dict(model.state_dict(), strict=True)
    rec_q = Recognizer(model_q.eval(), batch_sizes=(8,), int8_backbone=True,
                       int8_scales_path=SCALES)
    assert rec_q.recognize(crops) == texts


def test_trained_bundle_int8_bf16_reads_the_words():
    """The served configuration itself (bf16 compute, early stop, every
    int8 switch, the committed scales; plain versions on the CPU) reads the
    WORDS crops: every string equals its label, as JAX's int8 step's do
    (test_trained_bundle_int8_matches_jax_and_labels)."""
    samples = make_dataset(**WORDS)
    crops = [s.image[..., 0] for s in samples]
    cfg = dataclasses.replace(FLAGSHIP, decode_early_stop=True, **INT8)
    rec = Recognizer(api.get_model(BUNDLE, cfg, device="cpu"), batch_sizes=(8,),
                     int8_backbone=True)
    assert rec.recognize(crops) == [s.label for s in samples]


@pytest.fixture(scope="module")
def small_model():
    return api.get_model(cfg=ModelConfig(**SMALL, **INT8, decode_early_stop=True), device="cpu",
                         seed=5)


def test_persisted_scales_are_loaded_not_calibrated(small_model, tmp_path, monkeypatch):
    """Scales persisted beside the bundle (``<bundle>.scales.npz``) are
    found and loaded when the Recognizer is built; serving never calibrates
    and gives the strings of a Recognizer that calibrated on the same crops
    (a full bucket, so the lazy calibration sees exactly them)."""
    crops = _crops(4, 11)
    lazy = Recognizer(small_model, batch_sizes=(4,), int8_backbone=True)
    assert lazy._int8_absmax is None
    want = lazy.recognize(crops)
    small_model.bundle_path = str(tmp_path / "m.params.npz")
    try:
        ri.save_activation_scales(str(tmp_path / "m.scales.npz"), lazy._int8_absmax)
        rec = Recognizer(small_model, batch_sizes=(4,), int8_backbone=True)
    finally:
        small_model.bundle_path = None
    assert rec.int8_scales_path == str(tmp_path / "m.scales.npz")
    assert rec._int8_absmax == pytest.approx(lazy._int8_absmax)

    def refuse(*a):
        raise AssertionError("calibrated although scales were persisted")

    monkeypatch.setattr(rec, "calibrate_int8", refuse)
    assert rec.recognize(crops) == want


def test_lazy_calibration_sees_only_real_crops(small_model, monkeypatch):
    """Without scales the first call calibrates on its own crops, the pad
    rows of the bucket filled by cycling them (never zeros), and keeps the
    scales; a later call does not calibrate again."""
    seen = []
    real = serve.calibrate_tps

    def spy(transformation, images):
        seen.append(images.clone())
        return real(transformation, images)

    monkeypatch.setattr(serve, "calibrate_tps", spy)
    crops = _crops(3, 12)
    rec = Recognizer(small_model, batch_sizes=(2, 8), int8_backbone=True)
    texts = rec.recognize(crops)
    assert len(texts) == 3 and len(seen) == 1
    batch = seen[0][..., 0].numpy()
    assert batch.shape == (8, 32, 100)
    for i, row in enumerate(batch):
        np.testing.assert_array_equal(row, crops[i % 3].astype(np.float32) / 255.0)
    absmax = dict(rec._int8_absmax)
    rec.recognize(crops[:1])
    assert len(seen) == 1 and rec._int8_absmax == absmax


def test_drift_warning_fires_once(small_model, tmp_path):
    """Persisted scales far below what the crops produce warn once, on the
    first call; the int8 steps are built per decoding kind (greedy, beam
    k=3) and kept."""
    crops = _crops(2, 13)
    probe = Recognizer(small_model, batch_sizes=(2,), int8_backbone=True)
    probe.calibrate_int8(crops)
    path = str(tmp_path / "low.scales.npz")
    ri.save_activation_scales(path, {k: v / 10 for k, v in probe._int8_absmax.items()})
    rec = Recognizer(small_model, batch_sizes=(2,), int8_backbone=True, int8_scales_path=path)
    with pytest.warns(UserWarning, match="drifted"):
        rec.recognize(crops)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rec.recognize(crops)
        texts, scores = rec.recognize(crops, beam_size=3, return_scores=True)
    assert len(texts) == 2 and all(np.isfinite(scores)) and max(scores) <= 0
    assert set(rec._int8_steps) == {None, 3}
    greedy = rec._int8_steps[None]
    rec.recognize(crops)
    assert rec._int8_steps[None] is greedy


def test_tps_int8_needs_tps_scales(small_model):
    """tps_int8 with persisted scales that have no ``tps/`` keys raises (as
    JAX's make_int8_eval_step does); with them the step builds."""
    crops = _crops(2, 14)
    rec = Recognizer(small_model, batch_sizes=(2,), int8_backbone=True)
    rec.calibrate_int8(crops)
    backbone = {k: v for k, v in rec._int8_absmax.items() if not k.startswith("tps/")}
    with pytest.raises(ValueError, match="tps/"):
        make_int8_eval_step(small_model, x_absmax=backbone)
    make_int8_eval_step(small_model, x_absmax=rec._int8_absmax)
