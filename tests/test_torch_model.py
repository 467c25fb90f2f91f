"""The PyTorch port end to end against the JAX package on the CPU, float32:
a small flagship-shaped model through ``Recognizer`` with converted random
weights, and the trained bundle at full width."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.core.charset import AttnCodec as JAttnCodec
from multimodal_scene_text_recognition_tpu.core.config import Config as JConfig
from multimodal_scene_text_recognition_tpu.core.config import ModelConfig as JModelConfig
from multimodal_scene_text_recognition_tpu.data.synthetic import make_dataset
from multimodal_scene_text_recognition_tpu.eval.serve import Recognizer as JRecognizer
from multimodal_scene_text_recognition_tpu.models.model import build_model
from multimodal_scene_text_recognition_tpu_torch import api, convert
from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP, ModelConfig
from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
from multimodal_scene_text_recognition_tpu_torch.models.model import SceneTextModel
from test_torch_modules import flatten, randomize

BUNDLE = "assets/trained/synth_openvocab_xxl.params.npz"
SMALL = dict(enc_layers=2, dec_layers=2, ff_dim=64, hidden_dim=64, embed_dim=32,
             num_heads=4, compute_dtype="float32")


def _crops(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (32, 100), dtype=np.uint8) for _ in range(n)]


def _jax_batch(crops):
    """uint8 or [0, 1] float crops -> the JAX model's inputs."""
    img = np.stack([c.astype(np.float32) / (255.0 if c.dtype == np.uint8 else 1.0)
                    for c in crops])[..., None]
    B = len(crops)
    return (jnp.asarray(img), jnp.zeros((B, 15), jnp.int32),
            jnp.zeros((B, 52), jnp.int32), jnp.full((B, 52), -1000.0))


def test_small_flagship_shape_end_to_end():
    """Small flagship-shaped model (2+2 layers, widths 64/32, TPS and
    ResNet-31 at full depth) with seeded random weights in every slot:
    logits within 1e-3 of JAX, and identical strings through both
    Recognizers on 5 crops (buckets 1 and 4, so one bucket is padded)."""
    jcfg = JModelConfig(**SMALL)
    jm = build_model(jcfg)
    crops = _crops(5, 1)
    img, ov, sc, io = _jax_batch(crops)
    rng = jax.random.PRNGKey(0)
    v = jm.init({"params": rng, "dropout": rng, "semantics": rng}, img,
                jnp.zeros((5, 26), jnp.int32), ov, sc, io, train=True)
    v = randomize(v, 9)
    want = np.asarray(jm.apply(v, img, None, ov, sc, io, train=False))

    model = SceneTextModel(ModelConfig(**SMALL, decode_fused=True))
    model.load_state_dict(convert.bundle_to_state_dict(flatten(v)), strict=True)
    model.eval().requires_grad_(False)
    got = model(torch.from_numpy(np.asarray(img)),
                torch.zeros(5, 15, dtype=torch.long)).numpy()
    assert got.shape == want.shape == (5, 25, 97)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)

    texts = Recognizer(model, batch_sizes=(1, 4)).recognize(crops)
    jtexts = JRecognizer(jm, v, JConfig(model=jcfg), batch_sizes=(1, 4)).recognize(crops)
    assert texts == jtexts
    assert texts == JAttnCodec(jcfg.chars).decode(want.argmax(-1))


def test_no_tps_ablation():
    """use_tps=False feeds the crops straight to the backbone; with no TPS
    solve in the path the logits agree within 1e-4 * scale (measured 1.4e-6
    at scale 2.7)."""
    jcfg = JModelConfig(**SMALL, use_tps=False)
    jm = build_model(jcfg)
    img, ov, sc, io = _jax_batch(_crops(2, 4))
    rng = jax.random.PRNGKey(0)
    v = randomize(jm.init({"params": rng, "dropout": rng, "semantics": rng}, img,
                          jnp.zeros((2, 26), jnp.int32), ov, sc, io, train=True), 10)
    want = np.asarray(jm.apply(v, img, None, ov, sc, io, train=False))
    model = SceneTextModel(ModelConfig(**SMALL, use_tps=False, decode_fused=True))
    model.load_state_dict(convert.bundle_to_state_dict(flatten(v)), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(np.asarray(img)),
                           torch.zeros(2, 15, dtype=torch.long)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def trained_jax_variables():
    flat = convert.load_bundle(BUNDLE)
    variables = {}
    for key, arr in flat.items():
        if key in convert.META_KEYS:
            continue
        *path, leaf = key.split(".")
        node = variables
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr.astype(np.float32))
    return variables


def test_trained_bundle_matches_jax_greedy(trained_jax_variables):
    """The trained flagship at full width, B=2, float32, on two word crops
    rendered by the JAX package's synthetic-data renderer: the port's strings
    equal JAX greedy's (JAX built with decode_fused=False: its scan decode
    equals the fused kernel in float32) and the labels.  The logits agree within 5e-3
    (measured 2.1e-3): JAX's float32 TPS solve moves the sample
    points by up to 3.5e-5 (test_torch_ops) and the trained backbone carries
    the resulting pixel differences through."""
    samples = make_dataset(2, seed=5)
    crops = [s.image[..., 0] for s in samples]  # float32 in [0, 1]
    img, ov, sc, io = _jax_batch(crops)
    jcfg = JModelConfig(compute_dtype="float32", decode_fused=False)
    want = np.asarray(jax.jit(
        lambda v, *a: build_model(jcfg).apply(v, *a, train=False)
    )(trained_jax_variables, img, None, ov, sc, io))
    jtexts = JAttnCodec(jcfg.chars).decode(want.argmax(-1))

    model = api.get_model(BUNDLE, dataclasses.replace(FLAGSHIP, compute_dtype="float32"),
                          device="cpu")
    texts = Recognizer(model, batch_sizes=(2,)).recognize(crops)
    assert texts == jtexts
    assert texts == [s.label for s in samples]
    got = model(torch.from_numpy(np.asarray(img)), torch.zeros(2, 15, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)


def test_get_model_requires_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        api.get_model(cfg=ModelConfig(**SMALL, decode_fused=True))


def test_unported_paths_are_refused():
    """Greedy decoding through the stepper (decode_fused=False) and the
    semantic CLS step-0 input are not ported; early stop and the fused beam
    are."""
    for cfg in (ModelConfig(**SMALL), ModelConfig(**SMALL, decode_fused=True,
                                                   cls_decoder_init=True)):
        with pytest.raises(NotImplementedError):
            SceneTextModel(cfg)
    SceneTextModel(ModelConfig(**SMALL, decode_fused=True, decode_early_stop=True,
                               decode_beam_fused=True))


def test_recognizer_refuses_other_crop_sizes():
    model = api.get_model(cfg=ModelConfig(**SMALL, decode_fused=True), device="cpu")
    rec = Recognizer(model, batch_sizes=(2,))
    with pytest.raises(ValueError):
        rec.recognize([np.zeros((32, 64), np.uint8)])
    # float crops in [0, 1] and uint8 crops are the same input
    c = _crops(1, 3)[0]
    assert rec.recognize([c]) == rec.recognize([c.astype(np.float32) / 255.0])
