"""The PyTorch port end to end against the JAX package on the CPU, float32:
a small flagship-shaped model through ``Recognizer`` with converted random
weights, and the trained bundle at full width."""

import dataclasses
import functools

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
import torch_threads

torch_threads.limit()

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


def init_shapes(jm, img, ov, sc, io):
    """The shapes of the JAX model's train-mode variables, traced by
    ``jax.eval_shape`` (``randomize`` reads only the shapes; an eager
    ``init`` compiles each of its ops)."""
    rng = jax.random.PRNGKey(0)
    return jax.eval_shape(functools.partial(jm.init, train=True),
                          {"params": rng, "dropout": rng, "semantics": rng}, img,
                          jnp.zeros((len(img), 26), jnp.int32), ov, sc, io)


def jax_greedy(jm, v, img, ov, sc, io):
    """JAX ``model.apply`` greedily, jitted (one XLA compile instead of one
    a primitive)."""
    return np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
        v, img, None, ov, sc, io))


def test_small_flagship_shape_end_to_end():
    """Small flagship-shaped model (2+2 layers, widths 64/32, TPS and
    ResNet-31 at full depth) with seeded random weights in every slot:
    logits within 1e-3 of JAX, and identical strings through both
    Recognizers on 5 crops (buckets 1 and 4, so one bucket is padded)."""
    jcfg = JModelConfig(**SMALL)
    jm = build_model(jcfg)
    crops = _crops(5, 1)
    img, ov, sc, io = _jax_batch(crops)
    v = randomize(init_shapes(jm, img, ov, sc, io), 9)
    want = jax_greedy(jm, v, img, ov, sc, io)

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
    solve in the path the logits agree within 1e-4 * scale (measured 1.2e-6
    at scale 2.7)."""
    jcfg = JModelConfig(**SMALL, use_tps=False)
    jm = build_model(jcfg)
    img, ov, sc, io = _jax_batch(_crops(2, 4))
    v = randomize(init_shapes(jm, img, ov, sc, io), 10)
    want = jax_greedy(jm, v, img, ov, sc, io)
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
    """Every model variant of the JAX package is ported: the random and
    BERT semantic embedders, the Oscar encoder (with fusion here; without
    it in tests/test_torch_variants.py) and backbone remat are built and run (greedily, or for ``rand`` one
    train step), beside early stop, the fused beam, the fusion hooks the
    fused kernels carry in every linear embedder mode, and the zero
    embedder.  What is still refused raises: a ``rand`` model has no eval
    path (JAX's raises for want of its ``semantics`` stream), and unknown
    names.  The paths lifted earlier (the stepper, the per-layer fusion
    sites, training with every hook) are built and run in
    test_lifted_paths_are_built_and_run."""
    fused = dict(SMALL, decode_fused=True)
    image, overlap = torch.rand(2, 32, 100, 1), torch.randint(0, 50, (2, 15))
    lifted = [dict(semantic_source="rand"), dict(semantic_embedding="bert"),
              dict(semantic_source="rand", multihead_pre_memory=True, decode_fused=False),
              dict(encoder="oscar", oscar_encoder=True), dict(remat=True)]
    for changes in lifted:
        cfg = ModelConfig(**dict(fused, **changes))
        model = api.get_model(None, cfg, device="cpu", seed=1)
        if cfg.semantic_source == "rand":
            with torch.no_grad(), pytest.raises(ValueError, match="rand"):
                model(image, overlap)
            trainer = api.get_trainer(None, cfg, device="cpu", seed=1)
            batch = {"image": (image * 255).to(torch.uint8), "overlap": overlap,
                     "text": torch.randint(3, 50, (2, 27))}
            assert torch.isfinite(trainer(batch)["loss"])
        else:
            with torch.no_grad():
                assert torch.isfinite(model(image, overlap)).all()
    for bad, what in ((dict(encoder="nope"), "encoder"), (dict(decoder="nope"), "decoder"),
                      (dict(semantic_embedding="nope"), "semantic")):
        with pytest.raises(ValueError, match=what):
            SceneTextModel(ModelConfig(**dict(fused, **bad)))
    SceneTextModel(ModelConfig(**fused, decode_early_stop=True, decode_beam_fused=True))
    for mode in ("overlap", "scene", "combined"):
        SceneTextModel(ModelConfig(**fused, semantic_vector=mode, pre_encoder_mlp=True,
                                   pre_decoder_mlp=True, cls_decoder_init=True,
                                   post_decoder_mlp=True))
    SceneTextModel(ModelConfig(**fused, semantic_source="zero", cls_decoder_init=True))


LIFTED = [("decode_fused", {}), ("multihead_pre_target", {"multihead_pre_target": True}),
          ("multihead_pre_memory", {"multihead_pre_memory": True}),
          ("multihead_post_memory", {"multihead_post_memory": True})]
HOOK_MODULES = {"pre_encoder_mlp": "encoder.sem_relevance_mlp",
                "pre_decoder_mlp": "decoder.relevant_mlp",
                "cls_decoder_init": "decoder.sem_cls_mlp", "post_decoder_mlp": "decoder.post_mlp"}
LIFTED += [(f"train {hook}", {"decode_fused": True, hook: True}) for hook in HOOK_MODULES]


@pytest.mark.parametrize("what,changes", LIFTED, ids=[w for w, _ in LIFTED])
def test_lifted_paths_are_built_and_run(what, changes):
    """The configurations the port once refused are built and run at the
    small widths: ``decode_fused=False`` (the JAX default) and each
    per-layer fusion site serve greedily through the stepper (a site also
    by beam search, the fused beam giving way to it), and a model with any
    fusion hook takes a train step whose loss and gradient norm are finite
    and whose hook's weights get a finite gradient (``sem_cls_mlp``'s is
    zero up to rounding: the semantic CLS vector is all ones)."""
    cfg = ModelConfig(**{**SMALL, **changes}, use_tps=False)  # the decoder's and hooks' paths
    image = torch.from_numpy(np.stack(_crops(2, 7))[..., None].astype(np.float32) / 255)
    overlap = torch.ones(2, 15, dtype=torch.long)
    if what.startswith("train"):
        trainer = api.get_trainer(cfg=cfg, device="cpu")
        batch = {"image": image.numpy(), "text": np.tile(np.arange(27) % 97, (2, 1)),
                 "overlap": overlap.numpy()}
        m = trainer(batch)
        assert np.isfinite([m["loss"].item(), m["grad_norm"].item()]).all()
        grads = [p.grad for n, p in trainer.model.named_parameters()
                 if n.startswith(HOOK_MODULES[what.split()[1]])]
        assert grads and all(g is not None and torch.isfinite(g).all() for g in grads)
        return
    model = api.get_model(cfg=dataclasses.replace(cfg, decode_beam_fused=True), device="cpu")
    assert model.decoder.uses_stepper
    with torch.no_grad():
        logits = model(image, overlap)
        tokens, scores = model.beam_decode(image, overlap, 3)
    assert logits.shape == (2, 25, 97) and torch.isfinite(logits).all()
    assert tokens.shape == (2, 25) and torch.isfinite(scores).all()


def test_recognizer_refuses_other_crop_sizes():
    """Crops of other sizes, which the port once refused, are served: each
    resized to 32x100 as the JAX package resizes it (tests/test_torch_resize.py
    holds the batch to JAX ``_prepare``), a [H, W, 3] crop is still refused,
    and float crops in [0, 1] and uint8 crops are the same input."""
    model = api.get_model(cfg=ModelConfig(**SMALL, decode_fused=True), device="cpu")
    rec = Recognizer(model, batch_sizes=(2,))
    other = np.random.default_rng(8).integers(0, 256, (32, 64), dtype=np.uint8)
    texts = rec.recognize([other, other[:20]])
    assert len(texts) == 2
    image = rec.prepare([other], 1)[0]
    assert image.shape == (1, 32, 100, 1) and 0.0 <= image.min() and image.max() <= 1.0
    with pytest.raises(ValueError):
        rec.recognize([np.zeros((32, 100, 3), np.uint8)])
    # float crops in [0, 1] and uint8 crops are the same input
    c = _crops(1, 3)[0]
    assert rec.recognize([c]) == rec.recognize([c.astype(np.float32) / 255.0])
