"""The semantic fusion hooks of the PyTorch port against the JAX package on
the CPU, float32: the embedders, the fusion MLP and its relevance fusion,
the pre-encoder fusion, the decoder's memory fusion, semantic CLS vector
and logit fusion, then a small model of the served semantic configuration
(every hook the fused kernels carry) greedily, by the three beam forms,
with the logit fusion, in int8 and through ``Recognizer.recognize(
semantics=)``.

Weights are the JAX modules' variables trees (``jax.eval_shape`` of their
``init``, which traces without compiling) with every leaf a seeded draw
(``randomize``), carried into the port by its weight bridge.  Module
comparisons hold max |port - jax| <= 1e-4 * max(1, max |jax|), as
tests/test_torch_modules.py does; the docstrings give the scale and the
difference measured when the test was written."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.core.charset import EOS_ID
from multimodal_scene_text_recognition_tpu.core.config import Config as JConfig
from multimodal_scene_text_recognition_tpu.core.config import ModelConfig as JModelConfig
from multimodal_scene_text_recognition_tpu.eval.serve import Recognizer as JRecognizer
from multimodal_scene_text_recognition_tpu.models import layers as jlayers
from multimodal_scene_text_recognition_tpu.models import resnet_int8 as jri
from multimodal_scene_text_recognition_tpu.models import semantic as jsemantic
from multimodal_scene_text_recognition_tpu.models.decoders import (
    TransformerDecoder as JTransformerDecoder,
)
from multimodal_scene_text_recognition_tpu.models.encoders import (
    TransformerEncoder as JTransformerEncoder,
)
from multimodal_scene_text_recognition_tpu.models.model import build_model
from multimodal_scene_text_recognition_tpu_torch import convert
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig
from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
from multimodal_scene_text_recognition_tpu_torch.models.decoders import TransformerDecoder
from multimodal_scene_text_recognition_tpu_torch.models.encoders import TransformerEncoder
from multimodal_scene_text_recognition_tpu_torch.models.layers import FusionMLP, relevance_fusion
from multimodal_scene_text_recognition_tpu_torch.models.model import (SceneTextModel,
                                                                      make_int8_eval_step)
from multimodal_scene_text_recognition_tpu_torch.models.semantic import build_semantic_embedder
from test_torch_model import SMALL, _crops
from test_torch_modules import assert_close_to_scale, flatten, load_port, randomize
import torch_threads

torch_threads.limit()

E, HID, C, NOBJ = 32, 64, 97, 2000
# the served semantic configuration at the small size: every hook the fused
# decode and beam kernels carry (not the per-layer sites)
SEMANTIC = dict(semantic_vector="combined", pre_encoder_mlp=True, pre_decoder_mlp=True,
                cls_decoder_init=True, decode_fused=True, decode_beam_fused=True)
POST = ("post_mlp", "post_combine_mlp", "sem_to_classes")  # post_decoder_mlp's modules


def semantic_inputs(B, seed, n_ov=15, n_sc=52):
    """Seeded object ids and ious as a detector hands them over: overlap ids
    in 0..1999 with trailing 0 pads, scene ids likewise, ious float32 with
    -1000 at the scene pads."""
    rng = np.random.default_rng(seed)
    ov = rng.integers(1, NOBJ, (B, n_ov))
    sc = rng.integers(1, NOBJ, (B, n_sc))
    ious = rng.uniform(0.0, 1.0, (B, n_sc)).astype(np.float32)
    for b in range(B):
        ov[b, rng.integers(n_ov // 2, n_ov):] = 0
        pad = rng.integers(n_sc // 2, n_sc)
        sc[b, pad:] = 0
        ious[b, pad:] = -1000.0
    return ov.astype(np.int32), sc.astype(np.int32), ious


def variables(init, seed, *args, **kw):
    """The variables tree ``init(*args, **kw)`` gives, every leaf a seeded
    draw of its shape (``randomize``)."""
    shapes = jax.eval_shape(functools.partial(init, **kw), *args)
    return randomize(jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), shapes), seed)


def _port_sem_inputs(ov, sc, ious):
    return (torch.from_numpy(ov.astype(np.int64)), torch.from_numpy(sc.astype(np.int64)),
            torch.from_numpy(ious))


# -- modules -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["overlap", "scene", "combined", "zero"])
def test_embedder_matches_jax(mode):
    """Semantic vectors [3, 15, 32] of each embedder (``scene`` [3, 52, 32],
    the ious-softmax weights; ``combined`` the two tables and the ``combine``
    dense layer), pads included: scale 3.1e-3 (scene) to 0.29, measured
    difference 0 (lookups, combined) and 4.7e-10 (scene); zero is all
    zeros."""
    ov, sc, ious = semantic_inputs(3, 1)
    if mode == "zero":
        jm = jsemantic.ZeroEmbedding(E)
        cfg = ModelConfig(embed_dim=E, semantic_source="zero")
    else:
        jm = jsemantic.LinearEmbedding(NOBJ, E, mode=mode)
        cfg = ModelConfig(embed_dim=E, semantic_vector=mode)
    v = variables(jm.init, 21, jax.random.PRNGKey(0), ov, sc, ious)
    want = np.asarray(jm.apply(v, ov, sc, ious))
    port = load_port(build_semantic_embedder(cfg), v)
    got = port(*_port_sem_inputs(ov, sc, ious)).numpy()
    assert got.shape == want.shape == (3, 52 if mode == "scene" else 15, E)
    assert_close_to_scale(got, want)
    assert (got == 0).all() == (mode == "zero")


@pytest.mark.parametrize("kind", ["MLP", "MLPP"])
def test_fusion_mlp_matches_jax(kind):
    """The port's FusionMLP against both JAX fusion MLPs (3 layers, 24 ->
    16 -> 16 -> 5), loaded through the bridge (MLP: ``fc{i}.kernel``;
    MLPP: flat ``fc{i}_kernel``): outputs [2, 4, 5] of scale 0.60, measured
    difference 1.8e-7."""
    x = np.random.default_rng(2).standard_normal((2, 4, 24)).astype(np.float32)
    jm = (jlayers.MLP(16, 5, num_layers=3) if kind == "MLP"
          else jlayers.MLPP(24, 16, 5, num_layers=3))
    v = variables(jm.init, 22, jax.random.PRNGKey(0), x)
    want = np.asarray(jm.apply(v, x))
    port = load_port(FusionMLP(24, 16, 5, 3), v)
    assert_close_to_scale(port(torch.from_numpy(x)).numpy(), want)


def test_relevance_fusion_matches_jax():
    """relevance_fusion of features [2, 5, 24] with semantic vectors
    [2, 7, 8] (one object row all zero, as a pad's may be: not masked),
    scores from a 3-layer MLP: [2, 5, 8] of scale 0.76, measured difference
    2.4e-7; the pair tensor is never formed in the port."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 5, 24)).astype(np.float32)
    sem = rng.standard_normal((2, 7, 8)).astype(np.float32)
    sem[:, -1] = 0.0
    jm = jlayers.MLP(16, 1, num_layers=3)
    v = variables(jm.init, 23, jax.random.PRNGKey(0), np.zeros((1, 32), np.float32))
    want = np.asarray(jlayers.relevance_fusion(jnp.asarray(feats), jnp.asarray(sem),
                                               lambda p: jm.apply(v, p)))
    port = load_port(FusionMLP(32, 16, 1, 3), v)
    got = relevance_fusion(torch.from_numpy(feats), torch.from_numpy(sem), port).numpy()
    assert got.shape == (2, 5, 8)
    assert_close_to_scale(got, want)


def test_pre_encoder_fusion_matches_jax():
    """The encoder with ``pre_encoder_mlp`` (columns [2, 26, 64], semantic
    vectors [2, 15, 32]): encoded [2, 26, 64] of scale 3.6, measured
    difference 1.8e-6; the fusion moves the output (it is not skipped)."""
    rng = np.random.default_rng(4)
    cols = rng.standard_normal((2, 26, HID)).astype(np.float32)
    sem = rng.standard_normal((2, 15, E)).astype(np.float32)
    jm = JTransformerEncoder(d_model=HID, embed_dim=E, num_heads=4, ff_dim=128, num_layers=2,
                             max_len=26, pre_encoder_mlp=True)
    v = variables(jm.init, 24, jax.random.PRNGKey(0), cols, semantics=sem)
    want = np.asarray(jm.apply(v, cols, semantics=sem))
    port = load_port(TransformerEncoder(HID, 4, 128, 2, 26, pre_encoder_mlp=True, embed_dim=E), v)
    got = port(torch.from_numpy(cols), semantics=torch.from_numpy(sem)).numpy()
    assert_close_to_scale(got, want)
    assert np.abs(got - port.encode(torch.from_numpy(cols)).numpy()).max() > 1e-2


@pytest.fixture(scope="module")
def fusion_decoder():
    """A small JAX decoder with the three fusion hooks and its port twin."""
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((3, 26, HID)).astype(np.float32)
    sem = rng.standard_normal((3, 15, E)).astype(np.float32)
    jm = JTransformerDecoder(num_classes=C, d_model=E, memory_dim=HID, num_heads=4, ff_dim=64,
                             num_layers=2, dropout=0.0, max_text_length=25,
                             pre_decoder_mlp=True, cls_decoder_init=True, post_decoder_mlp=True)
    k = jax.random.PRNGKey(0)
    v = variables(jm.init, 25, {"params": k, "dropout": k}, enc, np.zeros((3, 26), np.int32),
                  sem, train=True)
    port = load_port(TransformerDecoder(C, E, HID, 4, 64, 2, 25, torch.float32,
                                        pre_decoder_mlp=True, cls_decoder_init=True,
                                        post_decoder_mlp=True), v)
    return jm, v, port, enc, sem


def _no_drop(x, site):
    return x


@pytest.mark.parametrize("hook", ["memory", "sem_cls", "post_decoder"])
def test_decoder_fusion_hooks_match_jax(hook, fusion_decoder):
    """JAX ``_memory`` (pre_decoder_mlp: [3, 26, 32] of scale 4.0, measured
    1.4e-6), ``_sem_cls`` ([3, 32], every element 1 up to rounding: the
    softmax over memory positions is summed over the same axis; measured
    2.4e-7, two float32 ulps at 1, held at 1e-6 with some elements off 1.0,
    so a port that returned ones would fail) and ``_post_decoder`` (logits
    [3, 25, 97] of scale 4.1, measured 7.2e-7)."""
    jm, v, port, enc, sem = fusion_decoder
    te, ts = torch.from_numpy(enc), torch.from_numpy(sem)
    if hook == "memory":
        want = jm.apply(v, enc, sem, method=lambda m, e, s: m._memory(e, s, _no_drop))
        got = port.memory(te, ts)
    elif hook == "sem_cls":
        want = jm.apply(v, enc, sem,
                        method=lambda m, e, s: m._sem_cls(m._memory(e, s, _no_drop), s))
        got = port.sem_cls(port.memory(te, ts), ts)
    else:
        logits = np.random.default_rng(6).standard_normal((3, 25, C)).astype(np.float32)
        want = jm.apply(v, logits, sem, method=lambda m, lg, s: m._post_decoder(lg, s))
        got = port.post_decoder(torch.from_numpy(logits), ts)
    want, got = np.asarray(want), got.numpy()
    assert_close_to_scale(got, want)
    if hook == "sem_cls":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert (got != 1.0).any() and np.abs(got - 1.0).max() < 1e-5


# -- the whole small model of the served semantic configuration ----------

B = 3


@pytest.fixture(scope="module")
def sem_model():
    return make_sem_model()


def make_sem_model():
    """The JAX variables of the small semantic model with
    ``post_decoder_mlp``, 3 crops with their seeded objects, and the JAX model's
    column features of them (the shared input of the from-columns cases)."""
    jcfg = JModelConfig(**SMALL, **SEMANTIC, post_decoder_mlp=True)
    jm = build_model(jcfg)
    crops = _crops(B, 31)
    img = np.stack(crops)[..., None].astype(np.float32) / 255.0
    ov, sc, ious = semantic_inputs(B, 32)
    k = jax.random.PRNGKey(0)
    v = variables(jm.init, 33, {"params": k, "dropout": k, "semantics": k}, img,
                  np.zeros((B, 26), np.int32), ov, sc, ious, train=True)
    cols = jm.apply(v, jm.apply(v, img, method=type(jm).rectify), method=type(jm).features)
    return dict(jcfg=jcfg, v=v, crops=crops, img=img, ov=ov, sc=sc, ious=ious,
                cols=np.array(cols))


def _without_post(variables):
    """The variables without ``post_decoder_mlp``'s modules."""
    params = dict(variables["params"])
    params["decoder"] = {k: t for k, t in params["decoder"].items() if k not in POST}
    return dict(variables, params=params)


def _jax(s, **changes):
    """The JAX model of the fixture's config with ``changes``, and the
    variables it takes."""
    cfg = dataclasses.replace(s["jcfg"], **{"post_decoder_mlp": False, **changes})
    v = s["v"] if cfg.post_decoder_mlp else _without_post(s["v"])
    return build_model(cfg), v


def _port(s, **changes):
    """The port's model of the same config, loaded strictly."""
    cfg = ModelConfig(**{**SMALL, **SEMANTIC, **changes})
    _, v = _jax(s, **changes)
    model = SceneTextModel(cfg)
    model.load_state_dict(convert.bundle_to_state_dict(flatten(v)), strict=True)
    return model.eval().requires_grad_(False)


def _first_eos(row):
    hit = np.flatnonzero(row == EOS_ID)
    return hit[0] if hit.size else len(row) - 1


@pytest.mark.parametrize("early_stop", [False, True])
def test_semantic_model_greedy_matches_jax(early_stop, sem_model):
    """The whole model (TPS, ResNet-31, embedder, pre-encoder fusion,
    encoder, pre-decoder fusion, semantic CLS step 0, fused greedy loop) on
    3 crops with their objects, against JAX ``model.apply``: logits within
    1e-3 (test_torch_model's limit for the whole model: JAX's TPS solve
    carries ~3e-5 of float32 error; measured 4.2e-6 at scale 3.4) up to each
    row's first [s] (the port stops each row, JAX the batch), tokens
    identical there."""
    s = sem_model
    jm, v = _jax(s, decode_early_stop=early_stop)
    want = np.asarray(jm.apply(v, s["img"], None, s["ov"], s["sc"], s["ious"], train=False))
    model = _port(s, decode_early_stop=early_stop)
    with torch.no_grad():
        got = model(torch.from_numpy(s["img"]), torch.from_numpy(s["ov"].astype(np.int64)),
                    scene=torch.from_numpy(s["sc"].astype(np.int64)),
                    ious=torch.from_numpy(s["ious"])).numpy()
    assert got.shape == want.shape == (B, 25, C)
    for g, w in zip(got, want):
        n = _first_eos(w.argmax(-1)) + 1
        np.testing.assert_array_equal(g[:n].argmax(-1), w[:n].argmax(-1))
        np.testing.assert_allclose(g[:n], w[:n], atol=1e-3, rtol=0)


def _jax_reorder_beam(m, cols, ov, sc, ious, k):
    sem = m.semantic(ov, sc, ious)
    return m.decoder.beam_decode(m.encoder(cols, semantics=sem), sem, beam_size=k,
                                 reorder_caches=True)


@pytest.mark.parametrize("form", ["fused", "ancestry", "reorder"])
def test_semantic_model_beam_forms_match_jax(form, sem_model):
    """Beam search (k=3, early stop) of the semantic model from the same
    column features, every beam starting from its row's semantic CLS
    vector: the fused beam (the plain version of K4 against the interpreted
    Pallas kernel), the ancestry scan and the reorder form each give JAX's
    form's tokens, and scores within 1e-6 of their size (measured 1.9e-7 to
    3.2e-7: up to 1.9e-5 at scale 59, the sum of 25 float32
    log-probabilities; JAX's own fused-vs-XLA beam limit, 1e-5 on scores of
    scale ~5, is 2e-6 of their size)."""
    s = sem_model
    jm, v = _jax(s, decode_early_stop=True, decode_beam_fused=form == "fused")
    args = (s["cols"], s["ov"], s["sc"], s["ious"])
    if form == "reorder":
        want_t, want_s = jm.apply(v, *args, 3, method=_jax_reorder_beam)
    else:
        want_t, want_s = jm.apply(v, *args, 3, method=type(jm).beam_from_columns)
    model = _port(s, decode_early_stop=True, decode_beam_fused=form == "fused")
    ov, sc, ious = _port_sem_inputs(s["ov"], s["sc"], s["ious"])
    cols = torch.from_numpy(s["cols"])
    with torch.no_grad():
        if form == "reorder":
            sem = model.semantics(ov, sc, ious)
            got_t, got_s = model.decoder.beam_decode(model.encoder(cols, semantics=sem), sem,
                                                     beam_size=3, reorder_caches=True)
        else:
            got_t, got_s = model.beam_from_columns(cols, ov, scene=sc, ious=ious, beam_size=3)
    want_t, want_s = np.asarray(want_t), np.asarray(want_s)
    for g, w in zip(got_t.numpy(), want_t):
        n = _first_eos(w) + 1
        np.testing.assert_array_equal(g[:n], w[:n])
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=0, rtol=1e-6)


def test_semantic_model_post_decoder_greedy_matches_jax(sem_model):
    """Greedy decoding with ``post_decoder_mlp`` too, from the same column
    features: the fused loop's logits fused with the semantics mapped to
    classes, within 1e-4 * scale of JAX's (measured 1.7e-6 at scale 4.8),
    argmax identical; beam search refuses the configuration, as JAX's
    does."""
    s = sem_model
    jm, v = _jax(s, post_decoder_mlp=True)
    args = (s["cols"], s["ov"], s["sc"], s["ious"])
    want = np.asarray(jm.apply(v, *args, method=type(jm).decode_from_columns))
    model = _port(s, post_decoder_mlp=True)
    ov, sc, ious = _port_sem_inputs(s["ov"], s["sc"], s["ious"])
    with torch.no_grad():
        got = model.decode_from_columns(torch.from_numpy(s["cols"]), ov, scene=sc,
                                        ious=ious).numpy()
        with pytest.raises(NotImplementedError):
            model.beam_from_columns(torch.from_numpy(s["cols"]), ov, scene=sc, ious=ious)
    assert_close_to_scale(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_semantic_model_int8_matches_jax_int8_eval_step(sem_model):
    """Every int8 switch on the semantic model, JAX's calibration of the 3
    crops: the port's int8 step (int8 loc-net, backbone and encoder, the
    fusion hooks in float32, K1q's plain version with the semantic CLS
    step-0 row) gives exactly the ids of JAX's ``make_int8_eval_step``."""
    s = sem_model
    int8 = dict(decode_int8=True, encoder_int8=True, tps_int8=True)
    jm, v = _jax(s, **int8)
    img = jnp.asarray(s["img"])
    absmax = jri.calibrate_resnet(v, jm.apply(v, img, method=type(jm).rectify),
                                  output_channels=HID)
    absmax.update({f"tps/{k}": x for k, x in jri.calibrate_tps(v, img).items()})
    jstep, jq = jri.make_int8_eval_step(jm, v, x_absmax=absmax)
    want = np.asarray(jstep(v, jq, {"image": img, "overlap": s["ov"], "scene": s["sc"],
                                    "ious": s["ious"]}))
    step, _ = make_int8_eval_step(_port(s, **int8), x_absmax=absmax)
    got = step(torch.from_numpy(s["img"]), *_port_sem_inputs(s["ov"], s["sc"], s["ious"]))
    assert got.shape == want.shape == (B, 25)
    np.testing.assert_array_equal(got.numpy(), want)


def test_recognizer_semantics_matches_jax(sem_model):
    """``Recognizer.recognize(crops, semantics=)`` of the semantic model
    (greedy with early stop, one bucket of 4, so one pad row) gives JAX
    ``Recognizer.recognize(crops, semantics=)``'s strings.  The batch it
    serves holds the given objects and, as JAX fills it, zeros in the pad
    row; without ``semantics`` it holds JAX's defaults (no objects, ious
    -1000)."""
    s = sem_model
    jm, v = _jax(s, decode_early_stop=True)
    sem = {"overlap": s["ov"], "scene": s["sc"], "ious": s["ious"]}
    want = JRecognizer(jm, v, JConfig(model=jm.cfg), batch_sizes=(4,)).recognize(
        s["crops"], semantics=sem)
    rec = Recognizer(_port(s, decode_early_stop=True), batch_sizes=(4,))
    assert rec.recognize(s["crops"], semantics=sem) == want
    _, ov, sc, ious = rec.prepare(s["crops"], 4, semantics=sem)
    np.testing.assert_array_equal(ious[:B].numpy(), s["ious"])
    np.testing.assert_array_equal(sc[:B].numpy(), s["sc"])
    assert (ov[B] == 0).all() and (sc[B] == 0).all() and (ious[B] == 0).all()
    _, ov, sc, ious = rec.prepare(s["crops"], 4)
    assert ov.shape == (4, 15) and sc.shape == (4, 52) and (ov == 0).all() and (sc == 0).all()
    assert (ious == -1000.0).all()


def test_semantic_bundle_round_trip(sem_model, tmp_path):
    """The semantic model's JAX variables (``post_decoder_mlp`` included:
    the combined embedder's two tables and dense layer, the encoder's MLP
    layers, the decoder's flat MLPP leaves, ``sem_to_classes``) load
    strictly into the port, and ``state_dict_to_bundle`` gives every key
    back unchanged, so JAX's own ``restore_params_bundle`` restores the
    tree from it."""
    from flax import struct

    from multimodal_scene_text_recognition_tpu.train.checkpoint import restore_params_bundle

    @struct.dataclass
    class State:
        params: dict
        batch_stats: dict
        step: int

    s = sem_model
    flat = flatten(s["v"])
    assert {"params.decoder.sem_cls_mlp.fc0_kernel", "params.semantic.overlap_embed.embedding",
            "params.encoder.sem_relevance_mlp.fc2.kernel",
            "params.decoder.sem_to_classes.kernel"} <= set(flat)
    model = _port(s, post_decoder_mlp=True)
    back = convert.state_dict_to_bundle(model.state_dict())
    assert set(back) == set(flat)
    for k, arr in back.items():
        np.testing.assert_array_equal(arr, flat[k], err_msg=k)
    path = tmp_path / "semantic.params.npz"
    np.savez(path, __step__=np.int64(7), **back)
    template = State(params=s["v"]["params"], batch_stats=s["v"]["batch_stats"], step=0)
    restored = restore_params_bundle(str(path), template)
    assert restored.step == 7
    for coll in ("params", "batch_stats"):
        for k, arr in flatten({coll: getattr(restored, coll)}).items():
            np.testing.assert_array_equal(arr, flat[k], err_msg=k)
