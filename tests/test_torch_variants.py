"""The remaining model variants of the PyTorch port against the JAX package
on the CPU, float32: the Oscar encoder, the BERT and random semantic
embedders with the tag tokenizer, whole Oscar models greedily, the bridge
for Oscar-BERT and ``remat`` models, a train step of the ``rand`` model,
backbone remat against none, int8 serving of the BiLSTM-Attn and Oscar
models, and the fusion-score introspection.

Weights are the JAX modules' variables trees (``jax.eval_shape`` of their
``init``, which traces without compiling) with every leaf a seeded draw
(``randomize``), carried into the port by its weight bridge.  Module
outputs are held to max |port - jax| <= 1e-4 * max(1, max |jax|) and
their gradients (``jax.vjp`` against autograd, one seeded cotangent) to
the same limit of each tensor's own scale; the docstrings give the scales
and the differences measured when the tests were written."""

import functools
import os

import numpy as np
import pytest

import flax.errors
import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
import torch

from multimodal_scene_text_recognition_tpu.core.charset import AttnCodec as JAttnCodec
from multimodal_scene_text_recognition_tpu.core.config import ModelConfig as JModelConfig
from multimodal_scene_text_recognition_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_scene_text_recognition_tpu.data import bert_tokens as jtokens
from multimodal_scene_text_recognition_tpu.eval import attention as jattention
from multimodal_scene_text_recognition_tpu.models import encoders as jencoders
from multimodal_scene_text_recognition_tpu.models import resnet_int8 as jri
from multimodal_scene_text_recognition_tpu.models import semantic as jsemantic
from multimodal_scene_text_recognition_tpu.models.model import build_model
from multimodal_scene_text_recognition_tpu.train.state import TrainState
from multimodal_scene_text_recognition_tpu.train.state import make_optimizer as j_make_optimizer
from multimodal_scene_text_recognition_tpu.train.steps import make_train_step
from multimodal_scene_text_recognition_tpu_torch import api, convert
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig, TrainConfig
from multimodal_scene_text_recognition_tpu_torch.data import bert_tokens
from multimodal_scene_text_recognition_tpu_torch.eval import attention
from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
from multimodal_scene_text_recognition_tpu_torch.models.encoders import OscarEncoder
from multimodal_scene_text_recognition_tpu_torch.models import decoders
from multimodal_scene_text_recognition_tpu_torch.models.layers import BatchNorm2d
from multimodal_scene_text_recognition_tpu_torch.models.model import SceneTextModel
from multimodal_scene_text_recognition_tpu_torch.models.semantic import (BertEmbedding,
                                                                         RandomEmbedding)
from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode
from test_torch_model import SMALL, _crops
from test_torch_modules import assert_close_to_scale, flatten, load_port, randomize
from test_torch_train import GROUPS, TOLS, _flat, _rel_l2, make_batch
import torch_threads

torch_threads.limit()

CLASSES = os.path.join(os.path.dirname(__file__), "..", "assets", "features",
                       "vinvl_classes.txt")
HID, E = 64, 32  # the columns' width (hidden_dim) and the semantic vectors' (embed_dim)
# the narrow Oscar encoder and BERT embedder of the module tests
NARROW = dict(bert_dim=48, num_heads=4, ff_dim=96, num_layers=2)
RNG = np.random.default_rng(23)


def variables(init, seed, *args, **kw):
    """The variables tree ``init(*args, **kw)`` gives, every leaf a seeded
    draw of its shape (``randomize``)."""
    shapes = jax.eval_shape(functools.partial(init, **kw), *args)
    return randomize(jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), shapes), seed)


def value_and_vjp(fn, cot, *args):
    """``fn(*args)`` and the gradients of ``<fn(*args), cot>`` with respect
    to each argument (``jax.vjp``), in one jitted call."""
    def run(cot, *a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(cot)

    return jax.jit(run)(jnp.asarray(cot), *args)


def grads_as_port(tree):
    """A JAX gradient tree of ``params`` as the port's ``state_dict`` names
    and layouts (through the bridge)."""
    return convert.bundle_to_state_dict({f"params.{k}": np.asarray(a)
                                         for k, a in _flat(tree).items()})


def assert_grads_close(port, jgrads, rel=1e-4):
    """Every parameter's gradient of ``port`` against the converted JAX
    gradients, each to ``rel`` of its own scale; none is all zero."""
    want = grads_as_port(jgrads)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want)
    for k, g in want.items():
        assert g.abs().max() > 0, k
        assert_close_to_scale(got[k].numpy(), g.numpy(), rel)


def tokens(B, T, vocab, seed):
    """Seeded token rows as ``TagTokenizer`` lays them out: [CLS] (1) first,
    ids in 4..vocab-1, trailing 0 pads of seeded lengths."""
    rng = np.random.default_rng(seed)
    out = rng.integers(4, vocab, (B, T))
    out[:, 0] = 1
    for b in range(B):
        out[b, rng.integers(2, T):] = 0
    return out.astype(np.int32)


# -- the modules -----------------------------------------------------------------

@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "visual only"])
def test_oscar_encoder_matches_jax(fuse):
    """The Oscar encoder at narrow widths (bert_dim 48, 4 heads, FF 96, 2
    layers) on columns [2, 26, 64] (with ``fuse_semantics`` and semantic
    vectors [2, 15, 32]): outputs [2, 26, 64] of scale 3.4 (3.6 without
    fusion), measured difference 1.8e-6 (1.3e-6); the gradients of every
    parameter, of the columns and of the semantic vectors under one
    cotangent against ``jax.vjp``, each within 9e-7 of its own scale."""
    cols = RNG.standard_normal((2, 26, HID)).astype(np.float32)
    sem = RNG.standard_normal((2, 15, E)).astype(np.float32)
    jm = jencoders.OscarEncoder(d_model=HID, fuse_semantics=fuse, **NARROW)
    v = variables(jm.init, 31, jax.random.PRNGKey(0), cols, semantics=sem)
    cot = RNG.standard_normal((2, 26, HID)).astype(np.float32)
    want, (gp, gc, gs) = value_and_vjp(
        lambda p, c, s: jm.apply({"params": p}, c, semantics=s), cot, v["params"], cols, sem)

    port = load_port(OscarEncoder(HID, E, fuse_semantics=fuse, **NARROW), v).requires_grad_(True)
    tc, ts = (torch.from_numpy(a).requires_grad_(True) for a in (cols, sem))
    got = port(tc, semantics=ts)
    assert_close_to_scale(got.detach().numpy(), np.asarray(want))
    got.backward(torch.from_numpy(cot))
    assert_grads_close(port, gp)
    assert_close_to_scale(tc.grad.numpy(), np.asarray(gc))
    if fuse:
        assert_close_to_scale(ts.grad.numpy(), np.asarray(gs))
    else:
        assert ts.grad is None and not np.asarray(gs).any()


def test_bert_embedding_matches_jax():
    """The BERT embedder at narrow widths (vocab 60, model_dim 48, 2 layers,
    4 heads, FF 96, 32 positions) on token rows [3, 15] with trailing pads
    (attended, as in JAX): semantic vectors [3, 15, 32] of scale 3.5,
    measured difference 1.4e-6, and every parameter's gradient under one
    cotangent against ``jax.vjp`` (the pad rows' token gradient included),
    each within 1.4e-6 of its own scale."""
    ids = tokens(3, 15, 60, 32)
    jm = jsemantic.BertEmbedding(vocab_size=60, embed_dim=E, model_dim=48, num_layers=2,
                                 num_heads=4, ff_dim=96, max_positions=32)
    z = np.zeros((3, 52), np.int32)
    v = variables(jm.init, 33, jax.random.PRNGKey(0), ids, z, z.astype(np.float32))
    cot = RNG.standard_normal((3, 15, E)).astype(np.float32)
    want, (gp,) = value_and_vjp(lambda p: jm.apply({"params": p}, ids, z, z), cot, v["params"])

    port = load_port(BertEmbedding(60, E, 48, 2, 4, 96, 32), v).requires_grad_(True)
    zt = torch.zeros(3, 52)
    got = port(torch.from_numpy(ids).long(), zt.long(), zt)
    assert_close_to_scale(got.detach().numpy(), np.asarray(want))
    got.backward(torch.from_numpy(cot))
    assert_grads_close(port, gp)


def test_random_embedding():
    """Uniform [0, 1) noise [B, n_ov, E] from the generator passed: the same
    from the same seed, fresh each call; without a generator (every eval
    path) it raises, where JAX's raises for want of its ``semantics``
    stream."""
    emb = RandomEmbedding(E)
    ov = torch.zeros(4, 15, dtype=torch.long)
    z = torch.zeros(4, 52)
    g = torch.Generator().manual_seed(3)
    a, b = emb(ov, z.long(), z, g), emb(ov, z.long(), z, g)
    again = emb(ov, z.long(), z, torch.Generator().manual_seed(3))
    assert a.shape == (4, 15, E) and a.dtype == torch.float32
    assert a.min() >= 0 and a.max() < 1 and 0.45 < a.mean() < 0.55
    assert torch.equal(a, again) and not torch.equal(a, b)
    with pytest.raises(ValueError, match="rand"):
        emb(ov, z.long(), z)
    jm = jsemantic.RandomEmbedding(E)
    with pytest.raises(flax.errors.InvalidRngError):
        jm.apply({}, ov.numpy(), z.numpy(), z.numpy())


def test_tag_tokenizer_matches_jax():
    """``TagTokenizer`` on ``assets/features/vinvl_classes.txt``: the same
    vocabulary as JAX's, and the same rows for tag lists with several words
    to a tag, upper case, unknown words, repeats by frequency and rows cut
    at ``max_len``."""
    got = bert_tokens.tokenizer_from_class_file(CLASSES)
    want = jtokens.tokenizer_from_class_file(CLASSES)
    assert got.vocab == want.vocab and got.vocab_size == want.vocab_size > 1000
    assert [got.vocab[t] for t in bert_tokens.SPECIALS] == [0, 1, 2, 3]
    cases = [(["man", "Traffic Light"], {}), (["zzzunknown", "dog", "the sky"], {}),
             ([], {}), (["man", "dog"], dict(encode_frequency=True, counts=[3, 2])),
             (["man", "dog"], dict(encode_frequency=True, counts=None)),
             (["man"] * 20, dict(max_len=15)), (["mountain", "bag"], dict(max_len=3))]
    for tags, kw in cases:
        row = got.encode_tags(tags, **kw)
        np.testing.assert_array_equal(row, want.encode_tags(tags, **kw), err_msg=str(tags))
        assert row.dtype == np.int32 and row.shape == (kw.get("max_len", 64),)
    assert (got.encode_tags(["zzzunknown"], max_len=4) == [1, 3, 0, 0]).all()
    vocab = {"[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "[UNK]": 3, "a": 4}
    assert (bert_tokens.TagTokenizer([], vocab=vocab).encode_tags(["a", "b"], 5)
            == jtokens.TagTokenizer([], vocab=vocab).encode_tags(["a", "b"], 5)).all()


# -- whole models ------------------------------------------------------------------

OSCAR_BERT = dict(encoder="oscar", oscar_encoder=True, semantic_embedding="bert",
                  cls_decoder_init=True)
OSCAR_VISUAL = dict(encoder="oscar")  # visual only, the linear embedder
B = 3


def init_shapes(jm):
    """The shapes of a whole JAX model's variables (its eval-mode ``init``,
    which makes the train-mode tree and traces quicker)."""
    k = jax.random.PRNGKey(0)
    args = (np.zeros((1, 32, 100, 1), np.float32), np.zeros((1, 26), np.int32),
            np.zeros((1, 15), np.int32), np.zeros((1, 52), np.int32),
            np.full((1, 52), -1000.0, np.float32))
    return jax.eval_shape(jm.init, {"params": k, "dropout": k, "semantics": k}, *args)


def fast_variables(jm, seed, shapes=None):
    """:func:`variables` of a whole JAX model (of ``shapes``, by default
    :func:`init_shapes`), drawn uniform in float32 for speed (the Oscar
    encoder and the BERT embedder hold ~150M weights), with ``randomize``'s
    means and variances: kernels and tables of variance 1/fan_in, norm
    scales 1 + 0.1 u, other vectors 0.1 u (u of variance 1), running
    variances ~ U(0.5, 1.5)."""
    shapes = shapes if shapes is not None else init_shapes(jm)
    rng = np.random.default_rng(seed)

    def draw(path, t):
        name, shape = path[-1].key, t.shape
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        x = (rng.random(shape, dtype=np.float32) - np.float32(0.5)) * np.float32(np.sqrt(12.0))
        if name == "scale":
            return 1.0 + 0.1 * x
        return x / np.float32(np.sqrt(np.prod(shape[:-1]))) if len(shape) >= 2 else 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(cfg, v):
    """``SceneTextModel(cfg)`` holding the JAX variables ``v`` (eval mode,
    gradients off): built on the meta device and given the converted
    tensors, strictly, so that ~150M weights are neither initialized nor
    copied twice."""
    with torch.device("meta"):
        model = SceneTextModel(cfg)
    model.load_state_dict(convert.bundle_to_state_dict(flatten(v)), strict=True, assign=True)
    return model.eval().requires_grad_(False)


def model_inputs(seed, bert: bool):
    """Crops [B, 32, 100, 1] in [0, 1] and overlap rows: BERT tag token
    rows (``TagTokenizer`` on ``vinvl_classes.txt``, 15 wide) or object ids,
    each with trailing pads."""
    rng = np.random.default_rng(seed)
    img = np.stack(_crops(B, seed)).astype(np.float32)[..., None] / 255.0
    if bert:
        tok = bert_tokens.tokenizer_from_class_file(CLASSES)
        labels = [line.strip() for line in open(CLASSES)]
        ov = np.stack([tok.encode_tags(list(rng.choice(labels, rng.integers(1, 8))), 15)
                       for _ in range(B)])
    else:
        ov = rng.integers(1, 2000, (B, 15)).astype(np.int32)
        ov[:, 9:] = 0
    return img, ov


def twin(model, cfg):
    """A port model of ``cfg`` sharing ``model``'s tensors (no copy)."""
    with torch.device("meta"):
        out = SceneTextModel(cfg)
    out.load_state_dict(model.state_dict(), strict=True, assign=True)
    return out.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def oscar_bert():
    """The JAX Oscar-BERT model (the Oscar encoder and the BERT embedder at
    their fixed widths, the rest at SMALL, with the semantic CLS step-0
    input), its variables, and the port's model holding them."""
    jm = build_model(JModelConfig(**SMALL, **OSCAR_BERT))
    v = fast_variables(jm, 41)
    return jm, v, port_model(ModelConfig(**SMALL, **OSCAR_BERT, decode_fused=True), v)


def _greedy_vs_jax(jm, v, model, seed, bert):
    img, ov = model_inputs(seed, bert)
    z = np.zeros((B, 52), np.int32)
    want = np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
        v, img, None, ov, z, np.full((B, 52), -1000.0, np.float32)))
    got = model(torch.from_numpy(img), torch.from_numpy(ov).long()).numpy()
    assert got.shape == want.shape == (B, 25, 97)
    assert_close_to_scale(got, want)
    codec = JAttnCodec(ModelConfig().chars)
    assert codec.decode(got.argmax(-1)) == codec.decode(want.argmax(-1))
    return model


@pytest.mark.parametrize("name", ["Oscar-BERT", "Oscar visual only"])
def test_oscar_model_greedy_matches_jax(name, oscar_bert):
    """Greedy logits [3, 25, 97] and strings of the whole model (TPS,
    ResNet-31, the semantic embedder, the Oscar encoder, the transformer
    decoder through K1's plain version) against JAX ``model.apply`` (its
    XLA scan): Oscar-BERT on tag token rows (with the semantic CLS
    step-0 input), scale 2.6, measured difference 9.7e-6; and the Oscar
    encoder without fusion on object ids through the linear embedder,
    scale 2.8, measured 3.9e-6."""
    if name == "Oscar-BERT":
        _greedy_vs_jax(*oscar_bert, 42, bert=True)
    else:
        jm = build_model(JModelConfig(**SMALL, **OSCAR_VISUAL))
        v = fast_variables(jm, 43)
        model = port_model(ModelConfig(**SMALL, **OSCAR_VISUAL, decode_fused=True), v)
        _greedy_vs_jax(jm, v, model, 43, bert=False)
        assert not hasattr(model.encoder, "sem_to_bert")


def test_bundle_round_trip(oscar_bert):
    """The Oscar-BERT bundle converts and loads strictly into the port, and
    ``state_dict_to_bundle`` gives back the same keys and values; a JAX
    model built with ``remat`` has exactly the keys of one without, and
    loads strictly into a port model with ``remat``."""
    jm, v, model = oscar_bert
    flat = flatten(v)
    assert any(".seg_embed." in k for k in flat) and any(".tok." in k for k in flat)
    back = convert.state_dict_to_bundle(model.state_dict())
    assert set(back) == set(flat)
    for k, arr in back.items():
        np.testing.assert_array_equal(arr, flat[k], err_msg=k)

    micro = dict(SMALL, use_tps=False)
    remat = jax.eval_shape(build_model(JModelConfig(**micro, remat=True)).init,
                           {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                           np.zeros((1, 32, 100, 1), np.float32), np.zeros((1, 26), np.int32),
                           np.zeros((1, 15), np.int32), np.zeros((1, 52), np.int32),
                           np.zeros((1, 52), np.float32))
    plain = fast_variables(build_model(JModelConfig(**micro)), 44)
    assert set(flatten(remat)) == set(flatten(plain))
    assert port_model(ModelConfig(**micro, remat=True), plain).cfg.remat


# -- training ------------------------------------------------------------------

MICRO = dict(SMALL, use_tps=False, dropout=0.0)
RAND = dict(semantic_source="rand", pre_encoder_mlp=True)


def test_rand_train_step_matches_jax():
    """One train step of the flagship shape with the random semantic source
    and the pre-encoder fusion that reads it (B=4, TPS off, no dropout, the
    default optimizer) against JAX ``make_train_step``, with the port's
    noise (the first draw of a generator seeded with ``TrainConfig().seed``,
    which the trainer's own generator draws) fed to JAX's
    ``RandomEmbedding`` through ``flax.linen.intercept_methods``: loss,
    token accuracy, gradient norm, every gradient group and every updated
    parameter, each within the larger of ``test_torch_train.TOLS``' two
    limits (and the smaller share of parameters checked after the update).
    The backbone's ReLUs flip at these widths, as in that file with TPS
    and in tests/test_torch_classic.py, and here the pre-encoder fusion
    carries them into every later gradient.  Measured when the test was
    written, at three weight seeds (this one, 45, first): relative L2 of
    the decoder's gradients 1.25e-5, 3.2e-6, 7.5e-6 (limit 2e-4), the
    encoder's <= 9.9e-4 (5e-3), the backbone's 4.7e-3 to 1.4e-2 (6e-2).
    The relevance MLP's last bias gets a zero gradient in exact arithmetic
    (the softmax over the objects ignores it), so both packages give only
    rounding there."""
    jm = build_model(JModelConfig(**MICRO, **RAND))
    v = fast_variables(jm, 45)
    batch = make_batch(4, 8)
    noise = torch.rand(4, 15, E, generator=torch.Generator().manual_seed(TrainConfig().seed))

    def feed_noise(next_fun, args, kwargs, context):
        if isinstance(context.module, jsemantic.RandomEmbedding):
            return jnp.asarray(noise.numpy())
        return next_fun(*args, **kwargs)

    keep = optax.GradientTransformation(lambda params: params,
                                        lambda g, state, params=None: (g, g))
    tx = optax.chain(keep, j_make_optimizer(JTrainConfig()))
    raw_step = make_train_step(jm, tx, jit_compile=False)

    @jax.jit
    def step_and_grads(params, b):
        state = TrainState(step=0, params=params, batch_stats=v["batch_stats"],
                           opt_state=tx.init(params))
        with fnn.intercept_methods(feed_noise):
            new_state, metrics = raw_step(state, b, jax.random.PRNGKey(0))
        return new_state, metrics, new_state.opt_state[0]

    new_state, m, grads = step_and_grads(v["params"], {k: jnp.asarray(a)
                                                       for k, a in batch.items()})
    trainer = api.get_trainer(cfg=ModelConfig(**MICRO, **RAND), device="cpu")
    trainer.model.load_state_dict(convert.bundle_to_state_dict(flatten(v)), strict=True)
    got = trainer(batch)
    port_grads = {k: p.grad for k, p in trainer.model.named_parameters()}
    grads = grads_as_port(grads)
    new = grads_as_port(new_state.params)
    tol = {k: max(TOLS[False][k], TOLS[True][k]) for k in TOLS[False]}
    tol["agree"] = min(TOLS[False]["agree"], TOLS[True]["agree"])
    assert got["loss"].item() == pytest.approx(float(m["loss"]), rel=tol["loss"])
    assert got["token_acc"].item() == pytest.approx(float(m["token_acc"]), abs=1e-6)
    assert got["grad_norm"].item() == pytest.approx(float(m["grad_norm"]), rel=tol["grad_norm"])
    assert set(grads) == set(port_grads)
    for group, prefixes in GROUPS.items():
        keys = [k for k in grads if k.startswith(prefixes)]
        assert keys and _rel_l2(port_grads, grads, keys) <= tol[group], group
    assert grads["encoder.sem_relevance_mlp.fc0.weight"].abs().max() > 0
    state = trainer.model.state_dict()
    agree_n = total = 0
    for k, want in new.items():
        agree = (port_grads[k] - grads[k]).abs() <= 0.1 * grads[k].abs()
        agree_n += int(agree.sum())
        total += agree.numel()
        diff = (state[k] - want).abs()[agree]
        assert diff.numel() == 0 or diff.max().item() <= 1e-5, k
    assert agree_n / total >= tol["agree"]
    with pytest.raises(ValueError, match="rand"):
        Recognizer(trainer.model.eval(), batch_sizes=(4,)).recognize(_crops(2, 3))


def test_remat_matches_no_remat():
    """A train step (B=4, TPS on, dropout 0.1) of the same weights with and
    without ``remat``: the backbone's BatchNorms run twice a step with it
    (the backward recomputes them) and once without, yet the loss, every
    gradient and every running statistic are equal, bit for bit."""
    batch = make_batch(4, 9)
    runs = {}
    for remat in (False, True):
        trainer = api.get_trainer(cfg=ModelConfig(**dict(SMALL, dropout=0.1), remat=remat),
                                  device="cpu", seed=7)
        backbone = {id(m) for m in trainer.model.feature_extractor.modules()}
        calls = []
        for m in trainer.model.modules():
            if isinstance(m, BatchNorm2d):
                m.register_forward_hook(lambda mod, i, o: calls.append(id(mod) in backbone))
        out = trainer(batch)
        runs[remat] = (out, {k: p.grad for k, p in trainer.model.named_parameters()
                             if p.grad is not None},
                       {k: t for k, t in trainer.model.state_dict().items() if "running" in k},
                       sum(calls), len(calls) - sum(calls))
    (out0, g0, s0, bb0, other0), (out1, g1, s1, bb1, other1) = runs[False], runs[True]
    assert bb1 == 2 * bb0 > 0 and other1 == other0 > 0
    assert out1["loss"].item() == out0["loss"].item()
    assert out1["grad_norm"].item() == out0["grad_norm"].item()
    assert set(g1) == set(g0) and len(g0) > 100
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k


# -- serving -------------------------------------------------------------------

INT8_CASES = {"BiLSTM-Attn": dict(encoder="lstm", decoder="lstm", tps_int8=True,
                                  lstm_hidden=48),
              "Oscar-BERT": dict(OSCAR_BERT, tps_int8=True)}


@pytest.mark.parametrize("name", list(INT8_CASES))
def test_int8_recognizer_matches_jax(name, oscar_bert, tmp_path, monkeypatch):
    """``Recognizer(int8_backbone=True)`` (the int8 loc-net and ResNet-31 in
    front of the model's own encoder and decoder) on 3 crops against JAX
    ``make_int8_eval_step`` with the same activation scales (the port's
    calibration, persisted and loaded as a served model finds them): the
    same strings.  BiLSTM-Attn at SMALL widths with ``lstm_hidden`` 48, where
    a beam width decodes greedily with scores 0.0, as JAX's Recognizer
    does; Oscar-BERT on tag token rows with the float decoder, then with
    ``decode_int8`` through K1q's plain version (its int8 tables; that
    route is held against the Pallas kernel in
    tests/test_torch_fused_decode.py: here the two packages' float32
    encoders differ by ~1e-6, enough to move an int8 rounding of the
    decoder's activations, so its ids are not compared with JAX's)."""
    changes = INT8_CASES[name]
    bert = name == "Oscar-BERT"
    jm = build_model(JModelConfig(**SMALL, **changes))
    if bert:
        _, v, model = oscar_bert
        model = twin(model, ModelConfig(**SMALL, **changes, decode_fused=True))
    else:
        v = fast_variables(jm, 46)
        model = port_model(ModelConfig(**SMALL, **changes), v)
    img, ov = model_inputs(47, bert)
    crops = list(img[..., 0])
    scales = str(tmp_path / "s.npz")
    Recognizer(model, batch_sizes=(B,), int8_backbone=True,
               int8_scales_path=scales).calibrate_int8(crops)
    rec = Recognizer(model, batch_sizes=(B,), int8_backbone=True, int8_scales_path=scales)
    texts, scores = rec.recognize(crops, beam_size=0 if bert else 5, return_scores=True,
                                  semantics={"overlap": ov})
    z = np.zeros((B, 52), np.int32)
    jstep, jq = jri.make_int8_eval_step(jm, v, x_absmax=rec._int8_absmax)
    want = np.asarray(jstep(v, jq, {"image": img, "overlap": ov, "scene": z,
                                    "ious": np.full((B, 52), -1000.0, np.float32)}))
    assert texts == JAttnCodec(ModelConfig().chars).decode(want) and scores == [0.0] * B
    if not bert:
        assert rec.recognize(crops) == texts
        return
    seen = []
    real = fused_decode.fused_greedy_decode

    def spy(*a, **kw):
        seen.append(kw["scales"] is not None)
        return real(*a, **kw)

    monkeypatch.setattr(decoders, "fused_greedy_decode", spy)
    model_q = twin(model, ModelConfig(**SMALL, **changes, decode_fused=True, decode_int8=True))
    rec_q = Recognizer(model_q, batch_sizes=(B,), int8_backbone=True, int8_scales_path=scales)
    assert len(rec_q.recognize(crops, semantics={"overlap": ov})) == B and seen == [True]


def test_collect_attention_scores_matches_jax():
    """``collect_attention_scores`` of a small model with the pre-encoder
    and pre-decoder fusion (TPS off) against JAX's on the same batch: the
    same keys (JAX's walk of its ``intermediates``) and scores [3, 26, 15],
    each row a softmax, within 1e-5; a model without the hooks gives
    ``{}``; ``format_scores`` tabulates a sample in percent."""
    changes = dict(pre_encoder_mlp=True, pre_decoder_mlp=True)
    jm = build_model(JModelConfig(**MICRO, **changes))
    v = fast_variables(jm, 48)
    batch = make_batch(B, 10)
    batch["ious"] = np.full((B, 52), -1000.0, np.float32)
    jbatch = dict(batch, image=batch["image"].astype(np.float32) / 255.0)
    want = jattention.collect_attention_scores(Jitted(jm), v, jbatch)
    model = port_model(ModelConfig(**MICRO, **changes, decode_fused=True), v)
    got = attention.collect_attention_scores(model, batch)
    assert set(got) == set(want) == {"encoder/pre_encoder_scores", "decoder/pre_decoder_scores"}
    for k in want:
        assert got[k].shape == (B, 26, 15)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k].sum(-1), 1.0, atol=1e-5)
    assert model.encoder.intermediates is None and model.decoder.intermediates is None
    table = attention.format_scores(got["encoder/pre_encoder_scores"], sample=1)
    assert table.shape == (26, 15)
    np.testing.assert_allclose(table.to_numpy(),
                               np.round(got["encoder/pre_encoder_scores"][1] * 100, 2))
    assert attention.collect_attention_scores(port_model(ModelConfig(**MICRO), without_hooks(v)),
                                              batch) == {}


def without_hooks(v):
    """``v`` without the fusion MLPs' weights (a model without the hooks)."""
    drop = ("sem_relevance_mlp", "combine_mlp", "relevant_mlp")
    return {c: {m: {k: s for k, s in sub.items() if k not in drop}
                if m in ("encoder", "decoder") else sub for m, sub in tree.items()}
            for c, tree in v.items()}


class Jitted:
    """A JAX model whose ``apply`` in eval mode with the ``intermediates``
    collection mutable (the one call ``collect_attention_scores`` makes) is
    jitted: the same values, compiled once instead of run op by op."""

    def __init__(self, jm):
        self._apply = jax.jit(lambda v, *a: jm.apply(v, *a, train=False,
                                                      mutable=["intermediates"]))

    def apply(self, variables, *args, train, mutable):
        assert not train and list(mutable) == ["intermediates"]
        return self._apply(variables, *args)
