"""The classic recognizers of the PyTorch port against the JAX package on the
CPU, float32: the LSTM primitives, the BiLSTM encoder, the LSTM-attention
decoder and the linear decoder; the CTC codec, loss and collapse; whole
models of the BiLSTM-Attn, BiLSTM-CTC and mixed configurations greedily;
one BiLSTM-CTC train step; validation in the CTC codec; and the bundle
round trip.

Widths: JAX ``tests/test_train.py``'s MICRO (one layer each, 32 wide, two
heads) with ``lstm_hidden=48``, so that the BiLSTM encoder's output (and
the decoder's memory) is narrower or wider than ``hidden_dim``, as at full
width (256 against 512); TPS off.  Weights: the JAX modules' variables
trees (``jax.eval_shape`` of their ``init``, which traces without
compiling) with every leaf a seeded draw, carried into the port by its
weight bridge.  Logits are held to max |port - jax| <= 1e-5 * max(1, max
|jax|) with identical argmax tokens."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from multimodal_scene_text_recognition_tpu.core.charset import CTCCodec as JCTCCodec
from multimodal_scene_text_recognition_tpu.core.config import ModelConfig as JModelConfig
from multimodal_scene_text_recognition_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_scene_text_recognition_tpu.eval import evaluate as jevaluate
from multimodal_scene_text_recognition_tpu.models import decoders as jdecoders
from multimodal_scene_text_recognition_tpu.models import encoders as jencoders
from multimodal_scene_text_recognition_tpu.models.model import build_model
from multimodal_scene_text_recognition_tpu.ops import lstm as jlstm
from multimodal_scene_text_recognition_tpu.train.state import TrainState
from multimodal_scene_text_recognition_tpu.train.state import make_optimizer as j_make_optimizer
from multimodal_scene_text_recognition_tpu.train.steps import ctc_collapse as j_ctc_collapse
from multimodal_scene_text_recognition_tpu.train.steps import ctc_loss as j_ctc_loss
from multimodal_scene_text_recognition_tpu.train.steps import make_eval_step as j_make_eval_step
from multimodal_scene_text_recognition_tpu.train.steps import make_train_step
from multimodal_scene_text_recognition_tpu_torch import api, convert
from multimodal_scene_text_recognition_tpu_torch.charset import CTCCodec
from multimodal_scene_text_recognition_tpu_torch.config import Config, ModelConfig, TrainConfig
from multimodal_scene_text_recognition_tpu_torch.data import synthetic
from multimodal_scene_text_recognition_tpu_torch.data.pipeline import Batcher, batches
from multimodal_scene_text_recognition_tpu_torch.eval import evaluate
from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
from multimodal_scene_text_recognition_tpu_torch.models.decoders import (LinearDecoder,
                                                                         LSTMAttentionDecoder)
from multimodal_scene_text_recognition_tpu_torch.models.encoders import BiLSTMEncoder
from multimodal_scene_text_recognition_tpu_torch.models.model import SceneTextModel
from multimodal_scene_text_recognition_tpu_torch.ops import lstm, precision
from multimodal_scene_text_recognition_tpu_torch.train.loop import build_codec
from multimodal_scene_text_recognition_tpu_torch.train.steps import (TrainStep, ctc_collapse,
                                                                     ctc_loss, make_eval_step)
from test_torch_modules import assert_close_to_scale, flatten, load_port, randomize
from test_torch_train import GROUPS, TOLS, _flat, _rel_l2, make_batch
import torch_threads

torch_threads.limit()

MICRO = dict(enc_layers=1, dec_layers=1, ff_dim=32, hidden_dim=32, embed_dim=32, lstm_hidden=48,
             num_heads=2, compute_dtype="float32", dropout=0.0, use_tps=False)
ATTN = dict(encoder="lstm", decoder="lstm")  # BiLSTM-Attn
CTC = dict(encoder="lstm", decoder="linear", label_codec="ctc")  # BiLSTM-CTC
CHARS = ModelConfig().chars
C_ATTN, C_CTC = 3 + len(CHARS), 1 + len(CHARS)
T, I, H = 26, 32, 48
RNG = np.random.default_rng(17)


def variables(init, seed, *args, **kw):
    """The variables tree ``init(*args, **kw)`` gives, every leaf a seeded
    draw of its shape."""
    shapes = jax.eval_shape(functools.partial(init, **kw), *args)
    return randomize(jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), shapes), seed)


def assert_logits(got, want, rel=1e-5):
    """Identical argmax tokens, and max |got - want| <= rel * max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * scale {scale}"


def load_under(name, module, v):
    """Load the converted variables of a JAX module whose own leaves sit at
    its root (the LSTM decoder's cell) into ``module``, strictly, through
    the bridge as the model's ``name`` (the bridge maps module paths)."""
    holder = torch.nn.Module()
    holder.add_module(name, module)
    flat = {f"{c}.{name}.{k.partition('.')[2]}": a for k, a in flatten(v).items()
            for c in [k.partition(".")[0]]}
    holder.load_state_dict(convert.bundle_to_state_dict(flat), strict=True)
    return module.eval().requires_grad_(False)


# -- the LSTM primitives and the modules ---------------------------------------

def _lstm_weights():
    return jlstm.LSTMWeights(*(RNG.standard_normal(s).astype(np.float32) * 0.3
                               for s in ((I, 4 * H), (H, 4 * H), (4 * H,), (4 * H,))))


def _torch_lstm(w):
    """An ``nn.LSTM`` holding JAX's weights ``w`` (w_ih [I, 4H] transposed,
    both biases kept)."""
    mod = torch.nn.LSTM(I, H, batch_first=True)
    mod.load_state_dict({"weight_ih_l0": torch.from_numpy(w.w_ih.T.copy()),
                         "weight_hh_l0": torch.from_numpy(w.w_hh.T.copy()),
                         "bias_ih_l0": torch.from_numpy(w.b_ih),
                         "bias_hh_l0": torch.from_numpy(w.b_hh)})
    return mod


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_jax(reverse):
    """``lstm_scan`` on an ``nn.LSTM`` against JAX ``ops/lstm.lstm_scan``
    with the same weights: the reverse scan's outputs sit at their input
    positions in both."""
    x = RNG.standard_normal((3, T, I)).astype(np.float32)
    w = _lstm_weights()
    want = np.asarray(jlstm.lstm_scan(jnp.asarray(x), w, reverse=reverse))
    with torch.no_grad():
        got = lstm.lstm_scan(torch.from_numpy(x), _torch_lstm(w), reverse=reverse).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bilstm_matches_jax():
    x = RNG.standard_normal((2, T, I)).astype(np.float32)
    ws = [_lstm_weights(), _lstm_weights()]
    want = np.asarray(jlstm.bilstm(jnp.asarray(x), *ws))
    with torch.no_grad():
        got = lstm.bilstm(torch.from_numpy(x), *map(_torch_lstm, ws)).numpy()
    assert got.shape == (2, T, 2 * H)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bilstm_encoder_matches_jax():
    """Two BiLSTM blocks, 32 -> 48 -> 48 wide (scale 0.65 when written)."""
    x = RNG.standard_normal((3, T, I)).astype(np.float32)
    jm = jencoders.BiLSTMEncoder(H, H)
    v = variables(jm.init, 1, jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    port = load_port(BiLSTMEncoder(I, H, H), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert_logits(got.numpy(), want)


@pytest.fixture(scope="module")
def lstm_decoder():
    """The JAX LSTM-attention decoder over a 48-wide memory, its seeded
    variables, the port's decoder loaded from them, a memory and teacher
    ids."""
    enc = (RNG.standard_normal((3, T, H)) * 0.5).astype(np.float32)
    text = RNG.integers(0, C_ATTN, (3, 26)).astype(np.int32)
    jm = jdecoders.LSTMAttentionDecoder(num_classes=C_ATTN, input_dim=H, hidden_dim=H)
    v = variables(jm.init, 2, jax.random.PRNGKey(0), jnp.asarray(enc), jnp.asarray(text),
                  train=True)
    port = load_under("decoder", LSTMAttentionDecoder(C_ATTN, H, H), v)
    return jm, v, port, enc, text


def test_lstm_decoder_teacher_forced_matches_jax(lstm_decoder):
    jm, v, port, enc, text = lstm_decoder
    want = jm.apply(v, jnp.asarray(enc), jnp.asarray(text), train=True)
    with torch.no_grad():
        got = port.teacher_forced(torch.from_numpy(enc), torch.from_numpy(text).long())
    assert got.shape == (3, 26, C_ATTN)
    assert_logits(got.numpy(), want)


def test_lstm_decoder_greedy_matches_jax(lstm_decoder):
    """26 steps from [GO], each fed the previous argmax."""
    jm, v, port, enc, _ = lstm_decoder
    want = jm.apply(v, jnp.asarray(enc), None, train=False)
    with torch.no_grad():
        got = port.greedy_decode(torch.from_numpy(enc))
    assert got.shape == (3, 26, C_ATTN)
    assert_logits(got.numpy(), want)


def test_lstm_decoder_gradients_match_jax_vjp(lstm_decoder):
    """The teacher-forced pass's gradients (every parameter and the memory)
    under a seeded cotangent against ``jax.vjp`` of the JAX module alone,
    relative L2 per tensor."""
    jm, v, port, enc, text = lstm_decoder
    cot = RNG.standard_normal((3, 26, C_ATTN)).astype(np.float32)

    def f(params, e):
        return jm.apply({"params": params}, e, jnp.asarray(text), train=True)

    _, vjp = jax.vjp(f, v["params"], jnp.asarray(enc))
    g_params, g_enc = vjp(jnp.asarray(cot))
    want = convert.bundle_to_state_dict({f"params.decoder.{k}": np.asarray(a)
                                         for k, a in _flat(g_params).items()})
    port = port.train().requires_grad_(True)
    e = torch.from_numpy(enc).requires_grad_(True)
    (port.teacher_forced(e, torch.from_numpy(text).long()) * torch.from_numpy(cot)).sum().backward()
    got = {f"decoder.{k}": p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert _rel_l2(got, want, [k]) <= 1e-4, k
    assert _rel_l2({"e": e.grad}, {"e": torch.from_numpy(np.array(g_enc))}, ["e"]) <= 1e-4


def test_linear_decoder_matches_jax():
    enc = RNG.standard_normal((3, T, H)).astype(np.float32)
    jm = jdecoders.LinearDecoder(num_classes=C_CTC, in_dim=H)
    v = variables(jm.init, 3, jax.random.PRNGKey(0), jnp.asarray(enc), None)
    want = jm.apply(v, jnp.asarray(enc), None, train=False)
    port = load_port(LinearDecoder(C_CTC, H), v)
    with torch.no_grad():
        got = port.greedy_decode(torch.from_numpy(enc))
        tf = port.teacher_forced(torch.from_numpy(enc), torch.zeros(3, 24, dtype=torch.long))
    assert_logits(got.numpy(), want)
    assert torch.equal(tf, got)


# -- whole models --------------------------------------------------------------

def _configs(changes):
    """The port's and the JAX package's configuration of MICRO with
    ``changes`` (the port decoding a transformer decoder with K1's plain
    version, JAX with its XLA scan)."""
    return (ModelConfig(**MICRO, **changes, decode_fused=True),
            JModelConfig(**MICRO, **changes))


def _model(changes, seed):
    """The JAX model, its seeded variables, and the port's model loaded
    strictly from them (eval mode)."""
    cfg, jcfg = _configs(changes)
    jm = build_model(jcfg)
    k = jax.random.PRNGKey(0)
    v = variables(jm.init, seed, {"params": k, "dropout": k, "semantics": k},
                  np.zeros((2, 32, 100, 1), np.float32), np.zeros((2, 26), np.int32),
                  np.zeros((2, 15), np.int32), np.zeros((2, 52), np.int32),
                  np.full((2, 52), -1000.0, np.float32), train=True)
    model = SceneTextModel(cfg)
    model.load_state_dict(convert.bundle_to_state_dict(flatten(v)), strict=True)
    return jm, v, model.eval().requires_grad_(False)


MODELS = {"lstm/lstm": ATTN, "lstm/linear ctc": CTC,
          "transformer/linear": {"decoder": "linear"}, "lstm/transformer": {"encoder": "lstm"},
          "standard norm": {"encoder_norm_style": "standard"}}
STEPS = {"lstm/lstm": 26, "lstm/linear ctc": 26, "transformer/linear": 26,
         "lstm/transformer": 25, "standard norm": 25}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_greedy_matches_jax(name):
    """Greedy logits of the whole model (ResNet-31, the encoder, the
    decoder) on 3 crops against JAX ``model.apply``."""
    jm, v, model = _model(MODELS[name], 5)
    batch = make_batch(3, 6)
    img = batch["image"].astype(np.float32) / 255.0
    want = jax.jit(functools.partial(jm.apply, train=False))(
        v, img, None, batch["overlap"], batch["scene"], batch["ious"])
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(batch["overlap"]).long())
    assert got.shape[:2] == (3, STEPS[name])
    assert_logits(got.numpy(), want)


@pytest.mark.parametrize("name", ["BiLSTM-Attn", "BiLSTM-CTC"])
def test_bundle_round_trip(name):
    """A JAX model's bundle converts and loads strictly into the port, and
    ``state_dict_to_bundle`` gives back the same keys and values."""
    _, v, model = _model(ATTN if name == "BiLSTM-Attn" else CTC, 9)
    flat = flatten(v)
    lstm_keys = {k for k in flat if ".fwd." in k or ".bwd." in k}
    assert len(lstm_keys) == 16  # two blocks, two directions, four leaves
    back = convert.state_dict_to_bundle(model.state_dict())
    assert set(back) == set(flat)
    for k, arr in back.items():
        np.testing.assert_array_equal(arr, flat[k], err_msg=k)


# -- the CTC codec, loss and collapse ------------------------------------------

def test_ctc_codec_matches_jax():
    words = ["", "a", "aa", "Hello,World!", "x" * 25]
    got, got_len = CTCCodec(CHARS).encode(words)
    want, want_len = JCTCCodec(CHARS).encode(words)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_array_equal(CTCCodec(CHARS).encode(words, max_len=30)[0],
                                  JCTCCodec(CHARS).encode(words, max_len=30)[0])
    with pytest.raises(ValueError):
        CTCCodec(CHARS).encode(["x" * 26])
    rows = RNG.integers(0, 6, (16, 12))
    assert CTCCodec(CHARS).decode(rows) == JCTCCodec(CHARS).decode(rows)
    lengths = RNG.integers(0, 13, 16)
    assert CTCCodec(CHARS).decode(rows, lengths) == JCTCCodec(CHARS).decode(rows, lengths)
    assert CTCCodec(CHARS).num_classes == C_CTC == ModelConfig(label_codec="ctc").num_classes


def test_ctc_collapse_matches_jax():
    """JAX's own cases, then seeded rows against its collapse."""
    ids = torch.tensor([[0, 3, 3, 0, 4, 4, 4, 5], [7, 7, 0, 7, 0, 0, 0, 0]])
    np.testing.assert_array_equal(ctc_collapse(ids, 4).numpy(), [[3, 4, 5, 0], [7, 7, 0, 0]])
    ids = RNG.integers(0, 4, (32, 26))
    for out_len in (3, 25):
        np.testing.assert_array_equal(ctc_collapse(torch.from_numpy(ids), out_len).numpy(),
                                      np.asarray(j_ctc_collapse(jnp.asarray(ids), out_len)))


def test_ctc_loss_matches_jax_with_an_infeasible_row():
    """Row 2's label needs 5 + 4 repeats = 9 > 8 columns: both packages
    leave it out of the mean, so the loss is that of the batch without it;
    the gradient is finite everywhere, zero on that row, and the other
    rows' match ``jax.grad`` of JAX's loss."""
    Tc = 8
    logits = RNG.standard_normal((4, Tc, C_CTC)).astype(np.float32)
    labels, lengths = CTCCodec(CHARS).encode(["ab", "abc", "aaaaa", "a"], max_len=6)
    jl = jnp.asarray(labels)
    want, jgrad = jax.jit(jax.value_and_grad(j_ctc_loss))(jnp.asarray(logits), jl,
                                                          jnp.asarray(lengths))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_loss(x, torch.from_numpy(labels).long(), torch.from_numpy(lengths).long())
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    keep = [0, 1, 3]
    without = ctc_loss(torch.from_numpy(logits[keep]), torch.from_numpy(labels[keep]).long(),
                       torch.from_numpy(lengths[keep]).long())
    assert got.item() == pytest.approx(without.item(), rel=1e-6)
    assert torch.isfinite(x.grad).all() and not x.grad[2].any()
    # JAX weights the infeasible row's gradient by 0 as well
    assert_close_to_scale(x.grad.numpy(), np.asarray(jgrad), rel=1e-5)


def test_build_codec_checks_the_recipe():
    """JAX ``build_codec``'s checks and messages."""
    micro = ModelConfig(**MICRO)
    with pytest.raises(ValueError, match="label_codec"):
        build_codec(Config(model=micro, train=TrainConfig(loss="ctc")))
    with pytest.raises(ValueError, match="label_codec"):
        build_codec(Config(model=dataclasses.replace(micro, **CTC)))
    with pytest.raises(ValueError, match="linear"):
        build_codec(Config(model=dataclasses.replace(micro, label_codec="ctc"),
                           train=TrainConfig(loss="ctc")))
    assert isinstance(build_codec(Config(model=dataclasses.replace(micro, **CTC),
                                         train=TrainConfig(loss="ctc"))), CTCCodec)
    with pytest.raises(ValueError, match="unknown train loss"):
        TrainStep(torch.nn.Linear(2, 2), TrainConfig(loss="nope"))


# -- training and validating the CTC recipe ------------------------------------

def test_ctc_train_step_matches_jax():
    """One BiLSTM-CTC train step (B=4, the default optimizer, whose clip
    triggers) against JAX ``make_train_step(loss="ctc")``, the JAX
    gradients from ``jax.grad`` of the same loss: loss, collapsed
    exact-match accuracy, gradient norm, every gradient group, the running
    statistics and the updated parameters, within the limits of
    ``test_torch_train.TOLS``: without TPS's for all but the backbone's
    gradients, which take the limit that file sets where the backbone's
    ReLUs see other inputs (6e-2).

    The backbone is not this recipe's: its gradients are piecewise
    continuous, a ReLU whose input lies within the packages' float32
    forward difference of zero may take the other side, and at these
    narrow widths a flip moves a block's gradient by up to a few percent.
    Measured when the test was written, relative L2 of the backbone's
    gradients: here 1.1e-2; the untouched attention recipe (transformer
    encoder and decoder, cross-entropy) at these widths 6.6e-3 and 1.1e-2
    at two seeds, and at ``test_torch_train``'s widths 1.3e-2 to 7.4e-2 at
    three seeds other than that file's; while the BiLSTM encoder's and the
    linear decoder's gradients, which the CTC loss reaches first, agree to
    1e-5."""
    jm, v, _ = _model(CTC, 11)
    batch = make_batch(4, 3)
    words = ["".join(RNG.choice(list("abcdef"), RNG.integers(1, 9))) for _ in range(4)]
    batch["text"] = CTCCodec(CHARS).encode(words)[0]
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    # the first link of the chain keeps the raw gradients it is handed as
    # its state and passes them on, so one compiled JAX train step gives
    # both (no second backward pass)
    keep = optax.GradientTransformation(lambda params: params,
                                        lambda g, state, params=None: (g, g))
    tx = optax.chain(keep, j_make_optimizer(JTrainConfig(loss="ctc")))
    raw_step = make_train_step(jm, tx, jit_compile=False, loss="ctc")

    @jax.jit
    def step_and_grads(params, b):
        state = TrainState(step=0, params=params, batch_stats=v["batch_stats"],
                           opt_state=tx.init(params))
        new_state, metrics = raw_step(state, b, jax.random.PRNGKey(0))
        return new_state, metrics, new_state.opt_state[0]

    new_state, m, grads = step_and_grads(v["params"], jb)

    cfg, _ = _configs(CTC)
    trainer = api.get_trainer(cfg=cfg, train_cfg=TrainConfig(loss="ctc"), device="cpu")
    trainer.model.load_state_dict(convert.bundle_to_state_dict(flatten(v)), strict=True)
    got = trainer(batch)
    port_grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                  for k, p in trainer.model.named_parameters()}

    def as_port(tree, collection="params"):
        return convert.bundle_to_state_dict(
            {f"{collection}.{k}": np.asarray(a) for k, a in _flat(tree).items()})

    grads, new, stats = as_port(grads), as_port(new_state.params), as_port(
        new_state.batch_stats, "batch_stats")
    tol = dict(TOLS[False], backbone=TOLS[True]["backbone"])
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
    assert got["loss"].item() == pytest.approx(float(m["loss"]), rel=tol["loss"])
    assert got["token_acc"].item() == pytest.approx(float(m["token_acc"]), abs=1e-6)
    assert got["grad_norm"].item() == pytest.approx(float(m["grad_norm"]), rel=tol["grad_norm"])
    assert set(grads) == set(port_grads)
    for group, prefixes in GROUPS.items():
        keys = [k for k in grads if k.startswith(prefixes) and grads[k].abs().max() > 0]
        assert keys, group
        assert _rel_l2(port_grads, grads, keys) <= tol[group], group
    state = trainer.model.state_dict()
    for k, want in stats.items():
        np.testing.assert_allclose(state[k].numpy(), want.numpy(), rtol=0,
                                   atol=tol["stats"] * max(1.0, want.abs().max().item()),
                                   err_msg=k)
    agree_n = total = 0
    for k, want in new.items():
        agree = (port_grads[k] - grads[k]).abs() <= 0.1 * grads[k].abs()
        agree_n += int(agree.sum())
        total += agree.numel()
        diff = (state[k] - want).abs()[agree]
        assert diff.numel() == 0 or diff.max().item() <= 1e-5, k
    assert agree_n / total >= tol["agree"]


def test_ctc_validate_matches_jax():
    """``eval.evaluate.validate`` with ``CTCCodec`` on 12 committed
    validation crops in batches of 8 (the last padded) against JAX
    ``validate`` on the same weights and batches: every crop's collapsed
    string."""
    jm, v, model = _model(CTC, 13)
    codec = CTCCodec(CHARS)
    val = synthetic.make_dataset(12, 1000, codec)
    assert val.text.shape == (12, 25)
    ready = list(batches(val, Batcher(codec, 8), shuffle=False, drop_last=False))
    got = evaluate.validate(make_eval_step(model), ready, codec, return_records=True)
    want = jevaluate.validate(j_make_eval_step(jm), v, ready, JCTCCodec(CHARS),
                              return_records=True)
    assert [r.prediction for r in got.records] == [r.prediction for r in want.records]
    assert got.accuracy == want.accuracy and len(got.records) == 12


# -- serving and the float32 switches ------------------------------------------

def test_recognizer_beam_on_lstm_decoder_is_greedy():
    """As JAX's Recognizer does, a beam width with the LSTM decoder decodes
    greedily and scores 0.0; the model's beam search is refused.  Through
    the int8 backbone too (held against JAX's int8 step in
    tests/test_torch_variants.py)."""
    model = api.get_model(cfg=ModelConfig(**MICRO, **ATTN), device="cpu", seed=3)
    rng = np.random.default_rng(4)
    crops = [rng.integers(0, 256, (32, 100), dtype=np.uint8) for _ in range(5)]
    rec = Recognizer(model, batch_sizes=(8,))
    greedy = rec.recognize(crops)
    texts, scores = rec.recognize(crops, beam_size=5, return_scores=True)
    assert texts == greedy and scores == [0.0] * 5
    with torch.no_grad(), pytest.raises(NotImplementedError, match="TF decoder"):
        model.beam_decode(torch.zeros(1, 32, 100, 1), torch.zeros(1, 15, dtype=torch.long))
    rec8 = Recognizer(model, batch_sizes=(8,), int8_backbone=True)
    greedy8 = rec8.recognize(crops)
    assert rec8.recognize(crops, beam_size=5, return_scores=True) == (greedy8, [0.0] * 5)


def test_full_fp32_sets_and_restores_the_cudnn_rnn_switch():
    """``full_fp32`` turns TF32 off for cuDNN RNNs too (``cudnn.rnn`` where
    the newer API holds it apart; with the older one ``cudnn.allow_tf32``
    covers RNNs) and gives the caller's setting back; an f32 BiLSTM model's
    LSTMs run inside it."""
    cudnn = torch.backends.cudnn
    switches = precision._switches()
    if hasattr(cudnn, "rnn") and hasattr(cudnn, "conv"):
        assert (cudnn.rnn, "fp32_precision", "ieee") in switches
        obj, name, full, tf32 = cudnn.rnn, "fp32_precision", "ieee", "tf32"
    else:
        assert (cudnn, "allow_tf32", False) in switches
        obj, name, full, tf32 = cudnn, "allow_tf32", False, True
    saved = getattr(obj, name)
    seen = []
    try:
        setattr(obj, name, tf32)
        with precision.full_fp32():
            assert getattr(obj, name) == full
        assert getattr(obj, name) == tf32
        model = api.get_model(cfg=ModelConfig(**MICRO, **ATTN), device="cpu")
        model.encoder.l0.fwd.register_forward_hook(lambda *_: seen.append(getattr(obj, name)))
        with torch.no_grad():
            model(torch.zeros(1, 32, 100, 1), torch.zeros(1, 15, dtype=torch.long))
        assert seen == [full] and getattr(obj, name) == tf32
    finally:
        setattr(obj, name, saved)
