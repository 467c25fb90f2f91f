"""Greedy decoding and beam search through the port's single-position
stepper, with the three per-layer fusion sites (``multihead_pre_target``,
``multihead_pre_memory``, ``multihead_post_memory``) and the other fusion
hooks, against the JAX package's XLA stepper on the CPU; then the
teacher-forced pass and one whole train step with every hook on.

Small widths: 2 layers, E=32, 4 heads, 13 classes (the beam tests' decoder)
and T=8; the model-level cases use test_torch_model's SMALL sizes at the
full 97 classes and T=25.  Weights are seeded draws over the JAX modules'
variables trees (``jax.eval_shape`` of ``init``), carried into the port by
its weight bridge.  Float32 logits are held within 1e-5 * max(1,
max |jax|), tokens identical; bfloat16 runs hold the tokens identical (JAX
on the CPU computes some of its bf16 intermediates wider, so its logits
differ by rounding); beam scores within 1e-4 of their size.  Each
docstring gives what was measured when the test was written."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from multimodal_scene_text_recognition_tpu.core.config import ModelConfig as JModelConfig
from multimodal_scene_text_recognition_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_scene_text_recognition_tpu.models.decoders import (
    TransformerDecoder as JTransformerDecoder,
)
from multimodal_scene_text_recognition_tpu.models.model import build_model
from multimodal_scene_text_recognition_tpu.train.state import TrainState
from multimodal_scene_text_recognition_tpu.train.state import make_optimizer as j_make_optimizer
from multimodal_scene_text_recognition_tpu.train.steps import make_train_step
from multimodal_scene_text_recognition_tpu_torch import api, convert
from multimodal_scene_text_recognition_tpu_torch.charset import EOS_ID
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig
from multimodal_scene_text_recognition_tpu_torch.models.decoders import SITES, TransformerDecoder
from multimodal_scene_text_recognition_tpu_torch.models.encoders import no_dropout
from test_torch_modules import assert_close_to_scale, load_port
from test_torch_semantic import semantic_inputs, variables
from test_torch_train import _flat, _rel_l2, make_batch, random_bundle, unflatten
import torch_threads

torch_threads.limit()

B, HID, E, T, C, O = 4, 64, 32, 8, 13, 6
RNG = np.random.default_rng(41)
ENC = RNG.standard_normal((B, 10, HID)).astype(np.float32)
SEM = RNG.standard_normal((B, O, E)).astype(np.float32)
HOOKS = ("pre_decoder_mlp", "cls_decoder_init", "post_decoder_mlp")
F32_TOL = 1e-5


def jax_decoder(sites=(), hooks=(), eos_bias=0.0, **kw):
    """A small JAX decoder with the fusion ``sites`` and ``hooks`` on, its
    seeded variables, and ``eos_bias`` added to the [s] logit."""
    flags = {f"multihead_{s}": True for s in sites}
    flags.update({h: True for h in hooks})
    jm = JTransformerDecoder(num_classes=C, d_model=E, memory_dim=HID, num_heads=4, ff_dim=64,
                             num_layers=2, dropout=0.0, max_text_length=T, **flags, **kw)
    k = jax.random.PRNGKey(0)
    v = variables(jm.init, 43, {"params": k, "dropout": k}, ENC, np.zeros((B, T + 1), np.int32),
                  SEM, train=True)
    params = dict(v["params"])
    head = dict(params["emb_to_classes"])
    head["bias"] = head["bias"].at[EOS_ID].add(eos_bias)
    params["emb_to_classes"] = head
    return jm, dict(v, params=params)


def port_decoder(v, sites=(), hooks=(), dtype=torch.float32, **kw):
    return load_port(TransformerDecoder(C, E, HID, 4, 64, 2, T, dtype, sites=sites,
                                        **{h: True for h in hooks}, **kw), v)


def jax_greedy(jm, v):
    return np.asarray(jm.apply(v, ENC, None, SEM, train=False))


def port_greedy(dec):
    with torch.no_grad():
        return dec.greedy_decode(torch.from_numpy(ENC), torch.from_numpy(SEM)).float().numpy()


def first_eos(row):
    hit = np.flatnonzero(row == EOS_ID)
    return hit[0] if hit.size else len(row) - 1


# the cases: (fusion sites, other hooks, [s] bias for the early-stop runs).
# The biases make every row emit [s] before the last step, not all at the
# same step, so that the batch's early exit, the rows decoded on after
# their [s] and the unwritten [s] rows all show.
CASES = {
    "stepper": ((), (), 0.2),
    "pre_target": (("pre_target",), (), None),
    "pre_memory": (("pre_memory",), (), None),
    "post_memory": (("post_memory",), (), None),
    "all sites": (SITES, (), None),
    "all sites and hooks": (SITES, HOOKS, 1.2),
}


@pytest.mark.parametrize("case,early_stop", [
    ("stepper", False), ("stepper", True), ("pre_target", False), ("pre_memory", False),
    ("post_memory", False), ("all sites", False), ("all sites and hooks", False),
    ("all sites and hooks", True)])
def test_stepper_greedy_matches_jax(case, early_stop):
    """JAX ``greedy_decode`` with ``fused=False`` (its scan, or with early
    stop its while loop) against the port's stepper loop: float32 logits
    [4, 8, 13] within 1e-5 * scale (measured 1.2e-6 at scale 3.0 with
    every site and hook on), tokens identical.  With early stop the rows
    end at different steps and the batch before the last step; the rows
    never written are the [s] one-hot in both."""
    sites, hooks, bias = CASES[case]
    jm, v = jax_decoder(sites, hooks, bias if early_stop else 0.0, early_stop=early_stop)
    want = jax_greedy(jm, v)
    got = port_greedy(port_decoder(v, sites, hooks, fused=False, early_stop=early_stop))
    assert_close_to_scale(got, want, rel=F32_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if early_stop:
        stops = [first_eos(r) for r in want.argmax(-1)]
        assert max(stops) < T - 1 and len(set(stops)) > 1, stops


@pytest.mark.parametrize("early_stop", [False, True])
def test_stepper_greedy_bf16_matches_jax(early_stop):
    """Every site and hook, in bfloat16 (the stepper's matmuls, relevance
    MLPs, softmaxes and site attentions in bf16, norms and logits float32,
    as JAX casts them): tokens identical to JAX's bf16 loop, logits within
    0.1 of its (measured 0.042 at scale 3.0: JAX on the CPU rounds some bf16
    intermediates later)."""
    sites, hooks, bias = CASES["all sites and hooks"]
    jm, v = jax_decoder(sites, hooks, bias if early_stop else 0.0, early_stop=early_stop,
                        dtype="bfloat16")
    want = jax_greedy(jm, v)
    got = port_greedy(port_decoder(v, sites, hooks, torch.bfloat16, fused=False,
                                   early_stop=early_stop))
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() < 0.1


def test_site_takes_the_stepper_when_fused(monkeypatch):
    """``fused=True`` with a site on: JAX falls back to its stepper (as
    tests/test_model.py checks), and so does the port: never the fused
    decode or beam, logits within 1e-5 * scale of JAX's fused=True
    decoder, and beam search's tokens those of JAX's."""
    def refuse(*a, **k):
        raise AssertionError("a fused kernel ran with a fusion site on")

    monkeypatch.setattr("multimodal_scene_text_recognition_tpu_torch.models.decoders."
                        "fused_greedy_decode", refuse)
    monkeypatch.setattr("multimodal_scene_text_recognition_tpu_torch.models.decoders."
                        "fused_beam_decode", refuse)
    jm, v = jax_decoder(("pre_memory",), fused=True, beam_fused=True)
    dec = port_decoder(v, ("pre_memory",), fused=True, beam_fused=True)
    assert dec.uses_stepper
    assert_close_to_scale(port_greedy(dec), jax_greedy(jm, v), rel=F32_TOL)
    jt, js = jm.apply(v, ENC, SEM, 3, method=JTransformerDecoder.beam_decode)
    with torch.no_grad():
        tokens, scores = dec.beam_decode(torch.from_numpy(ENC), torch.from_numpy(SEM), 3)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=1e-4, atol=0)


def _jax_beam(m, enc, sem, k, reorder):
    return m.beam_decode(enc, sem, beam_size=k, reorder_caches=reorder)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("reorder", [False, True])
def test_beam_with_sites_matches_jax(k, reorder):
    """Beam search with every site and the semantic CLS step 0 (not the
    logit fusion, which beam search refuses), the ancestry form and the
    reorder form against JAX's same form, as tests/test_beam.py's site
    case: the site caches follow each beam's ancestry (or are gathered
    with the self-attention's).  Tokens identical, scores within 1e-4 of
    their size (measured 3e-7); k=1 gives the greedy loop's tokens up to
    each row's first [s]."""
    hooks = ("pre_decoder_mlp", "cls_decoder_init")
    jm, v = jax_decoder(SITES, hooks, 1.0)
    jt, js = jm.apply(v, ENC, SEM, k, reorder, method=_jax_beam)
    dec = port_decoder(v, SITES, hooks, beam_fused=True)
    with torch.no_grad():
        tokens, scores = dec.beam_decode(torch.from_numpy(ENC), torch.from_numpy(SEM), k,
                                         reorder_caches=reorder)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=1e-4, atol=0)
    if k == 1:
        greedy = port_greedy(port_decoder(v, SITES, hooks, fused=False)).argmax(-1)
        for a, b in zip(tokens.numpy(), greedy):
            n = first_eos(b) + 1
            np.testing.assert_array_equal(a[:n], b[:n])


def test_teacher_forced_with_every_hook_matches_jax():
    """The training pass (JAX ``__call__`` with ``train=True`` at dropout
    0) with every site and hook: the semantic CLS vector at position 0, the
    sites' causal attentions, the logit fusion; logits [4, 9, 13] within
    1e-5 * scale (measured 1.4e-6 at scale 3.2), and the stepper's greedy
    logits equal the pass over the tokens its loop fed back (the argmax
    before the logit fusion), as the sites are causal."""
    jm, v = jax_decoder(SITES, HOOKS)
    text = np.random.default_rng(44).integers(0, C, (B, T + 1)).astype(np.int32)
    text[:, 0] = 0
    k = jax.random.PRNGKey(1)
    want = np.asarray(jm.apply(v, ENC, text, SEM, train=True, rngs={"dropout": k}))
    dec = port_decoder(v, SITES, HOOKS, fused=False)
    with torch.no_grad():
        got = dec.teacher_forced(torch.from_numpy(ENC), torch.from_numpy(text).long(),
                                 no_dropout, torch.from_numpy(SEM)).numpy()
        greedy = port_greedy(dec)
        fed = dec.greedy_from_memory(*dec.memory_and_cls0(torch.from_numpy(ENC),
                                                          torch.from_numpy(SEM)),
                                     torch.from_numpy(SEM)).argmax(-1).numpy()
        ids = np.concatenate([np.zeros((B, 1), np.int64), fed[:, :-1]], axis=1)
        forced = dec.teacher_forced(torch.from_numpy(ENC), torch.from_numpy(ids), no_dropout,
                                    torch.from_numpy(SEM)).numpy()
    assert got.shape == want.shape == (B, T + 1, C)
    assert_close_to_scale(got, want, rel=F32_TOL)
    assert_close_to_scale(forced, greedy, rel=F32_TOL)


# -- the whole model: training with every hook ----------------------------------

SMALL = dict(enc_layers=1, dec_layers=2, ff_dim=64, hidden_dim=64, embed_dim=32, num_heads=4,
             compute_dtype="float32")
EVERY_HOOK = dict(semantic_vector="combined", pre_encoder_mlp=True, pre_decoder_mlp=True,
                  cls_decoder_init=True, post_decoder_mlp=True, multihead_pre_target=True,
                  multihead_pre_memory=True, multihead_post_memory=True)


def hook_batch(n, seed):
    """test_torch_train's wire-format batch with seeded objects: overlap
    ids, scene ids and ious (its pads at -1000)."""
    batch = make_batch(n, seed)
    ov, sc, ious = semantic_inputs(n, seed + 1)
    return dict(batch, overlap=ov, scene=sc, ious=ious)


def test_train_step_with_every_hook_matches_jax():
    """One train step of a small model with every fusion hook and site on
    (combined semantics, TPS off), the port's ``TrainStep`` against JAX
    ``make_train_step`` at dropout 0, the default TrainConfig, the batch's
    scene ids and ious passed through: loss within 1e-5 relative (measured
    1.1e-7), gradient norm before the clip 1e-3 (2.6e-5), the decoder's
    and the semantic tables' gradients within 1e-4 relative L2 each
    (<= 6.1e-5), the encoder's within 5e-3 as a group, every fusion
    module's gradient nonzero, and every updated decoder parameter within
    1e-5 of JAX's where the two gradients agree to 10%.

    ReLUs whose input lies within the packages' float32 difference of zero
    may take the other side, as test_train_step_matches_jax explains.  A
    relevance MLP (the sites', ``relevant_mlp``, ``post_mlp``: one score a
    (position, object) pair) has thousands of such ReLUs a hidden unit and
    gradients of ~1e-5: one flip moved one hidden unit's gradient by 12%
    while every other unit agreed within 1e-10 (``mlp_pre_memory`` of layer
    1 and ``post_mlp``: their first layers 0.9-1.5% off in relative L2; a
    flip in a second layer, seen with one decoder layer, moved the first
    layer's every unit, 4.8%).  So those tensors are held within 0.1
    relative L2 each, where a fault in their wiring would be of order 1.
    The backbone, behind the pre-encoder fusion and the sites, is held
    within 3e-2 as a group (measured 1.3e-2; 1e-2 and 6e-2 without and with
    TPS in test_train_step_matches_jax).
    Two gradients are zero up to rounding in both packages, and are held
    within 1e-6 of JAX's instead: the last bias of a relevance MLP (the
    softmax over the objects ignores it) and all of ``sem_cls_mlp`` (the
    semantic CLS vector is all ones whatever it holds)."""
    cfg = ModelConfig(**SMALL, **EVERY_HOOK, use_tps=False, dropout=0.0)
    flat = random_bundle(cfg, 45)
    batch = hook_batch(4, 46)
    jm = build_model(JModelConfig(**SMALL, **EVERY_HOOK, use_tps=False, dropout=0.0))
    variables = unflatten(flat)
    # the gradients of the step itself: the first link of the chain keeps
    # the raw gradients it is handed as its state and passes them on, so one
    # compiled JAX train step gives both (no second backward pass)
    keep = optax.GradientTransformation(lambda params: params,
                                        lambda g, state, params=None: (g, g))
    tx = optax.chain(keep, j_make_optimizer(JTrainConfig()))
    key = jax.random.PRNGKey(0)
    raw_step = make_train_step(jm, tx, jit_compile=False)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    @jax.jit
    def step_and_grads(params):
        state = TrainState(step=0, params=params, batch_stats=variables["batch_stats"],
                           opt_state=tx.init(params))
        new_state, metrics = raw_step(state, jb, key)
        return new_state, metrics, new_state.opt_state[0]

    new_state, metrics, grads = step_and_grads(variables["params"])
    trainer = api.get_trainer(cfg=cfg, device="cpu")
    trainer.model.load_state_dict(convert.bundle_to_state_dict(flat), strict=True)
    got = trainer(batch)

    def as_port(tree):
        return convert.bundle_to_state_dict(
            {f"params.{k}": np.asarray(x) for k, x in _flat(tree).items()})

    grads, new = as_port(grads), as_port(new_state.params)
    port_grads = {k: p.grad for k, p in trainer.model.named_parameters()}
    assert set(grads) == set(port_grads)
    assert got["loss"].item() == pytest.approx(float(metrics["loss"]), rel=1e-5)
    assert got["grad_norm"].item() == pytest.approx(float(metrics["grad_norm"]), rel=1e-3)
    # the relevance MLPs (one score a pair: a site's, the memory's, the
    # logits'); sem_cls_mlp's and their last biases' gradients are rounding
    relevance = [k for k in grads if k.startswith(
        ("decoder.relevant_mlp.", "decoder.post_mlp.")) or ".mlp_" in k]
    rounding = [k for k in grads if "sem_cls_mlp" in k or (k in relevance
                                                           and k.endswith("fc2.bias"))]
    relevance = [k for k in relevance if k not in rounding]
    assert "decoder.layer0.mlp_pre_target.fc2.bias" in rounding
    assert "decoder.relevant_mlp.fc0.weight" in relevance
    fusion = [k for k in grads if ("mlp" in k or "mha_" in k or "sem_to_classes" in k)
              and k not in rounding]
    assert {f"decoder.layer1.mha_{s}.in_proj_weight" for s in SITES} <= set(fusion)
    for k in fusion:
        assert port_grads[k].abs().max() > 0, k
    for k in grads:
        if k in rounding:
            assert (port_grads[k] - grads[k]).abs().max() <= 1e-6, k
        elif k in relevance:
            assert _rel_l2(port_grads, grads, [k]) <= 0.1, k
        elif k.startswith(("decoder.", "semantic.")):
            assert _rel_l2(port_grads, grads, [k]) <= 1e-4, k
    assert _rel_l2(port_grads, grads, [k for k in grads if k.startswith("encoder.")]) <= 5e-3
    assert _rel_l2(port_grads, grads,
                   [k for k in grads if k.startswith("feature_extractor.")]) <= 3e-2
    state = trainer.model.state_dict()
    for k, want in new.items():
        if k.startswith("decoder."):
            agree = (port_grads[k] - grads[k]).abs() <= 0.1 * grads[k].abs()
            diff = (state[k] - want).abs()[agree]
            assert diff.numel() == 0 or diff.max().item() <= 1e-5, k


def test_train_mode_with_every_hook_draws_its_dropout():
    """Train mode at dropout 0.1 with every hook and site: the same
    generator seed gives the same logits, another seed others; at dropout
    0 the pass repeats whatever the seed."""
    b = hook_batch(2, 47)
    args = (torch.from_numpy(b["image"]).float() / 255, torch.from_numpy(b["overlap"]).long(),
            torch.from_numpy(b["text"][:, :-1]).long())
    sem = dict(scene=torch.from_numpy(b["scene"]).long(), ious=torch.from_numpy(b["ious"]))

    def run(model, seed):
        with torch.no_grad():
            return model(*args, train=True, generator=torch.Generator().manual_seed(seed), **sem)

    for p, same in ((0.1, False), (0.0, True)):
        cfg = ModelConfig(**SMALL, **EVERY_HOOK, use_tps=False, dropout=p)
        model = api.get_model(cfg=cfg, device="cpu", seed=3, train=True)
        assert torch.equal(run(model, 1), run(model, 1))
        assert torch.equal(run(model, 1), run(model, 2)) is same


def test_default_config_serves_through_the_stepper():
    """``ModelConfig()`` (the JAX package's default, ``decode_fused=False``)
    at the small widths serves greedily through the stepper, its logits
    within 1e-3 of JAX ``model.apply``'s (test_torch_model's limit for the
    whole model; measured 2.5e-6), tokens identical."""
    cfg = dataclasses.replace(ModelConfig(**SMALL), use_tps=False)
    flat = random_bundle(cfg, 48)
    b = hook_batch(2, 49)
    jm = build_model(JModelConfig(**SMALL, use_tps=False))
    img = b["image"].astype(np.float32) / 255
    want = np.asarray(jm.apply(unflatten(flat), img, None, b["overlap"], b["scene"], b["ious"],
                               train=False))
    model = api.get_model(cfg=cfg, device="cpu")
    model.load_state_dict(convert.bundle_to_state_dict(flat), strict=True)
    assert model.decoder.uses_stepper
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(b["overlap"]).long(),
                    scene=torch.from_numpy(b["scene"]).long(),
                    ious=torch.from_numpy(b["ious"])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
