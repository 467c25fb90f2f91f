"""Beam search of the PyTorch port against the JAX package's, float32 on the
CPU: the decoder's three forms (ancestry scan, reordered caches, the fused
beam kernel's plain version), the ancestry attention, beam ranking, the
model and the Recognizer.  Mirrors tests/test_beam.py, with the seeded JAX
decoder weights converted into the port."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.models.decoders import (
    TransformerDecoder as JTransformerDecoder,
)
from multimodal_scene_text_recognition_tpu.ops import attention as jattention
from multimodal_scene_text_recognition_tpu_torch import api
from multimodal_scene_text_recognition_tpu_torch.charset import EOS_ID, GO_ID
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig
from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
from multimodal_scene_text_recognition_tpu_torch.models.decoders import TransformerDecoder
from multimodal_scene_text_recognition_tpu_torch.ops import attention
from test_torch_modules import load_port, randomize
import torch_threads

torch_threads.limit()

B, HID, E, T, C, BEAM = 3, 64, 32, 8, 13, 5
RNG = np.random.default_rng(3)
ENC = RNG.standard_normal((B, 10, HID)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_decoder():
    """The JAX test's small decoder (2 layers, 4 heads, 13 classes) with
    seeded weights; the [s] logit raised by 1 so that every row's best
    beam ends after one to three tokens."""
    dec = JTransformerDecoder(num_classes=C, d_model=E, memory_dim=HID, num_heads=4,
                              ff_dim=64, num_layers=2, dropout=0.0, max_text_length=T)
    rng = jax.random.PRNGKey(0)
    v = jax.jit(lambda: dec.init({"params": rng, "dropout": rng}, jnp.asarray(ENC),
                                 jnp.zeros((B, T + 1), jnp.int32), None, train=True))()
    return dec, eos_biased(randomize(v, 29), 1.0)


def eos_biased(variables, bias):
    """``variables`` with ``bias`` added to the [s] logit."""
    params = dict(variables["params"])
    head = dict(params["emb_to_classes"])
    head["bias"] = head["bias"].at[EOS_ID].add(bias)
    params["emb_to_classes"] = head
    return dict(variables, params=params)


def port_decoder(variables, **kw):
    return load_port(TransformerDecoder(C, E, HID, 4, 64, 2, T, torch.float32, **kw), variables)


def beam(dec, k=BEAM, **kw):
    with torch.no_grad():
        tokens, scores = dec.beam_decode(torch.from_numpy(ENC), beam_size=k, **kw)
    return tokens.numpy(), scores.numpy()


def first_eos(row):
    hit = np.flatnonzero(row == EOS_ID)
    return hit[0] if hit.size else len(row) - 1


def assert_pruned_equal(a, b):
    """Tokens equal up to and including each row's first [s]."""
    for x, y in zip(a, b):
        n = first_eos(y) + 1
        np.testing.assert_array_equal(x[:n], y[:n])


def test_beam_matches_jax_ancestry_beam(jax_decoder):
    """K=5, the JAX XLA ancestry beam: identical tokens and scores within
    1e-5, for the port's three forms."""
    dec, v = jax_decoder
    jt, js = dec.apply(v, jnp.asarray(ENC), None, BEAM, method=JTransformerDecoder.beam_decode)
    jt, js = np.asarray(jt), np.asarray(js)
    assert [first_eos(row) for row in jt] == [2, 2, 1]
    port = port_decoder(v)
    fused = port_decoder(v, beam_fused=True)
    for tokens, scores in (beam(port), beam(port, reorder_caches=True), beam(fused)):
        np.testing.assert_array_equal(tokens, jt)
        np.testing.assert_allclose(scores, js, atol=1e-5, rtol=0)


def test_beam1_equals_greedy(jax_decoder):
    """Up to each row's first [s]: a finished beam continues with [s],
    greedy decoding with its argmax."""
    port = port_decoder(jax_decoder[1])
    tokens, scores = beam(port, k=1)
    with torch.no_grad():
        greedy = port.greedy_decode(torch.from_numpy(ENC)).argmax(-1).numpy()
    assert_pruned_equal(tokens, greedy)
    assert scores.shape == (B,)


@pytest.mark.parametrize("beam_fused", [False, True])
def test_beam_early_stop_matches_full_scan(jax_decoder, beam_fused):
    """Early stop, both the ancestry scan and the fused beam's plain
    version: tokens up to each row's first [s] and scores (exactly) those
    of the full-length search.  The [s] logit raised further so that every
    beam ends within four steps: the search stops before the last step
    (whose tokens stay 0 where the full search froze them at [s])."""
    v = eos_biased(jax_decoder[1], 1.5)
    full = beam(port_decoder(v, beam_fused=beam_fused), k=4)
    early = beam(port_decoder(v, beam_fused=beam_fused, early_stop=True), k=4)
    assert_pruned_equal(early[0], full[0])
    np.testing.assert_array_equal(early[1], full[1])
    assert (full[0][:, -1] == EOS_ID).all() and (early[0][:, -1] == GO_ID).all()


def test_beam5_no_worse_than_greedy(jax_decoder):
    """The best beam's score is its teacher-forced log-probability up to
    and including the first [s] (within 1e-4), and no lower than the
    greedy sequence's."""
    port = port_decoder(jax_decoder[1])
    enc = torch.from_numpy(ENC)

    def seq_logprob(tokens):
        tokens = torch.as_tensor(tokens, dtype=torch.long)
        text_in = torch.cat([torch.full((B, 1), GO_ID), tokens[:, :-1]], dim=1)
        with torch.no_grad():
            logp = torch.log_softmax(port.teacher_forced(enc, text_in, lambda x: x), -1)
        picked = logp.gather(-1, tokens[..., None])[..., 0]
        before_eos = torch.cumprod(torch.cat(
            [torch.ones(B, 1, dtype=torch.long), (tokens[:, :-1] != EOS_ID).long()], 1), 1)
        return (picked * before_eos).sum(1).numpy()

    with torch.no_grad():
        greedy = port.greedy_decode(enc).argmax(-1)
    tokens, scores = beam(port)
    np.testing.assert_allclose(scores, seq_logprob(tokens), atol=1e-4, rtol=0)
    assert (seq_logprob(tokens) >= seq_logprob(greedy) - 1e-5).all()


@pytest.mark.parametrize("k", [1, 4])
def test_beam_ancestry_matches_reorder(jax_decoder, k):
    port = port_decoder(jax_decoder[1])
    tok_a, sc_a = beam(port, k=k)
    tok_b, sc_b = beam(port, k=k, reorder_caches=True)
    np.testing.assert_array_equal(tok_a, tok_b)
    np.testing.assert_allclose(sc_a, sc_b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", [1, 4])
def test_fused_beam_matches_ancestry_scan(jax_decoder, k):
    """The fused beam's plain version against the ancestry scan, float32:
    identical tokens, scores within 1e-5."""
    v = jax_decoder[1]
    tok_a, sc_a = beam(port_decoder(v), k=k)
    tok_b, sc_b = beam(port_decoder(v, beam_fused=True), k=k)
    np.testing.assert_array_equal(tok_a, tok_b)
    np.testing.assert_allclose(sc_a, sc_b, atol=1e-5, rtol=0)


def test_attend_ancestry_forms_agree_with_each_other_and_jax():
    """Both ancestry attentions (select-then-softmax and the flat masked
    form) agree with each other and with JAX's within 1e-5; the select form
    equals plain attention over caches gathered by ancestry."""
    Bq, K, Tq, Eq, H = 2, 3, 6, 16, 4
    rng = np.random.default_rng(5)
    q = rng.standard_normal((Bq * K, 1, Eq)).astype(np.float32)
    k = rng.standard_normal((Bq * K, Tq, Eq)).astype(np.float32)
    v = rng.standard_normal((Bq * K, Tq, Eq)).astype(np.float32)
    anc = rng.integers(0, K, (Bq, K, Tq))
    mask = np.where(np.arange(Tq) <= 4, 0.0, -np.inf).astype(np.float32)
    oh = np.eye(K, dtype=np.float32)[anc]
    tq, tk, tv, toh, tm = map(torch.from_numpy, (q, k, v, oh, mask))
    sel = attention.attend_ancestry(tq, tk, tv, H, toh, tm).numpy()
    flat = attention.attend_ancestry_flat(tq, tk, tv, H, toh, tm).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, jnp.asarray(oh),
             jnp.asarray(mask)[None, None, None])
    for got in (sel, flat):
        np.testing.assert_allclose(got, np.asarray(jattention.attend_ancestry(*jargs)),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, np.asarray(jattention.attend_ancestry_flat(*jargs)),
                                   atol=1e-5, rtol=0)
    # the caches each beam sees, gathered: slot anc[b, j, t] at position t
    rows = np.arange(Bq)[:, None, None] * K + anc
    gk = torch.from_numpy(k[rows, np.arange(Tq)].reshape(Bq * K, Tq, Eq))
    gv = torch.from_numpy(v[rows, np.arange(Tq)].reshape(Bq * K, Tq, Eq))
    np.testing.assert_allclose(sel, attention.attend(tq, gk, gv, H, tm).numpy(),
                               atol=1e-5, rtol=0)


def test_rank_beams_matches_jax():
    """Raw scores and GNMT length penalties 0.6 and 1.0, on beams whose
    [s] comes at different places (and one that never ends): the same
    pick and ranked score as JAX within 1e-6."""
    rng = np.random.default_rng(8)
    seqs = rng.integers(3, C, (4, 3, T))
    seqs[0, 0, 2] = seqs[0, 1, 6] = seqs[1, 2, 0] = seqs[2, 1, 3] = EOS_ID
    scores = (-rng.random((4, 3)) * 5).astype(np.float32)
    for penalty in (0.0, 0.6, 1.0):
        want_t, want_s = JTransformerDecoder._rank_beams(jnp.asarray(seqs), jnp.asarray(scores),
                                                         penalty)
        got_t, got_s = TransformerDecoder.rank_beams(torch.from_numpy(seqs),
                                                     torch.from_numpy(scores), penalty)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6, rtol=0)


SMALL = ModelConfig(enc_layers=1, dec_layers=2, ff_dim=64, hidden_dim=64, embed_dim=32,
                    num_heads=4, compute_dtype="float32", decode_fused=True)
BEAM_CFG = dataclasses.replace(SMALL, decode_early_stop=True, decode_beam_fused=True)


def _crops(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (32, 100), dtype=np.uint8) for _ in range(n)]


def test_model_level_beam():
    """The model's beam over 32x100 crops: tokens [B, 25] and scores [B];
    the fused beam with early stop (the served beam configuration) gives the
    ancestry scan's tokens and scores (within 1e-5), and both equal the
    decoder's beam over the model's own encoder output."""
    model = api.get_model(cfg=BEAM_CFG, device="cpu", seed=4)
    scan = api.get_model(cfg=SMALL, device="cpu", seed=4)
    image = torch.from_numpy(np.stack(_crops(2, 1))[..., None].astype(np.float32) / 255.0)
    overlap = torch.zeros(2, 15, dtype=torch.long)
    with torch.no_grad():
        tokens, scores = model.beam_decode(image, overlap, 5)
        tok_s, sc_s = scan.beam_decode(image, overlap, 5)
        enc = model.encoder(model.features(model.rectify(image)))
        tok_d, sc_d = model.decoder.beam_decode(enc, beam_size=5)
    assert tokens.shape == (2, 25) and scores.shape == (2,)
    assert torch.isfinite(scores).all()
    np.testing.assert_array_equal(tokens.numpy(), tok_s.numpy())
    np.testing.assert_allclose(scores.numpy(), sc_s.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tokens.numpy(), tok_d.numpy())
    np.testing.assert_array_equal(scores.numpy(), sc_d.numpy())


def test_recognizer_beam_and_scores():
    """``recognize(beam_size=3, return_scores=True)`` over more crops than
    the largest bucket: one string and one finite, non-positive score per
    crop, the strings those of the model's beam; greedy decoding scores
    every crop 0.0 and returns bare strings without ``return_scores``."""
    model = api.get_model(cfg=BEAM_CFG, device="cpu", seed=4)
    rec = Recognizer(model, batch_sizes=(2, 4))
    crops = _crops(5, 2)
    texts, scores = rec.recognize(crops, beam_size=3, return_scores=True)
    assert len(texts) == len(scores) == 5
    assert all(isinstance(t, str) for t in texts)
    assert np.isfinite(scores).all() and max(scores) <= 0.0
    image, overlap, _, _ = rec.prepare(crops[:4], 4)
    with torch.no_grad():
        ids, best = model.beam_decode(image, overlap, 3)
    assert texts[:4] == rec.codec.decode(ids.numpy())
    np.testing.assert_allclose(scores[:4], best.numpy(), atol=0, rtol=0)
    greedy, zeros = rec.recognize(crops, return_scores=True)
    assert zeros == [0.0] * 5
    assert rec.recognize(crops) == greedy
