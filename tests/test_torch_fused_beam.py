"""The plain versions of the port's fused beam kernel (K4) and of the fused
decode kernel's early stop (K1e) against the JAX package's Pallas kernels
(interpret mode on the CPU), on the same seeded weights and cross K/V.

The batch (B=5) is not a multiple of the ``block_b=2`` passed to the JAX
beam kernel, so its zero-padded rows run beside the port's unpadded ones.
JAX stops a chunk of rows early, the port a single row, so tokens after a
beam's first [s] may differ and are never compared; scores may not (a
finished beam adds 0).

The ``-cls0`` cases give every beam of a row a step-0 row ``cls0``: a
seeded random N(0, 1) [B, E], different for every row (the model's own,
the semantic CLS vector, is all ones and could not tell a version that
reads it per row from one that writes 1.0 or reads row 0 for all)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.ops import fused_beam as jfb
from multimodal_scene_text_recognition_tpu.ops import fused_decode as jfd
from multimodal_scene_text_recognition_tpu_torch.charset import EOS_ID
from multimodal_scene_text_recognition_tpu_torch.ops import fused_beam as fb
from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd

L, E, H, FF, C, T, TM, B = 2, 32, 4, 64, 17, 8, 6, 5
ROW_BIASES = {"b_qkv", "b_out", "cb_q", "cb_o", "ff1_b", "ff2_b",
              "n1_s", "n1_b", "n2_s", "n2_b", "n3_s", "n3_b"}
TIED = (5, 9)  # classes made to tie exactly in the tie case


def _inputs(seed, eos_bias=0.0, tie=False):
    """FusedDecodeWeights in the JAX layout (biases [L,1,D]) and the port's,
    and cross K/V [L, B, Tm, E], from one numpy draw.  ``eos_bias`` raises
    the [s] logit so rows finish early; ``tie`` makes two classes' head
    columns, biases and embedding rows equal (and the classes likely), so
    the two classes tie exactly at every step, and so do the beams that
    differ only by one of them for another."""
    rng = np.random.default_rng(seed)

    def mat(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    def vec(*shape, base=0.0):
        return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    w = dict(
        w_qkv=mat(L, E, 3 * E), b_qkv=vec(L, 3 * E), w_out=mat(L, E, E), b_out=vec(L, E),
        cw_q=mat(L, E, E), cb_q=vec(L, E), cw_o=mat(L, E, E), cb_o=vec(L, E),
        ff1_w=mat(L, E, FF), ff1_b=vec(L, FF), ff2_w=mat(L, FF, E), ff2_b=vec(L, E),
        n1_s=vec(L, E, base=1.0), n1_b=vec(L, E), n2_s=vec(L, E, base=1.0), n2_b=vec(L, E),
        n3_s=vec(L, E, base=1.0), n3_b=vec(L, E), fn_s=vec(E, base=1.0), fn_b=vec(E),
        head_w=(rng.standard_normal((E, C)) * 0.5).astype(np.float32), head_b=vec(C),
        emb=rng.standard_normal((C, E)).astype(np.float32),
        pe=rng.standard_normal((T, E)).astype(np.float32),
    )
    w["head_b"][EOS_ID] += eos_bias
    if tie:
        a, b = TIED
        w["head_w"][:, b] = w["head_w"][:, a]
        w["head_b"][[a, b]] = 1.5
        w["emb"][b] = w["emb"][a]
    jw = jfd.FusedDecodeWeights(**{
        k: jnp.asarray(v[:, None, :] if k in ROW_BIASES else
                       v[None, :] if k in ("fn_s", "fn_b", "head_b") else v)
        for k, v in w.items()})
    tw = fd.FusedDecodeWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    ck = rng.standard_normal((L, B, TM, E)).astype(np.float32)
    cv = rng.standard_normal((L, B, TM, E)).astype(np.float32)
    return jw, tw, ck, cv


def _cls0(seed=17):
    """A seeded N(0, 1) step-0 row per batch row, float32 [B, E]."""
    return np.random.default_rng(seed).standard_normal((B, E)).astype(np.float32)


def _first_eos(row):
    hit = np.flatnonzero(row == EOS_ID)
    return hit[0] if hit.size else len(row) - 1


def _pruned_equal(a, b):
    """Per beam, tokens equal up to and including the first [s] of ``b``
    (the same position in ``a`` when they agree)."""
    return all(np.array_equal(x[:_first_eos(y) + 1], y[:_first_eos(y) + 1])
               for x, y in zip(a.reshape(-1, T), b.reshape(-1, T)))


# case: (compute type, K, early stop, [s] bias, tie, cls0)
CASES = {
    "f32-k4": ("float32", 4, False, 0.0, False, False),
    "f32-k4-early-stop": ("float32", 4, True, 5.0, False, False),
    "f32-k1": ("float32", 1, False, 0.0, False, False),
    "f32-k1-early-stop": ("float32", 1, True, 5.0, False, False),
    "f32-k4-tie": ("float32", 4, False, 0.0, True, False),
    "bf16-k4": ("bfloat16", 4, False, 0.0, False, False),
    "bf16-k4-early-stop": ("bfloat16", 4, True, 5.0, False, False),
    "f32-k4-cls0": ("float32", 4, False, 0.0, False, True),
    "f32-k4-early-stop-cls0": ("float32", 4, True, 5.0, False, True),
    "bf16-k4-early-stop-cls0": ("bfloat16", 4, True, 5.0, False, True),
}
BF16 = [c for c in CASES if CASES[c][0] == "bfloat16"]


def _pallas_beam(case):
    dtype, K, early_stop, eos_bias, tie, cls0 = CASES[case]
    jw, _, ck, cv = _inputs(7, eos_bias, tie)
    tokens, scores = jfb.fused_beam_decode(
        jw, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(_cls0()) if cls0 else None,
        beam_size=K, num_heads=H, steps=T,
        dtype=getattr(jnp, dtype), go_id=0, eos_id=EOS_ID, early_stop=early_stop,
        block_b=2, interpret=True)
    return np.asarray(tokens), np.asarray(scores)


# The bf16 cases' reference runs in a JAX process of its own with XLA's
# excess precision off.  By default XLA on the CPU may keep a value in f32
# where the kernel rounds it to bf16, and does so for the cross-attention
# value product (summed in f32 right after): the interpreted kernel then
# differs from its own arithmetic as written by ~0.02 in the log-probs of
# the first step, and the beams part after a few steps.
_BF16_REFERENCE = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_fused_beam as m
out = {}
for case in m.BF16:
    out[case + "/tokens"], out[case + "/scores"] = m._pallas_beam(case)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def pallas_bf16(tmp_path_factory):
    path = tmp_path_factory.mktemp("pallas_bf16") / "reference.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.dirname(tests),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _BF16_REFERENCE, str(path)], env=env, check=True,
                   cwd=tests, timeout=600)
    ref = np.load(path)
    return {case: (ref[case + "/tokens"], ref[case + "/scores"]) for case in BF16}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_beam_matches_pallas_kernel(case, request):
    """float32: tokens identical up to each beam's first [s], scores within
    1e-5 (JAX's own fused-vs-XLA beam limit; the two sum in other orders).
    bfloat16, against the kernel run with XLA's excess precision off: the
    plain loop rounds where the Pallas kernel rounds; tokens identical up
    to each beam's first [s] and scores (of scale ~7) within 1e-2 (measured
    5.5e-3: sums in another order move a value across a bf16 rounding
    boundary now and then; float32 measured 2.9e-6; the cls0 cases 2.9e-6
    in float32 and 7.2e-7 in bfloat16)."""
    dtype, K, early_stop, eos_bias, tie, cls0 = CASES[case]
    if dtype == "bfloat16":
        jt, js = request.getfixturevalue("pallas_bf16")[case]
    else:
        jt, js = _pallas_beam(case)
    _, tw, ck, cv = _inputs(7, eos_bias, tie)
    pt, ps = fb.fused_beam_decode(
        tw, torch.from_numpy(ck), torch.from_numpy(cv), beam_size=K, num_heads=H, steps=T,
        dtype=getattr(torch, dtype), go_id=0, eos_id=EOS_ID, early_stop=early_stop,
        cls0=torch.from_numpy(_cls0()) if cls0 else None)
    assert pt.dtype == torch.int32 and ps.dtype == torch.float32
    assert pt.shape == jt.shape == (B, K, T) and ps.shape == js.shape == (B, K)
    pt, ps = pt.numpy(), ps.numpy()
    assert _pruned_equal(pt, jt)
    np.testing.assert_allclose(ps, js, atol=1e-5 if dtype == "float32" else 1e-2, rtol=0)
    assert (np.diff(ps, axis=1) <= 0).all()  # best first
    if early_stop:  # rows do stop early: every beam of some row ends before T
        assert any((row == EOS_ID).any(axis=1).all() for row in jt[:, :, :T - 1])
    if tie:  # the tied beams: equal scores, the one through the lower class first
        a, b = TIED
        rows = [r for r in range(B) if {a, b} <= set(jt[r, :, 0])]
        assert rows
        for r in rows:
            first = list(jt[r, :, 0])
            assert first.index(a) < first.index(b)


def test_plain_beam_freezes_finished_beams_and_stops():
    """With early stop the plain loop leaves a stopped row's later tokens 0
    and keeps its scores; without it a finished beam continues with [s]."""
    _, tw, ck, cv = _inputs(7, eos_bias=5.0)
    kw = dict(beam_size=4, num_heads=H, steps=T, dtype=torch.float32)
    t_full, s_full = fb.fused_beam_decode(tw, torch.from_numpy(ck), torch.from_numpy(cv), **kw)
    t_es, s_es = fb.fused_beam_decode(tw, torch.from_numpy(ck), torch.from_numpy(cv),
                                      early_stop=True, **kw)
    torch.testing.assert_close(s_es, s_full, atol=0, rtol=0)
    stopped = False
    for full, es in zip(t_full.numpy(), t_es.numpy()):
        for f, e in zip(full, es):
            n = _first_eos(f) + 1
            assert (f[n:] == EOS_ID).all()  # frozen: [s] at zero cost
            np.testing.assert_array_equal(e[:n], f[:n])
        last = max(_first_eos(f) for f in full)
        stopped |= last < T - 1 and (es[:, last + 1:] == 0).all()
    assert stopped


def test_beam_dispatch_and_kernel_wrapper_checks():
    """CPU tensors take the plain version and launch nothing; the kernel
    wrapper refuses CPU tensors, other types and beam widths it cannot hold,
    rather than falling back."""
    _, tw, ck, cv = _inputs(3)
    ck, cv = torch.from_numpy(ck), torch.from_numpy(cv)
    before = fb.fused_beam_decode_cuda.launches
    fb.fused_beam_decode(tw, ck, cv, beam_size=2, num_heads=H, steps=T, dtype=torch.float32)
    kw = dict(beam_size=2, num_heads=H, steps=T)
    with pytest.raises(ValueError):
        fb.fused_beam_decode_cuda(fd.cast_weights(tw, torch.float32), ck, cv, **kw)
    with pytest.raises(TypeError):
        fb.fused_beam_decode_cuda(fd.cast_weights(tw, torch.float16), ck.half(), cv.half(), **kw)
    assert fb.fused_beam_decode_cuda.launches == before


@pytest.mark.parametrize("cls0,eos_bias", [(False, 0.5), (True, 3.0)], ids=["emb", "cls0"])
def test_plain_early_stop_matches_pallas_kernel(cls0, eos_bias):
    """K1e: the greedy plain loop with ``eos_id`` against the Pallas
    kernel's early stop, float32, head biased towards [s] so rows stop.
    Logits within 1e-4 up to each row's first [s] (JAX runs on until every
    row has stopped, the port stops each row); [s]-pruned tokens identical;
    the port's later rows are the [s] one-hot; and without early stop the
    same rows up to the first [s] are unchanged.  (With ``cls0`` the [s]
    bias is 3.0: up to 2.0 one row first emits [s] at the last step.)"""
    jw, tw, ck, cv = _inputs(11, eos_bias=eos_bias)
    c0 = _cls0(18) if cls0 else None
    want = np.asarray(jfd.fused_greedy_decode(
        jw, jnp.asarray(ck), jnp.asarray(cv), None, None if c0 is None else jnp.asarray(c0),
        num_heads=H, steps=T, dtype=jnp.float32, eos_id=EOS_ID, interpret=True))
    kw = dict(num_heads=H, steps=T, dtype=torch.float32,
              cls0=None if c0 is None else torch.from_numpy(c0))
    ck, cv = torch.from_numpy(ck), torch.from_numpy(cv)
    got = fd.fused_greedy_decode(tw, ck, cv, eos_id=EOS_ID, **kw).numpy()
    full = fd.fused_greedy_decode(tw, ck, cv, **kw).numpy()
    stops = [_first_eos(row) for row in want.argmax(-1)]
    assert max(stops) < T - 1  # every row stops early, so JAX does too
    onehot = np.eye(C, dtype=np.float32)[EOS_ID]
    for r, n in enumerate(stops):
        np.testing.assert_allclose(got[r, :n + 1], want[r, :n + 1], atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got[r, :n + 1], full[r, :n + 1])
        assert (got[r, n + 1:] == onehot).all()
    assert _pruned_equal(got.argmax(-1), want.argmax(-1))
