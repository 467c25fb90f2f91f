"""The plain version of the port's fused decode kernel against the JAX
package's Pallas kernel (``fused_greedy_decode``, interpret mode on the CPU),
on the same seeded weights and cross K/V, in float mode and int8 (K1q),
each with and without a step-0 row ``cls0``.  ``cls0`` is a seeded random
N(0, 1) [B, E], different for every row: the model's own (the semantic CLS
vector) is all ones, which cannot tell a version that reads it per row
from one that writes 1.0 or reads row 0 for every row."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.ops import fused_decode as jfd
from multimodal_scene_text_recognition_tpu_torch.models.decoders import TransformerDecoder
from multimodal_scene_text_recognition_tpu_torch.models.layers import positional_rows
from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd
import torch_threads

torch_threads.limit()

L, E, H, FF, C, T, TM, B = 2, 64, 4, 128, 97, 6, 8, 8


def _weights(seed):
    """FusedDecodeWeights in the JAX layout (biases [L,1,D]) and the port's
    (biases [L,D]), from one numpy draw."""
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
    rows = {"b_qkv", "b_out", "cb_q", "cb_o", "ff1_b", "ff2_b",
            "n1_s", "n1_b", "n2_s", "n2_b", "n3_s", "n3_b"}
    jw = jfd.FusedDecodeWeights(**{
        k: jnp.asarray(v[:, None, :] if k in rows else
                       v[None, :] if k in ("fn_s", "fn_b", "head_b") else v)
        for k, v in w.items()})
    tw = fd.FusedDecodeWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    ck = rng.standard_normal((L, B, TM, E)).astype(np.float32)
    cv = rng.standard_normal((L, B, TM, E)).astype(np.float32)
    return jw, tw, ck, cv


def random_cls0(seed, B=B, E=E):
    """A seeded N(0, 1) step-0 row per batch row, float32 [B, E]."""
    return np.random.default_rng(seed).standard_normal((B, E)).astype(np.float32)


def _both(dtype_j, dtype_t, seed=3, cls0=False):
    jw, tw, ck, cv = _weights(seed)
    c0 = random_cls0(seed + 100) if cls0 else None
    want = np.asarray(jfd.fused_greedy_decode(
        jw, jnp.asarray(ck), jnp.asarray(cv), None, None if c0 is None else jnp.asarray(c0),
        num_heads=H, steps=T, dtype=dtype_j, interpret=True))
    got = fd.fused_greedy_decode(tw, torch.from_numpy(ck), torch.from_numpy(cv),
                                 num_heads=H, steps=T, dtype=dtype_t,
                                 cls0=None if c0 is None else torch.from_numpy(c0)).numpy()
    return got, want


STEP0 = pytest.mark.parametrize("cls0", [False, True], ids=["emb", "cls0"])


@STEP0
def test_plain_matches_pallas_kernel_f32(cls0):
    """float32: logits atol 1e-4 (the two differ only in summation order)
    and identical greedy tokens; with ``cls0`` the step-0 logits move."""
    got, want = _both(jnp.float32, torch.float32, cls0=cls0)
    assert got.shape == want.shape == (B, T, C)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if cls0:
        assert np.abs(got[:, 0] - _both(jnp.float32, torch.float32)[0][:, 0]).max() > 0.1


@STEP0
def test_plain_matches_pallas_kernel_bf16(cls0):
    """bfloat16: the plain loop rounds where the Pallas kernel rounds, and
    the greedy tokens agree exactly on this seed.  The logits (scale ~5)
    agree to atol 0.15: bf16 keeps 8 significant bits and the two sum in
    different orders, so a value that lands on the other side of a rounding
    boundary early moves later ones (measured max difference 0.09; 0.074
    with cls0, whose step-0 row is rounded to bf16 only where a projection
    reads it, as in the Pallas kernel)."""
    got, want = _both(jnp.bfloat16, torch.bfloat16, cls0=cls0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=0.15, rtol=0)


def test_dispatch_and_kernel_wrapper_checks():
    """CPU tensors take the plain version and launch nothing; the kernel
    wrapper refuses CPU tensors and mixed types rather than falling back;
    a step-0 row of another shape or type raises in the plain version
    too."""
    _, tw, ck, cv = _weights(5)
    before = fd.fused_greedy_decode_cuda.launches
    fd.fused_greedy_decode(tw, torch.from_numpy(ck), torch.from_numpy(cv),
                           num_heads=H, steps=T, dtype=torch.float32)
    assert fd.fused_greedy_decode_cuda.launches == before
    c0 = torch.from_numpy(random_cls0(5))
    for bad in (c0[:-1], c0[:, :-1].contiguous(), c0.double(), c0.bfloat16()):
        with pytest.raises(ValueError, match="cls0"):
            fd.fused_greedy_decode(tw, torch.from_numpy(ck), torch.from_numpy(cv),
                                   num_heads=H, steps=T, dtype=torch.float32, cls0=bad)
    cw = fd.cast_weights(tw, torch.float32)
    with pytest.raises(ValueError):
        fd.fused_greedy_decode_cuda(cw, torch.from_numpy(ck), torch.from_numpy(cv),
                                    num_heads=H, steps=T)
    with pytest.raises(TypeError):
        fd.fused_greedy_decode_cuda(fd.cast_weights(tw, torch.float16), torch.from_numpy(ck),
                                    torch.from_numpy(cv), num_heads=H, steps=T)
    assert fd.fused_greedy_decode_cuda.launches == before


def _decoder(seed, dtype=torch.float32):
    """A small TransformerDecoder with seeded weights (memory width 32)."""
    dec = TransformerDecoder(C, d_model=E, memory_dim=32, num_heads=H, ff_dim=FF,
                             num_layers=L, max_text_length=T, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return dec


def _fresh_weights(dec, dtype):
    pe = positional_rows(T + 1, E, torch.device("cpu"))[:T]
    return fd.cast_weights(fd.stack_decoder_weights(
        dec.layers(), dec.final_norm, dec.emb_to_classes, dec.emb.weight, pe), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_weights_built_once_per_dtype(dtype):
    """The decoder stacks and casts its tables on first use only: a second
    call returns the same tensors, detached, contiguous, in ``dtype``
    (positional rows float32), equal to a fresh stack."""
    dec = _decoder(0)
    w1, w2 = dec.fused_weights(dtype), dec.fused_weights(dtype)
    assert all(a is b for a, b in zip(w1, w2))
    for name, t, want in zip(fd.FusedDecodeWeights._fields, w1, _fresh_weights(dec, dtype)):
        assert t.dtype == (torch.float32 if name == "pe" else dtype), name
        assert t.is_contiguous() and not t.requires_grad, name
        assert torch.equal(t, want), name


@pytest.mark.parametrize("change", ["in_place", "load_state_dict"])
def test_fused_weights_follow_parameter_changes(change):
    """A parameter written after the first call (in place, or by loading a
    state dict) rebuilds the cached tables."""
    dec, other = _decoder(0), _decoder(1)
    before = dec.fused_weights()
    with torch.no_grad():
        if change == "in_place":
            dec.layer1.linear1.weight.add_(1.0)
        else:
            dec.load_state_dict(other.state_dict())
    after = dec.fused_weights()
    assert after.ff1_w is not before.ff1_w
    for name, t, want in zip(fd.FusedDecodeWeights._fields, after,
                             _fresh_weights(dec, torch.float32)):
        assert torch.equal(t, want), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_decode_never_serves_stale_weights(dtype):
    """greedy_decode after a weight update equals a decoder built with the
    updated weights from the start, and differs from the first result."""
    dec, other = _decoder(2, dtype), _decoder(3, dtype)
    enc = torch.from_numpy(np.random.default_rng(4).standard_normal((B, TM, 32)).astype(np.float32))
    with torch.no_grad():
        first = dec.greedy_decode(enc)
        dec.load_state_dict(other.state_dict())
        second = dec.greedy_decode(enc)
        want = _decoder(3, dtype).greedy_decode(enc)
    torch.testing.assert_close(second, want, atol=0, rtol=0)
    assert not torch.equal(first, second)


# -- K1q: the quantized mode (decode_int8) --------------------------------

EOS = 1  # [s]


def _quantized(seed, eos_bias):
    """The seeded weights with the [s] logit raised by ``eos_bias``,
    quantized by each package: (JAX tables, JAX scales, port tables, port
    scales, cross K, cross V)."""
    jw, tw, ck, cv = _weights(seed)
    jw = jw._replace(head_b=jw.head_b.at[0, EOS].add(eos_bias))
    tw = tw._replace(head_b=tw.head_b.clone())
    tw.head_b[EOS] += eos_bias
    jq, js = jfd.quantize_fused_weights(jw)
    tq, ts = fd.quantize_fused_weights(tw)
    return jq, js, tq, ts, ck, cv


def _pallas_int8(dtype, early_stop, cls0=False):
    jq, js, _, _, ck, cv = _quantized(7, 5.0)
    return np.asarray(jfd.fused_greedy_decode(
        jq, jnp.asarray(ck), jnp.asarray(cv), js,
        jnp.asarray(random_cls0(8)) if cls0 else None, num_heads=H, steps=T,
        dtype=getattr(jnp, dtype), eos_id=EOS if early_stop else None, interpret=True))


# The bf16 reference runs in a JAX process of its own with XLA's excess
# precision off: by default XLA on the CPU may keep a product in float32
# where the kernel rounds it to bf16 (tests/test_torch_fused_beam.py).
_BF16_INT8_REFERENCE = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_fused_decode as m
np.savez(sys.argv[1], **{f"{es}-{c}": m._pallas_int8("bfloat16", es, c)
                         for es in (False, True) for c in (False, True)})
"""


@pytest.fixture(scope="module")
def pallas_int8_bf16(tmp_path_factory):
    path = tmp_path_factory.mktemp("pallas_int8") / "reference.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.dirname(tests),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _BF16_INT8_REFERENCE, str(path)], env=env,
                   check=True, cwd=tests, timeout=600)
    ref = np.load(path)
    return {(es, c): ref[f"{es}-{c}"] for es in (False, True) for c in (False, True)}


def test_quantized_tables_match_jax_bit_for_bit():
    """quantize_fused_weights: the six int8 tables (unpacked from K1q's
    layout, which packing and unpacking keep) and their per-channel scales
    equal JAX's exactly; the other tables pass through."""
    jq, js, tq, ts, _, _ = _quantized(7, 5.0)
    for name, scale in zip(fd.QUANTIZED, fd.FusedDecodeScales._fields):
        t = getattr(tq, name)
        assert t.dtype == torch.int8
        np.testing.assert_array_equal(fd.unpack_int8_table(t).numpy(),
                                      np.asarray(getattr(jq, name)))
        np.testing.assert_array_equal(getattr(ts, scale).numpy(),
                                      np.asarray(getattr(js, scale))[:, 0])
    assert torch.equal(tq.emb, _weights(7)[1].emb)
    assert torch.equal(fd.pack_int8_table(fd.unpack_int8_table(tq.ff2_w)), tq.ff2_w)


@STEP0
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("early_stop", [False, True])
def test_plain_int8_matches_pallas_kernel(dtype, early_stop, cls0, request):
    """K1q's plain version against the Pallas kernel with ``scales``
    (interpret mode; bf16 with XLA's excess precision off), the [s] logit
    raised so rows stop at different steps: identical tokens up to each
    row's first [s] (all of them without early stop), and the logit rows
    there within 2e-2 (scale ~5).  The int8 products are exact in both; the
    rest sums in other orders, and a float32 difference that moves an
    activation across a rounding boundary of its int8 step moves a
    projection by one step.  In float32 that is rare: at least 95% of the
    (row, step) logit rows agree within 1e-4 (measured: all but one within
    4e-6, the one 1.5e-2 off).  With ``cls0`` the step-0 row is quantized
    from its unrounded float32 values, as the Pallas kernel quantizes it;
    the one row that crosses a boundary in float32 is at step 0 and moves
    3.2e-2 (the other 47 within 5e-6), so the largest difference is held
    at 5e-2 there (one int8 step of another activation)."""
    if dtype == "bfloat16":
        want = request.getfixturevalue("pallas_int8_bf16")[early_stop, cls0]
    else:
        want = _pallas_int8(dtype, early_stop, cls0)
    _, _, tq, ts, ck, cv = _quantized(7, 5.0)
    got = fd.fused_greedy_decode(tq, torch.from_numpy(ck), torch.from_numpy(cv),
                                 num_heads=H, steps=T, dtype=getattr(torch, dtype),
                                 eos_id=EOS if early_stop else None, scales=ts,
                                 cls0=torch.from_numpy(random_cls0(8)) if cls0 else None).numpy()
    assert got.shape == want.shape == (B, T, C)
    ids, want_ids = got.argmax(-1), want.argmax(-1)
    stops = [int(np.flatnonzero(r == EOS)[0]) if (r == EOS).any() else T - 1 for r in want_ids]
    assert min(stops) < T - 1  # some rows do stop early
    row_err = []
    for r, n in enumerate(stops if early_stop else [T - 1] * B):
        np.testing.assert_array_equal(ids[r, :n + 1], want_ids[r, :n + 1])
        row_err += list(np.abs(got[r, :n + 1] - want[r, :n + 1]).max(axis=-1))
    assert max(row_err) <= (5e-2 if cls0 else 2e-2)
    if dtype == "float32":
        assert np.mean(np.asarray(row_err) <= 1e-4) >= 0.95
