"""The plain version of the port's fused decode kernel against the JAX
package's Pallas kernel (``fused_greedy_decode``, interpret mode on the CPU),
on the same seeded weights and cross K/V."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.ops import fused_decode as jfd
from multimodal_scene_text_recognition_tpu_torch.models.decoders import TransformerDecoder
from multimodal_scene_text_recognition_tpu_torch.models.layers import positional_rows
from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd

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


def _both(dtype_j, dtype_t, seed=3):
    jw, tw, ck, cv = _weights(seed)
    want = np.asarray(jfd.fused_greedy_decode(
        jw, jnp.asarray(ck), jnp.asarray(cv), num_heads=H, steps=T, dtype=dtype_j,
        interpret=True))
    got = fd.fused_greedy_decode(tw, torch.from_numpy(ck), torch.from_numpy(cv),
                                 num_heads=H, steps=T, dtype=dtype_t).numpy()
    return got, want


def test_plain_matches_pallas_kernel_f32():
    """float32: logits atol 1e-4 (the two differ only in summation order)
    and identical greedy tokens."""
    got, want = _both(jnp.float32, torch.float32)
    assert got.shape == want.shape == (B, T, C)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_plain_matches_pallas_kernel_bf16():
    """bfloat16: the plain loop rounds where the Pallas kernel rounds, and
    the greedy tokens agree exactly on this seed.  The logits (scale ~5)
    agree to atol 0.15: bf16 keeps 8 significant bits and the two sum in
    different orders, so a value that lands on the other side of a rounding
    boundary early moves later ones (measured max difference 0.09)."""
    got, want = _both(jnp.bfloat16, torch.bfloat16)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=0.15, rtol=0)


def test_dispatch_and_kernel_wrapper_checks():
    """CPU tensors take the plain version and launch nothing; the kernel
    wrapper refuses CPU tensors and mixed types rather than falling back."""
    _, tw, ck, cv = _weights(5)
    before = fd.fused_greedy_decode_cuda.launches
    fd.fused_greedy_decode(tw, torch.from_numpy(ck), torch.from_numpy(cv),
                           num_heads=H, steps=T, dtype=torch.float32)
    assert fd.fused_greedy_decode_cuda.launches == before
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
