"""Ops of the PyTorch port against the JAX package, float32 on the CPU:
the TPS grid solve, the plain version of the warp kernel (the form the JAX
Pallas kernel equals), and packed multi-head attention."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.models.layers import (
    sinusoidal_table as jax_sinusoidal_table,
)
from multimodal_scene_text_recognition_tpu.ops import tps as jax_tps
from multimodal_scene_text_recognition_tpu.ops.attention import (
    MHAWeights,
    causal_mask,
    multihead_attention,
)
from multimodal_scene_text_recognition_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from multimodal_scene_text_recognition_tpu_torch.models.layers import (
    MultiHeadAttention,
    sinusoidal_table,
)
from multimodal_scene_text_recognition_tpu_torch.ops import grid_sample as gs
from multimodal_scene_text_recognition_tpu_torch.ops import tps
import torch_threads

torch_threads.limit()

RNG = np.random.default_rng(7)


def test_tps_weights_match_jax_constants():
    """M = P_hat @ inv_delta_C formed in float64 from the JAX package's
    float32 constants: within 2e-5 of the port's weights (measured 1.3e-5,
    the float32 rounding of those constants)."""
    inv_delta_C, P_hat = jax_tps.tps_constants(20, 32, 100)
    want = (P_hat.astype(np.float64) @ inv_delta_C.astype(np.float64))[:, :20]
    np.testing.assert_allclose(tps.tps_weights(20, 32, 100), want, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(tps.build_identity_bias(20), jax_tps.build_identity_bias(20))


@pytest.mark.parametrize("kind", ["wide", "near_identity"])
def test_build_sampling_grid_matches_jax(kind):
    """Against the JAX package: atol 5e-5.  JAX solves in two float32
    matmuls with float32 constants whose entries (up to 17.6 in
    inv_delta_C) cancel; its own error against a float64 solve is 2e-5 to
    3.5e-5 on these inputs.  The port's float32 matmul with the float64-formed
    weights stays within 1e-6 of the same product taken in float64."""
    if kind == "wide":
        c_prime = (RNG.standard_normal((3, 20, 2)) * 0.6).astype(np.float32)
    else:
        c_prime = (tps.build_identity_bias(20).reshape(1, 20, 2)
                   + RNG.standard_normal((3, 20, 2)) * 0.1).astype(np.float32)
    got = tps.build_sampling_grid(torch.from_numpy(c_prime), 32, 100).numpy()
    assert got.shape == (3, 32, 100, 2)
    want = np.asarray(jax_tps.build_sampling_grid(jnp.asarray(c_prime), 32, 100))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    exact = np.einsum("nf,bfk->bnk", tps.tps_weights(20, 32, 100).astype(np.float64),
                      c_prime.astype(np.float64)).reshape(got.shape)
    np.testing.assert_allclose(got, exact, atol=1e-6, rtol=0)


def test_tps_matrix_uploaded_once():
    """The grid solve's constant matrix is made once per shape and device,
    and every grid is the product with that one matrix."""
    cpu = torch.device("cpu")
    M = tps._tps_matrix(20, 32, 100, cpu)
    assert tps._tps_matrix(20, 32, 100, cpu) is M
    assert M.dtype == torch.float32 and M.shape == (3200, 20)
    np.testing.assert_array_equal(M.numpy(), tps.tps_weights(20, 32, 100))
    c_prime = torch.from_numpy((RNG.standard_normal((2, 20, 2)) * 0.5).astype(np.float32))
    got = tps.build_sampling_grid(c_prime, 32, 100)
    torch.testing.assert_close(got, (M @ c_prime).reshape(2, 32, 100, 2), atol=0, rtol=0)


def _edge_grid(B, Ho, Wo, H, W):
    """Sample points on integer pixel coordinates, on the far edges
    (sx = W-1, sy = H-1), exactly at -1/+1, and well outside [-1, 1]."""
    g = (RNG.random((B, Ho, Wo, 2)) * 2 - 1).astype(np.float32)
    flat = g.reshape(B, -1, 2)
    n = flat.shape[1]
    ix = RNG.integers(0, W, n)
    iy = RNG.integers(0, H, n)
    flat[:, : n // 4, 0] = (2.0 * ix[: n // 4] / (W - 1) - 1.0)
    flat[:, : n // 4, 1] = (2.0 * iy[: n // 4] / (H - 1) - 1.0)
    flat[:, n // 4: n // 4 + 8] = [1.0, 1.0]
    flat[:, n // 4 + 8: n // 4 + 16] = [-1.0, -1.0]
    flat[:, n // 4 + 16: n // 2] *= 3.0
    return flat.reshape(B, Ho, Wo, 2)


@pytest.mark.parametrize("C,kind", [(1, "random"), (1, "edges"), (3, "edges"), (1, "outside")])
def test_grid_sample_plain_matches_jax(C, kind):
    """The plain version vs JAX grid_sample at HIGHEST precision (the form
    the Pallas kernel is bit-equal to, grid_sample.py:175-186): atol 1e-5."""
    B, H, W = 4, 32, 100
    img = RNG.random((B, H, W, C), dtype=np.float32)
    if kind == "random":
        grid = ((RNG.random((B, H, W, 2)) * 2 - 1) * 1.2).astype(np.float32)
    elif kind == "edges":
        grid = _edge_grid(B, H, W, H, W)
    else:
        grid = ((RNG.random((B, H, W, 2)) * 2 - 1) * 5.0).astype(np.float32)
    want = np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                      precision=jax.lax.Precision.HIGHEST))
    got = gs.grid_sample(torch.from_numpy(img), torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_grid_sample_kernel_function_backward_is_plain_vjp(monkeypatch):
    """The autograd wrapper's backward is the VJP of the plain form: with
    the kernel forward swapped for the plain version (the kernel itself runs
    only on the card), its gradients match JAX's grid_sample gradients."""
    B, H, W = 2, 8, 10
    img = RNG.random((B, H, W, 1), dtype=np.float32)
    grid = ((RNG.random((B, H, W, 2)) * 2 - 1) * 0.9).astype(np.float32)
    gi, gg = jax.grad(lambda i, g: jnp.sum(jax_grid_sample(i, g) ** 2), argnums=(0, 1))(
        jnp.asarray(img), jnp.asarray(grid))
    monkeypatch.setattr(gs, "grid_sample_cuda", gs.grid_sample_plain)
    timg = torch.from_numpy(img).requires_grad_(True)
    tgrid = torch.from_numpy(grid).requires_grad_(True)
    (gs._GridSampleKernel.apply(timg, tgrid) ** 2).sum().backward()
    np.testing.assert_allclose(timg.grad.numpy(), np.asarray(gi), atol=1e-4)
    np.testing.assert_allclose(tgrid.grad.numpy(), np.asarray(gg), atol=1e-4)


def test_grid_sample_cuda_rejects_cpu_tensors():
    img = torch.zeros(8, 32, 100, 1)
    grid = torch.zeros(8, 32, 100, 2)
    before = gs.grid_sample_cuda.launches
    with pytest.raises(ValueError):
        gs.grid_sample_cuda(img, grid)
    assert gs.grid_sample_cuda.launches == before
    gs.grid_sample(img, grid)  # CPU tensors take the plain version
    assert gs.grid_sample_cuda.launches == before


@pytest.mark.parametrize("causal", [False, True])
def test_multihead_attention_matches_jax(causal):
    """Packed-qkv attention with converted weights; atol 1e-5 (float32)."""
    B, T, E, H = 2, 7, 32, 4
    x = RNG.standard_normal((B, T, E)).astype(np.float32)
    w_qkv = (RNG.standard_normal((E, 3 * E)) / np.sqrt(E)).astype(np.float32)
    b_qkv = RNG.standard_normal(3 * E).astype(np.float32) * 0.1
    w_out = (RNG.standard_normal((E, E)) / np.sqrt(E)).astype(np.float32)
    b_out = RNG.standard_normal(E).astype(np.float32) * 0.1
    mask = causal_mask(T) if causal else None
    want = np.asarray(multihead_attention(
        jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
        MHAWeights(*map(jnp.asarray, (w_qkv, b_qkv, w_out, b_out))), H, mask))
    mha = MultiHeadAttention(E, H)
    with torch.no_grad():
        mha.in_proj_weight.copy_(torch.from_numpy(w_qkv.T))
        mha.in_proj_bias.copy_(torch.from_numpy(b_qkv))
        mha.out_proj.weight.copy_(torch.from_numpy(w_out.T))
        mha.out_proj.bias.copy_(torch.from_numpy(b_out))
        tmask = torch.from_numpy(np.array(mask)) if causal else None
        got = mha(torch.from_numpy(x), torch.from_numpy(x), tmask).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_sinusoidal_table_matches():
    np.testing.assert_array_equal(sinusoidal_table(26, 64), jax_sinusoidal_table(26, 64))
