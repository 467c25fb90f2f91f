"""Train-mode BatchNorm of the PyTorch port against the JAX package on the
CPU: the forward, the plain version of the backward reduction against the
JAX Pallas kernel in interpret mode, the plain version of the whole backward
(the function the CUDA kernel computes) against ``jax.vjp``, the
gradients, and the running-statistics update."""

from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.models.layers import FusedBatchNorm
from multimodal_scene_text_recognition_tpu.models.resnet import BasicBlock as JBasicBlock
from multimodal_scene_text_recognition_tpu.ops import batchnorm as jbn
from multimodal_scene_text_recognition_tpu_torch import convert
from multimodal_scene_text_recognition_tpu_torch.models.layers import BatchNorm2d
from multimodal_scene_text_recognition_tpu_torch.models.resnet import BasicBlock
from multimodal_scene_text_recognition_tpu_torch.ops import batchnorm as bn
from test_torch_modules import flatten, randomize
import torch_threads

torch_threads.limit()


def _nhwc(t):
    return np.asarray(t.detach().float()).transpose(0, 2, 3, 1)


def _inputs(shape, seed, dtype=np.float32):
    """x [B, C, H, W] with a per-channel offset, scale and bias [C]."""
    rng = np.random.default_rng(seed)
    B, C, H, W = shape
    x = (rng.normal(size=shape) * 2.0 + rng.normal(size=(1, C, 1, 1))).astype(np.float32)
    weight = (1.0 + 0.1 * rng.normal(size=C)).astype(np.float32)
    bias = (0.1 * rng.normal(size=C)).astype(np.float32)
    return x, weight, bias


@pytest.mark.parametrize("shape,dtype", [((4, 16, 6, 8), "float32"),
                                         ((8, 32, 5, 7), "bfloat16")])
def test_forward_matches_jax(shape, dtype):
    """y, mean, var of the same input (bf16 input: the same bf16 values).
    float32: y within 1e-5 (measured ~5e-7), statistics within 1e-5 of
    their scale (measured 1.5e-6: the sums run in another order).
    bfloat16: y within one bf16 step of its value (2^-7 relative: the
    float32 results round to bf16 on either side of a boundary), the float32
    statistics as above."""
    x, w, b = _inputs(shape, 0)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    y, mean, var = bn.bn_train(xt, torch.from_numpy(w), torch.from_numpy(b))
    jy, jmean, jvar = jbn.bn_train(jnp.asarray(_nhwc(xt), getattr(jnp, dtype)),
                                   jnp.asarray(w), jnp.asarray(b))
    assert y.dtype == tdt and mean.dtype == var.dtype == torch.float32
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy, np.float32), rtol=rtol, atol=1e-5)
    for got, want in ((mean, jmean), (var, jvar)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


def test_forward_variance_is_biased_and_clipped():
    """The fast-variance form E[x^2] - E[x]^2 is clipped at 0: a constant
    channel gives var 0, not a small negative number."""
    x = torch.full((2, 3, 2, 2), 0.1)
    x[:, 1] = torch.arange(8.0).reshape(2, 2, 2)
    _, mean, var = bn.bn_train(x, torch.ones(3), torch.zeros(3))
    assert var[0] == 0.0 and var[2] == 0.0
    np.testing.assert_allclose(var[1].item(), np.var(np.arange(8.0)), rtol=1e-6)


def test_plain_reduction_matches_pallas_kernel_interpret():
    """``bn_bwd_sums_plain`` against the JAX Pallas kernel itself in
    interpret mode (as tests/test_batchnorm.py runs it), bf16 x and dy with
    N = 25*10*10 = 2500 rows, not a multiple of its 1024-row tile, so its
    masked tail is exercised.  Both sum in float32 in another order:
    within 1e-5 relative, 1e-4 absolute (sums of scale ~50)."""
    rng = np.random.default_rng(3)
    shape = (25, 128, 10, 10)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
    mean = torch.from_numpy(rng.normal(size=128).astype(np.float32))
    rstd = torch.from_numpy(rng.uniform(0.5, 2.0, size=128).astype(np.float32))
    dg, db = bn.bn_bwd_sums_plain(x, dy, mean, rstd)

    real_call = jbn.pl.pallas_call

    def interp_call(*a, **kw):
        kw["interpret"] = True
        return real_call(*a, **kw)

    x2d = jnp.asarray(_nhwc(x).reshape(-1, 128), jnp.bfloat16)
    dy2d = jnp.asarray(_nhwc(dy).reshape(-1, 128), jnp.bfloat16)
    with mock.patch.object(jbn.pl, "pallas_call", interp_call):
        jdg, jdb = jbn._bn_bwd_sums_pallas(x2d, dy2d, jnp.asarray(mean.numpy()),
                                           jnp.asarray(rstd.numpy()))
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(4, 16, 6, 8), (2, 8, 2, 2), (3, 32, 7, 11)])
def test_gradients_match_jax_grad(shape):
    """(dx, dgamma, dbeta) of sum(y * cotangent) against jax.grad of the
    JAX ``bn_train``: within 1e-5 of each gradient's scale (measured
    <= 3e-7)."""
    x, w, b = _inputs(shape, 1)
    cot = np.random.default_rng(2).normal(size=shape).astype(np.float32)

    def f(x, w, b):
        y, _, _ = jbn.bn_train(x, w, b)
        return jnp.sum(y * jnp.asarray(cot.transpose(0, 2, 3, 1)))

    jgx, jgw, jgb = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y, _, _ = bn.bn_train(xt, wt, bt)
    (y * torch.from_numpy(cot)).sum().backward()
    for got, want in ((_nhwc(xt.grad), jgx), (wt.grad.numpy(), jgw), (bt.grad.numpy(), jgb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_running_update_matches_fused_batchnorm():
    """One train-mode call from random running statistics: the new running
    mean and variance equal JAX ``FusedBatchNorm``'s (0.9 * old + 0.1 *
    batch with the biased variance) within 1e-6.  At N = 2*2*2 = 8 per
    channel torch's unbiased rule would move the variance by 8/7 of the
    batch term, far outside that."""
    shape = (2, 8, 2, 2)
    x, w, b = _inputs(shape, 4)
    rng = np.random.default_rng(5)
    old_mean = rng.normal(size=8).astype(np.float32)
    old_var = rng.uniform(0.5, 1.5, size=8).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": {"mean": jnp.asarray(old_mean), "var": jnp.asarray(old_var)}}
    jy, upd = FusedBatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)), mutable=["batch_stats"])

    mod = BatchNorm2d(8)
    mod.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b),
                         "running_mean": torch.from_numpy(old_mean),
                         "running_var": torch.from_numpy(old_var)})
    y = mod(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), rtol=0, atol=1e-5)
    new_mean, new_var = np.asarray(upd["batch_stats"]["mean"]), np.asarray(upd["batch_stats"]["var"])
    np.testing.assert_allclose(mod.running_mean.numpy(), new_mean, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(), new_var, rtol=0, atol=1e-6)
    unbiased = 0.9 * old_var + 0.1 * x.var(axis=(0, 2, 3), ddof=1)
    assert np.abs(unbiased - new_var).max() > 1e-3


@pytest.mark.parametrize("cin,planes", [(16, 16), (8, 16)])
def test_basic_block_train_gradients_match_jax(cin, planes):
    """A residual block (two conv+BN, with and without the projection) in
    train mode, float32: the output, every parameter gradient and the input
    gradient within 1e-5 of their scale (measured <= 4e-6).  A
    single block is well conditioned; the whole backbone at initialisation
    is not (see test_torch_train)."""
    rng = np.random.default_rng(6)
    X = np.maximum(rng.normal(size=(4, 8, 20, cin)), 0).astype(np.float32)
    R = rng.normal(size=(4, 8, 20, planes)).astype(np.float32)
    jm = JBasicBlock(planes, dtype=jnp.float32, fused_bn=True)
    v = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(X)), 3)

    def f(params, x):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x, True,
                          mutable=["batch_stats"])
        return jnp.sum(out * R), out

    (_, jout), (jg, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(X))
    port = BasicBlock(cin, planes, torch.float32)
    port.load_state_dict(convert.bundle_to_state_dict(flatten(v)), strict=True)
    xt = torch.from_numpy(X.transpose(0, 3, 1, 2).copy()).requires_grad_()
    out = port(xt, train=True)
    (out * torch.from_numpy(R.transpose(0, 3, 1, 2))).sum().backward()
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jgx), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jgx)).max())
    params = dict(port.named_parameters())
    for name, want in convert.bundle_to_state_dict(flatten({"params": jg})).items():
        np.testing.assert_allclose(params[name].grad.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * want.abs().max().item(), err_msg=name)


def test_cpu_tensors_take_the_plain_reduction():
    """On the CPU the wrapper never reaches the kernel; the kernel's
    wrapper refuses CPU tensors instead of falling back."""
    x = torch.randn(2, 4, 3, 3)
    mean, rstd, weight = torch.zeros(4), torch.ones(4), torch.ones(4)
    before = bn.bn_bwd_cuda.launches
    for plain in (False, True):
        dx, dg, db = bn.bn_bwd(x, x, mean, rstd, weight, plain=plain)
        torch.testing.assert_close(db, x.sum(dim=(0, 2, 3)))
        assert dx.shape == x.shape and dx.dtype == x.dtype
    assert bn.bn_bwd_cuda.launches == before
    with pytest.raises(ValueError):
        bn.bn_bwd_cuda(x, x, mean, rstd, weight)


def _bf16_steps(got, want):
    """|got - want| in bf16 steps at ``want``: the spacing of bfloat16
    numbers in want's binade (the smallest normal's below it)."""
    want = want.astype(np.float64)
    exp = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    return np.abs(got.astype(np.float64) - want) / 2.0 ** (exp - 7)


@pytest.mark.parametrize("shape", [(3, 3, 7, 11), (5, 32, 3, 7), (2, 128, 5, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp(shape, dtype):
    """``bn_bwd_plain`` (the kernel's oracle) against ``jax.vjp`` of the
    JAX ``bn_train`` on the same x, dy (a per-channel offset on each, so
    that dbeta's term counts) and weight, at C = 3, 32 and 128 with N =
    231, 105 and 90 rows (no multiple of a tile or of 16).  float32: dx,
    dgamma and dbeta within 1e-5 of their scale (the sums run in another
    order).  bfloat16: dgamma and dbeta as in float32, dx within one bf16
    step of JAX's (float32 values on either side of a rounding boundary),
    or 1e-5 of dx's scale where that is larger (near 0)."""
    x, w, _ = _inputs(shape, shape[1])
    rng = np.random.default_rng(shape[1] + 1)
    C = shape[1]
    dy = (rng.normal(size=shape) + rng.normal(size=(1, C, 1, 1))).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt, dyt = torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt)
    xf = xt.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + 1e-5)
    dx, dg, db = bn.bn_bwd_plain(xt, dyt, mean, rstd, torch.from_numpy(w))
    assert dx.dtype == tdt and dg.dtype == db.dtype == torch.float32

    (jy, jmean, jvar), vjp = jax.vjp(lambda a, s, b: jbn.bn_train(a, s, b),
                                     jnp.asarray(_nhwc(xt), jdt), jnp.asarray(w),
                                     jnp.zeros(C, jnp.float32))
    jdx, jdg, jdb = vjp((jnp.asarray(_nhwc(dyt), jdt), jnp.zeros_like(jmean),
                         jnp.zeros_like(jvar)))
    jdx = np.asarray(jdx, np.float32)
    for got, want in ((dg.numpy(), np.asarray(jdg)), (db.numpy(), np.asarray(jdb))):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    scale = 1e-5 * np.abs(jdx).max()
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(dx), jdx, rtol=0, atol=scale)
    else:
        err = np.abs(_nhwc(dx) - jdx)
        assert np.all((_bf16_steps(_nhwc(dx), jdx) <= 1.0) | (err <= scale)), err.max()
