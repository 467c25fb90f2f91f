"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc and skip elsewhere.  They import no JAX, so
they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from multimodal_scene_text_recognition_tpu_torch import api
from multimodal_scene_text_recognition_tpu_torch.charset import AttnCodec
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig
from multimodal_scene_text_recognition_tpu_torch.charset import EOS_ID
from multimodal_scene_text_recognition_tpu_torch.ops import batchnorm as bn
from multimodal_scene_text_recognition_tpu_torch.ops import fused_beam as fb
from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd
from multimodal_scene_text_recognition_tpu_torch.ops import grid_sample as gs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,H,W,Ho,Wo", [(3, 32, 100, 32, 100), (5, 7, 9, 4, 6), (2, 1, 1, 3, 3)])
def test_grid_sample_kernel_matches_plain(dev, B, H, W, Ho, Wo):
    """atol 1e-5 (float32, the same taps; only FMA contraction differs),
    on grids with integer coordinates, the far edges and points far outside
    [-1, 1]; (2, 1, 1) is the degenerate one-pixel image."""
    rng = np.random.default_rng(B * 100 + H)
    img = torch.from_numpy(rng.random((B, H, W, 1), dtype=np.float32)).to(dev)
    g = ((rng.random((B, Ho, Wo, 2)) * 2 - 1) * 3).astype(np.float32)
    g[:, 0, 0] = [1.0, 1.0]
    g[:, -1, -1] = [-1.0, -1.0]
    if W > 1 and H > 1:
        g[:, 0, 1:] = np.stack([2.0 * (np.arange(1, Wo) % W) / (W - 1) - 1.0,
                                np.zeros(Wo - 1)], -1)
    grid = torch.from_numpy(g).to(dev)
    out = gs.grid_sample(img, grid)
    ref = gs.grid_sample_plain(img, grid)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_grid_sample_kernel_backward_is_plain_vjp(dev):
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.random((2, 8, 10, 1), dtype=np.float32)).to(dev)
    grid = torch.from_numpy(((rng.random((2, 8, 10, 2)) * 2 - 1) * 0.9).astype(np.float32)).to(dev)
    grads = []
    for f in (gs.grid_sample, gs.grid_sample_plain):
        i, g = img.clone().requires_grad_(True), grid.clone().requires_grad_(True)
        (f(i, g) ** 2).sum().backward()
        grads.append((i.grad, g.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=1e-5, rtol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-5, rtol=0)


def test_grid_sample_wrapper_refuses_bad_inputs(dev):
    img = torch.zeros(2, 8, 10, 1, device=dev)
    grid = torch.zeros(2, 8, 10, 2, device=dev)
    with pytest.raises(TypeError):
        gs.grid_sample_cuda(img.double(), grid)
    with pytest.raises(ValueError):
        gs.grid_sample_cuda(torch.zeros(2, 8, 10, 3, device=dev), grid)
    with pytest.raises(ValueError):
        gs.grid_sample_cuda(img.transpose(1, 2), grid)


def _decode_inputs(dev, B, seed, L=2, E=64, F=128, C=97, T=6, Tm=8):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=None, base=0.0):
        s = 1.0 / np.sqrt(shape[-2]) if scale is None else scale
        return torch.from_numpy((base + s * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    w = fd.FusedDecodeWeights(
        w_qkv=t(L, E, 3 * E), b_qkv=t(L, 3 * E, scale=0.1), w_out=t(L, E, E),
        b_out=t(L, E, scale=0.1), cw_q=t(L, E, E), cb_q=t(L, E, scale=0.1),
        cw_o=t(L, E, E), cb_o=t(L, E, scale=0.1), ff1_w=t(L, E, F),
        ff1_b=t(L, F, scale=0.1), ff2_w=t(L, F, E), ff2_b=t(L, E, scale=0.1),
        n1_s=t(L, E, scale=0.1, base=1.0), n1_b=t(L, E, scale=0.1),
        n2_s=t(L, E, scale=0.1, base=1.0), n2_b=t(L, E, scale=0.1),
        n3_s=t(L, E, scale=0.1, base=1.0), n3_b=t(L, E, scale=0.1),
        fn_s=t(E, scale=0.1, base=1.0), fn_b=t(E, scale=0.1),
        head_w=t(E, C, scale=0.5), head_b=t(C, scale=0.1), emb=t(C, E, scale=1.0),
        pe=t(T, E, scale=1.0))
    return w, t(L, B, Tm, E, scale=1.0), t(L, B, Tm, E, scale=1.0)


@pytest.mark.parametrize("B", [1, 13, 300])
def test_fused_decode_kernel_matches_plain(dev, B):
    """One row per CTA, from one CTA to more than two per SM.
    float32: logits atol 1e-4 (summation order only) and identical tokens;
    bfloat16: at least 95% of tokens identical."""
    w, ck, cv = _decode_inputs(dev, B, seed=B)
    kw = dict(num_heads=4, steps=6, go_id=0, eps=1e-5)
    for dt in (torch.float32, torch.bfloat16):
        wd = fd.cast_weights(w, dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw)
        ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw)
        assert torch.isfinite(out).all()
        agree = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
            assert agree == 1.0
        else:
            assert agree >= 0.95


def test_fused_decode_dispatch_launches_kernel_on_cuda(dev):
    w, ck, cv = _decode_inputs(dev, 4, seed=0)
    before = fd.fused_greedy_decode_cuda.launches
    out = fd.fused_greedy_decode(w, ck, cv, num_heads=4, steps=6, dtype=torch.bfloat16)
    assert out.shape == (4, 6, 97) and out.device.type == "cuda"
    assert fd.fused_greedy_decode_cuda.launches == before + 1


def test_fused_decode_wrapper_refuses_bad_inputs(dev):
    w, ck, cv = _decode_inputs(dev, 4, seed=1)
    w32 = fd.cast_weights(w, torch.float32)
    kw = dict(num_heads=4, steps=6)
    with pytest.raises(ValueError):  # cross K/V of another type
        fd.fused_greedy_decode_cuda(w32, ck.bfloat16(), cv.bfloat16(), **kw)
    with pytest.raises(ValueError):  # a non-contiguous table
        fd.fused_greedy_decode_cuda(w32._replace(w_out=w32.w_out.transpose(1, 2)), ck, cv, **kw)
    with pytest.raises(ValueError):  # heads that do not divide E
        fd.fused_greedy_decode_cuda(w32, ck, cv, num_heads=5, steps=6)
    with pytest.raises(ValueError):  # more steps than positional rows
        fd.fused_greedy_decode_cuda(w32, ck, cv, num_heads=4, steps=7)


def _pruned_agreement(a, b):
    """Share of beams (rows of [..., T] token arrays) equal up to and
    including the first [s] of ``b``."""
    a, b = a.reshape(-1, a.shape[-1]).cpu().numpy(), b.reshape(-1, b.shape[-1]).cpu().numpy()
    same = 0
    for x, y in zip(a, b):
        hit = np.flatnonzero(y == EOS_ID)
        n = hit[0] + 1 if hit.size else len(y)
        same += np.array_equal(x[:n], y[:n])
    return same / len(a)


@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("K", [1, 5, 8])
@pytest.mark.parametrize("early_stop", [False, True])
def test_fused_beam_kernel_matches_plain(dev, B, K, early_stop):
    """One batch row per CTA, K beams as its tile (K=1 and 5 in the 5-beam
    build, 8 in the 8-beam one); with early stop the [s]
    logit is raised so rows stop at different steps.  float32: identical
    tokens and scores within 1e-4 (summation order only); bfloat16: at
    least 90% of the beams identical up to their first [s] (a rounding
    that lands the other way can swap two close beams) and every score
    finite.  Both: beams best first, bit-equal from run to run."""
    w, ck, cv = _decode_inputs(dev, B, seed=B + K, T=8)
    if early_stop:
        w = w._replace(head_b=w.head_b + 4.0 * (torch.arange(97, device=dev) == EOS_ID))
    kw = dict(beam_size=K, num_heads=4, steps=8, go_id=0, eos_id=EOS_ID, early_stop=early_stop)
    for dt in (torch.float32, torch.bfloat16):
        wd = fd.cast_weights(w, dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        tok, sc = fb.fused_beam_decode_cuda(wd, ckd, cvd, **kw)
        tok2, sc2 = fb.fused_beam_decode_cuda(wd, ckd, cvd, **kw)
        ref_tok, ref_sc = fb.fused_beam_decode_plain(wd, ckd, cvd, **kw)
        torch.cuda.synchronize()
        assert torch.equal(tok, tok2) and torch.equal(sc, sc2)
        assert tok.shape == (B, K, 8) and sc.shape == (B, K) and torch.isfinite(sc).all()
        assert (sc[:, 1:] <= sc[:, :-1]).all()
        if dt == torch.float32:
            assert torch.equal(tok, ref_tok)
            torch.testing.assert_close(sc, ref_sc, atol=1e-4, rtol=0)
        else:
            assert _pruned_agreement(tok, ref_tok) >= 0.9


def test_fused_beam_kernel_tie_order(dev):
    """Class b made a copy of the class a that the search picks most at
    step 0 (equal head column, bias and embedding row): the two tie exactly
    at every step, and so do the beams that differ only by them.  The kernel
    keeps the plain version's order (the lower flat index first), float32."""
    w, ck, cv = _decode_inputs(dev, 16, seed=3, T=8)
    kw = dict(beam_size=5, num_heads=4, steps=8)
    tok, _ = fb.fused_beam_decode_plain(w, ck, cv, **kw)
    a = int(torch.mode(tok[:, 0, 0]).values)
    b = a - 1 if a > 3 else a + 1  # neither [GO], [s] nor [PAD]
    head_w, head_b, emb = w.head_w.clone(), w.head_b.clone(), w.emb.clone()
    head_w[:, b], head_b[b], emb[b] = head_w[:, a], head_b[a], emb[a]
    w = w._replace(head_w=head_w, head_b=head_b, emb=emb)
    tok, sc = fb.fused_beam_decode_cuda(w, ck, cv, **kw)
    ref_tok, ref_sc = fb.fused_beam_decode_plain(w, ck, cv, **kw)
    assert torch.equal(tok, ref_tok)
    torch.testing.assert_close(sc, ref_sc, atol=1e-4, rtol=0)
    first = tok[:, :, 0].cpu().numpy()
    assert any({a, b} <= set(row) for row in first)


def test_fused_beam_dispatch_launches_kernel_on_cuda(dev):
    w, ck, cv = _decode_inputs(dev, 4, seed=0)
    before = fb.fused_beam_decode_cuda.launches
    tok, sc = fb.fused_beam_decode(w, ck, cv, beam_size=3, num_heads=4, steps=6,
                                   dtype=torch.bfloat16)
    assert tok.shape == (4, 3, 6) and tok.device.type == "cuda" and sc.shape == (4, 3)
    assert fb.fused_beam_decode_cuda.launches == before + 1


def test_fused_beam_wrapper_refuses_bad_inputs(dev):
    w, ck, cv = _decode_inputs(dev, 4, seed=1)
    w32 = fd.cast_weights(w, torch.float32)
    kw = dict(beam_size=5, num_heads=4, steps=6)
    with pytest.raises(TypeError):  # a type the kernel is not built for
        fb.fused_beam_decode_cuda(fd.cast_weights(w, torch.float16), ck.half(), cv.half(), **kw)
    with pytest.raises(ValueError):  # cross K/V of another type
        fb.fused_beam_decode_cuda(w32, ck.bfloat16(), cv.bfloat16(), **kw)
    with pytest.raises(ValueError):  # CPU tensors
        fb.fused_beam_decode_cuda(fd.cast_weights(w, torch.float32)._replace(
            w_qkv=w32.w_qkv.cpu()), ck, cv, **kw)
    with pytest.raises(ValueError):  # a non-contiguous table
        fb.fused_beam_decode_cuda(w32._replace(w_out=w32.w_out.transpose(1, 2)), ck, cv, **kw)
    with pytest.raises(ValueError):  # heads that do not divide E
        fb.fused_beam_decode_cuda(w32, ck, cv, beam_size=5, num_heads=5, steps=6)
    with pytest.raises(ValueError):  # more steps than positional rows
        fb.fused_beam_decode_cuda(w32, ck, cv, beam_size=5, num_heads=4, steps=7)
    with pytest.raises(ValueError):  # more beams than a CTA holds
        fb.fused_beam_decode_cuda(w32, ck, cv, beam_size=9, num_heads=4, steps=6)
    wide, ckw, cvw = _decode_inputs(dev, 2, seed=2, F=12288)
    with pytest.raises(ValueError, match="shared memory"):
        fb.fused_beam_decode_cuda(wide, ckw, cvw, **kw)


def test_fused_decode_early_stop_kernel_matches_plain(dev):
    """K1e: with the [s] logit raised, rows stop at different steps.  The
    kernel's logits equal the plain version's within 1e-4 (float32), its
    rows after each row's first [s] are the [s] one-hot, and its
    [s]-pruned tokens equal those of the full-length kernel; bfloat16: at
    least 95% of the rows' pruned tokens identical to the plain version's."""
    w, ck, cv = _decode_inputs(dev, 64, seed=5, T=8)
    w = w._replace(head_b=w.head_b + 2.0 * (torch.arange(97, device=dev) == EOS_ID))
    kw = dict(num_heads=4, steps=8, go_id=0)
    for dt in (torch.float32, torch.bfloat16):
        wd = fd.cast_weights(w, dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, eos_id=EOS_ID, **kw)
        full = fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw)
        ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, eos_id=EOS_ID, **kw)
        torch.cuda.synchronize()
        ids, full_ids = out.argmax(-1), full.argmax(-1)
        assert _pruned_agreement(ids, full_ids) == 1.0
        stops = [int(np.flatnonzero(r == EOS_ID)[0]) if (r == EOS_ID).any() else 7
                 for r in ids.cpu().numpy()]
        assert min(stops) < 7
        onehot = torch.nn.functional.one_hot(torch.tensor(EOS_ID), 97).float().to(dev)
        for r, n in enumerate(stops):
            assert (out[r, n + 1:] == onehot).all()
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
        else:
            assert _pruned_agreement(ids, ref.argmax(-1)) >= 0.95


def test_f32_model_is_immune_to_the_callers_tf32(dev):
    """A float32 model's served logits with TF32 turned on by the caller
    equal, within 1e-6, those of the same call with TF32 off (the model
    turns it off for itself); the caller's setting survives the call."""
    cfg = ModelConfig(enc_layers=2, dec_layers=2, ff_dim=256, hidden_dim=128,
                      embed_dim=64, num_heads=4, compute_dtype="float32", decode_fused=True)
    model = api.get_model(cfg=cfg, seed=7)
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.random((8, 32, 100, 1), dtype=np.float32)).to(dev)
    overlap = torch.zeros(8, 15, dtype=torch.long, device=dev)
    with torch.no_grad():
        off = model(image, overlap)
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            on = model(image, overlap)
            assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
    torch.testing.assert_close(on, off, atol=1e-6, rtol=0)


def _bn_inputs(dev, shape, dtype, seed):
    """Channels-last x and dy (the layout of the backbone's convs), x's
    float32 batch mean and rstd."""
    rng = np.random.default_rng(seed)
    C = shape[1]
    cl = torch.channels_last
    x = torch.from_numpy((rng.normal(size=shape) + rng.normal(size=(1, C, 1, 1)))
                         .astype(np.float32)).to(dev, dtype).contiguous(memory_format=cl)
    dy = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dev, dtype).contiguous(memory_format=cl)
    mean = x.float().mean(dim=(0, 2, 3))
    rstd = torch.rsqrt(x.float().var(dim=(0, 2, 3), unbiased=False) + 1e-5)
    return x, dy, mean, rstd


def bn_reduction_error(x, dy, mean, rstd, got):
    """max over channels of |kernel - plain| / max(1, sum of |terms|), for
    dgamma (terms dy * xhat) and dbeta (terms dy)."""
    ref = bn.bn_bwd_sums_plain(x, dy, mean, rstd)
    dyf = dy.float()
    xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
    scales = ((dyf * xhat).abs().sum(dim=(0, 2, 3)), dyf.abs().sum(dim=(0, 2, 3)))
    return max(((g - r).abs() / s.clamp(min=1.0)).max().item()
               for g, r, s in zip(got, ref, scales))


@pytest.mark.parametrize("shape", [(3, 32, 7, 11), (8, 64, 16, 50), (16, 512, 4, 26),
                                   (5, 512, 2, 27), (3, 96, 7, 11), (1, 64, 1, 1),
                                   (4, 3, 5, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_bwd_reduce_kernel_matches_plain(dev, shape, dtype):
    """C = 32, 64, 96, 512, 3: multiples of the 16-byte load and (C = 3)
    not, so both load paths run; B*H*W of 231 to 13312 rows, so the chunks
    end ragged; C = 512 float32 takes two channel groups.  Within
    1e-6 of the sum of |terms| per channel (float32 sums in another order;
    one element dropped from the smallest case would be 1e-2 off).  The
    same inputs give bit-equal sums twice (no atomics)."""
    x, dy, mean, rstd = _bn_inputs(dev, shape, dtype, seed=shape[1] + shape[3])
    got = bn.bn_bwd_sums_cuda(x, dy, mean, rstd)
    torch.cuda.synchronize()
    assert bn_reduction_error(x, dy, mean, rstd, got) <= 1e-6
    again = bn.bn_bwd_sums_cuda(x, dy, mean, rstd)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_bn_bwd_reduce_wrapper_refuses_bad_inputs(dev):
    x, dy, mean, rstd = _bn_inputs(dev, (2, 8, 4, 4), torch.float32, seed=0)
    with pytest.raises(TypeError):  # x and dy of two types
        bn.bn_bwd_sums_cuda(x, dy.bfloat16(), mean, rstd)
    with pytest.raises(TypeError):
        bn.bn_bwd_sums_cuda(x.half(), dy.half(), mean, rstd)
    with pytest.raises(ValueError):  # NCHW is not copied into channels-last
        bn.bn_bwd_sums_cuda(x.contiguous(), dy, mean, rstd)
    with pytest.raises(ValueError):
        bn.bn_bwd_sums_cuda(x, dy, mean[:4], rstd)


def test_train_step_kernels_match_plain(dev):
    """One train step of a small flagship-shaped model (float32, dropout
    0.1, the same generator seed) with the kernels and with their plain
    versions from the same weights: K3 launched once per BatchNorm (36)
    and K2 once; the loss within 1e-5 relative and the gradient norm
    within 1e-2 (the backbone's gradients at initialisation magnify
    float32 summation order, see tests/test_torch_train.py)."""
    cfg = ModelConfig(enc_layers=1, dec_layers=1, ff_dim=64, hidden_dim=64, embed_dim=32,
                      num_heads=4, compute_dtype="float32", decode_fused=True)
    rng = np.random.default_rng(0)
    text, _ = AttnCodec(cfg.chars).encode(["abc", "hello", "x1", "wxyz"])
    batch = {"image": rng.integers(0, 256, (4, 32, 100, 1), dtype=np.uint8), "text": text,
             "overlap": rng.integers(0, 100, (4, 15))}
    out = []
    for use_kernels in (True, False):
        trainer = api.get_trainer(cfg=cfg, seed=3)
        trainer.model.set_use_kernels(use_kernels)
        bn.bn_bwd_sums_cuda.launches = gs.grid_sample_cuda.launches = 0
        m = trainer(batch)
        torch.cuda.synchronize()
        out.append((m["loss"].item(), m["grad_norm"].item(),
                    bn.bn_bwd_sums_cuda.launches, gs.grid_sample_cuda.launches))
    (loss_k, norm_k, k3, k2), (loss_p, norm_p, k3_p, k2_p) = out
    assert (k3, k2, k3_p, k2_p) == (36, 1, 0, 0)
    assert np.isfinite([loss_k, norm_k]).all()
    assert loss_k == pytest.approx(loss_p, rel=1e-5)
    assert norm_k == pytest.approx(norm_p, rel=1e-2)
