"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc and skip elsewhere.  They import no JAX (one
reads crops drawn by the JAX package's renderer, which needs only numpy and
PIL), so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from multimodal_scene_text_recognition_tpu_torch import api
from multimodal_scene_text_recognition_tpu_torch.charset import AttnCodec
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig
from multimodal_scene_text_recognition_tpu_torch.charset import EOS_ID
from multimodal_scene_text_recognition_tpu_torch.models import resnet_int8 as ri
from multimodal_scene_text_recognition_tpu_torch.ops import batchnorm as bn
from multimodal_scene_text_recognition_tpu_torch.ops import fused_beam as fb
from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd
from multimodal_scene_text_recognition_tpu_torch.ops import gemm_probe as gp
from multimodal_scene_text_recognition_tpu_torch.ops import grid_sample as gs
from multimodal_scene_text_recognition_tpu_torch.ops import int8

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,H,W,Ho,Wo", [(3, 32, 100, 32, 100), (5, 7, 9, 4, 6), (2, 1, 1, 3, 3),
                                         (7, 32, 100, 5, 7), (9, 5, 6, 7, 11),
                                         (193, 32, 100, 32, 100)])
def test_grid_sample_kernel_matches_plain(dev, B, H, W, Ho, Wo):
    """atol 1e-5 (float32, the same taps; only FMA contraction differs),
    on grids with integer coordinates, the far edges and points far outside
    [-1, 1]; (2, 1, 1) is the degenerate one-pixel image.  Odd B, Ho*Wo not
    a multiple of 4 (a pixel a thread) and H*W not a multiple of 4 (the
    image staged without the bulk copy) each run."""
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


# (E, H, F): the small widths, and the flagship's (L cut to 2)
DECODE_WIDTHS = {"small": (64, 4, 128), "flagship": (256, 8, 2048)}


@pytest.mark.parametrize("B", [1, 13, 192, 300])
@pytest.mark.parametrize("widths", sorted(DECODE_WIDTHS))
@pytest.mark.parametrize("cls0", [False, True])
@pytest.mark.parametrize("early_stop", [False, True])
def test_fused_decode_kernel_matches_plain(dev, B, widths, cls0, early_stop):
    """K1's cluster kernel, from one ragged row tile (B=1, 13) to tiles in
    waves (B=300 at 16 rows), at the small widths (a cluster of 4 CTAs)
    and the flagship's (8), with and without a random cls0 row and early
    stop.  float32: logits atol 1e-4 (summation order only) and identical
    tokens; bfloat16: at least 95% of tokens identical."""
    E, H, F = DECODE_WIDTHS[widths]
    w, ck, cv = _decode_inputs(dev, B, seed=B, E=E, F=F)
    if early_stop:  # the [s] logit raised, so rows stop at different steps
        w = w._replace(head_b=w.head_b + 2.0 * (torch.arange(97, device=dev) == EOS_ID))
    c0 = torch.from_numpy(np.random.default_rng(B).standard_normal((B, E)).astype(np.float32))
    kw = dict(num_heads=H, steps=6, go_id=0, eps=1e-5, eos_id=EOS_ID if early_stop else None,
              cls0=c0.to(dev) if cls0 else None)
    for dt in (torch.float32, torch.bfloat16):
        wd = fd.cast_weights(w, dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        packed = fd.pack_cluster_tables(wd, H)
        out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, packed=packed, **kw)
        ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw)
        assert torch.isfinite(out).all()
        agree = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
            assert agree == 1.0
        else:
            assert agree >= 0.95


def test_fused_decode_kernel_is_deterministic(dev):
    """Two launches on the same input give bit-identical logits: the G
    copies of the residual stream sum the partials in one order, with no
    atomics."""
    E, H, F = DECODE_WIDTHS["flagship"]
    w, ck, cv = _decode_inputs(dev, 192, seed=3, E=E, F=F)
    dt = torch.bfloat16
    wd = fd.cast_weights(w, dt)
    ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
    packed = fd.pack_cluster_tables(wd, H)
    kw = dict(num_heads=H, steps=6, packed=packed)
    first = fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw)
    again = fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw)
    assert torch.equal(first, again)


@pytest.mark.parametrize("E,H,F,why", [(48, 4, 128, None), (256, 16, 2048, None),
                                        (64, 4, 96, None), (40, 4, 128, None), (42, 3, 100, None),
                                        (1024, 8, 2048, "exceeds")])
def test_fused_decode_kernel_refuses_shapes_it_cannot_tile(dev, E, H, F, why):
    """Head slices 12 wide (padded to 16), sixteen heads (two a CTA of a
    cluster of 8), FF slices 24 wide (padded to 32) and rows 40 and 42
    wide (padded to 48; three heads of 14 in a cluster of 3) run, held to
    the plain version as the flagship is (float32: every token and logits
    within 1e-4; bfloat16: at least 99% of tokens identical), with and
    without early stop; a width the kernel cannot tile (rows wider than
    512) is a ValueError, never another kernel or the plain version."""
    w, ck, cv = _decode_inputs(dev, 24, seed=E + H + F, E=E, F=F)
    if why is not None:
        before = fd.fused_greedy_decode_cuda.launches
        with pytest.raises(ValueError, match=why):
            fd.fused_greedy_decode_cuda(fd.cast_weights(w, torch.bfloat16), ck.bfloat16(),
                                        cv.bfloat16(), num_heads=H, steps=6)
        assert fd.fused_greedy_decode_cuda.launches == before
        return
    for eos_id in (None, EOS_ID):
        kw = dict(num_heads=H, steps=6, go_id=0, eps=1e-5, eos_id=eos_id)
        for dt in (torch.float32, torch.bfloat16):
            wd = fd.cast_weights(w, dt)
            ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
            before = fd.fused_greedy_decode_cuda.launches
            out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, packed=fd.pack_cluster_tables(wd, H),
                                              **kw)
            ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw)
            assert fd.fused_greedy_decode_cuda.launches == before + 1
            assert torch.isfinite(out).all()
            agree = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
            if dt == torch.float32:
                torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
                assert agree == 1.0
            else:
                assert agree >= 0.99


def test_fused_decode_dispatch_launches_kernel_on_cuda(dev):
    w, ck, cv = _decode_inputs(dev, 4, seed=0)
    before = fd.fused_greedy_decode_cuda.launches
    units = lambda dt: fd.pack_cluster_tables(fd.cast_weights(w, dt), 4)  # noqa: E731
    out = fd.fused_greedy_decode(w, ck, cv, num_heads=4, steps=6, dtype=torch.bfloat16,
                                 units=units)
    assert out.shape == (4, 6, 97) and out.device.type == "cuda"
    assert fd.fused_greedy_decode_cuda.launches == before + 1
    with pytest.raises(ValueError, match="packed"):  # K1 never packs the tables itself
        fd.fused_greedy_decode(w, ck, cv, num_heads=4, steps=6, dtype=torch.bfloat16)
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
    with pytest.raises(ValueError, match="packed"):  # no packed tables
        fd.fused_greedy_decode_cuda(w32, ck, cv, **kw)
    with pytest.raises(ValueError, match="packed"):  # the bf16 tables' units
        fd.fused_greedy_decode_cuda(w32, ck, cv, packed=fd.pack_cluster_tables(
            fd.cast_weights(w, torch.bfloat16), 4), **kw)


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


@pytest.mark.parametrize("B", [1, 7, 13, 64, 300])
@pytest.mark.parametrize("K", [1, 5, 8])
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("cls0", [False, True])
def test_fused_beam_kernel_matches_plain(dev, B, K, early_stop, cls0):
    """The grid kernel from one ragged row tile (B=1, 7, 13) to tiles in
    waves (B=300 at K=8: 38 tiles of 64 beam rows a phase), at K=1, 5 and
    8, with a random cls0 row or the [GO] embedding; with early stop the
    [s] logit is raised so rows stop at different steps.  float32:
    identical tokens and scores within 1e-4 (summation order only);
    bfloat16: at least 90% of the beams identical up to their first [s]
    (a rounding that lands the other way can swap two close beams) and
    every score finite.  Both: beams best first, bit-equal from run to
    run."""
    w, ck, cv = _decode_inputs(dev, B, seed=B + K, T=8)
    if early_stop:
        w = w._replace(head_b=w.head_b + 4.0 * (torch.arange(97, device=dev) == EOS_ID))
    kw = dict(beam_size=K, num_heads=4, steps=8, go_id=0, eos_id=EOS_ID, early_stop=early_stop,
              cls0=_cls0(dev, B, seed=B * K) if cls0 else None)
    for dt in (torch.float32, torch.bfloat16):
        wd = fd.cast_weights(w, dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        before = fb.fused_beam_decode_cuda.launches
        tok, sc = fb.fused_beam_decode_cuda(wd, ckd, cvd, **kw)
        tok2, sc2 = fb.fused_beam_decode_cuda(wd, ckd, cvd, **kw)
        ref_tok, ref_sc = fb.fused_beam_decode_plain(wd, ckd, cvd, **kw)
        torch.cuda.synchronize()
        assert fb.fused_beam_decode_cuda.launches == before + 2
        assert torch.equal(tok, tok2) and torch.equal(sc, sc2)
        assert tok.shape == (B, K, 8) and sc.shape == (B, K) and torch.isfinite(sc).all()
        assert (sc[:, 1:] <= sc[:, :-1]).all()
        if dt == torch.float32:
            assert torch.equal(tok, ref_tok)
            torch.testing.assert_close(sc, ref_sc, atol=1e-4, rtol=0)
        else:
            assert _pruned_agreement(tok, ref_tok) >= 0.9


# (B, K, E, H, F, C, steps, Tm): widths the CUDA-core K4 served, at which a
# first layout of the grid kernel refused or cut its plan: class counts
# past 2,478 at K=5 (the top-K tile beside the product's rings), 1,500 at
# K=8 and 20,000 at K=1; a head of 512 columns (the attention's queries
# and one position of keys at a time, rows in groups in float32, the
# layernorm's rows staged a chunk at a time); 300 steps (positions staged
# in chunks); 15,000 beam rows (column tiles of 256 in float32, 128 in
# bf16, cut to what fits beside the rings; float32 stages the layernorm's
# rows a chunk at a time)
BEAM_WIDE = {"C=3000,K=5": (16, 5, 64, 4, 128, 3000, 8, 8),
             "C=1500,K=8": (8, 8, 64, 4, 128, 1500, 8, 8),
             "C=20000,K=1": (4, 1, 64, 4, 128, 20000, 8, 8),
             "hd=512": (16, 5, 512, 1, 256, 97, 8, 8),
             "T=300": (2, 5, 64, 4, 128, 97, 300, 26),
             "B=3000": (3000, 5, 256, 8, 256, 97, 8, 8)}


@pytest.mark.parametrize("case", sorted(BEAM_WIDE))
def test_fused_beam_kernel_serves_the_cuda_core_kernels_widths(dev, case):
    """The grid kernel at widths the CUDA-core K4 served (BEAM_WIDE): its
    plan fits, and it agrees with the plain version as in
    test_fused_beam_kernel_matches_plain: float32 identical tokens and
    scores within 1e-4, bfloat16 at least 90% of the beams identical up to
    their first [s]; bit-equal from run to run."""
    B, K, E, H, F, C, T, Tm = BEAM_WIDE[case]
    w, ck, cv = _decode_inputs(dev, B, seed=C + E + T, E=E, F=F, C=C, T=T, Tm=Tm)
    kw = dict(beam_size=K, num_heads=H, steps=T, go_id=0, eos_id=EOS_ID, early_stop=False)
    for dt in (torch.float32, torch.bfloat16):
        wd = fd.cast_weights(w, dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        tok, sc = fb.fused_beam_decode_cuda(wd, ckd, cvd, **kw)
        tok2, sc2 = fb.fused_beam_decode_cuda(wd, ckd, cvd, **kw)
        ref_tok, ref_sc = fb.fused_beam_decode_plain(wd, ckd, cvd, **kw)
        assert torch.equal(tok, tok2) and torch.equal(sc, sc2)
        assert tok.shape == (B, K, T) and torch.isfinite(sc).all()
        if dt == torch.float32:
            assert torch.equal(tok, ref_tok)
            torch.testing.assert_close(sc, ref_sc, atol=1e-4, rtol=0)
        else:
            assert _pruned_agreement(tok, ref_tok) >= 0.9


def test_fused_beam_kernel_profile_and_barrier_floor(dev):
    """``profile=`` counts cycles in every phase, barrier and part of the
    grid kernel at the flagship's widths (L cut to 2) without changing its
    result; the barrier-only launch runs and raises for a grid that cannot
    be resident."""
    w, ck, cv = _decode_inputs(dev, 192, seed=5, E=256, F=2048, T=8)
    wd = fd.cast_weights(w, torch.bfloat16)
    ckd, cvd = ck.bfloat16(), cv.bfloat16()
    kw = dict(beam_size=5, num_heads=8, steps=8, early_stop=True)
    prof = torch.zeros(fb.PROFILE_SLOTS, dtype=torch.int64, device=dev)
    tok, sc = fb.fused_beam_decode_cuda(wd, ckd, cvd, profile=prof, **kw)
    ref_tok, ref_sc = fb.fused_beam_decode_cuda(wd, ckd, cvd, **kw)
    assert torch.equal(tok, ref_tok) and torch.equal(sc, ref_sc)
    assert (prof > 0).all()
    with pytest.raises(ValueError, match="profile"):
        fb.fused_beam_decode_cuda(wd, ckd, cvd, profile=prof[:3], **kw)
    fb.barrier_floor_cuda(37, dev)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="launch failed"):
        fb.barrier_floor_cuda(1, dev, ctas=1 << 20)


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
    with pytest.raises(ValueError):  # more beams than the kernel serves
        fb.fused_beam_decode_cuda(w32, ck, cv, beam_size=9, num_heads=4, steps=6)
    # 20000 classes: one batch row's top-K tile (5 x 20000 logits) does not
    # fit a CTA's shared memory
    wide, ckw, cvw = _decode_inputs(dev, 2, seed=2, C=20000)
    before = fb.fused_beam_decode_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        fb.fused_beam_decode_cuda(wide, ckw, cvw, **kw)
    assert fb.fused_beam_decode_cuda.launches == before


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
        packed = fd.pack_cluster_tables(wd, 4)
        out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, eos_id=EOS_ID, packed=packed, **kw)
        full = fd.fused_greedy_decode_cuda(wd, ckd, cvd, packed=packed, **kw)
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
    """Channels-last x and dy (the layout of the backbone's convs), each
    with a per-channel offset, x's float32 batch mean and rstd, and a
    weight."""
    rng = np.random.default_rng(seed)
    C = shape[1]
    cl = torch.channels_last

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype).contiguous(memory_format=cl)

    x = t(rng.normal(size=shape) + rng.normal(size=(1, C, 1, 1)))
    dy = t(rng.normal(size=shape) + rng.normal(size=(1, C, 1, 1)))
    mean = x.float().mean(dim=(0, 2, 3))
    rstd = torch.rsqrt(x.float().var(dim=(0, 2, 3), unbiased=False) + 1e-5)
    weight = torch.from_numpy((1.0 + 0.1 * rng.normal(size=C)).astype(np.float32)).to(dev)
    return x, dy, mean, rstd, weight


def bn_reduction_error(x, dy, mean, rstd, got):
    """max over channels of |kernel - plain| / max(1, sum of |terms|), for
    dgamma (terms dy * xhat) and dbeta (terms dy)."""
    ref = bn.bn_bwd_sums_plain(x, dy, mean, rstd)
    dyf = dy.float()
    xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
    scales = ((dyf * xhat).abs().sum(dim=(0, 2, 3)), dyf.abs().sum(dim=(0, 2, 3)))
    return max(((g - r).abs() / s.clamp(min=1.0)).max().item()
               for g, r, s in zip(got, ref, scales))


def bn_dx_ok(got, ref) -> bool:
    """dx against the plain version's: float32 within 1e-5 of its scale
    (max |dx|); bfloat16 within one bf16 step of the plain value, or that
    1e-5 of the scale where the step is smaller (near 0).  The sums differ
    in the last float32 bits (another order), which moves dx's float32
    value by ~1e-7 of the terms and its bf16 rounding by at most a step."""
    err = (got.float() - ref.float()).abs()
    floor = 1e-5 * ref.float().abs().max().item()
    if got.dtype == torch.float32:
        return err.max().item() <= floor
    _, e = torch.frexp(ref.float())
    step = torch.where(ref == 0, 0.0, torch.ldexp(torch.ones_like(err), e - 8))
    return bool((err <= torch.clamp(step, min=floor)).all())


@pytest.mark.parametrize("shape", [(3, 32, 7, 11), (8, 64, 16, 50), (16, 512, 4, 26),
                                   (5, 512, 2, 27), (3, 96, 7, 11), (1, 64, 1, 1),
                                   (4, 3, 5, 9), (192, 512, 4, 26), (48, 64, 32, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_bwd_reduce_kernel_matches_plain(dev, shape, dtype):
    """The whole backward kernel against ``bn_bwd_plain``.  C = 32, 64, 96,
    512, 3: multiples of the 16-byte load and (C = 3) not, so both paths
    run; B*H*W of 1 to 153600 rows, so the spans end ragged, and at [192,
    512, 4, 26] and [48, 64, 32, 100] more rows a thread than its ring keeps
    (38 and 35 in bf16), so pass 2 reads rows again.  dgamma and dbeta within 1e-6 of the sum of
    |terms| per channel (float32 sums in another order; one element dropped
    from the smallest case would be 1e-2 off); dx as ``bn_dx_ok``.  The
    same inputs give bit-equal results twice (no atomics); dx keeps x's
    type and channels-last layout."""
    x, dy, mean, rstd, w = _bn_inputs(dev, shape, dtype, seed=shape[1] + shape[3])
    dx, dg, db = bn.bn_bwd_cuda(x, dy, mean, rstd, w)
    torch.cuda.synchronize()
    ref = bn.bn_bwd_plain(x, dy, mean, rstd, w)
    assert dx.dtype == dtype and dx.is_contiguous(memory_format=torch.channels_last)
    assert bn_reduction_error(x, dy, mean, rstd, (dg, db)) <= 1e-6
    assert bn_dx_ok(dx, ref[0])
    again = bn.bn_bwd_cuda(x, dy, mean, rstd, w)
    assert all(torch.equal(a, b) for a, b in zip((dx, dg, db), again))


@pytest.mark.parametrize("shape", [(3, 32, 7, 11), (16, 512, 4, 26), (4, 3, 5, 9),
                                   (48, 64, 32, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_bwd_two_pass_kernels_match_plain(dev, shape, dtype):
    """The two-pass mode against its plain versions: pass 1's sums
    bit-equal to the one-launch kernel's, then pass 2 from sums and a row
    count that another process's half adds to (other inputs), dx as
    ``bn_dx_ok`` against ``bn_bwd_dx_plain`` on the same sums, in x's type
    and channels-last; the 16-byte path and (C = 3) the scalar one."""
    x, dy, mean, rstd, w = _bn_inputs(dev, shape, dtype, seed=shape[1] + 7)
    x2, dy2 = _bn_inputs(dev, shape, dtype, seed=shape[1] + 8)[:2]
    g, b = bn.bn_bwd_sums_cuda(x, dy, mean, rstd)
    _, og, ob = bn.bn_bwd_cuda(x, dy, mean, rstd, w)
    assert torch.equal(g, og) and torch.equal(b, ob)
    g2, b2 = bn.bn_bwd_sums_plain(x2, dy2, mean, rstd)
    n = 2 * x.numel() // shape[1]
    dx = bn.bn_bwd_dx_cuda(x, dy, mean, rstd, w, g + g2, b + b2, n)
    torch.cuda.synchronize()
    ref = bn.bn_bwd_dx_plain(x, dy, mean, rstd, w, g + g2, b + b2, n)
    assert dx.dtype == dtype and dx.is_contiguous(memory_format=torch.channels_last)
    assert bn_dx_ok(dx, ref)


def test_bn_bwd_reduce_wrapper_refuses_bad_inputs(dev):
    x, dy, mean, rstd, w = _bn_inputs(dev, (2, 8, 4, 4), torch.float32, seed=0)
    with pytest.raises(TypeError):  # x and dy of two types
        bn.bn_bwd_cuda(x, dy.bfloat16(), mean, rstd, w)
    with pytest.raises(TypeError):
        bn.bn_bwd_cuda(x.half(), dy.half(), mean, rstd, w)
    with pytest.raises(ValueError):  # NCHW is not copied into channels-last
        bn.bn_bwd_cuda(x.contiguous(), dy, mean, rstd, w)
    with pytest.raises(ValueError):
        bn.bn_bwd_cuda(x, dy.contiguous(), mean, rstd, w)
    with pytest.raises(ValueError):
        bn.bn_bwd_cuda(x, dy, mean[:4], rstd, w)
    with pytest.raises(ValueError):
        bn.bn_bwd_cuda(x, dy, mean, rstd, w.double())
    with pytest.raises(ValueError):  # one device
        bn.bn_bwd_cuda(x, dy, mean, rstd, w.cpu())


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
        bn.bn_bwd_cuda.launches = gs.grid_sample_cuda.launches = 0
        m = trainer(batch)
        torch.cuda.synchronize()
        out.append((m["loss"].item(), m["grad_norm"].item(),
                    bn.bn_bwd_cuda.launches, gs.grid_sample_cuda.launches))
    (loss_k, norm_k, k3, k2), (loss_p, norm_p, k3_p, k2_p) = out
    assert (k3, k2, k3_p, k2_p) == (36, 1, 0, 0)
    assert np.isfinite([loss_k, norm_k]).all()
    assert loss_k == pytest.approx(loss_p, rel=1e-5)
    assert norm_k == pytest.approx(norm_p, rel=1e-2)


# -- int8 serving: K1q and the int8 products --------------------------------


def _int8_inputs(dev, B, seed, T=8, eos_bias=0.0):
    """Seeded decode inputs with the [s] logit raised by ``eos_bias``,
    quantized: (int8 tables, scales, cross K, cross V) on ``dev``."""
    w, ck, cv = _decode_inputs(dev, B, seed, T=T)
    w = w._replace(head_b=w.head_b + eos_bias * (torch.arange(97, device=dev) == EOS_ID))
    wq, scales = fd.quantize_fused_weights(w)
    return wq, scales, ck, cv


def _check_int8_against_plain(dev, wq, scales, ck, cv, H, kw, kernel="cluster", rows=0.95,
                              tol=0.2, f32_rows=1.0):
    """K1q (through the route ``kernel`` its plan picks) against its plain
    version in float32 and bfloat16, at the limits of
    test_fused_decode_int8_kernel_matches_plain (``f32_rows`` of the
    float32 token rows identical up to their first [s]; ``rows`` of the
    float32 logit rows within 1e-4, all within ``tol``, on a row whose
    tokens differ up to and at its first differing token); two launches
    bit-equal."""
    L, B, Tm, E = ck.shape
    for dt in (torch.float32, torch.bfloat16):
        wd = fd.cast_weights(wq, dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        route = fd.k1q_route(B, L, E, H, wd.ff1_w.shape[2], 97, kw["steps"], Tm, dt)
        assert route.kernel == kernel
        packed = fd.pack_cluster_tables_int8(wd, H) if kernel == "cluster" else None
        counts = lambda: (fd.fused_greedy_decode_cuda.launches_int8,  # noqa: E731
                          fd.fused_greedy_decode_cuda.launches_int8_wide)
        before = counts()
        out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, scales=scales, packed=packed, **kw)
        again = fd.fused_greedy_decode_cuda(wd, ckd, cvd, scales=scales, packed=packed, **kw)
        ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, scales=scales, **kw)
        torch.cuda.synchronize()
        assert counts() == ((before[0] + 2, before[1]) if kernel == "cluster"
                            else (before[0], before[1] + 2))
        assert torch.isfinite(out).all() and torch.equal(out, again)
        ids = out.argmax(-1)
        if kw.get("eos_id") is not None:
            onehot = torch.nn.functional.one_hot(torch.tensor(EOS_ID), 97).float().to(dev)
            for r, row in enumerate(ids.cpu().numpy()):
                hit = np.flatnonzero(row == EOS_ID)
                if hit.size:
                    assert (out[r, hit[0] + 1:] == onehot).all()
        if dt == torch.float32:
            ref_ids = ref.argmax(-1)
            assert _pruned_agreement(ids, ref_ids) >= f32_rows
            diff = ids != ref_ids
            is_eos = ref_ids == EOS_ID
            n = torch.where(is_eos.any(-1), is_eos.int().argmax(-1) + 1, ids.shape[-1])
            kept = torch.arange(ids.shape[-1], device=dev)[None] < n[:, None]
            same = (~diff | ~kept).all(-1)
            # past a row's first differing token the rows decode other prefixes
            held = same[:, None] | ((diff.int().cumsum(-1) - diff.int()) == 0)
            row_err = (out - ref).abs().amax(-1)[held]
            assert (row_err <= 1e-4).float().mean().item() >= rows
            assert row_err.max().item() <= tol
        else:
            assert _pruned_agreement(ids, ref.argmax(-1)) >= 0.9


@pytest.mark.parametrize("B", [1, 7, 13, 64, 97, 192, 300])
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("cls0", [False, True])
def test_fused_decode_int8_kernel_matches_plain(dev, B, early_stop, cls0):
    """K1q against its plain version, on the wide-row kernel (one row a
    CTA) for B up to K1Q_WIDE_BATCH and on the cluster kernel beyond, its
    last row tile ragged (one row at B=97, twelve at B=300), with and
    without a random cls0 row, the [s] logit raised with early stop so rows
    stop at different steps.  The int8 products are exact in both; the attention and
    layernorms sum in other orders, and a difference that moves an
    activation across a rounding boundary of its int8 step moves a
    projection by one step.  float32: the rows' tokens identical up to
    their first [s], at least 95% of the (row, step) logit rows within 1e-4
    and all within 0.2 (one such step moved a row by 0.089 at B=64 on an
    H100); bfloat16: at least 90% of the rows' tokens identical up to their
    first [s].  Both: bit-equal from run to run, rows after a row's first
    [s] the [s] one-hot."""
    wq, scales, ck, cv = _int8_inputs(dev, B, seed=40 + B, eos_bias=3.0 if early_stop else 0.0)
    c0 = _cls0(dev, B, seed=41 + B) if cls0 else None
    kw = dict(num_heads=4, steps=8, go_id=0, eos_id=EOS_ID if early_stop else None, cls0=c0)
    _check_int8_against_plain(dev, wq, scales, ck, cv, 4, kw,
                              kernel="cluster" if B > fd.K1Q_WIDE_BATCH else "wide")


def test_fused_decode_int8_kernel_is_deterministic(dev):
    """Two launches of K1q at the flagship's widths (L cut to 2) give
    bit-identical logits: the G copies of the rows take one abs-max and
    sum exact int32 partials."""
    w, ck, cv = _decode_inputs(dev, 192, seed=5, E=256, F=2048)
    wq, scales = fd.quantize_fused_weights(w)
    wd = fd.cast_weights(wq, torch.bfloat16)
    ckd, cvd = ck.bfloat16(), cv.bfloat16()
    kw = dict(num_heads=8, steps=6, scales=scales, packed=fd.pack_cluster_tables_int8(wd, 8))
    first = fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw)
    again = fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw)
    assert torch.equal(first, again)


# (E, H, F, route): K1q at widths its units pad to the k-step of 32 (heads
# of 12 and 10, sixteen heads two a CTA, FF slices of 24, rows of 36 in a
# cluster of one), and rows wider than the cluster kernel's exchange holds
# (E=640), which the plan sends to the wide-row kernel
K1Q_WIDTHS = ((48, 4, 128, "cluster"), (256, 16, 2048, "cluster"), (64, 4, 96, "cluster"),
              (40, 4, 128, "cluster"), (36, 3, 100, "cluster"), (640, 8, 1024, "wide"))


@pytest.mark.parametrize("E,H,F,route", K1Q_WIDTHS)
@pytest.mark.parametrize("early_stop", [False, True])
def test_fused_decode_int8_kernel_serves_every_width(dev, E, H, F, route, early_stop):
    """K1q at K1Q_WIDTHS (seeded random tables, L=2, B=100, the batch of
    chip_smoke.py's K1Q_WIDTHS check) against its plain version through the
    route k1q_route picks from the shapes, at the limits of
    test_fused_decode_int8_kernel_matches_plain, but for rows of 256 and
    more: 99% of the float32 token rows identical (one of 100 may take the
    other token at a near tie), 85% of the float32 logit rows within 1e-4
    and all within 1.0, a differing row's up to and at its first differing
    token.  Both products are exact; a float32 sum of another order moves an
    activation across a rounding boundary of its int8 step now and then,
    which moves every later logit of its row, and a row quantizes L(5E + F)
    values a step: ~1.4k at E=64, ~6.6k at E=256 with F=2048, ~8.5k at
    E=640.  On an H100: E=256 with sixteen heads (cluster kernel) 0.334 off;
    E=640 (one row a CTA; at B=24) 0.903-0.917 of the rows within 1e-4 and
    rows 0.399 and 0.555 off, every token equal; in chip_smoke.py at B=100,
    0.578 off up to the first differing token, and one row of 100 took the
    other token at step 1, where the plain version's top two were 0.054
    apart."""
    B = fd.K1Q_WIDE_BATCH + 4
    w, ck, cv = _decode_inputs(dev, B, seed=E + H + F, E=E, F=F)
    if early_stop:
        w = w._replace(head_b=w.head_b + 3.0 * (torch.arange(97, device=dev) == EOS_ID))
    wq, scales = fd.quantize_fused_weights(w)
    kw = dict(num_heads=H, steps=6, go_id=0, eos_id=EOS_ID if early_stop else None)
    limits = dict(rows=0.85, tol=1.0, f32_rows=0.99) if E >= 256 else {}
    _check_int8_against_plain(dev, wq, scales, ck, cv, H, kw, kernel=route, **limits)


def test_fused_decode_int8_profile(dev):
    """K1q's profile counts cycles in each of its phases, the three
    abs-max exchanges included."""
    wq, scales, ck, cv = _int8_inputs(dev, fd.K1Q_WIDE_BATCH + 4, seed=6)
    wd = fd.cast_weights(wq, torch.bfloat16)
    prof = torch.zeros(len(fd.INT8_CLUSTER_PHASES), dtype=torch.int64, device=dev)
    fd.fused_greedy_decode_cuda(wd, ck.bfloat16(), cv.bfloat16(), num_heads=4, steps=8,
                                scales=scales, packed=fd.pack_cluster_tables_int8(wd, 4),
                                profile=prof)
    assert (prof > 0).all()


def test_fused_decode_int8_dispatch_launches_kernel_on_cuda(dev):
    """fused_greedy_decode with scales on CUDA tensors launches K1q on the
    cluster kernel with the caller's int8 units (and not K1); without
    scales K1 (and not K1q); it never packs the units itself; a batch of
    at most K1Q_WIDE_BATCH rows takes the wide-row kernel, asking for no
    units."""
    B = fd.K1Q_WIDE_BATCH + 4
    wq, scales, ck, cv = _int8_inputs(dev, B, seed=0, T=6)
    w, _, _ = _decode_inputs(dev, B, seed=0, T=6)

    def units(dt, int8=False):
        if int8:
            return fd.pack_cluster_tables_int8(fd.cast_weights(wq, dt), 4)
        return fd.pack_cluster_tables(fd.cast_weights(w, dt), 4)

    count = lambda: (fd.fused_greedy_decode_cuda.launches,  # noqa: E731
                     fd.fused_greedy_decode_cuda.launches_int8)
    before = count()
    out = fd.fused_greedy_decode(wq, ck, cv, num_heads=4, steps=6, dtype=torch.bfloat16,
                                 scales=scales, units=units)
    assert out.shape == (B, 6, 97) and out.device.type == "cuda"
    assert count() == (before[0], before[1] + 1)
    fd.fused_greedy_decode(w, ck, cv, num_heads=4, steps=6, dtype=torch.bfloat16, units=units)
    assert count() == (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="packed"):  # K1q never packs the units itself
        fd.fused_greedy_decode(wq, ck, cv, num_heads=4, steps=6, dtype=torch.bfloat16,
                               scales=scales)
    assert count() == (before[0] + 1, before[1] + 1)
    wide = fd.fused_greedy_decode_cuda.launches_int8_wide

    def refuse(dt, int8=False):
        raise AssertionError("units asked for the wide-row kernel")

    fd.fused_greedy_decode(wq, ck[:, :4], cv[:, :4], num_heads=4, steps=6, dtype=torch.bfloat16,
                           scales=scales, units=refuse)
    assert fd.fused_greedy_decode_cuda.launches_int8_wide == wide + 1


def test_fused_decode_int8_wrapper_refuses_bad_inputs(dev):
    wq, scales, ck, cv = _int8_inputs(dev, 4, seed=1, T=6)
    w32 = fd.cast_weights(wq, torch.float32)
    kw = dict(num_heads=4, steps=6)
    with pytest.raises(ValueError):  # int8 tables without scales (K1 takes float tables)
        fd.fused_greedy_decode_cuda(w32, ck, cv, **kw)
    with pytest.raises(ValueError):  # the beam kernel has no int8 mode
        fb.fused_beam_decode_cuda(w32, ck, cv, beam_size=2, **kw)
    with pytest.raises(ValueError):  # a float table where an int8 one belongs
        fd.fused_greedy_decode_cuda(w32._replace(w_out=w32.w_out.float()), ck, cv,
                                    scales=scales, **kw)
    with pytest.raises(ValueError):  # scales of another type
        fd.fused_greedy_decode_cuda(w32, ck, cv, scales=scales._replace(
            s_ff1=scales.s_ff1.half()), **kw)
    with pytest.raises(ValueError):  # scales of another shape
        fd.fused_greedy_decode_cuda(w32, ck, cv, scales=scales._replace(
            s_qkv=scales.s_qkv[:, :64].contiguous()), **kw)
    with pytest.raises(ValueError):  # scales on the CPU
        fd.fused_greedy_decode_cuda(w32, ck, cv, scales=scales._replace(
            s_out=scales.s_out.cpu()), **kw)
    with pytest.raises(TypeError):  # a compute type the kernel is not built for
        fd.fused_greedy_decode_cuda(fd.cast_weights(wq, torch.float16), ck.half(), cv.half(),
                                    scales=scales, **kw)
    with pytest.raises(ValueError, match="multiples of 4"):  # a table not in K1q's layout
        fd.fused_greedy_decode_cuda(w32._replace(
            w_out=fd.unpack_int8_table(w32.w_out).contiguous()), ck, cv, scales=scales, **kw)
    with pytest.raises(ValueError, match="multiples of 4"):  # F = 126 has no such layout
        fd.quantize_fused_weights(_decode_inputs(dev, 2, seed=2, F=126, T=6)[0])
    # the cluster kernel's units and profile (a batch past K1Q_WIDE_BATCH)
    _, _, ck_c, cv_c = _int8_inputs(dev, fd.K1Q_WIDE_BATCH + 4, seed=1, T=6)
    packed = fd.pack_cluster_tables_int8(w32, 4)
    prof = lambda n: torch.zeros(n, dtype=torch.int64, device=dev)  # noqa: E731
    with pytest.raises(ValueError, match="packed"):  # no units
        fd.fused_greedy_decode_cuda(w32, ck_c, cv_c, scales=scales, **kw)
    with pytest.raises(ValueError, match="packed"):  # K1's units
        fd.fused_greedy_decode_cuda(w32, ck_c, cv_c, scales=scales, packed=fd.pack_cluster_tables(
            _decode_inputs(dev, 4, seed=1, T=6)[0], 4), **kw)
    with pytest.raises(ValueError, match="packed"):  # the bf16 head's units
        fd.fused_greedy_decode_cuda(w32, ck_c, cv_c, scales=scales,
                                    packed=fd.pack_cluster_tables_int8(
                                        fd.cast_weights(wq, torch.bfloat16), 4), **kw)
    with pytest.raises(ValueError, match="profile"):  # K1's profile
        fd.fused_greedy_decode_cuda(w32, ck_c, cv_c, scales=scales, packed=packed,
                                    profile=prof(len(fd.CLUSTER_PHASES)), **kw)
    with pytest.raises(ValueError, match="profile"):  # the wide-row kernel keeps none
        fd.fused_greedy_decode_cuda(w32, ck, cv, scales=scales,
                                    profile=prof(len(fd.INT8_CLUSTER_PHASES)), **kw)
    _, _, ck_w, cv_w = _int8_inputs(dev, 2, seed=2, T=6)
    big = fd.quantize_fused_weights(_decode_inputs(dev, 2, seed=2, F=49152, T=6)[0])
    with pytest.raises(ValueError, match="shared memory"):
        fd.fused_greedy_decode_cuda(big[0], ck_w, cv_w, scales=big[1], **kw)


@pytest.mark.parametrize("M,K,N", [(26, 64, 40), (5, 9, 12), (4096, 4608, 512)])
def test_int_mm_route_is_exact(dev, M, K, N):
    """int_mm on the card (torch._int_mm, with M, K and N padded where it
    refuses them) equals the exact float64 product: M = 26 (an encoder
    row), K = 9 (a single-channel 3x3 conv), and the widest conv's K."""
    rng = np.random.default_rng(M + K)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    a[0], b[:, 0] = 127, -127  # the largest magnitudes
    got = int8.int_mm(a.to(dev), b.to(dev))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.cpu(), (a.double() @ b.double()).to(torch.int32))


def test_int8_linear_and_conv_routes_equal_the_cpu(dev):
    """int8_linear, and the int8 conv of a single-channel 3x3 site (K = 9)
    and of a strided 2x2 one, give on the card exactly what the CPU's
    float64 route gives."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 26, 64)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 40)) / 8).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    got = int8.int8_linear(x.to(dev), w.to(dev), b.to(dev))
    assert torch.equal(got.cpu(), int8.int8_linear(x, w, b))
    for (ci, co, kh, kw), stride, pad in (((1, 32, 3, 3), (1, 1), (1, 1)),
                                          ((16, 24, 2, 2), (2, 1), (0, 1))):
        kf = rng.standard_normal((co, ci, kh, kw)).astype(np.float32)
        q = ri._quantize_folded({"s": (kf, np.zeros(co, np.float32))}, {"s": 1.0},
                                torch.device("cpu"))["s"]
        hq = torch.from_numpy(rng.integers(-127, 128, (3, 8, 13, ci), dtype=np.int8))
        want = ri.conv_int8(hq, q, stride, pad)
        q_dev = ri.QConv(*(t.to(dev) for t in q))
        assert torch.equal(ri.conv_int8(hq.to(dev), q_dev, stride, pad).cpu(), want)


def test_int8_backbone_on_the_card_equals_the_cpu(dev):
    """The int8 ResNet-31 (output channels 64, one block a stage) with the
    same scales: bit-equal on the card and on the CPU (exact int32
    products, the same float32 elementwise steps, bf16 between sites)."""
    from multimodal_scene_text_recognition_tpu_torch.models.resnet import ResNet31

    net = ResNet31(1, 64, (1, 1, 1, 1))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / max(1, p[0].numel()) ** 0.5)
        for m in net.modules():
            if hasattr(m, "running_var"):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    img = torch.rand(3, 32, 100, 1, generator=gen)
    absmax = ri.calibrate_resnet(net, img)
    want = ri.resnet31_int8_forward(ri.quantize_resnet(net, x_absmax=absmax), img, 64,
                                    (1, 1, 1, 1))
    net_dev = net.to(dev)
    got = ri.resnet31_int8_forward(ri.quantize_resnet(net_dev, x_absmax=absmax), img.to(dev),
                                   64, (1, 1, 1, 1))
    assert torch.equal(got.cpu(), want)


def test_served_int8_reads_the_words_on_the_card(dev):
    """The served int8 configuration (bf16, early stop, the int8 loc-net,
    backbone and encoder, K1q, the committed scales found beside the
    trained bundle) on the card reads the word crops that the JAX
    package's renderer draws for tests/test_torch_int8_serve.py (WORDS),
    greedily and by beam search (k=5): every string equals its label, as
    JAX's ``make_int8_eval_step`` and the port's plain versions do there on
    the CPU.  The greedy call launches K1q (on the wide-row kernel for these
    8 rows, on the cluster kernel for the same crops 13 times over) and the
    warp kernel."""
    import dataclasses

    from multimodal_scene_text_recognition_tpu.data import synthetic  # numpy and PIL only
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer

    samples = synthetic.make_dataset(size=8, seed=77)
    crops = [s.image[..., 0] for s in samples]
    cfg = dataclasses.replace(FLAGSHIP, decode_early_stop=True, decode_beam_fused=True,
                              decode_int8=True, encoder_int8=True, tps_int8=True)
    model = api.get_model("assets/trained/synth_openvocab_xxl.params.npz", cfg)
    rec = Recognizer(model, batch_sizes=(8,), int8_backbone=True)
    assert rec._int8_absmax is not None  # the committed scales, not a lazy calibration
    count = lambda: (fd.fused_greedy_decode_cuda.launches_int8,  # noqa: E731
                     fd.fused_greedy_decode_cuda.launches_int8_wide, gs.grid_sample_cuda.launches)
    before = count()
    texts = rec.recognize(crops)
    after = count()
    assert after[:2] == (before[0], before[1] + 1) and after[2] > before[2]
    labels = [s.label for s in samples]
    assert texts == labels
    assert rec.recognize(crops, beam_size=5) == labels
    many = Recognizer(model, batch_sizes=(8 * 13,), int8_backbone=True)
    before = count()
    assert many.recognize(crops * 13) == labels * 13
    assert count()[:2] == (before[0] + 1, before[1])


# -- the semantic CLS step-0 row (cls0) of K1, K1e, K1q and K4 ---------------


def _cls0(dev, B, E=64, seed=0):
    """A seeded random step-0 row per batch row, N(0, 1) float32 [B, E]:
    different for every row (the model's own cls0 is all ones, which
    cannot tell a kernel that reads it from one that writes 1.0 or reads
    row 0 for every row)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, E)).astype(np.float32)).to(dev)


@pytest.mark.parametrize("mode", ["K1", "K1e", "K1q", "K1q-early-stop"])
def test_fused_decode_cls0_kernel_matches_plain(dev, mode):
    """K1 with a random cls0 (full length, early stop, int8) against its
    plain version at B=64, f32 and bf16, with the limits of the tests
    above for the same mode (float: f32 logits atol 1e-4 and tokens equal,
    bf16 95% of the tokens, with early stop of the [s]-pruned rows; K1q: f32
    tokens equal and 95% of logit rows within 1e-4, bf16 90% of the
    [s]-pruned rows).  The step-0 logits differ from those of
    the same call without cls0, and from row to row as cls0 does."""
    B = 64
    int8_mode = mode.startswith("K1q")
    early_stop = mode in ("K1e", "K1q-early-stop")
    w, ck, cv = _decode_inputs(dev, B, seed=70, T=8)
    w = w._replace(head_b=w.head_b + (2.0 if early_stop else 0.0)
                   * (torch.arange(97, device=dev) == EOS_ID))
    scales = None
    if int8_mode:
        w, scales = fd.quantize_fused_weights(w)
    cls0 = _cls0(dev, B, seed=71)
    kw = dict(num_heads=4, steps=8, go_id=0, eos_id=EOS_ID if early_stop else None,
              scales=scales)
    for dt in (torch.float32, torch.bfloat16):
        wd = fd.cast_weights(w, dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        pack = fd.pack_cluster_tables_int8 if int8_mode else fd.pack_cluster_tables
        packed = pack(wd, 4)
        out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, cls0=cls0, packed=packed, **kw)
        ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, cls0=cls0, **kw)
        without = fd.fused_greedy_decode_cuda(wd, ckd, cvd, packed=packed, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert (out[:, 0] - without[:, 0]).abs().amax(-1).min().item() > 1e-3
        ids, ref_ids = out.argmax(-1), ref.argmax(-1)
        if dt == torch.float32:
            assert _pruned_agreement(ids, ref_ids) == 1.0
            row_err = (out - ref).abs().amax(-1)
            if int8_mode:
                assert (row_err <= 1e-4).float().mean().item() >= 0.95
            else:
                assert row_err.max().item() <= 1e-4
        elif mode == "K1":
            assert (ids == ref_ids).float().mean().item() >= 0.95
        else:
            assert _pruned_agreement(ids, ref_ids) >= (0.9 if int8_mode else 0.95)


@pytest.mark.parametrize("early_stop", [False, True])
def test_fused_beam_cls0_kernel_matches_plain(dev, early_stop):
    """K4 with a random cls0 (every beam of a row from that row's cls0)
    against its plain version at B=64, K=5, with the limits of
    test_fused_beam_kernel_matches_plain: f32 tokens identical and scores
    within 1e-4, bf16 90% of the beams identical up to their first [s];
    the scores differ from those of the same search without cls0."""
    B = 64
    w, ck, cv = _decode_inputs(dev, B, seed=72, T=8)
    if early_stop:
        w = w._replace(head_b=w.head_b + 4.0 * (torch.arange(97, device=dev) == EOS_ID))
    cls0 = _cls0(dev, B, seed=73)
    kw = dict(beam_size=5, num_heads=4, steps=8, go_id=0, eos_id=EOS_ID, early_stop=early_stop)
    for dt in (torch.float32, torch.bfloat16):
        wd = fd.cast_weights(w, dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        tok, sc = fb.fused_beam_decode_cuda(wd, ckd, cvd, cls0=cls0, **kw)
        ref_tok, ref_sc = fb.fused_beam_decode_plain(wd, ckd, cvd, cls0=cls0, **kw)
        _, sc_without = fb.fused_beam_decode_cuda(wd, ckd, cvd, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(sc).all() and (sc[:, 1:] <= sc[:, :-1]).all()
        assert (sc - sc_without).abs().amax(-1).min().item() > 1e-4
        if dt == torch.float32:
            assert torch.equal(tok, ref_tok)
            torch.testing.assert_close(sc, ref_sc, atol=1e-4, rtol=0)
        else:
            assert _pruned_agreement(tok, ref_tok) >= 0.9


def test_cls0_wrappers_refuse_bad_cls0(dev):
    """K1, K1q and K4 refuse a cls0 of another shape, type or device, and
    a non-contiguous one, rather than reading past it or converting it."""
    w, ck, cv = _decode_inputs(dev, 4, seed=74)
    wq, scales = fd.quantize_fused_weights(w)
    good = _cls0(dev, 4, seed=75)
    packed, packed_q = fd.pack_cluster_tables(w, 4), fd.pack_cluster_tables_int8(wq, 4)
    calls = (lambda c: fd.fused_greedy_decode_cuda(w, ck, cv, num_heads=4, steps=6, cls0=c,
                                                   packed=packed),
             lambda c: fd.fused_greedy_decode_cuda(wq, ck, cv, num_heads=4, steps=6,
                                                   scales=scales, cls0=c, packed=packed_q),
             lambda c: fb.fused_beam_decode_cuda(w, ck, cv, beam_size=3, num_heads=4, steps=6,
                                                 cls0=c))
    bad = (good[:3], good[:, :32].contiguous(), good.bfloat16(), good.double(), good.cpu(),
           good.t().contiguous().t(), good[None])
    for call in calls:
        call(good)
        for c in bad:
            with pytest.raises(ValueError, match="cls0"):
                call(c)


@pytest.mark.parametrize("x_kind,iters", [("normal", 1), ("normal", 4), ("normal", 30),
                                          ("ties", 1), ("ties", 4), ("nan", 1)])
def test_int8_chain_kernel_is_bit_equal_to_plain(dev, x_kind, iters):
    """P1 against its plain version on the probe's inputs, on
    ``tie_input`` (every first quantization a half-way tie; its chain
    starts 127 times larger and overflows before 30 steps) and on an x with
    one NaN (all NaN after one step, as jnp.maximum propagates it): bit for
    bit, each step the same IEEE operations in the same order, the int32
    sums exact."""
    x, wq, ws, _ = gp.probe_inputs(0, dev)
    if x_kind == "ties":
        x = gp.tie_input(0, dev)
    elif x_kind == "nan":
        x[3, 5] = float("nan")
    got = gp.int8_chain_cuda(x, wq, ws, iters)
    want = gp.int8_chain_plain(x, wq, ws, iters)
    assert torch.isnan(want).all() if x_kind == "nan" else torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("iters", [1, 4, 30])
def test_bf16_chain_kernel_matches_plain(dev, iters):
    x, _, _, wbf = gp.probe_inputs(0, dev)
    got = gp.bf16_chain_cuda(x, wbf, iters)
    want = gp.bf16_chain_plain(x, wbf, iters)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= gp.BF16_CHAIN_TOL[iters], err


def test_chain_kernels_end_all_nan_at_the_probes_length(dev):
    x, wq, ws, wbf = gp.probe_inputs(0, dev)
    for out in (gp.int8_chain_cuda(x, wq, ws), gp.int8_chain_plain(x, wq, ws),
                gp.bf16_chain_cuda(x, wbf), gp.bf16_chain_plain(x, wbf)):
        assert torch.isnan(out).all()


@pytest.mark.parametrize("B", [64, 32, 96, 160])
def test_chain_kernels_at_another_shape(dev, B):
    """F=384 (one column of wide tiles): B=64 is 4 chain CTAs (P1's in a
    cluster of 4) and one 64-row wide tile (P2: two of 32); B=32, 96 and
    160 end P1's last wide tile after 32 of its 64 rows.  The tiles and the
    feedback of the first 256 columns do not depend on the probe's own
    shape."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(B, 256, generator=g, device=dev)
    w = torch.randn(256, 384, generator=g, device=dev)
    ws = w.abs().amax(dim=0, keepdim=True) / 127.0
    wq = torch.clamp(torch.round(w / ws), -127, 127).to(torch.int8)
    assert torch.equal(gp.int8_chain_cuda(x, wq, ws, 6), gp.int8_chain_plain(x, wq, ws, 6))
    got = gp.bf16_chain_cuda(x, w.bfloat16(), 1)
    want = gp.bf16_chain_plain(x, w.bfloat16(), 1)
    assert ((got - want).abs().max() / want.abs().max()).item() <= gp.BF16_CHAIN_TOL[1]


def test_chain_dispatch_launches_the_kernels_once_a_call(dev):
    x, wq, ws, wbf = gp.probe_inputs(0, dev)
    n8, n16 = gp.int8_chain_cuda.launches, gp.bf16_chain_cuda.launches
    for _ in range(3):
        gp.int8_chain(x, wq, ws, 2)
        gp.bf16_chain(x, wbf, 2)
    assert gp.int8_chain_cuda.launches == n8 + 3 and gp.bf16_chain_cuda.launches == n16 + 3


def test_chain_wrappers_refuse_bad_inputs(dev):
    x, wq, ws, wbf = gp.probe_inputs(0, dev)
    p1 = lambda *a: gp.int8_chain_cuda(*a, 2)  # noqa: E731
    p2 = lambda *a: gp.bf16_chain_cuda(*a, 2)  # noqa: E731
    for call, args, exc in (
            (p1, (x.double(), wq, ws), TypeError), (p1, (x, wq.float(), ws), TypeError),
            (p1, (x, wq, ws.double()), TypeError), (p2, (x, wbf.float()), TypeError),
            (p1, (x[:100], wq, ws), ValueError), (p1, (x, wq[:, :200], ws[:, :200]), ValueError),
            (p1, (x[:, :128].contiguous(), wq[:128], ws), ValueError),
            (p1, (x, wq, ws[:, :1024]), ValueError), (p2, (x, wbf[:, :1000]), ValueError),
            (p1, (x.t().contiguous().t(), wq, ws), ValueError), (p2, (x, wbf.cpu()), ValueError),
            (p1, (torch.zeros(288, 256, device=dev), wq, ws), ValueError),
            (p1, (torch.zeros(192 * 256 + 1, device=dev)[1:].view(192, 256), wq, ws),
             ValueError)):
        with pytest.raises(exc):
            call(*args)
    with pytest.raises(ValueError, match="iters"):
        gp.int8_chain_cuda(x, wq, ws, -1)


def test_chain_launch_too_large_to_be_resident_raises(dev):
    """P2 at B=4096 makes 256 chain and 1792 wide CTAs, P1 at B=256 and
    F=8192 16 and 248 in clusters of 16: more than the card holds at once,
    so the cooperative launch is refused and the wrapper raises.  P1 at
    B=4096 would need a cluster of 256 and is refused before any launch."""
    x = torch.zeros(4096, 256, device=dev)
    _, wq, ws, wbf = gp.probe_inputs(0, dev)
    before = gp.bf16_chain_cuda.launches, gp.int8_chain_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        gp.bf16_chain_cuda(x, wbf, 1)
    wide_q = torch.zeros(256, 8192, dtype=torch.int8, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        gp.int8_chain_cuda(x[:256], wide_q, torch.ones(1, 8192, device=dev), 1)
    with pytest.raises(ValueError, match="cluster"):
        gp.int8_chain_cuda(x, wq, ws, 1)
    assert (gp.bf16_chain_cuda.launches, gp.int8_chain_cuda.launches) == before


def test_chain_kernels_repeat_bit_for_bit(dev):
    """Two launches of each kernel at 30 steps give the same acc bit for
    bit: the wide CTAs read each step's A operand (and P1's inv) from the
    history in the order the chain wrote it, however far the chain ran
    ahead."""
    x, wq, ws, wbf = gp.probe_inputs(0, dev)
    for call in (lambda: gp.int8_chain_cuda(x, wq, ws, 30), lambda: gp.bf16_chain_cuda(x, wbf, 30)):
        assert torch.equal(call(), call())
