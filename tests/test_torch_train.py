"""The training slice of the PyTorch port against the JAX package on the
CPU, float32: the label codec, the loss, the optimizer and its schedule,
dropout, one whole train step of a small flagship-shaped model, and the
training loop."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from multimodal_scene_text_recognition_tpu.core.charset import AttnCodec as JAttnCodec
from multimodal_scene_text_recognition_tpu.core.config import ModelConfig as JModelConfig
from multimodal_scene_text_recognition_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_scene_text_recognition_tpu.models.model import build_model
from multimodal_scene_text_recognition_tpu.models.transformation import (
    TPSTransform as JTPSTransform,
)
from multimodal_scene_text_recognition_tpu.ops import tps as jax_tps
from multimodal_scene_text_recognition_tpu.train.state import TrainState
from multimodal_scene_text_recognition_tpu.train.state import make_lr_schedule as j_make_lr_schedule
from multimodal_scene_text_recognition_tpu.train.state import make_optimizer as j_make_optimizer
from multimodal_scene_text_recognition_tpu.train.steps import cross_entropy as j_cross_entropy
from multimodal_scene_text_recognition_tpu.train.steps import make_train_step
from multimodal_scene_text_recognition_tpu.train.steps import prep_image as j_prep_image
from multimodal_scene_text_recognition_tpu_torch import api, convert
from multimodal_scene_text_recognition_tpu_torch.charset import AttnCodec
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig, TrainConfig
from multimodal_scene_text_recognition_tpu_torch.models.layers import dropout
from multimodal_scene_text_recognition_tpu_torch.models.model import SceneTextModel
from multimodal_scene_text_recognition_tpu_torch.models.transformation import TPSTransform
from multimodal_scene_text_recognition_tpu_torch.ops import batchnorm as bnops
from multimodal_scene_text_recognition_tpu_torch.ops import precision, tps
from multimodal_scene_text_recognition_tpu_torch.train.loop import run_steps
from multimodal_scene_text_recognition_tpu_torch.train.state import AdamW, make_lr_schedule
from multimodal_scene_text_recognition_tpu_torch.train.steps import cross_entropy
from test_torch_modules import flatten, randomize
import torch_threads

torch_threads.limit()

TINY = dict(enc_layers=1, dec_layers=1, ff_dim=64, hidden_dim=64, embed_dim=32, num_heads=4,
            compute_dtype="float32", dropout=0.0)
CHARS = ModelConfig().chars


def make_batch(B, seed):
    """A batch in the JAX pipeline's wire format: glyph-like uint8 crops (a
    background level, dark or light bars, pixel noise), label rows of random
    words, overlap ids in [0, 100), and the scene/ious the JAX model takes."""
    rng = np.random.default_rng(seed)
    img = np.empty((B, 32, 100, 1), np.float64)
    for b in range(B):
        bg = rng.uniform(40, 215)
        img[b] = bg
        for x in range(4, 92, 8):
            h0, h1 = sorted(rng.integers(4, 29, 2))
            img[b, h0:h1 + 2, x:x + rng.integers(2, 5)] = 255 - bg
    img += rng.normal(0, 8, img.shape)
    words = ["".join(rng.choice(list("abcdefghij0123"), rng.integers(1, 9))) for _ in range(B)]
    text, _ = AttnCodec(CHARS).encode(words)
    return {"image": np.clip(img, 0, 255).astype(np.uint8), "text": text,
            "overlap": rng.integers(0, 100, (B, 15)).astype(np.int32),
            "scene": np.zeros((B, 52), np.int32), "ious": np.full((B, 52), -1000.0, np.float32)}


def random_bundle(cfg, seed):
    """Seeded weights in the JAX bundle layout for every entry of the port's
    model: kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1), biases
    and running means ~ N(0, 0.1), running variances ~ U(0.5, 1.5)."""
    with torch.device("meta"):
        sd = SceneTextModel(cfg).state_dict()
    shapes = {k: v.shape for k, v in convert.state_dict_to_bundle(
        {k: torch.empty(v.shape) for k, v in sd.items()}).items()}
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in sorted(shapes.items()):
        leaf = key.rpartition(".")[2]
        if leaf == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = 0.1 * rng.standard_normal(shape)
        flat[key] = v.astype(np.float32)
    return flat


def unflatten(flat):
    """Dotted bundle keys -> the nested variables tree flax applies."""
    tree = {}
    for key, arr in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return tree


# --- label codec, loss -------------------------------------------------------


def test_codec_encode_matches_jax():
    words = ["", "a", "Hello,World!", "x" * 25]
    got, got_len = AttnCodec(CHARS).encode(words)
    want, want_len = JAttnCodec(CHARS).encode(words)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)
    assert got.shape == (4, 27) and got.dtype == np.int32
    with pytest.raises(ValueError):
        AttnCodec(CHARS).encode(["y" * 26])


@pytest.mark.parametrize("counts_pad", [True, False])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(counts_pad, smoothing):
    """Targets with [GO], [s], [PAD] and characters; within 1e-6 relative."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 26, 97))).astype(np.float32)
    targets = AttnCodec(CHARS).encode(["abc", "hello.world", ""])[0][:, 1:]
    targets[0, 5] = 0  # a [GO] target, which both mask
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets).long(),
                        counts_pad, smoothing).item()
    want = float(j_cross_entropy(jnp.asarray(logits), jnp.asarray(targets), counts_pad, smoothing))
    assert got == pytest.approx(want, rel=1e-6)


# --- optimizer ---------------------------------------------------------------


def test_lr_schedule_matches_optax():
    """Warmup 3 joined to StepLR(step 2, gamma 0.5): every count 0..12,
    within 1e-6 relative (optax evaluates in float32)."""
    for kw in (dict(warmup_steps=3, lr_step_size=2, lr_gamma=0.5),
               dict(lr_step_size=2, lr_gamma=0.5), dict(warmup_steps=3), {}):
        got = make_lr_schedule(TrainConfig(lr=1e-2, **kw))
        want = j_make_lr_schedule(JTrainConfig(lr=1e-2, **kw))
        for count in range(13):
            assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12), (kw, count)


def test_trainer_schedule_counts_epochs_as_jax_does():
    """``get_trainer(steps_per_epoch=k)`` puts the StepLR boundaries every
    ``lr_step_size * k`` steps after the warmup, as JAX's
    ``make_lr_schedule(cfg, steps_per_epoch=k)``: every count 0..40 within
    1e-6 relative, for k = 1, 3 and 4."""
    kw = dict(lr=1e-2, warmup_steps=3, lr_step_size=2, lr_gamma=0.5)
    for k in (1, 3, 4):
        trainer = api.get_trainer(cfg=ModelConfig(**TINY, decode_fused=True),
                                  train_cfg=TrainConfig(**kw), device="cpu", steps_per_epoch=k)
        want = j_make_lr_schedule(JTrainConfig(**kw), steps_per_epoch=k)
        for count in range(41):
            assert trainer.optimizer.schedule(count) == pytest.approx(
                float(want(count)), rel=1e-6, abs=1e-12), (k, count)


def test_f32_model_runs_without_tf32_and_restores_the_callers_switches():
    """With compute_dtype float32 the served forward, the beam search and
    the train step's forward and backward run with TF32 off for matmuls and
    convs, though the caller turned it on, and the caller's switches are
    back afterwards; a bf16 model leaves them as the caller set them."""
    switches = precision._switches()

    def state():
        return [getattr(obj, name) for obj, name, _ in switches]

    full = [value for _, _, value in switches]
    tf32 = ["tf32" if isinstance(v, str) else True for v in full]
    saved = state()
    seen = []

    def record(*_):
        seen.append(state())

    try:
        for (obj, name, _), v in zip(switches, tf32):
            setattr(obj, name, v)
        assert state() == tf32
        for dtype, want in (("float32", full), ("bfloat16", tf32)):
            cfg = ModelConfig(**dict(TINY, compute_dtype=dtype), decode_fused=True)
            trainer = api.get_trainer(cfg=cfg, device="cpu")
            model = trainer.model
            model.feature_extractor.register_forward_hook(record)
            model.decoder.emb_to_classes.register_full_backward_hook(record)
            seen.clear()
            trainer(make_batch(2, 0))
            model.eval()
            with torch.no_grad():
                image = torch.zeros(1, 32, 100, 1)
                overlap = torch.zeros(1, 15, dtype=torch.long)
                model(image, overlap)
                model.beam_decode(image, overlap, 2)
            assert len(seen) == 4 and all(s == want for s in seen), (dtype, seen)
            assert state() == tf32
    finally:
        for (obj, name, _), v in zip(switches, saved):
            setattr(obj, name, v)


def test_adamw_matches_optax_over_four_steps():
    """``make_optimizer``'s chain on three parameters over four steps with
    warmup 2 and StepLR(step 1, gamma 0.5): the gradients of steps 1 and 3
    have a global norm above the clip (2.0), those of 2 and 4 below it; one
    parameter never gets a gradient in the port (a zero gradient in optax).
    The global norm before the clip and every parameter after every step
    within 1e-6 relative (float32, another summation order)."""
    rng = np.random.default_rng(1)
    init = {"a": rng.standard_normal((5, 4)), "b": rng.standard_normal(7),
            "unused": rng.standard_normal(3)}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    cfg = dict(lr=1e-2, warmup_steps=2, lr_step_size=1, lr_gamma=0.5)
    tx = j_make_optimizer(JTrainConfig(**cfg))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = AdamW(params.values(), make_lr_schedule(TrainConfig(**cfg)),
                weight_decay=0.01, clip_norm=2.0)
    for step, scale in enumerate([3.0, 0.1, 5.0, 0.2]):
        grads = {k: (scale * rng.standard_normal(v.shape) / 4).astype(np.float32)
                 for k, v in init.items()}
        grads["unused"][:] = 0.0
        jnorm = optax.global_norm(grads)
        assert (jnorm > 2.0) == (step % 2 == 0)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = None if k == "unused" else torch.from_numpy(grads[k])
        norm = opt.step()
        assert norm.item() == pytest.approx(float(jnorm), rel=1e-6)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{k} after step {step + 1}")
    assert opt.count == 4


# --- dropout -------------------------------------------------------------------


def test_dropout_keeps_scales_and_repeats():
    """p = 0.1 over 200k ones: the kept share within 5 sigma of 0.9, kept
    values exactly 1 / 0.9, the same mask from the same generator seed and
    another from another seed; p = 0 is the identity."""
    x = torch.ones(200_000)
    out = dropout(x, 0.1, torch.Generator().manual_seed(3))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.9) < 5 * np.sqrt(0.09 / x.numel())
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.9), rtol=0, atol=0)
    assert torch.equal(out, dropout(x, 0.1, torch.Generator().manual_seed(3)))
    assert not torch.equal(out, dropout(x, 0.1, torch.Generator().manual_seed(4)))
    assert dropout(x, 0.0, torch.Generator()) is x


def test_dropout_is_on_in_train_and_off_in_eval():
    """Train mode with dropout 0.1 draws from the generator: the same seed
    gives the same logits, another seed others.  Eval mode (the served
    greedy path) draws nothing and repeats exactly."""
    cfg = ModelConfig(**{**TINY, "dropout": 0.1}, decode_fused=True)
    model = api.get_model(cfg=cfg, device="cpu", seed=2, train=True)
    b = make_batch(2, 5)
    image = torch.from_numpy(b["image"]).float() / 255
    overlap = torch.from_numpy(b["overlap"]).long()
    text = torch.from_numpy(b["text"][:, :-1]).long()

    def run(seed):
        with torch.no_grad():
            return model(image, overlap, text, train=True,
                         generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.allclose(run(1), run(2))
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(image, overlap), model(image, overlap))


# --- one train step against JAX --------------------------------------------


def _float64_solved_grid(batch_C_prime, I_r_height, I_r_width):
    """JAX's TPS grid with its system solved once in float64: ``M @ C'``
    in one float32 matmul, M from the port's ``tps_weights`` (held to the
    JAX constants and to a float64 solve in ``test_torch_ops.py``)."""
    B, F, _ = batch_C_prime.shape
    m = jnp.asarray(tps.tps_weights(F, I_r_height, I_r_width))
    grid = jnp.einsum("nf,bfk->bnk", m, batch_C_prime.astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)
    return grid.reshape(B, I_r_height, I_r_width, 2)


def _step_against_jax(use_tps, monkeypatch):
    """One train step of the same seeded weights on the same batch (B=4)
    in both packages at dropout 0, the default TrainConfig (lr 1e-4, the
    clip at 2.0 triggers).  JAX's TPS grid is solved as the port solves it
    (:func:`_float64_solved_grid`).  Returns what the assertions compare."""
    monkeypatch.setattr(jax_tps, "build_sampling_grid", _float64_solved_grid)
    cfg = ModelConfig(**TINY, use_tps=use_tps, decode_fused=True)
    flat = random_bundle(cfg, 7)
    batch = make_batch(4, 3)
    jm = build_model(JModelConfig(**TINY, use_tps=use_tps))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = unflatten(flat)
    tx = j_make_optimizer(JTrainConfig())
    key = jax.random.PRNGKey(0)
    raw_step = make_train_step(jm, tx, jit_compile=False)

    def loss_fn(params, b):
        logits, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             j_prep_image(b["image"]), b["text"][:, :-1], b["overlap"],
                             b["scene"], b["ious"], train=True,
                             rngs={"dropout": key, "semantics": key}, mutable=["batch_stats"])
        return j_cross_entropy(logits, b["text"][:, 1:])

    @jax.jit
    def step_and_grads(params, b):
        state = TrainState(step=0, params=params, batch_stats=variables["batch_stats"],
                           opt_state=tx.init(params))
        new_state, metrics = raw_step(state, b, key)
        return new_state, metrics, jax.grad(loss_fn)(params, b)

    new_state, metrics, grads = step_and_grads(variables["params"], jb)

    trainer = api.get_trainer(cfg=cfg, device="cpu")
    trainer.model.load_state_dict(convert.bundle_to_state_dict(flat), strict=True)
    got = trainer(batch)
    params = dict(trainer.model.named_parameters())
    port_grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                  for k, p in params.items()}

    def as_port(tree, collection="params"):
        return convert.bundle_to_state_dict(
            {f"{collection}.{k}": np.asarray(v) for k, v in _flat(tree).items()})

    return dict(got=got, metrics=metrics, port_grads=port_grads, grads=as_port(grads),
                new=as_port(new_state.params), stats=as_port(new_state.batch_stats, "batch_stats"),
                port_state=trainer.model.state_dict())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _rel_l2(a, b, keys):
    num = sum(float((a[k] - b[k]).pow(2).sum()) for k in keys)
    return np.sqrt(num / sum(float(b[k].pow(2).sum()) for k in keys))


BACKBONE = ("feature_extractor.", "transformation.")
GROUPS = {"decoder": ("decoder.", "semantic."), "encoder": ("encoder.",), "backbone": BACKBONE}
# relative tolerances (loss, grad norm, gradient groups by relative L2, running
# statistics of their scale) and the least share of parameters checked after
# the update
TOLS = {False: dict(loss=1e-5, grad_norm=1e-3, decoder=1e-5, encoder=5e-3, backbone=1e-2,
                    stats=1e-5, agree=0.95),
        True: dict(loss=2e-5, grad_norm=1e-2, decoder=2e-4, encoder=5e-4, backbone=6e-2,
                   stats=5e-5, agree=0.75)}


@pytest.mark.parametrize("use_tps", [False, True])
def test_train_step_matches_jax(use_tps, monkeypatch):
    """One train step of the port against JAX ``make_train_step`` (the JAX
    gradients from ``jax.grad`` of the same loss): loss, token accuracy,
    gradient norm before the clip, every gradient, every running statistic
    and every updated parameter.  Gradient differences are relative L2
    over a group; the decoder's and semantic table's per tensor.

    The backbone's gradients are piecewise continuous: a ReLU whose input
    lies within the two packages' float32 forward difference of zero may
    take the other side, and one such flip moves a block's gradient by
    ~2e-3 of its norm.  Without TPS the crops are the same and the
    forwards differ by rounding (~1e-7); with TPS the rectified crops differ
    by the warp of the loc-net's rounding (up to ~4e-5), so more ReLUs
    flip.  The loc-net and the warp themselves are held to 1e-4 in
    ``test_tps_stage_train_gradients_match_jax``.

    Measured, without / with TPS: loss 1e-7 / 2.9e-6, gradient norm 2.2e-4
    / 1.9e-3, decoder and semantic table <= 2.7e-6 / 7.1e-5 per tensor,
    encoder 5.4e-4 / 7.3e-5, backbone 3.4e-3 / 2.9e-2, running statistics
    7e-7 / 1.2e-5 of their scale.  Updated parameters: within 1e-5 of
    JAX's (measured 4.9e-7 / 2.2e-6) wherever the two gradients agree to
    10%, which is 98.5% / 82% of the elements; the others are near-zero
    gradients, where Adam's first step is their sign."""
    r = _step_against_jax(use_tps, monkeypatch)
    tol = TOLS[use_tps]
    got, m = r["got"], r["metrics"]
    grads, port_grads = r["grads"], r["port_grads"]
    assert set(grads) == set(port_grads)
    assert got["loss"].item() == pytest.approx(float(m["loss"]), rel=tol["loss"])
    assert got["token_acc"].item() == pytest.approx(float(m["token_acc"]), abs=1e-6)
    assert got["grad_norm"].item() == pytest.approx(float(m["grad_norm"]), rel=tol["grad_norm"])

    for group, prefixes in GROUPS.items():
        keys = [k for k in grads if k.startswith(prefixes) and grads[k].abs().max() > 0]
        assert keys, group
        assert _rel_l2(port_grads, grads, keys) <= tol[group], group
        if group == "decoder":
            for k in keys:
                assert _rel_l2(port_grads, grads, [k]) <= tol[group], k
    for k in grads:  # the semantic table feeds nothing: zero in both
        if not grads[k].abs().max() > 0:
            assert not port_grads[k].abs().max() > 0, k

    for k, want in r["stats"].items():
        np.testing.assert_allclose(r["port_state"][k].numpy(), want.numpy(), rtol=0,
                                   atol=tol["stats"] * max(1.0, want.abs().max().item()),
                                   err_msg=k)
    agree_n = total = 0
    for k, want in r["new"].items():
        agree = (port_grads[k] - grads[k]).abs() <= 0.1 * grads[k].abs()
        agree_n += int(agree.sum())
        total += agree.numel()
        diff = (r["port_state"][k] - want).abs()[agree]
        assert diff.numel() == 0 or diff.max().item() <= 1e-5, k
    assert agree_n / total >= tol["agree"]


def test_tps_stage_train_gradients_match_jax(monkeypatch):
    """The TPS stage alone in train mode (loc-net with batch statistics,
    the grid, the warp) against JAX's ``TPSTransform`` with its grid solved
    in float64, every weight randomized (the grid runs outside [-1, 1]),
    under a seeded cotangent on the rectified crops: every loc-net gradient
    within 1e-4 relative L2 (measured <= 1.2e-5) and the running statistics
    within 1e-5 of their scale (measured 4e-7)."""
    monkeypatch.setattr(jax_tps, "build_sampling_grid", _float64_solved_grid)
    img = make_batch(4, 3)["image"].astype(np.float32) / 255
    cot = np.random.default_rng(5).standard_normal(img.shape).astype(np.float32)
    jm = JTPSTransform(20, 32, 100, dtype=jnp.float32, fused_bn=True)
    variables = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(img)), 2)

    def loss_fn(params):
        out, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(img), train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), upd

    (_, upd), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    port = TPSTransform(20, 32, 100, 1, torch.float32)
    port.load_state_dict(convert.bundle_to_state_dict(flatten(variables)), strict=True)
    (port(torch.from_numpy(img), train=True) * torch.from_numpy(cot)).sum().backward()

    grads = dict(port.named_parameters())
    want = convert.bundle_to_state_dict(flatten({"params": jgrads}))
    assert set(want) == set(grads)
    for k, w in want.items():
        assert w.abs().max() > 0, k
        assert float((grads[k].grad - w).norm() / w.norm()) <= 1e-4, k
    state = port.state_dict()
    for k, w in convert.bundle_to_state_dict(flatten({"batch_stats": upd["batch_stats"]})).items():
        np.testing.assert_allclose(state[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, w.abs().max().item()), err_msg=k)


# --- loop and entry points -----------------------------------------------------


def test_train_loop_lowers_the_loss():
    """Five steps on one batch at lr 1e-3 lower the loss and count the
    steps; the averages are the means of the per-step history."""
    cfg = ModelConfig(**TINY, decode_fused=True)
    trainer = api.get_trainer(cfg=cfg, train_cfg=TrainConfig(lr=1e-3), device="cpu")
    batch = make_batch(8, 0)
    out = run_steps(trainer, [batch] * 5, num_steps=5, log_every=2)
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert trainer.step_count == 5
    assert out["loss"] == pytest.approx(np.mean(losses))
    with pytest.raises(ValueError):
        run_steps(trainer, [batch], num_steps=2)


def test_entry_points_train_mode(monkeypatch):
    """``get_model(train=True)`` is in train mode with gradients on, the
    default stays eval with gradients off; ``get_trainer`` defaults to the
    card and raises without one."""
    cfg = ModelConfig(**TINY, decode_fused=True)
    m = api.get_model(cfg=cfg, device="cpu", train=True)
    assert m.training and all(p.requires_grad for p in m.parameters())
    m = api.get_model(cfg=cfg, device="cpu")
    assert not m.training and not any(p.requires_grad for p in m.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        api.get_trainer(cfg=cfg)
    with pytest.raises(ValueError):  # train mode needs ids and a generator
        api.get_model(cfg=cfg, device="cpu")(torch.zeros(1, 32, 100, 1),
                                             torch.zeros(1, 15, dtype=torch.long), train=True)


def test_fused_bn_off_takes_the_plain_reduction():
    """``fused_bn`` is K3's default; ``set_use_kernels`` switches every
    BatchNorm at run time, whatever the default."""
    cfg = dataclasses.replace(ModelConfig(**TINY, decode_fused=True), fused_bn=False)
    model = SceneTextModel(cfg)
    bns = [m for m in model.modules() if hasattr(m, "running_var")]
    assert len(bns) == 36 and not any(m.use_kernels for m in bns)
    model.set_use_kernels(True)
    assert all(m.use_kernels for m in bns)
    model = SceneTextModel(ModelConfig(**TINY, decode_fused=True))
    assert all(m.use_kernels for m in model.modules() if hasattr(m, "running_var"))
    model.set_use_kernels(False)
    assert not any(m.use_kernels for m in model.modules() if hasattr(m, "running_var"))


def test_every_batchnorm_backward_gets_channels_last(monkeypatch):
    """K3 reads x and dy only as channels-last [B*H*W, C] rows and refuses
    any other layout.  In one train step with TPS, all 36 BatchNorm
    backwards get both in that layout from the convs and autograd, the
    loc-net's global mean and the column mean included, with no copy."""
    seen = []
    real = bnops.bn_bwd

    def spy(x, dy, mean, rstd, weight, plain=False):
        seen.append(all(t.is_contiguous(memory_format=torch.channels_last) for t in (x, dy)))
        return real(x, dy, mean, rstd, weight, plain)

    monkeypatch.setattr(bnops, "bn_bwd", spy)
    cfg = ModelConfig(**TINY, use_tps=True, decode_fused=True)
    api.get_trainer(cfg=cfg, device="cpu")(make_batch(2, 0))
    assert len(seen) == 36 and all(seen)
