"""The port's DistilBERT import and its timing and profiling utilities
against the JAX package's, on the CPU."""

import os

import numpy as np

import jax
import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.models.semantic import BertEmbedding as JBertEmbedding
from multimodal_scene_text_recognition_tpu.train.torch_import import (
    import_distilbert as j_import_distilbert,
)
from multimodal_scene_text_recognition_tpu.utils import profiling as j_profiling
from multimodal_scene_text_recognition_tpu.utils import timing as j_timing
from multimodal_scene_text_recognition_tpu_torch.models.semantic import BertEmbedding
from multimodal_scene_text_recognition_tpu_torch.train.torch_import import import_distilbert
from multimodal_scene_text_recognition_tpu_torch.utils import profiling, timing
import torch_threads

torch_threads.limit()

# a narrow DistilBERT: vocabulary, width, layers, heads, FF, positions
BERT = dict(vocab_size=300, model_dim=48, num_layers=2, num_heads=4, ff_dim=96,
            max_positions=20, embed_dim=16)


def distilbert_state(seed):
    """A seeded state dict under DistilBertModel's key names at BERT's
    widths."""
    rng = np.random.default_rng(seed)
    D, F = BERT["model_dim"], BERT["ff_dim"]

    def t(*shape, scale=0.1, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32))

    sd = {"embeddings.word_embeddings.weight": t(BERT["vocab_size"], D, scale=1.0),
          "embeddings.position_embeddings.weight": t(BERT["max_positions"], D, scale=1.0),
          "embeddings.LayerNorm.weight": t(D, offset=1.0), "embeddings.LayerNorm.bias": t(D)}
    for i in range(BERT["num_layers"]):
        p = f"transformer.layer.{i}."
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            sd[f"{p}attention.{name}.weight"] = t(D, D, scale=D ** -0.5)
            sd[f"{p}attention.{name}.bias"] = t(D)
        for ln in ("sa_layer_norm", "output_layer_norm"):
            sd[f"{p}{ln}.weight"], sd[f"{p}{ln}.bias"] = t(D, offset=1.0), t(D)
        sd[f"{p}ffn.lin1.weight"], sd[f"{p}ffn.lin1.bias"] = t(F, D, scale=D ** -0.5), t(F)
        sd[f"{p}ffn.lin2.weight"], sd[f"{p}ffn.lin2.bias"] = t(D, F, scale=F ** -0.5), t(D)
    return sd


def test_import_distilbert_matches_jax():
    """The same seeded DistilBERT state dict through both imports onto a
    bare embedder: ``stats`` equal field by field, and the embedder's
    output (the proj taken from JAX's tree) within 1e-5 of JAX's."""
    sd = distilbert_state(3)
    tokens = np.random.default_rng(4).integers(0, BERT["vocab_size"], (2, 12))
    jmod = JBertEmbedding(**BERT)
    jvars = jmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens, jnp.int32), None, None)
    jnew, jstats = j_import_distilbert(sd, jvars)

    port = BertEmbedding(**BERT)
    state, stats = import_distilbert(sd, port)
    assert stats == jstats
    assert stats["loaded"] == 4 + 16 * BERT["num_layers"] and not stats["unused_torch_keys"]
    assert stats["missing"] == ["params/proj/bias", "params/proj/kernel"]
    proj = jnew["params"]["proj"]
    state["proj.weight"] = torch.from_numpy(np.asarray(proj["kernel"]).T.copy())
    state["proj.bias"] = torch.from_numpy(np.array(proj["bias"]))
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(tokens), None, None).numpy()
    want = np.asarray(jmod.apply({"params": jnew["params"]}, jnp.asarray(tokens, jnp.int32),
                                 None, None))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_step_timer_stats_match_jax(monkeypatch):
    """The same ticks (a fake clock) give JAX's ``stats()`` exactly, the
    window dropping the oldest."""
    ticks = [0.0, 0.1, 0.25, 0.3, 0.7, 0.75, 0.9]

    timers = []
    for mod in (profiling, j_profiling):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(batch_size=64, window=4)
        assert timer.stats() == {}
        for _ in ticks:
            timer.tick()
        timers.append(timer)
    assert timers[0].times == timers[1].times and len(timers[0].times) == 4
    assert timers[0].stats() == timers[1].stats()
    assert set(timers[0].stats()) == {"step_ms_p50", "step_ms_p90", "crops_per_sec"}


def test_trace_and_annotate_write_a_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as prof:
        with profiling.annotate("matmul region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert any(e.key == "matmul region" for e in prof.key_averages())
    with open(os.path.join(logdir, "trace.json")) as f:
        assert "matmul region" in f.read()


def test_roundrobin_matches_jax():
    """The loop over stacked batches folds the same sums as JAX's jitted
    ``fori_loop`` (batch i % n, accumulated in float32)."""
    stacked = np.arange(24, dtype=np.float32).reshape(3, 2, 4) / 7
    scale = np.float32(1.5)
    got = timing.roundrobin(lambda b, s: b["x"] * s, {"x": torch.from_numpy(stacked)}, 3,
                            (torch.tensor(scale),))(5)()
    want = j_timing.roundrobin(lambda b, s: b["x"] * s, {"x": jnp.asarray(stacked)}, 3,
                               (jnp.float32(scale),))(5)()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_slope_ms_on_the_cpu():
    """A body whose work grows with the trip count gives a positive slope
    (or None, never a rate <= 0)."""
    x = torch.randn(64, 64)
    ms = timing.slope_ms(timing.roundrobin(lambda b: b["x"] @ b["x"], {"x": x[None]}, 1),
                         2, 20, reps=2, pairs=3, device="cpu")
    assert ms is None or ms > 0
