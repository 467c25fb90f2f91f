"""The port's training and validation on data against the JAX package on
the CPU: ``eval/evaluate``, the training loop (both data routes), the
checkpoints and the params bundle, and the ``api`` verbs.

Widths: JAX ``tests/test_train.py``'s MICRO (one encoder and one decoder
layer, 32 wide, 2 heads), float32, dropout 0, TPS off (the TPS solve's
float32 error in JAX, ~3e-5, is held in test_torch_train; here it would
only blur the comparisons).  The port decodes with ``decode_fused=True``
(on the CPU the fused decode's plain version, which reads the decoder's
cached weight tables), JAX with its XLA scan.  Data: prefixes of the
committed synthetic sets.  One JAX loop per data route runs once for the
module, and every JAX loop and validation here shares one compiled JAX
eval step."""

import csv
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax

from multimodal_scene_text_recognition_tpu.core.charset import AttnCodec as JAttnCodec
from multimodal_scene_text_recognition_tpu.core.config import Config as JConfig
from multimodal_scene_text_recognition_tpu.core.config import ModelConfig as JModelConfig
from multimodal_scene_text_recognition_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_scene_text_recognition_tpu.data.pipeline import packed_batches as j_packed_batches
from multimodal_scene_text_recognition_tpu.eval import evaluate as jevaluate
from multimodal_scene_text_recognition_tpu.models.model import build_model
from multimodal_scene_text_recognition_tpu.train import checkpoint as jcheckpoint
from multimodal_scene_text_recognition_tpu.train import loop as jloop
from multimodal_scene_text_recognition_tpu.train.state import TrainState
from multimodal_scene_text_recognition_tpu.train.state import make_optimizer as j_make_optimizer
from multimodal_scene_text_recognition_tpu.train.steps import make_eval_step as j_make_eval_step
from multimodal_scene_text_recognition_tpu_torch import api, convert
from multimodal_scene_text_recognition_tpu_torch.charset import AttnCodec
from multimodal_scene_text_recognition_tpu_torch.config import (DEFAULT_CHARS, Config,
                                                                DataConfig, ModelConfig,
                                                                TrainConfig)
from multimodal_scene_text_recognition_tpu_torch.data import synthetic
from multimodal_scene_text_recognition_tpu_torch.data.pipeline import (PackedSamples,
                                                                       packed_batches)
from multimodal_scene_text_recognition_tpu_torch.eval import evaluate
from multimodal_scene_text_recognition_tpu_torch.train import checkpoint, loop
from multimodal_scene_text_recognition_tpu_torch.train.steps import make_eval_step
from test_torch_train import _flat, random_bundle, unflatten
import torch_threads

torch_threads.limit()

MICRO = dict(enc_layers=1, dec_layers=1, ff_dim=32, hidden_dim=32, embed_dim=32, num_heads=2,
             compute_dtype="float32", dropout=0.0, use_tps=False)
PORT_CFG = ModelConfig(**MICRO, decode_fused=True)
JAX_CFG = JModelConfig(**MICRO)
B = 8
# the loop's run: 32 crops = 4 steps an epoch, 2 epochs, stopped at 7 (not a
# multiple of steps_per_call=2, and inside the second epoch); validation
# every 3 steps; any accuracy beats the threshold, so the first validation
# saves a checkpoint and the later ones (as good, not better) do not.  StepLR
# every epoch (lr / 10 from step 5: the loop's steps_per_epoch feeds the
# boundary) and weight decay 1.0, so that the decay moves a weight by a
# visible share of its update.  lr 1e-5: Adam's first steps are sign-like,
# so a parameter whose gradient lies within the packages' float32
# difference of zero moves by +-lr a step (the backbone's convs do: at lr
# 1e-3 their weights were 2e-4 apart after one step and the losses 2e-4
# apart after two); 1e-5 keeps the two runs' batches and losses together.
LR = 1e-5
LOOP = dict(batch_size=B, epochs=2, validation_steps=3, iteration_limit=7, steps_per_call=2,
            lr=LR, lr_step_size=1, weight_decay=1.0, seed=999, model_save_threshold=-1.0)
COST_TOL = 1e-4
# Each parameter's update over the run (after - before) against JAX's, as
# ||d_port - d_jax|| / ||d_jax||: over all parameters at most UPDATE_TOL
# (measured 0.0127 on both routes), each tensor at most TENSOR_UPDATE_TOL
# (measured worst 0.135: feature_extractor.block3_2.bn2.bias, one of its 32
# elements moved the other way, its gradient near zero; the next is 0.052).
# Run against faults in the port's settings, the whole-run measure reads
# 0.18 without the weight decay, 0.52 without the StepLR boundary, 1.0 with
# no update and 2.0 with every update's sign flipped.
UPDATE_TOL = 0.05
TENSOR_UPDATE_TOL = 0.25


@pytest.fixture(scope="module")
def weights():
    return random_bundle(PORT_CFG, 61)


@pytest.fixture(scope="module")
def jax_model():
    return build_model(JAX_CFG)


@pytest.fixture(scope="module")
def shared_eval(jax_model):
    """One compiled JAX eval step of ``jax_model``, which the JAX loops get
    in place of a fresh one (their own would compile anew every run)."""
    return j_make_eval_step(jax_model)


@pytest.fixture(scope="module")
def data():
    return synthetic.make_dataset(32, 999), synthetic.make_dataset(12, 1000)


def port_model(flat, cfg=PORT_CFG, train_cfg=None):
    trainer = api.get_trainer(cfg=cfg, train_cfg=train_cfg or TrainConfig(**LOOP), device="cpu")
    trainer.model.load_state_dict(convert.bundle_to_state_dict(flat), strict=True)
    return trainer


def read_log(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def as_port(tree):
    return convert.bundle_to_state_dict(
        {f"params.{k}": np.asarray(x) for k, x in _flat(tree).items()})


def run_jax_loop(device_data, weights, jax_model, shared_eval, data, tmp):
    cfg = JConfig(experiment="t", model=JAX_CFG,
                  train=JTrainConfig(**LOOP, device_data=device_data), results_dir=str(tmp))
    v = unflatten(weights)
    tx = j_make_optimizer(cfg.train)
    state = TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "make_eval_step", lambda model: shared_eval)
        state = jloop.train(cfg, jax_model, *data, state=state, verbose=False)
    return {"step": int(state.step), "params": as_port(state.params),
            "log": read_log(tmp / "t_training_log.csv"),
            "saved": os.path.isdir(tmp / "models" / "t")}


@pytest.fixture(scope="module")
def jax_runs(weights, jax_model, shared_eval, data, tmp_path_factory):
    return {dd: run_jax_loop(dd, weights, jax_model, shared_eval, data,
                             tmp_path_factory.mktemp(f"jax_loop_{dd}"))
            for dd in (True, False)}


# --- validation --------------------------------------------------------------------


def val_set_with_hits(model, n=20):
    """``n`` committed validation crops whose even rows are relabelled with
    the model's own reading, so that about half are right."""
    packed = synthetic.make_dataset(n, 1000)
    step = make_eval_step(model)
    preds = []
    for b in packed_batches(packed, B, shuffle=False, drop_last=False):
        preds += AttnCodec(DEFAULT_CHARS, 25).decode(step(
            {k: torch.from_numpy(b[k]) for k in ("image", "overlap", "scene", "ious")}).numpy())
    labels = [preds[i] if i % 2 == 0 else lab for i, lab in enumerate(packed.labels)]
    return PackedSamples(packed.image, packed.text, packed.overlap, packed.scene, packed.ious,
                         packed.anno_id, labels)


def test_validate_and_error_diff_match_jax(weights, shared_eval):
    """Greedy validation of 20 crops at B=8 (the last batch padded with 4
    pad rows, which are decoded and not counted): the same accuracy and
    the same per-crop records as JAX ``validate`` with the same weights,
    and the same ``error_diff_eval`` result with the object tags."""
    model = port_model(weights).model
    val = val_set_with_hits(model)
    jvars = unflatten(weights)
    codec, jcodec = AttnCodec(DEFAULT_CHARS, 25), JAttnCodec(DEFAULT_CHARS, 25)
    got = evaluate.validate(make_eval_step(model), packed_batches(val, B, False, drop_last=False),
                            codec, return_records=True)
    want = jevaluate.validate(shared_eval, jvars, j_packed_batches(val, B, False, drop_last=False),
                              jcodec, return_records=True)
    assert got.accuracy == want.accuracy and 45 <= got.accuracy < 100
    assert [r.__dict__ for r in got.records] == [r.__dict__ for r in want.records]
    assert len(got.records) == 20

    labels = [f"object {i}" for i in range(1, 2000)]  # the synthetic set's 2000 classes
    base = {str(i) for i in range(0, 20, 3)} | {"999"}
    got = evaluate.error_diff_eval(make_eval_step(model),
                                   packed_batches(val, B, False, drop_last=False), codec, base,
                                   class_labels=labels)
    want = jevaluate.error_diff_eval(shared_eval, jvars,
                                     j_packed_batches(val, B, False, drop_last=False), jcodec,
                                     base, class_labels=labels)
    assert got == want and got["total"] == 7 and 0 < got["corrected"] < 7


def test_validation_follows_in_place_steps_and_restores(tmp_path):
    """The decoder's cached weight tables (the fused decode's) must follow
    the parameters: after an in-place AdamW step, and after a restore that
    copies into them, validation equals that of a fresh model loaded with
    the same weights (eval mode, BatchNorm on the running statistics) and
    the trainer is back in train mode."""
    flat = random_bundle(PORT_CFG, 62)
    trainer = port_model(flat, train_cfg=TrainConfig(lr=1e-2))
    val = synthetic.make_dataset(12, 1000)
    batch = next(packed_batches(synthetic.make_dataset(8, 999), B, shuffle=False))
    dev = {k: torch.from_numpy(val.take(np.arange(8))[k]) for k in
           ("image", "overlap", "scene", "ious")}

    def fresh_ids():
        fresh = api.get_model(cfg=PORT_CFG, device="cpu")
        fresh.load_state_dict(trainer.model.state_dict(), strict=True)
        return make_eval_step(fresh)(dev)

    step = make_eval_step(trainer.model)
    before = step(dev)
    assert torch.equal(before, fresh_ids()) and trainer.model.training
    trainer.model.decoder.fused_weights()  # the cached tables of the weights before the step
    trainer(batch)
    after = step(dev)
    assert torch.equal(after, fresh_ids()) and trainer.model.training
    assert not torch.equal(after, before)

    checkpoint.save_checkpoint(str(tmp_path), port_model(flat))
    checkpoint.restore_checkpoint(str(tmp_path), trainer)
    assert torch.equal(step(dev), before) and torch.equal(before, fresh_ids())


# --- the loop ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_data", [True, False])
def test_loop_matches_jax(device_data, weights, jax_runs, data, tmp_path, monkeypatch):
    """``train/loop.train`` against JAX ``train/loop.train`` from the same
    weights and data, with device data (blocks of 2 steps, the last one
    cut to 1 by the limit) and through the host prefetcher: the same step
    count (7), the same batches in the same order, the same CSV rows (iter
    and val_acc equal; cost_avg and train_acc within 1e-4), a checkpoint
    after the first validation, and each parameter's update over the run
    within UPDATE_TOL (all of them) and TENSOR_UPDATE_TOL (each tensor) of
    JAX's, relative to JAX's."""
    want = jax_runs[device_data]
    cfg = Config(experiment="t", model=PORT_CFG,
                 train=TrainConfig(**LOOP, device_data=device_data), results_dir=str(tmp_path))
    trainer = port_model(weights)
    seen = []
    real = type(trainer).__call__
    monkeypatch.setattr(type(trainer), "__call__",
                        lambda self, b: seen.append(np.asarray(b["text"])) or real(self, b))
    loop.train(cfg, trainer, *data, verbose=False)

    train, _ = data
    if device_data:
        orders = [np.random.default_rng(999 + e).permutation(32)[:k * B]
                  for e, k in ((0, 4), (1, 3))]
    else:
        orders = []
        for e, k in ((0, 4), (1, 3)):
            rng = np.random.default_rng(999 + e)
            o = np.arange(32)
            rng.shuffle(o)
            orders.append(o[:k * B])
    np.testing.assert_array_equal(np.concatenate(seen), train.text[np.concatenate(orders)])

    assert trainer.step_count == want["step"] == 7
    got_log = read_log(tmp_path / "t_training_log.csv")
    assert [r["iter"] for r in got_log] == [r["iter"] for r in want["log"]]
    assert [r["iter"] for r in got_log] == ["0", "4" if device_data else "3"]
    assert [r["val_acc"] for r in got_log] == [r["val_acc"] for r in want["log"]]
    for g, w in zip(got_log[1:], want["log"][1:]):
        assert abs(float(g["cost_avg"]) - float(w["cost_avg"])) <= COST_TOL
        assert abs(float(g["train_acc"]) - float(w["train_acc"])) <= COST_TOL
    assert want["saved"] and os.path.exists(tmp_path / "models" / "t" / checkpoint.STATE_FILE)
    before, state = convert.bundle_to_state_dict(weights), trainer.model.state_dict()
    err2 = norm2 = 0.0
    for k, w in want["params"].items():
        d_jax, d_port = w - before[k], state[k] - before[k]
        e, n = (d_port - d_jax).norm().item(), d_jax.norm().item()
        assert n > 0 and d_port.norm().item() > 0, k
        assert e <= TENSOR_UPDATE_TOL * n, (k, e / n)
        err2, norm2 = err2 + e * e, norm2 + n * n
    assert (err2 / norm2) ** 0.5 <= UPDATE_TOL


def test_a_failing_step_ends_the_prefetcher(tmp_path, data, monkeypatch):
    """A step that raises on the host route: the error reaches the caller
    and the prefetcher's thread has ended (it had filled its queue and
    waited to put the epoch's end)."""
    made = []

    class Spy(loop.Prefetcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    def fail(self, batch):
        raise RuntimeError("the step failed")

    monkeypatch.setattr(loop, "Prefetcher", Spy)
    trainer = port_model(random_bundle(PORT_CFG, 69))
    monkeypatch.setattr(type(trainer), "__call__", fail)
    cfg = Config(experiment="f", model=PORT_CFG,
                 train=TrainConfig(**LOOP, device_data=False), results_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="the step failed"):
        loop.train(cfg, trainer, *data, verbose=False)
    assert len(made) == 1 and not made[0].thread.is_alive()


# --- checkpoints ------------------------------------------------------------------------


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """Two steps, a save, two more, against a second trainer that took a
    step of its own (other weights, moments and dropout draws), restored
    the checkpoint and took the same two steps: parameters, running
    statistics, AdamW moments, count and the next dropout draws are
    bit-equal, as are the two steps' metrics.  Dropout 0.1."""
    cfg = dataclasses.replace(PORT_CFG, dropout=0.1)
    flat = random_bundle(cfg, 63)
    tc = TrainConfig(lr=1e-3, seed=5)
    packed = synthetic.make_dataset(32, 999)
    bs = list(packed_batches(packed, B, shuffle=True, seed=3))
    a = port_model(flat, cfg, tc)
    a(bs[0])
    a(bs[1])
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(path, a)
    ma = [a(bs[2]), a(bs[3])]

    b = port_model(random_bundle(cfg, 64), cfg, TrainConfig(lr=1e-3, seed=6))
    b(bs[1])
    checkpoint.restore_checkpoint(path, b)
    assert b.step_count == 2
    mb = [b(bs[2]), b(bs[3])]
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in x)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(x, y) for x, y in zip(a.optimizer.mu + a.optimizer.nu,
                                                 b.optimizer.mu + b.optimizer.nu))
    assert a.step_count == b.step_count == 4
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_resumed_loop_starts_from_the_restored_step(tmp_path, data):
    trainer = port_model(random_bundle(PORT_CFG, 65))
    trainer(next(packed_batches(data[0], B, shuffle=False)))
    checkpoint.save_checkpoint(str(tmp_path / "c"), trainer)
    resumed = checkpoint.restore_checkpoint(str(tmp_path / "c"),
                                            port_model(random_bundle(PORT_CFG, 66)))
    cfg = Config(experiment="r", model=PORT_CFG, train=TrainConfig(**LOOP),
                 results_dir=str(tmp_path))
    loop.train(cfg, resumed, *data, verbose=False)
    assert resumed.step_count == 7
    assert [r["iter"] for r in read_log(tmp_path / "r_training_log.csv")] == ["0", "3"]


def test_params_bundle_round_trip_into_jax(tmp_path, jax_model):
    """``save_params_bundle`` (fp16 where the values fit, ``__step__``)
    read back by JAX ``restore_params_bundle``: JAX's greedy logits equal
    the port's, from the same bundle, within 1e-5 of their scale
    (measured 1.2e-6); a float32 array that would overflow fp16 stays
    float32."""
    trainer = port_model(random_bundle(PORT_CFG, 67))
    with torch.no_grad():
        trainer.model.decoder.emb_to_classes.bias[0] = 1e5  # beyond fp16's range
    path = str(tmp_path / "b.params.npz")
    checkpoint.save_params_bundle(path, trainer.model, step_count=12)
    with np.load(path) as z:
        assert int(z["__step__"]) == 12
        assert z["params.decoder.emb_to_classes.bias"].dtype == np.float32
        assert z["params.decoder.emb_to_classes.kernel"].dtype == np.float16
    model = api.get_model(cfg=PORT_CFG, device="cpu", seed=1)
    assert checkpoint.restore_params_bundle(path, model) == 12

    v = unflatten(random_bundle(PORT_CFG, 68))
    template = TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=None)
    state = jcheckpoint.restore_params_bundle(path, template)
    assert int(state.step) == 12
    val = synthetic.make_dataset(4, 1000)
    img = val.image.astype(np.float32) / 255.0
    want = np.asarray(jax.jit(lambda var: jax_model.apply(
        var, img, None, val.overlap, val.scene, val.ious, train=False))(state.variables()))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(val.overlap).long(),
                    scene=torch.from_numpy(val.scene).long(),
                    ious=torch.from_numpy(val.ious)).numpy()
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-5 * scale


# --- the api verbs -----------------------------------------------------------------------


API_CFG = Config(model=PORT_CFG, train=TrainConfig(batch_size=8, epochs=1, validation_steps=4),
                 data=DataConfig(synthetic_train_size=32, synthetic_val_size=16))


def test_get_trainer_train_validate(tmp_path):
    """JAX tests/test_api.py's round: validate, train 4 steps with a
    validation at 4, validate with the per-crop DataFrame."""
    cfg = dataclasses.replace(API_CFG, results_dir=str(tmp_path))
    trainer = api.get_trainer(cfg=cfg.model, train_cfg=cfg.train, device="cpu")
    acc0 = api.validate(trainer, cfg=cfg)
    assert isinstance(acc0, float)
    trainer = api.train(trainer, "synthetic", validation_steps=4, iteration_limit=4, cfg=cfg)
    assert trainer.step_count == 4 and trainer.model.training
    pytest.importorskip("pandas")
    acc, df = api.run_validation(trainer.model, return_dataframe=True, cfg=cfg)
    assert len(df) == 16 and isinstance(acc, float)
    assert set(df.columns) >= {"anno_id", "ground_truth", "prediction", "correct"}
    assert [r["iter"] for r in read_log(tmp_path / "tpu_rebuild_training_log.csv")][0] == "0"


def test_api_validate_pads_with_zero_crops(monkeypatch):
    """``api.validate`` batches with ``Batcher`` as JAX ``api.validate``
    does: 16 crops at B=6 give two full batches and one of 4 crops and 2
    zero crops, whose rows are not counted."""
    cfg = dataclasses.replace(API_CFG, train=TrainConfig(batch_size=6))
    model = api.get_model(cfg=PORT_CFG, device="cpu")
    seen = []
    real = evaluate.validate

    def spy(step, batches, *a, **k):
        batches = list(batches)
        seen.extend(batches)
        return real(step, batches, *a, **k)

    monkeypatch.setattr(evaluate, "validate", spy)
    acc, df = (api.validate(model, cfg=cfg, return_dataframe=True)
               if _has_pandas() else (api.validate(model, cfg=cfg), None))
    assert [len(b["labels"]) for b in seen] == [6, 6, 6]
    assert seen[2]["valid"].tolist() == [True] * 4 + [False] * 2
    assert not seen[2]["image"][4:].any()
    assert df is None or len(df) == 16


def _has_pandas():
    try:
        import pandas  # noqa: F401
    except ImportError:
        return False
    return True


def test_get_dataset_dispatch(monkeypatch):
    train, val = api.get_dataset("synthetic", API_CFG)
    assert len(train) == 32 and len(val) == 16
    full_train, full_val = api.get_dataset("synthetic")
    assert (len(full_train), len(full_val)) == (4096, 512)
    np.testing.assert_array_equal(full_val.image[:16], val.image)
    # the real corpora are absent at the default paths: their loaders raise
    # as JAX's do (tests/test_torch_loaders.py holds them on the fixtures)
    for name in ("cocotext", "textocr", "cocotext_single_image_val"):
        with pytest.raises(FileNotFoundError):
            api.get_dataset(name)
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError):  # no lmdb package
        api.get_dataset("synth")
    with pytest.raises(ValueError):
        api.get_dataset("nope")


def test_evaluate_verb(tmp_path):
    """``api.evaluate`` on the synthetic set with a class list of its 2000
    object classes; without the list, no tags; the default dataset,
    cocotext, raises where its files are absent."""
    model = api.get_model(cfg=PORT_CFG, device="cpu")
    path = tmp_path / "base_errors.txt"
    path.write_text("1\n3\n5\n100000\n")
    (tmp_path / "vinvl_classes.txt").write_text("\n".join(f"c{i}" for i in range(1, 2000)))
    cfg = dataclasses.replace(API_CFG, data=dataclasses.replace(API_CFG.data,
                                                                class_labels_dir=str(tmp_path)))
    out = api.evaluate(model, str(path), dataset="synthetic", cfg=cfg)
    assert out["total"] == 3 and all(d["tags"] is not None for d in out["detail"])
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                            class_labels_dir=str(tmp_path / "x")))
    out = api.evaluate(model, str(path), dataset="synthetic", cfg=cfg)
    assert out["total"] == 3 and all(d["tags"] is None for d in out["detail"])
    with pytest.raises(FileNotFoundError):
        api.evaluate(model, str(path), cfg=cfg)


def test_verbs_need_the_card_unless_told_cpu(monkeypatch):
    """The model and the trainer the verbs run on default to the card and
    raise without one; the linear CTC model is built on the CPU, and a CTC
    recipe that lacks a part is refused with JAX ``build_codec``'s
    ValueErrors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.get_trainer(cfg=PORT_CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.get_model(cfg=PORT_CFG)
    ctc = dataclasses.replace(PORT_CFG, decoder="linear", label_codec="ctc")
    assert api.get_model(cfg=ctc, device="cpu").decoder.head.out_features == 1 + len(DEFAULT_CHARS)
    trainer = api.get_trainer(cfg=PORT_CFG, device="cpu")
    with pytest.raises(ValueError, match="label_codec"):
        api.train(trainer, cfg=dataclasses.replace(
            API_CFG, train=dataclasses.replace(API_CFG.train, loss="ctc")))
    with pytest.raises(ValueError, match="linear"):
        api.get_dataset("synthetic", dataclasses.replace(
            API_CFG, model=dataclasses.replace(PORT_CFG, label_codec="ctc"),
            train=dataclasses.replace(API_CFG.train, loss="ctc")))
    with pytest.raises(TypeError):
        api.train(trainer.model)
