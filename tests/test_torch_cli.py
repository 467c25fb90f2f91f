"""The PyTorch port's command line (``cli.py``) and its dotted overrides
(``config.apply_overrides``) against the JAX package's on the CPU: both
command lines validate and evaluate one reference ``.pth`` on the first 64
crops of the committed validation set (JAX renders them with PIL at their
seed, and they equal the committed ones: tests/test_torch_data.py) and on
the COCO-Text fixtures, and recognize a folder of crop files with it; the
port's ``train`` writes a checkpoint its ``validate`` reads back."""

import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from multimodal_scene_text_recognition_tpu import cli as jcli
from multimodal_scene_text_recognition_tpu.core import config as jconfig
from multimodal_scene_text_recognition_tpu.core.config import ModelConfig as JModelConfig
from multimodal_scene_text_recognition_tpu.models.model import build_model
from multimodal_scene_text_recognition_tpu.train import state as jstate
from multimodal_scene_text_recognition_tpu_torch import api, cli, config
from multimodal_scene_text_recognition_tpu_torch.train.checkpoint import restore_checkpoint
from multimodal_scene_text_recognition_tpu_torch.utils.images import save_image
import loader_fixtures as lf
from test_torch_reference_import import reference_state_dict
from test_torch_resize import jax_native_library  # noqa: F401  (autouse: JAX's private build)
from test_torch_variants import fast_variables
import torch_threads

torch_threads.limit()

# small widths, no TPS, one layer each, float32; 64 crops in batches of 32
WIDTHS = dict(use_tps=False, enc_layers=1, dec_layers=1, ff_dim=64, hidden_dim=64,
              embed_dim=32, num_heads=4, compute_dtype="float32")
SETS = [x for k, v in WIDTHS.items() for x in ("--set", f"model.{k}={v}")] + [
    "--set", "train.batch_size=32", "--set", "data.synthetic_train_size=64",
    "--set", "data.synthetic_val_size=64"]


@pytest.mark.parametrize("item", [
    "model.enc_layers=3", "train.lr=3e-4", "model.use_tps=false", "model.use_tps=YES",
    "model.encoder=lstm", "train.iteration_limit=5", "train.iteration_limit=none",
    "train.lr_step_size=2.5", "train.lr_step_size=steps", "saved_model=ref.pth",
    "experiment= exp1 ", "data.synthetic_val_size=64", "model.dropout=0",
])
def test_apply_overrides_matches_jax(item):
    """One ``key=value`` item (int, float, bool, string, ``Optional`` and
    nested fields) gives the field the value and type JAX gives it, and
    leaves every other field as it was."""
    key = item.split("=", 1)[0].strip()
    got = config.apply_overrides(config.Config(), [item])
    want = jconfig.apply_overrides(jconfig.Config(), [item])

    def field(cfg):
        for part in key.split("."):
            cfg = getattr(cfg, part)
        return cfg

    assert field(got) == field(want) and type(field(got)) is type(field(want))
    base = dataclasses.asdict(config.Config())
    new = dataclasses.asdict(got)
    head, _, leaf = key.rpartition(".")
    (new[head] if head else new).pop(leaf)
    (base[head] if head else base).pop(leaf)
    assert new == base


def test_apply_overrides_refuses_as_jax():
    """An item without ``=`` raises ValueError, an unknown field
    AttributeError; a dict takes non-string values as they are."""
    for mod in (config, jconfig):
        with pytest.raises(ValueError, match="key=value"):
            mod.apply_overrides(mod.Config(), ["model.encoder"])
        with pytest.raises(AttributeError):
            mod.apply_overrides(mod.Config(), ["model.no_such_field=1"])
    got = config.apply_overrides(config.Config(), {"train.iteration_limit": 7,
                                                   "model.chars": "abc"})
    assert got.train.iteration_limit == 7 and got.model.num_classes == 6


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """A reference ``.pth`` of a seeded draw of the JAX model of WIDTHS."""
    v = fast_variables(build_model(JModelConfig(**WIDTHS)), 71)
    path = tmp_path_factory.mktemp("ref") / "ref.pth"
    torch.save(reference_state_dict(v), path)
    return str(path)


@pytest.fixture
def jax_state_from_a_draw(monkeypatch):
    """JAX ``create_train_state`` (which its command line calls before the
    import) initializes the model op by op, ~28 s of XLA compiles on the
    CPU; this gives it the same tree from a seeded draw traced by
    ``jax.eval_shape`` instead, and no optimizer state (validate and
    evaluate read none).  The import overwrites every weight the model
    reads; the skipped semantic embed is unread at these switches."""
    def create(model, tx, sample_batch, rng):
        v = fast_variables(model, 72)
        return jstate.TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                                 opt_state=None)

    monkeypatch.setattr(jstate, "create_train_state", create)


def _run(main, argv, capsys, **kw):
    assert main(argv, **kw) == 0
    return capsys.readouterr().out.splitlines()


def _line(lines, start):
    return next(x for x in lines if x.startswith(start))


def test_validate_and_evaluate_match_jax(pth, tmp_path, capsys, jax_state_from_a_draw):
    """``validate --checkpoint ref.pth --records`` in both command lines:
    the same accuracy line and the same records, row by row; the same
    import stats; then ``evaluate --base-errors`` on the anno ids of the
    first 40 crops: the same "Corrected" line."""
    out = {}
    for name, main, kw in (("jax", jcli.main, {}), ("port", cli.main, {"device": "cpu"})):
        records = str(tmp_path / f"{name}.csv")
        out[name] = _run(main, ["validate", "--checkpoint", pth, "--records", records] + SETS,
                         capsys, **kw)
    for start in ("val accuracy", "  - imported torch checkpoint"):
        assert _line(out["port"], start) == _line(out["jax"], start)
    import pandas as pd

    want = pd.read_csv(tmp_path / "jax.csv", keep_default_na=False)
    got = pd.read_csv(tmp_path / "port.csv", keep_default_na=False)
    assert len(got) == 64 and list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got, want)

    base = tmp_path / "base_errors.txt"
    base.write_text("\n".join(str(i) for i in got["anno_id"][:40]) + "\n")
    # no class labels: the committed set's object ids run to 1999, past
    # every class list in assets/features, where both packages' tags_for
    # raise IndexError
    argv = ["evaluate", "--checkpoint", pth, "--base-errors", str(base),
            "--set", f"data.class_labels_dir={tmp_path}"] + SETS
    lines = {}
    for name, main, kw in (("jax", jcli.main, {}), ("port", cli.main, {"device": "cpu"})):
        lines[name] = _line(_run(main, argv, capsys, **kw), "Corrected")
    assert lines["port"] == lines["jax"]
    assert lines["port"] == f"Corrected: {int(got['correct'][:40].sum())} / 40"


def test_train_writes_a_checkpoint_that_validate_reads(pth, tmp_path, capsys):
    """``train`` from the ``.pth`` takes 2 steps and saves the full state
    at its validation (a threshold below 0% lets the random model's save);
    ``validate --checkpoint`` on that directory prints the accuracy that
    ``api.validate`` gives of a trainer restored from it."""
    argv = SETS + ["--set", f"results_dir={tmp_path}", "--set", "train.iteration_limit=2",
                   "--set", "train.validation_steps=2", "--set", "train.model_save_threshold=-1",
                   "--experiment", "cli"]
    lines = _run(cli.main, ["train", "--checkpoint", pth] + argv, capsys, device="cpu")
    assert "--- Iteration limit reached: 2" in lines and "  - New best model saved" in lines
    ckpt = os.path.join(tmp_path, "models", "cli")
    assert os.path.exists(os.path.join(ckpt, "train_state.pt"))
    acc = _line(_run(cli.main, ["validate", "--checkpoint", ckpt] + argv, capsys,
                     device="cpu"), "val accuracy")

    cfg = config.apply_overrides(config.Config(experiment="cli"),
                                 [a for a in argv[:-2] if a != "--set"])
    trainer = api.get_trainer(None, cfg.model, cfg.train, device="cpu")
    restore_checkpoint(ckpt, trainer)
    assert trainer.step_count == 2
    assert acc == f"val accuracy: {api.validate(trainer, cfg=cfg)}%"


def test_validate_dumps_the_fusion_scores(capsys):
    """``validate --dump-attention`` prints each fusion site's table of the
    first batch before the accuracy (the pre-encoder fusion here)."""
    lines = _run(cli.main, ["validate", "--dump-attention", "--set", "model.pre_encoder_mlp=true"]
                 + SETS, capsys, device="cpu")
    i = lines.index("--- encoder/pre_encoder_scores")
    assert i < lines.index(_line(lines, "val accuracy"))


FIXTURE_SETS = [x for k, v in lf.fixture_config(jax=False).data.__dict__.items()
                if k.startswith(("cocotext", "textocr")) for x in ("--set", f"data.{k}={v}")]


def test_validate_on_cocotext_matches_jax(pth, tmp_path, capsys, jax_state_from_a_draw):
    """``validate --dataset cocotext`` on the fixtures (pages decoded,
    words cropped, vectors from the object tags) in both command lines: the
    same dataset line, accuracy line and records."""
    out = {}
    for name, main, kw in (("jax", jcli.main, {}), ("port", cli.main, {"device": "cpu"})):
        records = str(tmp_path / f"{name}.csv")
        out[name] = _run(main, ["validate", "--dataset", "cocotext", "--checkpoint", pth,
                                "--records", records] + SETS + FIXTURE_SETS, capsys, **kw)
    for start in ("  - cocotext:", "val accuracy", "  - imported torch checkpoint"):
        assert _line(out["port"], start) == _line(out["jax"], start)
    import pandas as pd

    want = pd.read_csv(tmp_path / "jax.csv", keep_default_na=False)
    got = pd.read_csv(tmp_path / "port.csv", keep_default_na=False)
    assert len(got) == 36
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("beam", [0, 3], ids=["greedy", "beam 3"])
def test_recognize_matches_jax(pth, tmp_path, capsys, jax_state_from_a_draw, beam):
    """``recognize <folder>`` greedily and by beam search in both command
    lines: a folder of 20 committed crops written as PNG by the port's
    ``save_image`` and fixture JPEGs of other sizes, in subfolders; the
    same lines, one ``path<TAB>text`` a file in natural order."""
    val = api.get_dataset("synthetic", config.apply_overrides(
        config.Config(), ["data.synthetic_val_size=20"]))[1]
    (tmp_path / "sub").mkdir()
    for i in range(20):
        save_image(val.image[i].astype(np.float32) / 255.0,
                   str(tmp_path / ("sub" if i % 3 else "") / f"w{i}.png"))
    for name in lf.crop_files()[:4]:
        shutil.copy(lf.OUT / "crops" / name, tmp_path / name)
    argv = ["recognize", str(tmp_path), "--checkpoint", pth, "--beam", str(beam)] + SETS
    lines = {}
    for name, main, kw in (("jax", jcli.main, {}), ("port", cli.main, {"device": "cpu"})):
        lines[name] = _run(main, argv, capsys, **kw)
    assert lines["port"] == lines["jax"]
    rows = [x.split("\t") for x in lines["port"] if "\t" in x]
    assert len(rows) == 24 and rows[0][0].endswith("crop_00.jpg")


def test_recognize_an_empty_folder(tmp_path, capsys):
    """No image under the folder: the message and exit code 1, as JAX's."""
    assert cli.main(["recognize", str(tmp_path)], device="cpu") == 1
    assert capsys.readouterr().out == "no images found\n"


@pytest.mark.parametrize("name", ["cocotext", "textocr", "synth"])
def test_unported_dataset_exits_with_its_message(name, monkeypatch):
    """Where a corpus's files are missing, both command lines stop alike:
    COCO-Text and TextOCR exit with the JAX command line's message, which
    names the ``--set`` keys that point at them; "synth" raises where the
    ``lmdb`` package is missing (as on both test machines), as JAX's
    does."""
    monkeypatch.setitem(sys.modules, "lmdb", None)
    stops = []
    for main, kw in ((jcli.main, {}), (cli.main, {"device": "cpu"})):
        with pytest.raises((SystemExit, ImportError)) as e:
            main(["validate", "--dataset", name], **kw)
        stops.append((type(e.value), str(e.value)))
    assert stops[1] == stops[0]
    if name == "synth":
        assert issubclass(stops[1][0], ImportError)
    else:
        assert stops[1][0] is SystemExit and f"{name} dataset unavailable" in stops[1][1]
        assert f"data.{name}_" in stops[1][1]


def test_refusals():
    """An unknown dataset raises ValueError (the API's
    "cocotext_single_image_val" too, as in JAX's command line), a closed
    vocabulary (no committed set holds one) the set's ValueError, and with
    no GPU ``main`` without ``device="cpu"`` raises rather than run on the
    CPU."""
    for name in ("nope", "cocotext_single_image_val"):
        with pytest.raises(ValueError, match="unknown dataset"):
            cli.main(["validate", "--dataset", name], device="cpu")
    with pytest.raises(ValueError, match="closed vocabulary of 100 words"):
        cli.main(["validate", "--set", "data.synthetic_vocab_size=100"], device="cpu")
    if not torch.cuda.is_available():
        for argv in (["validate"], ["recognize", "."]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(argv)
