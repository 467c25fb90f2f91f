"""Entry points: the served model and the trainer of the flagship, with the
trained weights or random ones, and the verbs that train and validate them
on a dataset (JAX counterpart: api.py: ``get_model``, ``get_dataset``,
``train``, ``validate``, ``evaluate``).  The model and the trainer live on
the card unless the caller passes ``device="cpu"``; the verbs run on their
device."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from . import convert
from .charset import AttnCodec
from .config import FLAGSHIP, Config, ModelConfig, TrainConfig
from .models.model import SceneTextModel, init_random
from .train.steps import TrainStep, make_eval_step


def get_model(bundle_path: Optional[str] = None, cfg: Optional[ModelConfig] = None,
              device: str = "cuda", seed: int = 0, train: bool = False) -> SceneTextModel:
    """The recognizer of ``cfg`` (default the flagship: bf16, fused decode)
    on ``device``: in eval mode with gradients off, or with ``train=True``
    in train mode with gradients on.

    ``bundle_path``: a JAX ``.params.npz`` bundle, loaded strictly (every
    weight of the model must come from it), and kept as ``model.bundle_path``
    (an int8 ``Recognizer`` finds the persisted activation scales beside
    it).  Without one the weights are random, drawn from a
    ``torch.Generator`` seeded with ``seed``.
    ``device`` defaults to the card; pass ``"cpu"`` explicitly for the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("get_model: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    cfg = cfg or FLAGSHIP
    with torch.device("meta"):
        model = SceneTextModel(cfg)
    model.to_empty(device=device)
    if bundle_path is not None:
        model.load_state_dict(convert.bundle_to_state_dict(convert.load_bundle(bundle_path)),
                              strict=True)
    else:
        init_random(model, torch.Generator().manual_seed(seed))
    model.bundle_path = bundle_path
    if train:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)


def get_trainer(bundle_path: Optional[str] = None, cfg: Optional[ModelConfig] = None,
                train_cfg: Optional[TrainConfig] = None, device: str = "cuda",
                seed: int = 0, steps_per_epoch: int = 1) -> TrainStep:
    """A :class:`~.train.steps.TrainStep` over :func:`get_model` (the same
    arguments, in train mode) with ``train_cfg`` (default ``TrainConfig()``)
    and ``steps_per_epoch`` (the StepLR boundaries count epochs): call it
    on a batch to take one optimizer step."""
    model = get_model(bundle_path, cfg, device=device, seed=seed, train=True)
    return TrainStep(model, train_cfg or TrainConfig(), steps_per_epoch)


def get_dataset(name: str = "synthetic", cfg: Optional[Config] = None):
    """``(train, val)`` :class:`~.data.pipeline.PackedSamples` of dataset
    ``name``, host arrays (the verbs move batches to their model's device).
    "synthetic": the committed sets, ``cfg.data.synthetic_train_size`` crops
    at ``cfg.train.seed`` and ``synthetic_val_size`` at ``seed + 1``, label
    rows in the codec of ``cfg``'s recipe (``train.loop.build_codec``)."""
    from .train.loop import build_codec

    cfg = cfg or Config()
    codec = build_codec(cfg)
    return _dataset(name, cfg, "train", codec), _dataset(name, cfg, "val", codec)


def _dataset(name: str, cfg: Config, split: str, codec):
    if name == "synthetic":
        from .data.synthetic import make_dataset

        size, seed = ((cfg.data.synthetic_train_size, cfg.train.seed) if split == "train"
                      else (cfg.data.synthetic_val_size, cfg.train.seed + 1))
        return make_dataset(size, seed, codec, cfg.data.synthetic_cache_dir or None,
                            vocab_size=cfg.data.synthetic_vocab_size)
    if name in ("cocotext", "textocr", "synth", "cocotext_single_image_val"):
        raise NotImplementedError(f"dataset {name!r}: its loader is not ported yet; the port "
                                  "trains and validates on the committed synthetic set")
    raise ValueError(f"unknown dataset {name!r}")


def _config(model: SceneTextModel, train_cfg: Optional[TrainConfig],
            cfg: Optional[Config]) -> Config:
    if cfg is None:
        return Config(model=model.cfg, train=train_cfg or TrainConfig())
    if cfg.model != model.cfg:
        raise ValueError("cfg.model is not the model's configuration")
    return cfg


def train(trainer: TrainStep, dataset: str = "synthetic", validation_steps: int = 2000,
          iteration_limit: Optional[int] = None, cfg: Optional[Config] = None) -> TrainStep:
    """Train ``trainer`` (from :func:`get_trainer`) on ``dataset`` with
    ``train.loop.train``, validating every ``validation_steps`` steps and
    stopping after ``iteration_limit``; ``cfg`` defaults to the trainer's
    model and train configurations.  Returns the trainer."""
    from .train.loop import train as train_loop

    if not isinstance(trainer, TrainStep):
        raise TypeError("train takes a TrainStep (api.get_trainer)")
    cfg = _config(trainer.model, trainer.cfg, cfg)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, validation_steps=validation_steps, iteration_limit=iteration_limit))
    train_samples, val_samples = get_dataset(dataset, cfg)
    return train_loop(cfg, trainer, train_samples, val_samples)


def _model_of(model: Union[SceneTextModel, TrainStep]) -> SceneTextModel:
    return model.model if isinstance(model, TrainStep) else model


def _val_batches(model, dataset: str, cfg: Optional[Config]):
    from .data.pipeline import Batcher, batches

    cfg = _config(model, None, cfg)
    # AttnCodec whatever the recipe, as the JAX package's validate and
    # evaluate decode (a CTC model's strings come from the training loop's
    # validation, or from eval.evaluate.validate given a CTCCodec)
    codec = AttnCodec(cfg.model.chars, cfg.model.max_text_length)
    val_samples = _dataset(dataset, cfg, "val", codec)  # the training set is not loaded
    return cfg, codec, batches(val_samples, Batcher(codec, cfg.train.batch_size),
                               shuffle=False, drop_last=False)


def validate(model: Union[SceneTextModel, TrainStep], dataset: str = "synthetic",
             print_samples: bool = False, return_dataframe: bool = False,
             cfg: Optional[Config] = None) -> Union[float, Tuple[float, object]]:
    """Greedy validation of ``model`` (or a trainer's) on ``dataset``'s
    validation set in batches of ``cfg.train.batch_size``, the short last
    one padded with zero crops: the word accuracy in percent, or with ``return_dataframe``
    ``(accuracy, DataFrame of the per-crop records)`` (needs pandas).  The
    ids are decoded by ``AttnCodec`` whatever ``label_codec`` says, as the
    JAX package's ``validate`` decodes them."""
    from .eval.evaluate import validate as run

    model = _model_of(model)
    _, codec, val_iter = _val_batches(model, dataset, cfg)
    result = run(make_eval_step(model), val_iter, codec, print_samples=print_samples,
                 return_records=return_dataframe)
    if return_dataframe:
        return result.accuracy, result.to_dataframe()
    return result.accuracy


run_validation = validate  # the reference's name


def evaluate(model: Union[SceneTextModel, TrainStep], base_errors_path: str,
             dataset: str = "cocotext", print_sem: bool = False,
             cfg: Optional[Config] = None):
    """The error-correction study (``eval.evaluate.error_diff_eval``) of
    ``model`` on ``dataset``'s validation set against the anno ids, one a
    line, in ``base_errors_path``; object tags from
    ``cfg.data.class_labels_dir/<semantic_source>_classes.txt`` where it
    exists."""
    from .eval.evaluate import error_diff_eval, load_class_labels

    model = _model_of(model)
    cfg, codec, val_iter = _val_batches(model, dataset, cfg)
    with open(base_errors_path) as f:
        base_errors = set(f.read().splitlines())
    try:
        labels = load_class_labels(cfg.data.class_labels_dir, cfg.model.semantic_source)
    except OSError:
        labels = None
    return error_diff_eval(make_eval_step(model), val_iter, codec, base_errors,
                           class_labels=labels, semantic_vector=cfg.model.semantic_vector,
                           print_sem=print_sem)
