"""Entry points: the served model and the trainer of the flagship, with the
trained weights or random ones (JAX counterpart: api.get_model)."""

from __future__ import annotations

from typing import Optional

import torch

from . import convert
from .config import FLAGSHIP, ModelConfig, TrainConfig
from .models.model import SceneTextModel, init_random
from .train.steps import TrainStep


def get_model(bundle_path: Optional[str] = None, cfg: Optional[ModelConfig] = None,
              device: str = "cuda", seed: int = 0, train: bool = False) -> SceneTextModel:
    """The recognizer of ``cfg`` (default the flagship: bf16, fused decode)
    on ``device``: in eval mode with gradients off, or with ``train=True``
    in train mode with gradients on.

    ``bundle_path``: a JAX ``.params.npz`` bundle, loaded strictly (every
    weight of the model must come from it).  Without one the weights are
    random, drawn from a ``torch.Generator`` seeded with ``seed``.
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
