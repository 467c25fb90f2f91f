"""Entry point: build the served model, with the trained weights or random
ones (JAX counterpart: api.get_model)."""

from __future__ import annotations

from typing import Optional

import torch

from . import convert
from .config import FLAGSHIP, ModelConfig
from .models.model import SceneTextModel, init_random


def get_model(bundle_path: Optional[str] = None, cfg: Optional[ModelConfig] = None,
              device: str = "cuda", seed: int = 0) -> SceneTextModel:
    """The flagship recognizer (bf16, fused decode) in eval mode on ``device``.

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
    return model.eval().requires_grad_(False)
