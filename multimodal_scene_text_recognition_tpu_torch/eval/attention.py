"""Relevance-score introspection of the fusion MLPs (JAX counterpart:
eval/attention.py): the softmax over the objects that the pre-encoder
fusion (``pre_encoder_mlp``) gives each column and the pre-decoder fusion
(``pre_decoder_mlp``) each memory position, collected from one eval
forward and shown as a table of percentages.

The encoder and the decoder keep the scores in their ``intermediates``
dict while one is set there (None otherwise, so serving keeps nothing);
the keys are JAX's walk of its ``intermediates`` collection:
``encoder/pre_encoder_scores`` and ``decoder/pre_decoder_scores``."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..train.steps import prep_image


@torch.no_grad()
def collect_attention_scores(model, batch: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """One eval forward of ``model`` (a ``SceneTextModel``) on ``batch``
    (``image`` [B, H, W, 1] uint8 or float in [0, 1], ``overlap``,
    ``scene``, ``ious``; numpy arrays or tensors) -> ``{site path: [B, T,
    O] float32 array}`` for every fusion site that is on (none: ``{}``)."""
    device = next(model.parameters()).device
    parts = {k: torch.as_tensor(batch[k]).to(device) for k in ("image", "overlap", "scene", "ious")}
    holders = {"encoder": model.encoder, "decoder": model.decoder}
    holders = {k: m for k, m in holders.items() if hasattr(m, "intermediates")}
    was_training = model.training
    model.eval()
    for m in holders.values():
        m.intermediates = {}
    try:
        model(prep_image(parts["image"]), parts["overlap"].long(), scene=parts["scene"].long(),
              ious=parts["ious"].float())
        return {f"{path}/{name}": scores.float().cpu().numpy()
                for path, m in holders.items() for name, scores in m.intermediates.items()}
    finally:
        for m in holders.values():
            m.intermediates = None
        model.train(was_training)


def format_scores(scores: np.ndarray, sample: int = 0, max_rows: int = 26, max_objs: int = 25):
    """A pandas table of sample ``sample``'s scores [T, O]: a row a
    position (at most ``max_rows``), a column an object (at most
    ``max_objs``), percentages rounded to 2 places.  pandas is imported
    here only."""
    import pandas as pd

    s = np.asarray(scores)[sample][:max_rows, :max_objs]
    return pd.DataFrame(np.round(s * 100, 2))


def print_attention_scores(model, batch: Mapping[str, Any], sample: int = 0) -> None:
    """Print each site's table for sample ``sample``."""
    for site, scores in collect_attention_scores(model, batch).items():
        print(f"--- {site}")
        print(format_scores(scores, sample))
