"""The train step: forward (train) -> loss -> backward -> clip -> AdamW,
with the BatchNorm running statistics updated by the forward (JAX
counterpart: train/steps.py, the cross-entropy path of
``make_train_step``)."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

from ..charset import GO_ID, PAD_ID
from ..config import TrainConfig
from .state import make_optimizer


def prep_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 crops (the wire format) -> float32 in [0, 1]; float crops as
    they are."""
    if image.dtype == torch.uint8:
        return image.float() / 255.0
    return image


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, counts_pad: bool = True,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy: [GO] targets are masked, [PAD] targets
    are counted unless ``counts_pad=False``.  ``label_smoothing`` mixes
    ``label_smoothing / C`` into every class, as optax's soft-label form."""
    mask = targets != GO_ID
    if not counts_pad:
        mask &= targets != PAD_ID
    logp = F.log_softmax(logits.float(), dim=-1)
    if label_smoothing > 0:
        n = logits.shape[-1]
        soft = F.one_hot(targets, n).float() * (1 - label_smoothing) + label_smoothing / n
        losses = -(soft * logp).sum(dim=-1)
    else:
        losses = -logp.gather(-1, targets[..., None])[..., 0]
    mask = mask.float()
    return (losses * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Share of non-[GO] targets that the teacher-forced argmax hits."""
    valid = targets != GO_ID
    hits = ((logits.argmax(dim=-1) == targets) & valid).sum()
    return hits / torch.clamp(valid.sum(), min=1)


class TrainStep:
    """Owns the model, its optimizer, the step count and the dropout
    generator (on the model's device, seeded with ``cfg.seed``).
    ``steps_per_epoch`` scales the StepLR boundaries, which ``cfg`` counts
    in epochs (the JAX loop passes ``n_train // batch_size``).

    ``step(batch)`` takes a batch in the JAX pipeline's wire format: numpy
    arrays or tensors ``image`` uint8 [B, H, W, 1] (or float in [0, 1]),
    ``text`` [B, max_text_length + 2] label rows, ``overlap`` [B, n] ids,
    and where present ``scene`` [B, m] ids and ``ious`` [B, m] float32
    (else the JAX defaults: no scene objects); other keys are ignored.  It
    returns 0-dim tensors on the device (not synchronised): ``loss``,
    ``token_acc`` and ``grad_norm`` (before the clip)."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1):
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.optimizer = make_optimizer(model.parameters(), cfg, steps_per_epoch)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    @property
    def step_count(self) -> int:
        return self.optimizer.count

    def __call__(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        image = prep_image(torch.as_tensor(batch["image"]).to(self.device))
        text = torch.as_tensor(batch["text"]).to(self.device, torch.long)
        overlap = torch.as_tensor(batch["overlap"]).to(self.device, torch.long)
        scene, ious = batch.get("scene"), batch.get("ious")
        if scene is not None:
            scene = torch.as_tensor(scene).to(self.device, torch.long)
        if ious is not None:
            ious = torch.as_tensor(ious).to(self.device, torch.float32)
        text_in, targets = text[:, :-1], text[:, 1:]

        self.model.train()
        self.optimizer.zero_grad()
        with self.model.precision():  # the backward too
            logits = self.model(image, overlap, text_in, train=True, generator=self.generator,
                                scene=scene, ious=ious)
            loss = cross_entropy(logits, targets, self.cfg.loss_counts_pad,
                                 self.cfg.label_smoothing)
            loss.backward()
        grad_norm = self.optimizer.step()
        with torch.no_grad():
            acc = token_accuracy(logits, targets)
        return {"loss": loss.detach(), "token_acc": acc, "grad_norm": grad_norm}
