"""The train step: forward (train) -> loss -> backward -> clip -> AdamW,
with the BatchNorm running statistics updated by the forward; and the
greedy eval step of validation (JAX counterpart: train/steps.py,
``make_train_step`` with its cross-entropy and CTC losses, and
``make_eval_step``).  Over a mesh of processes (``parallel/mesh.py``):
:func:`shard_train_step`, :func:`shard_eval_step` and
:func:`shard_beam_step`, JAX's steps of the same names."""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..charset import BLANK_ID, GO_ID, PAD_ID
from ..config import TrainConfig
from ..models.layers import BatchRows
from ..parallel.mesh import Mesh, all_gather, all_reduce, shard_batch, split_dims
from .state import make_lr_schedule, make_optimizer


def prep_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 crops (the wire format) -> float32 in [0, 1]; float crops as
    they are."""
    if image.dtype == torch.uint8:
        return image.float() / 255.0
    return image


def token_mask(targets: torch.Tensor, counts_pad: bool = True) -> torch.Tensor:
    """The targets the cross-entropy counts: not [GO], and not [PAD] unless
    ``counts_pad``."""
    mask = targets != GO_ID
    if not counts_pad:
        mask &= targets != PAD_ID
    return mask


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, counts_pad: bool = True,
                  label_smoothing: float = 0.0,
                  total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy: [GO] targets are masked, [PAD] targets
    are counted unless ``counts_pad=False``.  ``label_smoothing`` mixes
    ``label_smoothing / C`` into every class, as optax's soft-label form.
    ``total`` is the count to divide by (a sharded step's, over the whole
    batch); by default this batch's."""
    mask = token_mask(targets, counts_pad)
    logp = F.log_softmax(logits.float(), dim=-1)
    if label_smoothing > 0:
        n = logits.shape[-1]
        soft = F.one_hot(targets, n).float() * (1 - label_smoothing) + label_smoothing / n
        losses = -(soft * logp).sum(dim=-1)
    else:
        losses = -logp.gather(-1, targets[..., None])[..., 0]
    mask = mask.float()
    return (losses * mask).sum() / torch.clamp(mask.sum() if total is None else total, min=1.0)


def ctc_feasible(labels: torch.Tensor, label_lengths: torch.Tensor, T: int) -> torch.Tensor:
    """float32 [B]: 1 where a label of ``label_lengths`` ids has an
    alignment in T columns (its length plus its adjacent repeats)."""
    L = labels.shape[1]
    valid = torch.arange(L, device=labels.device)[None] < label_lengths[:, None]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & (labels[:, 1:] != BLANK_ID)
               & valid[:, 1:]).sum(dim=1)
    return ((label_lengths + repeats) <= T).float()


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, label_lengths: torch.Tensor,
             total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean CTC loss over per-column logits [B, T, C] (blank 0, the
    layout of ``charset.CTCCodec``) of 0-padded labels [B, L] with
    ``label_lengths`` [B], each row's loss its negative log-likelihood.

    A label needs ``length + adjacent repeats`` columns (a repeat takes a
    blank between its two), and a row that needs more than T has no
    alignment: it is left out of the mean, as the JAX package leaves it
    out.  PyTorch gives such a row an infinite loss, and ``inf * 0`` is NaN
    in the loss and its gradient, so ``zero_infinity`` zeroes both before
    the mask: the loss is that of the feasible rows alone, and every
    gradient finite (zero on the rows left out).  ``total`` is the count
    of feasible rows to divide by (a sharded step's); by default this
    batch's."""
    B, T, _ = logits.shape
    feasible = ctc_feasible(labels, label_lengths, T)
    logp = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # [T, B, C]
    losses = F.ctc_loss(logp, labels, torch.full((B,), T, dtype=torch.long,
                                                 device=logits.device),
                        label_lengths, blank=BLANK_ID, reduction="none", zero_infinity=True)
    count = feasible.sum() if total is None else total
    return (losses * feasible).sum() / torch.clamp(count, min=1.0)


def ctc_collapse(ids: torch.Tensor, out_len: int) -> torch.Tensor:
    """The best-path collapse on the device: per-column argmax ids [B, T]
    -> [B, out_len] rows of the kept ids (repeats merged, then blanks
    dropped), 0-padded; ids past ``out_len`` are dropped."""
    prev = F.pad(ids[:, :-1], (1, 0), value=-1)
    keep = (ids != BLANK_ID) & (ids != prev)
    pos = torch.where(keep, keep.long().cumsum(dim=1) - 1, out_len).clamp(max=out_len)
    out = torch.zeros(ids.shape[0], out_len + 1, dtype=ids.dtype, device=ids.device)
    return out.scatter(1, pos, torch.where(keep, ids, 0))[:, :out_len]


def token_hits(logits: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hits, count) float32: the non-[GO] targets that the teacher-forced
    argmax hits, and all of them."""
    valid = targets != GO_ID
    return ((logits.argmax(dim=-1) == targets) & valid).sum().float(), valid.sum().float()


def _check_loss(cfg: TrainConfig) -> None:
    if cfg.loss not in ("ce", "ctc"):
        raise ValueError(f"unknown train loss {cfg.loss!r}")


class TrainStep:
    """Owns the model, its optimizer, the step count and the generator of
    its dropout and of the ``rand`` source's semantics (on the model's
    device, seeded with ``cfg.seed``: two steps of one seed draw the same).
    ``steps_per_epoch`` scales the StepLR boundaries, which ``cfg`` counts
    in epochs (the JAX loop passes ``n_train // batch_size``).

    ``step(batch)`` takes a batch in the JAX pipeline's wire format: numpy
    arrays or tensors ``image`` uint8 [B, H, W, 1] (or float in [0, 1]),
    ``text`` label rows (``AttnCodec``'s [B, max_text_length + 2], or with
    ``cfg.loss="ctc"`` ``CTCCodec``'s [B, max_text_length]), ``overlap``
    [B, n] ids, and where present ``scene`` [B, m] ids and ``ious`` [B, m]
    float32 (else the JAX defaults: no scene objects); other keys are
    ignored.  The model reads ``text[:, :-1]`` (the linear decoder ignores
    it); the cross-entropy's targets are ``text[:, 1:]``, the CTC loss's
    labels ``text`` itself, their lengths its non-zero ids.  It returns
    0-dim tensors on the device (not synchronised): ``loss``,
    ``token_acc`` (with CTC the share of rows whose best-path collapse is
    the label) and ``grad_norm`` (before the clip).

    After :func:`shard_train_step` (``mesh`` set) it takes the whole batch
    on every rank and returns the whole batch's metrics, equal on every
    rank to the single process's."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1):
        _check_loss(cfg)
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.optimizer = make_optimizer(model.parameters(), cfg, steps_per_epoch)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.mesh: Optional[Mesh] = None
        self._split = None  # per parameter: a piece of a model-split leaf

    @property
    def step_count(self) -> int:
        return self.optimizer.count

    def configure(self, cfg: TrainConfig, steps_per_epoch: int) -> None:
        """Take the optimizer settings of ``cfg`` and StepLR boundaries
        ``steps_per_epoch`` apart (the training loop's), keeping the
        moments, the step count and the dropout generator."""
        _check_loss(cfg)
        self.cfg = cfg
        opt = self.optimizer
        opt.schedule = make_lr_schedule(cfg, steps_per_epoch)
        opt.weight_decay, opt.clip_norm = cfg.weight_decay, cfg.grad_clip_norm

    def __call__(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        mesh = self.mesh
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        image = prep_image(torch.as_tensor(batch["image"]).to(self.device))
        text = torch.as_tensor(batch["text"]).to(self.device, torch.long)
        overlap = torch.as_tensor(batch["overlap"]).to(self.device, torch.long)
        scene, ious = batch.get("scene"), batch.get("ious")
        if scene is not None:
            scene = torch.as_tensor(scene).to(self.device, torch.long)
        if ious is not None:
            ious = torch.as_tensor(ious).to(self.device, torch.float32)
        text_in, targets = text[:, :-1], text[:, 1:]
        generator, total = self.generator, None
        ctc = self.cfg.loss == "ctc"
        if mesh is not None:  # this rank's rows of the whole batch's draws and counts
            B = image.shape[0]
            generator = BatchRows(self.generator, mesh.data_rank * B, B * mesh.data)
            with torch.no_grad():
                count = (ctc_feasible(text, (text != BLANK_ID).sum(dim=1),
                                      self.model.cfg.num_cols).sum() if ctc
                         else token_mask(targets, self.cfg.loss_counts_pad).float().sum())
                total = all_reduce(count, mesh.data_group)

        self.model.train()
        self.optimizer.zero_grad()
        with self.model.precision():  # the backward too
            logits = self.model(image, overlap, text_in, train=True, generator=generator,
                                scene=scene, ious=ious)
            if ctc:
                loss = ctc_loss(logits, text, (text != BLANK_ID).sum(dim=1), total)
            else:
                loss = cross_entropy(logits, targets, self.cfg.loss_counts_pad,
                                     self.cfg.label_smoothing, total)
            loss.backward()
        grad_norm = self.optimizer.step() if mesh is None else self._sharded_update()
        with torch.no_grad():
            if ctc:
                collapsed = ctc_collapse(logits.argmax(dim=-1), text.shape[1])
                hits = (collapsed == text).all(dim=1).float().sum()
                valid = torch.tensor(float(text.shape[0]), device=hits.device)
            else:
                hits, valid = token_hits(logits, targets)
            loss = loss.detach()
            if mesh is not None:
                loss, hits, valid = all_reduce(torch.stack([loss, hits, valid]), mesh.data_group)
            acc = hits / torch.clamp(valid, min=1)
        return {"loss": loss, "token_acc": acc, "grad_norm": grad_norm}

    @torch.no_grad()
    def _sharded_update(self) -> torch.Tensor:
        """The gradients summed over the data group (one all-reduce of them
        all), their global norm (the squares of split pieces summed over
        the model group, a replicated parameter's counted once), then the
        clipped AdamW step; returns the norm."""
        params = self.optimizer.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), self.mesh.data_group)
        grads = [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in params]), params)]
        for p, g in zip(params, grads):
            p.grad = g
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        split = torch.tensor(self._split, device=sq.device)
        split_sq = all_reduce(sq[split].sum(), self.mesh.model_group)
        return self.optimizer.step(torch.sqrt(sq[~split].sum() + split_sq))


def shard_train_step(trainer: TrainStep, mesh: Mesh) -> TrainStep:
    """The train step over ``mesh`` (JAX ``shard_train_step``): the batch
    split over the data axis, each leaf that JAX's rule splits over the
    model axis cut to this rank's piece, its AdamW moments with it (JAX's
    ``opt_state`` spec).  ``trainer`` holds the whole model, the same on
    every rank (one bundle or seed), on this rank's device; it is placed in
    place and returned.  Each call takes the whole batch (the same on every
    rank; a batch the data axis does not divide raises) and returns what
    the single-process step returns on it: the loss and token accuracy of
    the whole batch, the global gradient norm and clip, BatchNorm over the
    whole batch (the two-pass K3 on the card), and dropout and ``rand``
    draws that are this rank's rows (and columns) of the single process's.
    Configurations whose split leaves have no tensor-parallel form raise
    ValueError (``parallel.tensor.parallelize``)."""
    from ..parallel.tensor import model_split, parallelize

    model, opt = trainer.model, trainer.optimizer
    named = dict(model.named_parameters())
    dims = split_dims(named, mesh.model)
    parallelize(model, mesh)
    params = list(model.parameters())

    def piece(t, name):
        d = dims.get(name)
        return t if d is None else t.chunk(mesh.model, d)[mesh.model_rank].clone()

    mu = [piece(m, n) for m, n in zip(opt.mu, named)]
    nu = [piece(v, n) for v, n in zip(opt.nu, named)]
    if [m.shape for m in mu] != [p.shape for p in params]:
        raise RuntimeError("shard_train_step: the placed parameters do not line up with "
                           "the optimizer's moments")
    opt.params, opt.mu, opt.nu = params, mu, nu
    trainer.mesh, trainer._split = mesh, model_split(model)
    return trainer


def _local_inputs(batch: Mapping[str, Any], mesh: Mesh, device) -> Tuple:
    """This rank's rows of a batch's image (float, [0, 1]), overlap, scene
    and ious, on ``device``."""
    local = shard_batch(batch, mesh)
    image = prep_image(torch.as_tensor(local["image"]).to(device))
    overlap = torch.as_tensor(local["overlap"]).to(device, torch.long)
    scene, ious = local.get("scene"), local.get("ious")
    if scene is not None:
        scene = torch.as_tensor(scene).to(device, torch.long)
    if ious is not None:
        ious = torch.as_tensor(ious).to(device, torch.float32)
    return image, overlap, scene, ious


def _sharded_decode(model: torch.nn.Module, mesh: Mesh, decode: Callable):
    """``(step, placed)``: ``model`` placed with its decoder whole, and a
    step that decodes this rank's rows of a whole batch with ``decode(
    placed, image, overlap, scene, ious)`` -> ids and all-gathers them."""
    from ..parallel.tensor import parallelize

    if mesh.model > 1 and model.cfg.encoder_int8:
        raise ValueError("the int8 encoder takes whole weights: serve encoder_int8 with "
                         "model_axis=1")
    placed = parallelize(model, mesh, whole=("decoder",))
    device = next(placed.parameters()).device

    @torch.no_grad()
    def step(batch: Mapping[str, Any]) -> torch.Tensor:
        inputs = _local_inputs(batch, mesh, device)
        placed.eval()
        return all_gather(decode(placed, *inputs), mesh.data_group, 0)

    return step, placed


def shard_eval_step(model: torch.nn.Module, mesh: Mesh
                    ) -> Tuple[Callable[[Mapping[str, Any]], torch.Tensor], torch.nn.Module]:
    """Greedy decode over ``mesh`` (JAX ``shard_eval_step``): returns
    ``(eval_step, placed)``.  ``model`` (whole weights, the same on every
    rank, on this rank's device) is placed in place: the leaves that JAX's
    rule splits cut to this rank's pieces, except the decoder's, which stay
    whole for the fused decode (K1): gathered once, at placing, never per
    call.  ``eval_step(batch)`` takes the whole batch (the wire format's
    ``image``, ``overlap`` and, where present, ``scene`` and ``ious``),
    decodes this rank's rows in eval mode and returns the whole batch's ids
    [B, T], all-gathered over the data group."""
    return _sharded_decode(model, mesh, lambda m, image, overlap, scene, ious: m(
        image, overlap, scene=scene, ious=ious).argmax(dim=-1))


def shard_beam_step(model: torch.nn.Module, mesh: Mesh, beam_size: int = 2
                    ) -> Tuple[Callable[[Mapping[str, Any]], torch.Tensor], torch.nn.Module]:
    """Beam search over ``mesh`` (JAX ``shard_beam_step``), placed as
    :func:`shard_eval_step` places (the decoder whole for the fused beam
    search, K4): ``(beam_step, placed)``, ``beam_step(batch)`` -> the whole
    batch's best beams' token ids [B, T]."""
    return _sharded_decode(model, mesh, lambda m, image, overlap, scene, ious: m.beam_decode(
        image, overlap, beam_size, scene=scene, ious=ious)[0])


def make_eval_step(model: torch.nn.Module) -> Callable[[Mapping[str, Any]], torch.Tensor]:
    """Greedy decode of a batch (the wire format's ``image``, ``overlap``,
    ``scene`` and ``ious``, on the model's device) -> argmax ids [B, T].
    The model runs in eval mode (BatchNorm on its running statistics, no
    dropout) under ``torch.no_grad()``, and returns to its former mode.
    ``eval_step.device`` is the model's device."""
    device = next(model.parameters()).device

    def eval_step(batch: Mapping[str, Any]) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                logits = model(prep_image(batch["image"]), batch["overlap"].long(),
                               scene=batch["scene"].long(), ious=batch["ious"])
            return logits.argmax(dim=-1)
        finally:
            model.train(was_training)

    eval_step.device = device
    return eval_step
