"""Serving facade: crops (and, for the semantic fusion hooks, the crops'
detected objects) in, strings out, in fixed batch buckets, by greedy
decoding or beam search, in float or through the int8 backbone (JAX
counterpart: eval/serve.Recognizer)."""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..charset import AttnCodec
from ..models.model import make_int8_eval_step
from ..models.resnet_int8 import (calibrate_resnet, calibrate_tps, check_scale_drift,
                                  load_activation_scales, save_activation_scales)
from ..ops.resize import crop_resize_gray_batch, resize_float


def scales_path_beside(bundle_path: Optional[str]) -> Optional[str]:
    """Where a bundle's persisted int8 activation scales live:
    ``x.params.npz`` -> ``x.scales.npz``, any other path -> ``path +
    ".scales.npz"`` (JAX ``Recognizer.from_bundle``)."""
    if not bundle_path:
        return None
    if bundle_path.endswith(".params.npz"):
        return bundle_path[: -len(".params.npz")] + ".scales.npz"
    return bundle_path + ".scales.npz"


class Recognizer:
    """Recognition of grayscale crops through a
    :class:`~..models.model.SceneTextModel` (from ``api.get_model``).

    Crops are grayscale [H, W] or [H, W, 1] of any size: float in [0, 1]
    or uint8 (any crop whose maximum exceeds 1.5 is scaled by 1/255).  Crops
    that are not ``img_h x img_w`` (32x100) are resized on the host as the
    JAX package resizes them (:meth:`prepare`).

    ``int8_backbone=True`` serves through the int8 loc-net (with
    ``cfg.tps_int8``) and the int8 ResNet-31 (models/resnet_int8.py), in
    front of the model's encoder and decoder.  Activation scales resolve in
    order: (1) ``int8_scales_path``, or where it is None the
    ``<bundle>.scales.npz`` beside the bundle the model was loaded from,
    when that file exists; (2) an explicit :meth:`calibrate_int8` call on
    representative crops (which persists them to ``int8_scales_path`` when
    one is set); (3) lazily on the first recognize call, from that call's
    REAL crops only (pad rows are filled by cycling the real crops: a
    zero-padded bucket would pull the static scales below real ranges and
    clip later traffic).  Persisted scales are checked once against the
    first traffic seen, and a drift past 2x warns.  A model with random
    weights (``api.get_model(None, ...)``) has no bundle and so no
    persisted scales: it calibrates on its first call's crops.  The
    int8 backbone serves any encoder and decoder (transformer, BiLSTM or
    Oscar; transformer, LSTM or linear), as JAX's int8 step splices it in
    front of ``decode_from_columns``.  A ``semantic_source="rand"`` model
    is refused at its first call, as JAX's is (its semantics come from the
    train step's generator).

    Strings are decoded by ``AttnCodec`` whatever ``label_codec`` says, as
    the JAX package's Recognizer decodes them.
    """

    def __init__(self, model, batch_sizes: Sequence[int] = (1, 8, 64),
                 int8_backbone: bool = False, int8_scales_path: Optional[str] = None):
        self.model = model
        self.cfg = model.cfg
        self.codec = AttnCodec(self.cfg.chars, self.cfg.max_text_length)
        self.batch_sizes = tuple(sorted(batch_sizes))
        self.device = next(model.parameters()).device
        self.int8_backbone = int8_backbone
        if int8_backbone and int8_scales_path is None:
            found = scales_path_beside(getattr(model, "bundle_path", None))
            int8_scales_path = found if found and os.path.exists(found) else None
        self.int8_scales_path = int8_scales_path
        self._int8_steps: Dict[Optional[int], object] = {}  # None: greedy, k: beam k
        self._qsites = None
        self._int8_absmax: Optional[Dict[str, float]] = None
        self._drift_checked = False
        if int8_scales_path is not None and os.path.exists(int8_scales_path):
            self._int8_absmax = load_activation_scales(int8_scales_path)

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def prepare(self, crops: Sequence[np.ndarray], B: int, tile_real: bool = False,
                semantics: Optional[Mapping[str, np.ndarray]] = None):
        """Stack ``crops`` into a [B, H, W, 1] float32 batch on the model's
        device (JAX ``_prepare``, in its order: a crop's type is noted, the
        crop is scaled by 1/255 where its maximum exceeds 1.5, and one that
        is not ``img_h x img_w`` is resized: a uint8 crop, taken back to
        bytes, by the C++ bilinear crop resize
        (:func:`~..ops.resize.crop_resize_gray_batch`, all such crops of
        the batch in one call), any other by the float64 bicubic resize
        (:func:`~..ops.resize.resize_float`)), with its semantic inputs:
        ``overlap`` ids [B,
        max_overlap_objs], ``scene`` ids [B, max_scene_objs] and ``ious``
        float32 [B, max_scene_objs].  Image pad rows are zero, or with
        ``tile_real`` copies of the real crops in turn (calibration batches
        must not see pad rows).  Without ``semantics`` the semantic inputs
        are the JAX defaults (no objects: zero ids, ``ious`` -1000); each
        array that ``semantics`` holds (rows aligned with ``crops``) fills
        its input, whose pad rows are then zero, as JAX ``recognize`` fills
        them.  Returns ``(image, overlap, scene, ious)``."""
        m = self.cfg
        img = np.zeros((B, m.img_h, m.img_w, 1), np.float32)
        byte_rows, byte_crops = [], []
        for i, c in enumerate(crops):
            c = np.asarray(c)
            was_uint8 = c.dtype == np.uint8
            c = c.astype(np.float32)
            if c.max() > 1.5:  # uint8-range input
                c = c / 255.0
            if c.ndim == 2:
                c = c[..., None]
            if c.ndim != 3 or c.shape[2] != 1:
                raise ValueError(f"crop {i} has shape {c.shape}; this recognizer takes "
                                 f"grayscale crops [H, W] or [H, W, 1]")
            if c.shape[:2] == (m.img_h, m.img_w):
                img[i] = c
            elif was_uint8:
                # back to bytes, as JAX does: exact for byte input; a uint8
                # crop whose maximum is at most 1.5 was not scaled, so its 1s
                # become 255
                byte_rows.append(i)
                byte_crops.append((c[..., 0] * 255).astype(np.uint8))
            else:
                img[i, ..., 0] = resize_float(c[..., 0], m.img_h, m.img_w)
        if byte_crops:
            boxes = np.array([[0, 0, c.shape[1], c.shape[0]] for c in byte_crops], np.float32)
            img[byte_rows] = crop_resize_gray_batch(byte_crops, boxes, m.img_h, m.img_w)
        if tile_real and len(crops) > 0:
            for i in range(len(crops), B):
                img[i] = img[i % len(crops)]
        sem = {"overlap": np.zeros((B, m.max_overlap_objs), np.int64),
               "scene": np.zeros((B, m.max_scene_objs), np.int64),
               "ious": np.full((B, m.max_scene_objs), -1000.0, np.float32)}
        for k, v in (semantics or {}).items():
            if k not in sem:
                raise ValueError(f"unknown semantic input {k!r} (overlap, scene, ious)")
            arr = np.zeros_like(sem[k])
            arr[: len(crops)] = np.asarray(v)[: len(crops)]
            sem[k] = arr
        image = torch.from_numpy(img).to(self.device)
        return (image, *(torch.from_numpy(sem[k]).to(self.device)
                         for k in ("overlap", "scene", "ious")))

    @torch.no_grad()
    def _observe_absmax(self, crops: Sequence[np.ndarray]) -> Dict[str, float]:
        """Per-site input abs-max of the backbone (and, with ``tps_int8``,
        of the loc-net under ``tps/``) over real crops, pad rows filled by
        cycling them."""
        crops = list(crops)[: self.batch_sizes[-1]]
        image = self.prepare(crops, self._bucket(len(crops)), tile_real=True)[0]
        model = self.model
        with model.precision():
            observed = calibrate_resnet(model.feature_extractor, model.rectify(image))
        if self.cfg.tps_int8 and self.cfg.use_tps:
            observed.update({f"tps/{k}": v
                             for k, v in calibrate_tps(model.transformation, image).items()})
        return observed

    def calibrate_int8(self, crops: Sequence[np.ndarray]) -> None:
        """Calibrate the int8 activation scales on representative crops and
        persist them to ``int8_scales_path`` when one is set.  Scales
        already held are checked against the new ones for drift first."""
        observed = self._observe_absmax(crops)
        if self._int8_absmax is not None:
            check_scale_drift(self._int8_absmax, observed)
        self._drift_checked = True
        self._int8_absmax = observed
        self._int8_steps = {}  # rebuilt with the new scales
        self._qsites = None
        if self.int8_scales_path is not None:
            save_activation_scales(self.int8_scales_path, observed)

    def _ensure_int8(self, chunk: Sequence[np.ndarray], beam_size: Optional[int] = None):
        """The int8 step (greedy, or beam search of width ``beam_size``),
        built once per kind; calibrates lazily on ``chunk``'s real crops if
        no scales are held, and checks persisted scales once for drift."""
        key = int(beam_size) if beam_size else None
        if self._int8_absmax is None:
            self.calibrate_int8(chunk)
        if key not in self._int8_steps:
            step, self._qsites = make_int8_eval_step(self.model, x_absmax=self._int8_absmax,
                                                     beam_size=key)
            self._int8_steps[key] = step
        if not self._drift_checked:
            check_scale_drift(self._int8_absmax, self._observe_absmax(chunk))
            self._drift_checked = True
        return self._int8_steps[key]

    @torch.no_grad()
    def recognize(self, crops: Sequence[np.ndarray], beam_size: int = 0,
                  return_scores: bool = False, *,
                  semantics: Optional[Mapping[str, np.ndarray]] = None
                  ) -> Union[List[str], Tuple[List[str], List[float]]]:
        """Recognise a list of grayscale crops; returns the decoded strings,
        or with ``return_scores`` (strings, scores).

        ``beam_size`` > 0 decodes by beam search of that width, and a
        crop's score is its best beam's cumulative log-probability; greedy
        decoding (``beam_size=0``, and any ``beam_size`` with a decoder
        other than the transformer, as in the JAX package) scores every
        crop 0.0.  ``semantics``:
        the crops' detected objects for the fusion hooks, a dict of
        ``overlap`` ids [N, max_overlap_objs], ``scene`` ids [N,
        max_scene_objs] and ``ious`` [N, max_scene_objs] (any of them; see
        :meth:`prepare`), rows aligned with ``crops``."""
        texts: List[str] = []
        scores: List[float] = []
        step = self.batch_sizes[-1]
        for i in range(0, len(crops), step):
            chunk = crops[i:i + step]
            n = len(chunk)
            sem = None if semantics is None else {k: np.asarray(v)[i:i + n]
                                                  for k, v in semantics.items()}
            image, overlap, scene, ious = self.prepare(chunk, self._bucket(n), semantics=sem)
            if beam_size and self.cfg.decoder == "transformer":
                if self.int8_backbone:
                    ids, best = self._ensure_int8(chunk, beam_size)(image, overlap, scene, ious)
                else:
                    ids, best = self.model.beam_decode(image, overlap, int(beam_size),
                                                       scene=scene, ious=ious)
                scores.extend(best[:n].tolist())
            else:
                if self.int8_backbone:
                    ids = self._ensure_int8(chunk)(image, overlap, scene, ious)
                else:
                    ids = self.model(image, overlap, scene=scene, ious=ious).argmax(dim=-1)
                scores.extend([0.0] * n)
            texts.extend(self.codec.decode(ids.cpu().numpy())[:n])
        return (texts, scores) if return_scores else texts
