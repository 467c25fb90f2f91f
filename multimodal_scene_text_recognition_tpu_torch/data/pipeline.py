"""Host input pipeline: the packed dataset, collation, shuffling, padding,
prefetch and the move to the device (JAX counterpart: data/pipeline.py).

The fixed-shape wire format of a batch:
  image  uint8 [B, 32, 100, 1] (float32 in [0, 1] where the source is float)
  text   int32 [B, max_text_length + 2] (AttnCodec rows)
  overlap int32 [B, 15]; scene int32 [B, 52]; ious float32 [B, 52]
plus the host-only ``anno_id``, ``labels`` and, on a padded batch,
``valid``.  Training drops the short final batch; evaluation pads it with
zero crops and marks the pad rows ``valid=False``.
"""

from __future__ import annotations

import queue
import threading
from types import SimpleNamespace
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..charset import AttnCodec

DEVICE_KEYS = ("image", "text", "overlap", "scene", "ious")


def quantize_images(image: np.ndarray) -> np.ndarray:
    """float [0, 1] crops -> uint8 for the wire (uint8 passes through):
    crops come from uint8 sources, so the round trip is lossless, and the
    device converts back in the step (``train.steps.prep_image``)."""
    if image.dtype == np.uint8:
        return image
    return np.clip(np.rint(image * 255.0), 0, 255).astype(np.uint8)


class PackedSamples:
    """A whole dataset collated once into contiguous arrays (uint8 images):
    a batch is then five fancy-index gathers."""

    def __init__(self, image, text, overlap, scene, ious, anno_id, labels: List[str]):
        self.image = image
        self.text = text
        self.overlap = overlap
        self.scene = scene
        self.ious = ious
        self.anno_id = anno_id
        self.labels = labels

    @classmethod
    def from_samples(cls, samples: Sequence, codec: AttnCodec) -> "PackedSamples":
        """Pack sample-like objects (``.image .label .overlap .scene .ious
        .anno_id``); a :class:`PackedSamples` is returned as it is.  Images
        are quantized one by one into the uint8 pack."""
        if isinstance(samples, cls):
            return samples
        labels = [s.label for s in samples]
        text, _ = codec.encode(labels)
        first = np.asarray(samples[0].image)
        image = np.empty((len(samples),) + first.shape, np.uint8)
        for i, s in enumerate(samples):
            image[i] = quantize_images(np.asarray(s.image))
        return cls(
            image=image,
            text=np.asarray(text, np.int32),
            overlap=np.stack([s.overlap for s in samples]).astype(np.int32),
            scene=np.stack([s.scene for s in samples]).astype(np.int32),
            ious=np.stack([s.ious for s in samples]).astype(np.float32),
            anno_id=np.asarray([s.anno_id for s in samples], np.int64),
            labels=labels,
        )

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int) -> SimpleNamespace:
        """A sample-like view of row ``i``."""
        return SimpleNamespace(image=self.image[i], label=self.labels[i],
                               overlap=self.overlap[i], scene=self.scene[i],
                               ious=self.ious[i], anno_id=self.anno_id[i])

    def take(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "image": self.image[idx],
            "text": self.text[idx],
            "overlap": self.overlap[idx],
            "scene": self.scene[idx],
            "ious": self.ious[idx],
            "anno_id": self.anno_id[idx],
            "labels": [self.labels[j] for j in idx],
        }

    def nbytes(self) -> int:
        """Bytes of the arrays a device copy holds."""
        return sum(getattr(self, k).nbytes for k in DEVICE_KEYS)


def packed_batches(packed: PackedSamples, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True,
                   epochs: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of ``packed``: with ``shuffle``, ``arange(n)`` shuffled in
    place by ``default_rng(seed)`` each epoch; a short final batch is
    dropped, or with ``drop_last=False`` padded with row 0's index to
    ``batch_size`` (its ``labels`` with "") and marked by ``valid``."""
    rng = np.random.default_rng(seed)
    B = batch_size
    n = len(packed)
    for _ in range(epochs):
        order = np.arange(n)
        if shuffle:
            rng.shuffle(order)
        for i in range(0, n, B):
            idx = order[i: i + B]
            if len(idx) < B:
                if drop_last:
                    continue
                short = len(idx)
                batch = packed.take(np.concatenate([idx, np.zeros(B - short, np.int64)]))
                batch["labels"] = batch["labels"][:short] + [""] * (B - short)
                batch["valid"] = np.arange(B) < short
                yield batch
            else:
                yield packed.take(idx)


class Batcher:
    """Collate sample-like objects into fixed-shape numpy batches."""

    def __init__(self, codec: AttnCodec, batch_size: int):
        self.codec = codec
        self.batch_size = batch_size

    def collate(self, samples: Sequence) -> Dict[str, np.ndarray]:
        text, _ = self.codec.encode([s.label for s in samples])
        imgs = np.stack([s.image for s in samples])
        if imgs.dtype != np.uint8:  # uint8 stays uint8 on the wire
            imgs = imgs.astype(np.float32)
        return {
            "image": imgs,
            "text": text,
            "overlap": np.stack([s.overlap for s in samples]).astype(np.int32),
            "scene": np.stack([s.scene for s in samples]).astype(np.int32),
            "ious": np.stack([s.ious for s in samples]).astype(np.float32),
            "anno_id": np.asarray([s.anno_id for s in samples], np.int64),
            "labels": [s.label for s in samples],
        }

    def pad_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Pad a short batch with zero rows up to ``batch_size``; adds
        ``valid``."""
        n = len(batch["labels"])
        if n == self.batch_size:
            return dict(batch, valid=np.ones(n, bool))
        pad = self.batch_size - n
        out = {}
        for k, v in batch.items():
            if k == "labels":
                out[k] = list(v) + [""] * pad
            else:
                out[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
        out["valid"] = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
        return out


def batches(samples: Sequence, batcher: Batcher, shuffle: bool = True, seed: int = 0,
            drop_last: bool = True, epochs: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of a sequence of samples through ``batcher``, in the order
    of :func:`packed_batches`; a short final batch is dropped or padded by
    ``Batcher.pad_batch``."""
    rng = np.random.default_rng(seed)
    B = batcher.batch_size
    for _ in range(epochs):
        order = np.arange(len(samples))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order), B):
            idx = order[i: i + B]
            if len(idx) < B and drop_last:
                continue
            batch = batcher.collate([samples[j] for j in idx])
            if len(idx) < B:
                batch = batcher.pad_batch(batch)
            yield batch


class Prefetcher:
    """Runs an iterator in a background thread, ``depth`` items ahead of
    the consumer; an exception raised there is raised to the consumer.
    A consumer that stops early calls :meth:`close`, which ends the thread
    and drops the items it holds."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 4):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.err: Optional[BaseException] = None
        self._stop = threading.Event()

        def run():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self.q.put(item)
            except BaseException as e:  # raised again in the consumer
                self.err = e
            finally:
                self.q.put(self._DONE)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self._stop.set()
        while self.thread.is_alive():  # unblock a put on a full queue
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._DONE:
                if self.err is not None:
                    raise self.err
                return
            yield item


def pinned(batch: Dict[str, np.ndarray]) -> Dict[str, object]:
    """The device arrays of ``batch`` as page-locked CPU tensors (the host
    half of a copy to the card, done in a :class:`Prefetcher`'s thread);
    host-only fields stay as they are."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() if k in DEVICE_KEYS
            else v for k, v in batch.items()}


def device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The device arrays of ``batch`` (numpy arrays or CPU tensors) as
    tensors on ``device``, dtypes kept (uint8 crops stay uint8); host-only
    fields are dropped.  Pinned tensors are copied without blocking the host,
    on the caller's current stream, so the kernels that read them are
    ordered after the copy."""
    device = torch.device(device)
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
            for k in DEVICE_KEYS if k in batch}
