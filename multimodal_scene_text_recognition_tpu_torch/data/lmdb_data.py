"""The MJSynth/SynthText LMDB corpora (JAX counterpart: data/lmdb_data.py).

* :class:`LmdbReader`: a clovaai-layout LMDB (keys ``image-%09d`` and
  ``label-%09d`` from 1, and ``num-samples``), labels filtered by length
  and charset when it opens; each image decoded to grey (``data/images``)
  and squash-resized bilinearly, or with ``keep_ratio`` by
  :func:`keep_ratio_resize`; a record PIL would refuse with an
  ``OSError`` (broken or truncated data, a 12-bit or hierarchical JPEG)
  is a black crop labelled "[dummy_label]", as in JAX.  A record of a kind
  PIL opens and ``data/images`` does not decode (arithmetic-coded or
  lossless JPEG, a TIFF compression or layout ``data/tiff`` names, a
  format ``data/identify`` names: DIB, ICO, TGA, ...) raises
  ``NotImplementedError``: it is no dummy, since JAX reads it.  GIF and
  TIFF records are decoded as PIL decodes them.
* :class:`ConcatSamples`: sample sequences end to end.
* :class:`BalancedMixture`: batches that take a fixed quota from each
  source, each source reshuffled by one generator when it runs out.
* :func:`get_synth_datasets`: MJ (train, test and valid) and ST for
  training, concatenated or mixed by ``data.mixture_ratios``; the
  ``validation/`` LMDB for validation.

The ``lmdb`` package is imported when a reader opens, not before.
"""

from __future__ import annotations

import os
import re
from typing import List, Sequence

import numpy as np

from ..config import Config
from . import images
from .sample import Sample, blank_semantics


class LmdbReader:
    """A filtered reader over a clovaai-layout LMDB at ``root``."""

    def __init__(self, root: str, chars: str, max_len: int = 25, img_h: int = 32,
                 img_w: int = 100, filter_charset: bool = True, keep_ratio: bool = False):
        import lmdb

        self.root = root
        self.img_h, self.img_w = img_h, img_w
        self.chars = chars
        self.keep_ratio = keep_ratio
        self.env = lmdb.open(root, max_readers=32, readonly=True, lock=False, readahead=False,
                             meminit=False)
        with self.env.begin(write=False) as txn:
            n = int(txn.get(b"num-samples"))
            if not filter_charset:
                self.index = list(range(1, n + 1))
            else:
                # over-long labels and labels with a character outside the
                # charset (matched lowercased) are left out
                self.index = []
                bad = re.compile(f"[^{re.escape(chars)}]")
                for i in range(1, n + 1):
                    label = txn.get(b"label-%09d" % i).decode("utf-8")
                    if len(label) > max_len + 1:
                        continue
                    if bad.search(label.lower()):
                        continue
                    self.index.append(i)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> Sample:
        idx = self.index[i]
        with self.env.begin(write=False) as txn:
            label = txn.get(b"label-%09d" % idx).decode("utf-8")
            buf = txn.get(b"image-%09d" % idx)
        try:
            img = images.decode_gray(buf or b"")
            if self.keep_ratio:
                raw = (np.asarray(img, np.float32) / 255.0)[..., None]
                arr = keep_ratio_resize(raw, self.img_h, self.img_w)
            else:
                img = images.resize_gray(img, self.img_w, self.img_h)
                arr = (np.asarray(img, np.float32) / 255.0)[..., None]
        except OSError:  # a corrupt image: a dummy sample in its place
            arr = np.zeros((self.img_h, self.img_w, 1), np.float32)
            label = "[dummy_label]"
        label = re.sub(f"[^{re.escape(self.chars)}]", "", label)
        ov, sc, ious = blank_semantics()
        return Sample(anno_id=idx, image=arr, label=label[:25], overlap=ov, scene=sc, ious=ious)


class ConcatSamples:
    """Sample sequences end to end."""

    def __init__(self, parts: Sequence):
        self.parts = list(parts)
        self.offsets = np.cumsum([0] + [len(p) for p in self.parts])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, i: int):
        j = int(np.searchsorted(self.offsets, i, side="right")) - 1
        return self.parts[j][i - int(self.offsets[j])]


class BalancedMixture:
    """Batch-balanced sampling over several sources: each batch takes
    ``round(batch_size * ratio / sum(ratios))`` samples (at least one) from
    each source in its order, the largest-ratio source the remainder; each
    source walks its own permutation and draws a new one from the shared
    ``default_rng(seed)`` when it runs out, so a small source repeats."""

    def __init__(self, sources: Sequence, ratios: Sequence[float], batch_size: int,
                 seed: int = 0):
        assert len(sources) == len(ratios)
        total = sum(ratios)
        self.sources = list(sources)
        self.quotas = [max(1, round(batch_size * r / total)) for r in ratios]
        self.quotas[int(np.argmax(ratios))] += batch_size - sum(self.quotas)
        self.rng = np.random.default_rng(seed)
        self._perm = [self.rng.permutation(len(s)) for s in self.sources]
        self._pos = [0] * len(self.sources)

    def next_batch(self) -> List:
        out = []
        for si, (src, quota) in enumerate(zip(self.sources, self.quotas)):
            for _ in range(quota):
                if self._pos[si] >= len(src):
                    self._perm[si] = self.rng.permutation(len(src))
                    self._pos[si] = 0
                out.append(src[int(self._perm[si][self._pos[si]])])
                self._pos[si] += 1
        return out


def keep_ratio_resize(img: np.ndarray, out_h: int = 32, out_w: int = 100) -> np.ndarray:
    """A float crop [H, W, 1] in [0, 1] resized to ``out_h`` high keeping
    its aspect ratio (at most ``out_w`` wide) by PIL's bicubic 8-bit resize,
    its values truncated (not rounded) to uint8 first, then padded right
    with its last column: float32 [out_h, out_w, 1]."""
    h, w = img.shape[:2]
    ratio = w / max(h, 1)
    new_w = min(out_w, max(1, int(np.ceil(out_h * ratio))))
    arr = images.resize_gray((img[..., 0] * 255).astype(np.uint8), new_w, out_h, "bicubic")
    arr = np.asarray(arr, np.float32) / 255.0
    out = np.zeros((out_h, out_w), np.float32)
    out[:, :new_w] = arr
    if new_w < out_w:
        out[:, new_w:] = arr[:, -1:]
    return out[..., None]


def synth_reader(cfg: Config, rel: str) -> LmdbReader:
    """The reader of the LMDB at ``rel`` under ``data.deep_text_dataset_path``."""
    return LmdbReader(os.path.join(cfg.data.deep_text_dataset_path, rel), cfg.model.chars,
                      cfg.model.max_text_length, cfg.model.img_h, cfg.model.img_w,
                      keep_ratio=cfg.data.keep_ratio)


def get_synth_datasets(cfg: Config):
    """``(train, val)`` of the LMDBs under ``data.deep_text_dataset_path``:
    ``training/MJ/MJ_{train,test,valid}/`` and ``training/ST/`` for
    training (a :class:`BalancedMixture` over [MJ, ST] with
    ``data.mixture_ratios``, e.g. "0.5,0.5", else :class:`ConcatSamples`),
    ``validation/`` for validation."""
    mj = ConcatSamples([synth_reader(cfg, f"training/MJ/MJ_{part}/")
                        for part in ("train", "test", "valid")])
    st = synth_reader(cfg, "training/ST/")
    if cfg.data.mixture_ratios:
        ratios = [float(r) for r in cfg.data.mixture_ratios.split(",")]
        if len(ratios) != 2:
            raise ValueError("data.mixture_ratios must be two comma floats (MJ,ST), got "
                             f"{cfg.data.mixture_ratios!r}")
        train = BalancedMixture([mj, st], ratios, cfg.train.batch_size, seed=cfg.train.seed)
        n_train = len(mj) + len(st)
    else:
        train = ConcatSamples([mj, st])
        n_train = len(train)
    val = synth_reader(cfg, "validation/")
    print(f"  - synth: {n_train} train / {len(val)} val samples"
          + (f" (balanced mixture {cfg.data.mixture_ratios})" if cfg.data.mixture_ratios
             else ""))
    return train, val
