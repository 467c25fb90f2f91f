"""The synthetic rendered-text sets, loaded with numpy alone from the
committed files in ``assets/synthetic/`` (JAX counterpart:
data/synthetic.py, whose renderer needs PIL; ``scripts/render_synthetic_set.py``
rendered these files with it).

A committed set of N crops at a seed serves any ``size <= N`` at that seed
as its first ``size`` crops: the renderer draws every label and object id
first and gives each crop its own generator spawned from the seed, so a
smaller render is exactly that prefix.  Other sizes and seeds raise.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from ..charset import AttnCodec, Codec
from ..config import DEFAULT_CHARS, SYNTHETIC_DIR
from .pipeline import PackedSamples

# the renderer's cache name at its defaults: words of 1-10 letters and
# digits (charset key f43b04), open vocabulary, 2000 object classes
_NAME = re.compile(r"synth_(\d+)_(\d+)_10_f43b04_open_o2000_v1\.npz")
RENDER_SCRIPT = "scripts/render_synthetic_set.py"


def committed_sets(directory: str = SYNTHETIC_DIR) -> Dict[int, Tuple[int, str]]:
    """``{seed: (size, path)}`` of the committed sets in ``directory`` (the
    largest set of each seed)."""
    out: Dict[int, Tuple[int, str]] = {}
    for path in sorted(glob.glob(os.path.join(directory, "synth_*.npz"))):
        m = _NAME.fullmatch(os.path.basename(path))
        if m:
            size, seed = int(m.group(1)), int(m.group(2))
            if size > out.get(seed, (0, ""))[0]:
                out[seed] = (size, path)
    return out


def make_dataset(size: int, seed: int = 0, codec: Optional[Codec] = None,
                 directory: Optional[str] = None, vocab_size: int = 0) -> PackedSamples:
    """The JAX renderer's ``make_dataset(size, seed)`` at its defaults, as
    :class:`PackedSamples` (uint8 images), label rows encoded by ``codec``
    (default: the model's 94 characters, 25 long).  Raises ``ValueError``
    where no committed set at ``seed`` holds ``size`` crops, or for a closed
    vocabulary (``vocab_size > 0``), which no committed set holds."""
    directory = directory or SYNTHETIC_DIR
    sets = committed_sets(directory)
    if vocab_size or seed not in sets or size > sets[seed][0] or size < 1:
        have = ", ".join(f"{n} crops at seed {s}" for s, (n, _) in sorted(sets.items()))
        what = f"a closed vocabulary of {vocab_size} words" if vocab_size else f"{size} crops"
        raise ValueError(
            f"no committed synthetic set holds {what} at seed {seed} (committed in "
            f"{directory}: {have or 'none'}); any smaller size at a committed seed is served. "
            f"Render others with {RENDER_SCRIPT}, where PIL is installed")
    codec = codec or AttnCodec(DEFAULT_CHARS, 25)
    with np.load(sets[seed][1], allow_pickle=False) as z:
        labels = [str(s) for s in z["labels"][:size]]
        text, _ = codec.encode(labels)
        return PackedSamples(
            image=z["image"][:size],
            text=np.asarray(text, np.int32),
            overlap=z["overlap"][:size].astype(np.int32),
            scene=z["scene"][:size].astype(np.int32),
            ious=z["ious"][:size].astype(np.float32),
            anno_id=z["anno_id"][:size].astype(np.int64),
            labels=labels,
        )
