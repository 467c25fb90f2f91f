"""Render the committed synthetic train and validation sets.

Calls the JAX package's renderer (``data/synthetic.make_dataset``, numpy
and PIL) at the defaults ``api.get_dataset("synthetic")`` uses:
4096 crops at seed 999 and 512 crops at seed 1000, words of 1-10 letters
and digits, 2000 object classes.  Each set is written with
``np.savez_compressed`` under the renderer's own cache name
(``_cache_names(...)[0]``) and cache keys (``image`` uint8 [N, 32, 100, 1],
``labels``, ``overlap``, ``scene``, ``ious``, ``anno_id``), plus
``pil_version``, into ``assets/synthetic/``.  So
``DataConfig(synthetic_cache_dir="assets/synthetic")`` makes the JAX
package load these very crops, and the PyTorch port loads them with numpy
alone (``multimodal_scene_text_recognition_tpu_torch/data/synthetic.py``).

A set of N crops at a seed holds the first n crops of every smaller set at
that seed: the renderer draws all labels and object ids first, then gives
each crop its own generator from ``rng.spawn(N)``.

Usage: python scripts/render_synthetic_set.py [out_dir]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import PIL

from multimodal_scene_text_recognition_tpu.data import synthetic

SETS = ((4096, 999), (512, 1000))  # (size, seed): DataConfig's sizes, TrainConfig.seed and +1


def render(size: int, seed: int, out_dir: str) -> str:
    samples = synthetic.make_dataset(size, seed=seed)
    name = synthetic._cache_names(size, seed, 10, synthetic._CHARS_EASY, None, 2000)[0]
    path = os.path.join(out_dir, name)
    np.savez_compressed(
        path,
        image=np.stack([np.clip(np.rint(s.image * 255.0), 0, 255).astype(np.uint8)
                        for s in samples]),
        labels=np.asarray([s.label for s in samples]),
        overlap=np.stack([s.overlap for s in samples]),
        scene=np.stack([s.scene for s in samples]),
        ious=np.stack([s.ious for s in samples]),
        anno_id=np.asarray([s.anno_id for s in samples], np.int64),
        pil_version=np.asarray(PIL.__version__),
    )
    return path


def main(argv) -> None:
    out_dir = os.path.abspath(argv[0] if argv else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "synthetic"))
    os.makedirs(out_dir, exist_ok=True)
    for size, seed in SETS:
        t = time.time()
        path = render(size, seed, out_dir)
        print(f"wrote {path} ({os.path.getsize(path)} bytes, {size} crops, seed {seed}, "
              f"PIL {PIL.__version__}) in {time.time() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
