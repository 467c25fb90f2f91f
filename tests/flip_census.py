"""The outcome census of damaged GIF and TIFF fixtures, the port against
PIL (the reference): for each fixture of ``loader_fixtures.gif_tiff_files``
(or those named), ``N`` single-bit flips or truncations drawn from ``SEED``,
counted by (PIL's outcome, the port's outcome) wherever they differ, and
wherever both decode to different arrays.  With ``jpeg`` for the
fixtures: five JPEGs PIL writes here (4:2:0, 4:4:4, grey, progressive,
quality 100), flipped in their last two thirds, no truncation.

    python tests/flip_census.py N SEED [fixture ... | jpeg]

Runs on the CPU with PIL installed (the tests' environment)."""

import collections
import io
import os
import random
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

import loader_fixtures as lf  # noqa: E402
from multimodal_scene_text_recognition_tpu_torch.data import images  # noqa: E402


def outcome(decode, data):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return "ok", decode(data)
        except NotImplementedError as e:
            return "NotImplementedError", str(e)
        except Exception as e:  # noqa: BLE001 - the class is what is counted
            return ("OSError" if isinstance(e, OSError) else type(e).__name__), str(e)


def jpeg_files() -> dict:
    yy, xx = np.mgrid[0:48, 0:64]
    rgb = np.stack([(xx * 4) % 256, (yy * 5) % 256, ((xx + yy) * 3) % 256], -1)
    rgb = np.clip(rgb + np.random.default_rng(0).integers(-20, 20, rgb.shape), 0, 255)
    files = {}
    for name, mode, kw in [("4:2:0", "RGB", dict(quality=90)),
                           ("4:4:4", "RGB", dict(quality=95, subsampling=0)),
                           ("grey", "L", dict(quality=80)),
                           ("progressive", "RGB", dict(quality=85, progressive=True)),
                           ("quality 100", "RGB", dict(quality=100, subsampling=0))]:
        buf = io.BytesIO()
        Image.fromarray(rgb.astype(np.uint8)).convert(mode).save(buf, "JPEG", **kw)
        files[name] = buf.getvalue()
    return files


def census(n: int, seed: int, names=None) -> collections.Counter:
    jpeg = names == ["jpeg"]
    files = jpeg_files() if jpeg else lf.gif_tiff_files()
    counts = collections.Counter()
    for name in (None if jpeg else names) or sorted(files):
        rng = random.Random(f"{seed}-{name}")
        data0 = files[name]
        for _ in range(n):
            i = rng.randrange(len(data0) // 3 if jpeg else 0, len(data0))
            if jpeg or rng.random() < 0.7:
                data = data0[:i] + bytes([data0[i] ^ (1 << rng.randrange(8))]) + data0[i + 1:]
            else:
                data = data0[:i]
            want = outcome(lambda d: np.asarray(Image.open(io.BytesIO(d)).convert("L")), data)
            got = outcome(images.decode_gray, data)
            if want[0] != got[0]:
                counts[(name, want[0], got[0])] += 1
            elif want[0] == "ok" and not np.array_equal(want[1], got[1]):
                counts[(name, "ok", "ok, other pixels")] += 1
    return counts


if __name__ == "__main__":
    found = census(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3:])
    for (name, want, got), k in sorted(found.items()):
        print(f"{k:5d}  {name}: PIL {want}, port {got}")
    print(f"{sum(found.values())} of the flips differ")
