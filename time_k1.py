"""Time K1, the float greedy decode kernel, K1q, the int8 one, and K4, the
beam-search kernel, of a checkout of this repository on the card, so that two
checkouts can be compared on one card, in turns.

    python3 time_k1.py [--repo DIR]

It imports the port from DIR (default: this checkout), whose kernels build
in DIR's ``kernels/_build``, and takes the rest from this checkout's
``chip_smoke.py``: the trained flagship (``BUNDLE``), the seeded B=192
crops it serves, the cross K/V its encoder makes of them, ``k1_times``
(bf16 at B=192 at full length and with early stop, and at B=1) and
``k1q_times`` (the int8 decoder's tables, likewise; ``int8`` below) and
``k4_times`` (bf16, K=5, at B=192 with early stop and at full length, and at
B=1).  A checkout whose decoder keeps no int8 units times its K1q as its
served path calls it.  Prints the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import chip_smoke  # this checkout's, imported before DIR goes first on the path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.abspath(__file__)),
                    help="checkout whose K1 is timed")
    repo = os.path.abspath(ap.parse_args(argv).repo)
    sys.path.insert(0, repo)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_k1: no CUDA device; K1 runs only on the card")
    from multimodal_scene_text_recognition_tpu_torch import api
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
    from multimodal_scene_text_recognition_tpu_torch.ops import fused_beam as fb
    from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd

    for mod in (fd, fb):
        if not os.path.abspath(mod.__file__).startswith(repo + os.sep):
            raise SystemExit(f"time_k1: imported {mod.__file__}, not the port of {repo}")
    card = chip_smoke.card_line()
    B = chip_smoke.B
    model = api.get_model(chip_smoke.BUNDLE)
    int8 = api.get_model(chip_smoke.BUNDLE, dataclasses.replace(
        FLAGSHIP, decode_early_stop=True, decode_int8=True)).decoder
    image = Recognizer(model, batch_sizes=(B,)).prepare(chip_smoke.make_crops(B, seed=1234), B)[0]
    dec, ck, cv = chip_smoke.beam_inputs(model, image)
    # a checkout whose K1 reads repacked tables takes them, as its served path does
    kw = {"packed": dec.cluster_tables(torch.bfloat16)} if hasattr(dec, "cluster_tables") else {}
    times = chip_smoke.k1_times(fd, dec, ck, cv, **kw)
    k1q = chip_smoke.k1q_times(fd, int8, ck, cv)
    k4 = chip_smoke.k4_times(fb, dec, ck, cv)
    print(card, flush=True)
    print(json.dumps({"repo": repo, "card": card, "batch": B, "k1_bf16_ms": times,
                      "k1q_bf16_ms": k1q, "k4_bf16_ms": k4}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
