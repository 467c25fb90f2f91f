"""Command line: train / validate / evaluate / recognize (JAX counterpart:
cli.py).

Every configuration field is addressable as a dotted override, and every
verb runs on the card (``main(argv, device="cpu")`` runs on the CPU, as the
tests do):

    python -m multimodal_scene_text_recognition_tpu_torch.cli train \\
        --set model.encoder=lstm --set train.batch_size=96 --dataset synthetic

    python -m multimodal_scene_text_recognition_tpu_torch.cli validate \\
        --checkpoint ref.pth --set model.decode_fused=true --records out.csv

    python -m multimodal_scene_text_recognition_tpu_torch.cli evaluate \\
        --checkpoint results/models/exp --base-errors base_error_ids.txt

    python -m multimodal_scene_text_recognition_tpu_torch.cli validate \\
        --dataset cocotext --checkpoint ref.pth \\
        --set data.cocotext_api_path=/path/COCO_Text_2014.json \\
        --set data.cocotext_object_tags_path=/path/coco_object_tags.json \\
        --set data.cocotext_image_path=/path/train2014/

    python -m multimodal_scene_text_recognition_tpu_torch.cli recognize \\
        crops/ --checkpoint ref.pth --beam 5

``--checkpoint`` takes a reference ``.pth``/``.pt`` (imported as the
reference loader does, ``train.checkpoint.import_torch_checkpoint``) or a
directory of ``train.checkpoint.save_checkpoint``.  ``--dataset`` is
``synthetic`` (the committed sets, the default), ``cocotext`` or
``textocr`` (the files ``data.*_path`` name) or ``synth`` (the LMDBs under
``data.deep_text_dataset_path``; ``data.mixture_ratios`` and
``data.keep_ratio`` as in the JAX package).  ``recognize`` reads every
image file under a directory (``data/raw.RawImageFolder``) and prints one
``path<TAB>text`` line for each.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from .config import Config, apply_overrides, check_single_process


def _load_dataset(cfg: Config):
    """``(train, val)`` of ``cfg.data.dataset``; where the COCO-Text or
    TextOCR files are missing, exits with the JAX command line's message,
    which names the ``--set`` keys that point at them."""
    from .api import get_dataset

    name = cfg.data.dataset
    if name not in ("synthetic", "cocotext", "textocr", "synth"):
        raise ValueError(f"unknown dataset {name!r}")
    try:
        return get_dataset(name, cfg)
    except FileNotFoundError as e:
        if name == "cocotext":
            raise SystemExit(
                f"cocotext dataset unavailable: {e}\n"
                "The COCO-Text annotation JSONs and MS-COCO images are "
                "stripped from this mirror (reference "
                ".MISSING_LARGE_BLOBS:1-4).  To run the real-data parity "
                "eval, mount them and point the config at the files:\n"
                "  --set data.cocotext_api_path=/path/COCO_Text_2014.json \\\n"
                "  --set data.cocotext_object_tags_path=/path/"
                "coco_object_tags.json \\\n"
                "  --set data.cocotext_image_path=/path/train2014/\n"
                "then: cli validate --dataset cocotext --checkpoint ref.pth"
            ) from e
        if name == "textocr":
            raise SystemExit(
                f"textocr dataset unavailable: {e}\n"
                "TextOCR annotations/images are stripped from this mirror; "
                "mount them and set data.textocr_anno_path / "
                "data.textocr_image_path / data.textocr_object_tags_path "
                "(see core/config.py DataConfig)."
            ) from e
        raise


def _restore(cfg: Config, step) -> None:
    """Load ``cfg.saved_model`` into the trainer ``step``, if one is set."""
    path = cfg.saved_model
    if not path:
        return
    if path.endswith((".pt", ".pth")):
        from .train.checkpoint import import_torch_checkpoint

        stats = import_torch_checkpoint(path, step.model)
        print(f"  - imported torch checkpoint: {stats}")
    else:
        from .train.checkpoint import restore_checkpoint

        restore_checkpoint(path, step)
        print(f"  - restored checkpoint from {path}")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mstr-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--set", action="append", default=[],
                       help="config override key=value (repeatable)")
        p.add_argument("--dataset", default=None)
        p.add_argument("--checkpoint", default=None,
                       help="checkpoint directory or reference .pth")
        p.add_argument("--experiment", default=None)

    common(sub.add_parser("train"))
    p_val = sub.add_parser("validate")
    common(p_val)
    p_val.add_argument("--records", default=None,
                       help="write per-sample prediction CSV here (needs pandas)")
    p_val.add_argument("--dump-attention", action="store_true",
                       help="print fusion attention-score tables for the first batch")
    p_eval = sub.add_parser("evaluate")
    common(p_eval)
    p_eval.add_argument("--base-errors", required=False,
                        help="file of anno ids a baseline got wrong")
    p_eval.add_argument("--print-sem", action="store_true")
    p_rec = sub.add_parser("recognize", help="recognize a folder of word-crop images")
    common(p_rec)
    p_rec.add_argument("images", help="directory of crop images")
    p_rec.add_argument("--beam", type=int, default=0, help="beam size (0 = greedy)")
    return parser


def _recognize(args, device: str) -> int:
    """Read every image under ``args.images`` with the model of the
    ``--set`` configuration and ``--checkpoint``'s weights (``--dataset``
    and ``--experiment`` are not read), in batches of up to
    ``train.batch_size`` crops, and print ``path<TAB>text`` lines."""
    cfg = Config()
    if args.checkpoint:
        cfg = apply_overrides(cfg, {"saved_model": args.checkpoint})
    cfg = apply_overrides(cfg, args.set)
    check_single_process(cfg)

    from . import api
    from .data.raw import RawImageFolder
    from .eval.serve import Recognizer

    folder = RawImageFolder(args.images, cfg.model.img_h, cfg.model.img_w)
    if not len(folder):
        print("no images found")
        return 1
    step = api.get_trainer(None, cfg.model, cfg.train, device=device, seed=cfg.train.seed)
    _restore(cfg, step)
    model = step.model.eval().requires_grad_(False)
    crops = [folder[i].image for i in range(len(folder))]
    rec = Recognizer(model, batch_sizes=sorted({1, 8, 64, cfg.train.batch_size}))
    texts = rec.recognize(crops, beam_size=args.beam)
    for path, text in zip(folder.paths, texts):
        print(f"{path}\t{text}")
    return 0


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    """Run one verb; returns its exit code.  ``device`` defaults to the
    card, and with no card raises rather than run on the CPU."""
    args = _parser().parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cli: no CUDA device is available "
                           "(main(argv, device='cpu') runs on the CPU)")
    # a no-op in one process; joins the run that parallel/mesh.init_distributed's
    # environment describes (one process a card)
    from .parallel.mesh import init_distributed

    n_proc = init_distributed(device=torch.device(device).type)
    if n_proc > 1:
        print(f"  - distributed: {n_proc} processes, {n_proc} global devices")

    if args.cmd == "recognize":
        return _recognize(args, device)

    cfg = Config()
    if args.experiment:
        cfg = apply_overrides(cfg, {"experiment": args.experiment})
    if args.dataset:
        cfg = apply_overrides(cfg, {"data.dataset": args.dataset})
    if args.checkpoint:
        cfg = apply_overrides(cfg, {"saved_model": args.checkpoint})
    cfg = apply_overrides(cfg, args.set)
    check_single_process(cfg)

    from . import api
    from .data.pipeline import Batcher, batches
    from .train.loop import build_codec

    codec = build_codec(cfg)
    train_samples, val_samples = _load_dataset(cfg)
    step = api.get_trainer(None, cfg.model, cfg.train, device=device, seed=cfg.train.seed)
    _restore(cfg, step)

    if args.cmd == "train":
        from .train.loop import train as train_loop

        train_loop(cfg, step, train_samples, val_samples)
        return 0

    from .eval.evaluate import validate as run_validate
    from .train.steps import make_eval_step

    eval_step = make_eval_step(step.model)
    batcher = Batcher(codec, cfg.train.batch_size)

    def val_batches():
        return batches(val_samples, batcher, shuffle=False, drop_last=False)

    if args.cmd == "validate":
        if args.dump_attention:
            from .eval.attention import print_attention_scores

            print_attention_scores(step.model, next(iter(val_batches())))
        result = run_validate(eval_step, val_batches(), codec, print_samples=True,
                              return_records=bool(args.records))
        print(f"val accuracy: {result.accuracy}%")
        if args.records:
            result.to_dataframe().to_csv(args.records, index=False)
            print(f"wrote {args.records}")
        return 0

    from .eval.evaluate import error_diff_eval, load_class_labels

    base_errors = set()
    if args.base_errors:
        with open(args.base_errors) as f:
            base_errors = set(f.read().splitlines())
    try:
        labels = load_class_labels(cfg.data.class_labels_dir, cfg.model.semantic_source)
    except OSError:
        labels = None
    out = error_diff_eval(eval_step, val_batches(), codec, base_errors, class_labels=labels,
                          semantic_vector=cfg.model.semantic_vector, print_sem=args.print_sem)
    print(f"Corrected: {out['corrected']} / {out['total']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
