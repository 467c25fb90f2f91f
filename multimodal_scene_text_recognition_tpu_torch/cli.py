"""Command line: train / validate / evaluate (JAX counterpart: cli.py).

Every configuration field is addressable as a dotted override, and every
verb runs on the card (``main(argv, device="cpu")`` runs on the CPU, as the
tests do):

    python -m multimodal_scene_text_recognition_tpu_torch.cli train \\
        --set model.encoder=lstm --set train.batch_size=96 --dataset synthetic

    python -m multimodal_scene_text_recognition_tpu_torch.cli validate \\
        --checkpoint ref.pth --set model.decode_fused=true --records out.csv

    python -m multimodal_scene_text_recognition_tpu_torch.cli evaluate \\
        --checkpoint results/models/exp --base-errors base_error_ids.txt

``--checkpoint`` takes a reference ``.pth``/``.pt`` (imported as the
reference loader does, ``train.checkpoint.import_torch_checkpoint``) or a
directory of ``train.checkpoint.save_checkpoint``.  The dataset is the
committed synthetic set; the COCO-Text, TextOCR and LMDB loaders are not
ported yet.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from .config import Config, apply_overrides


def _load_dataset(cfg: Config):
    """``(train, val)`` of ``cfg.data.dataset``; a dataset whose loader is
    not ported exits with its message, as the JAX command line exits where
    a dataset's files are missing."""
    from .api import get_dataset

    try:
        return get_dataset(cfg.data.dataset, cfg)
    except NotImplementedError as e:
        raise SystemExit(f"{cfg.data.dataset} dataset unavailable: {e}") from e


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
    return parser


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    """Run one verb; returns its exit code.  ``device`` defaults to the
    card, and with no card raises rather than run on the CPU."""
    args = _parser().parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cli: no CUDA device is available "
                           "(main(argv, device='cpu') runs on the CPU)")

    cfg = Config()
    if args.experiment:
        cfg = apply_overrides(cfg, {"experiment": args.experiment})
    if args.dataset:
        cfg = apply_overrides(cfg, {"data.dataset": args.dataset})
    if args.checkpoint:
        cfg = apply_overrides(cfg, {"saved_model": args.checkpoint})
    cfg = apply_overrides(cfg, args.set)

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
