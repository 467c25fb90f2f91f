"""Model, training and data configuration: the fields of the JAX package's
``ModelConfig``, ``TrainConfig``, ``DataConfig`` and ``Config`` that the
serving paths (greedy, beam, int8 and the semantic fusion hooks), the
classic recognizers (BiLSTM encoder, LSTM-attention and linear decoders,
CTC), the Oscar encoder, the BERT and random embedders, backbone remat, the
train step, the training loop, the synthetic set, the real-data loaders
and the command line read, with the same names and defaults, and the command line's dotted
overrides (JAX counterpart: core/config.py)."""

from __future__ import annotations

import dataclasses
import os
import string
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

# 94 printable characters: string.printable minus the 6 trailing whitespace
# controls.
DEFAULT_CHARS: str = string.printable[:-6]


@dataclass(frozen=True)
class ModelConfig:
    # the sequence encoder and the decoder (JAX models/model.py): the
    # BiLSTM encoder's output is lstm_hidden wide, the transformer's and
    # the Oscar encoder's hidden_dim, and the decoder's memory takes that
    # width.  The Oscar encoder has fixed BERT widths (768, 12 layers, 12
    # heads, FF 3072); oscar_encoder appends the semantic vectors to its
    # input.
    encoder: str = "transformer"  # lstm | transformer | oscar
    decoder: str = "transformer"  # lstm | transformer | linear
    use_tps: bool = True
    embed_dim: int = 256
    hidden_dim: int = 512
    img_h: int = 32
    img_w: int = 100
    input_channels: int = 1
    num_fiducial: int = 20
    enc_layers: int = 6
    dec_layers: int = 6
    num_heads: int = 8
    ff_dim: int = 2048
    lstm_hidden: int = 256  # the BiLSTM encoder's and the LSTM decoder's width
    # "reference": the transformer encoder norms the residual stream before
    # each add (the reference model's order); "standard": textbook post-LN
    encoder_norm_style: str = "reference"
    oscar_encoder: bool = False
    # semantic vectors: detector class ids embedded per crop (JAX
    # models/semantic.py); "rand" draws noise from the train step's
    # generator (training only), "bert" runs tag token ids (in overlap)
    # through a DistilBERT-shaped encoder.
    semantic_vector: str = "overlap"      # overlap | scene | combined
    semantic_source: str = "vinvl"        # coco | vg | vinvl | zero | rand
    # which detected objects a word's overlap vector takes (data/geometry.py):
    # "resize", those whose box strictly contains the word box rescaled by
    # its mask area; a number, those whose IoU + 1 reaches it
    semantic_assignment: str = "resize"   # resize | 0.25 | 0.50 | 0.75
    semantic_embedding: str = "linear"    # linear | bert
    num_obj_classes: int = 2000
    max_overlap_objs: int = 15
    max_scene_objs: int = 52
    # fusion hooks: relevance-weighted semantics fused into the encoder's
    # input, the decoder's memory, its step-0 input (the semantic CLS
    # vector, the cls0 row of the fused decode and beam kernels) and its
    # logits (greedy only); and the three per-layer decoder sites
    # (multihead_*: an attention over the relevance-weighted semantics
    # before the self-attention, between it and the cross-attention, after
    # the cross-attention), which the kernels do not carry: with a site on,
    # greedy decoding and beam search run the stepper.  All serve and train.
    pre_encoder_mlp: bool = False
    pre_decoder_mlp: bool = False
    cls_decoder_init: bool = False
    post_decoder_mlp: bool = False
    multihead_pre_target: bool = False
    multihead_pre_memory: bool = False
    multihead_post_memory: bool = False
    # greedy decode and beam search stop once every row (every beam of a
    # row) has emitted [s]; [s]-pruned strings and beam scores are those of
    # the full-length loop.  decode_fused runs the greedy loop as the fused
    # decode kernel; without it (the JAX default) greedy decoding runs the
    # single-position stepper, as beam search does without decode_beam_fused.
    decode_early_stop: bool = False
    decode_fused: bool = False
    # run beam search as the fused beam kernel (ops/fused_beam.py) instead
    # of the stepper's ancestry scan
    decode_beam_fused: bool = False
    # int8 serving (ops/int8.py, models/resnet_int8.py): the fused greedy
    # decode's six projections as int8 x int8 -> int32 products (K1q), and
    # in eval mode the encoder's attention projections and FF matmuls;
    # training stays float.  ``tps_int8`` quantizes the loc-net convs and
    # acts only in a Recognizer built with ``int8_backbone=True``.
    decode_int8: bool = False
    encoder_int8: bool = False
    tps_int8: bool = False
    max_text_length: int = 25
    chars: str = DEFAULT_CHARS
    # "attn": [GO]/[s]/[PAD] + chars (the attention decoders); "ctc": blank
    # + chars (CTCCodec, with decoder="linear" and TrainConfig(loss="ctc"))
    label_codec: str = "attn"
    compute_dtype: str = "bfloat16"
    # dropout of the encoder and decoder in train mode
    dropout: float = 0.1
    # recompute the backbone's forward in the backward pass (torch
    # checkpointing) instead of keeping its activations: less memory a
    # train step for more work; the running statistics move once a step
    remat: bool = False
    # the default of the train-mode BatchNorm backward reduction on CUDA
    # tensors: the CUDA kernel (ops/batchnorm.py), or with False its plain
    # version; SceneTextModel.set_use_kernels switches it at run time
    fused_bn: bool = True

    @property
    def num_classes(self) -> int:
        if self.label_codec == "ctc":
            return 1 + len(self.chars)  # [CTCblank] + charset
        return 3 + len(self.chars)  # [GO], [s], [PAD] + charset

    @property
    def num_cols(self) -> int:
        # encoder column count: backbone width for a 100-wide crop
        return self.img_w // 4 + 1


@dataclass(frozen=True)
class TrainConfig:
    """Optimisation and loop settings the train step and the training loop
    read (train/state.py, train/steps.py, train/loop.py)."""

    batch_size: int = 192
    epochs: int = 8
    lr: float = 1e-4
    weight_decay: float = 0.01
    grad_clip_norm: float = 2.0
    # StepLR: lr * lr_gamma ** (steps after warmup // lr_step_size); None = constant
    lr_step_size: Optional[int] = None
    lr_gamma: float = 0.1
    # linear warmup from 0 over this many steps (0 = none)
    warmup_steps: int = 0
    seed: int = 999
    # validate every this many steps; stop after iteration_limit steps
    validation_steps: int = 2000
    iteration_limit: Optional[int] = None
    # a validation accuracy (%) must beat this (then the best so far) to save
    model_save_threshold: float = 0.0
    # "ce": cross-entropy over the decoder's steps; "ctc": the CTC loss over
    # per-column logits (decoder="linear", label_codec="ctc")
    loss: str = "ce"
    # the loss ignores [GO] targets and counts [PAD] ones; False masks [PAD] too
    loss_counts_pad: bool = True
    label_smoothing: float = 0.0
    # keep the packed uint8 training set on the device when it is at most
    # device_data_max_mb, and gather each batch there by index
    device_data: bool = True
    device_data_max_mb: int = 4096
    # the JAX loop runs this many device-data steps in one jitted call; the
    # port takes the same steps one by one (train/loop.py)
    steps_per_call: int = 8


_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
# The committed synthetic sets (scripts/render_synthetic_set.py).
SYNTHETIC_DIR: str = os.path.join(_ASSETS, "synthetic")


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection and locations: the real corpora's files (COCO-Text,
    TextOCR, the MJSynth/SynthText LMDBs; none is in the repository) and
    the synthetic sets' sizes and directory."""

    dataset: str = "synthetic"  # cocotext | textocr | synth | synthetic
    cocotext_api_path: str = "./annotations/COCO_Text_2014.json"
    cocotext_image_path: str = "./data/coco/train2014/"
    cocotext_object_tags_path: str = "./annotations/features/coco_object_tags.json"
    textocr_anno_path: str = "./data/textocr/"
    textocr_image_path: str = "./data/textocr/"
    textocr_object_tags_path: str = "./annotations/features/open_images_vinvl_features.json"
    deep_text_dataset_path: str = "./data/deep_text_datasets/"
    # batch-balanced sampling of data.dataset=synth: "MJ,ST" ratios as two
    # comma floats, e.g. "0.5,0.5" (data/lmdb_data.BalancedMixture); empty:
    # the two corpora concatenated
    mixture_ratios: str = ""
    # keep-ratio resize with the border column padded right, instead of a
    # squash resize (data/lmdb_data.keep_ratio_resize)
    keep_ratio: bool = False
    synthetic_train_size: int = 4096
    synthetic_val_size: int = 512
    # JAX renders a closed vocabulary of this many seeded words where > 0;
    # every committed set is open vocabulary, so the port serves only 0
    synthetic_vocab_size: int = 0
    # a directory of sets under the renderer's cache names (in JAX, its
    # cache of rendered sets); empty: the committed sets, SYNTHETIC_DIR
    synthetic_cache_dir: str = ""
    # the detectors' class-id -> label lists (eval.evaluate.load_class_labels)
    class_labels_dir: str = os.path.join(_ASSETS, "features")


@dataclass(frozen=True)
class ParallelConfig:
    """The (data, model) mesh layout: the batch split over ``data_axis``
    ranks, the large matrices (Megatron columns and rows) over
    ``model_axis`` ranks, the JAX package's ``ParallelConfig``, parsed as
    its are.  Nothing that takes a whole ``Config`` builds a mesh: the
    command line, ``train/loop.train`` and ``api`` run one process's step,
    as the JAX package's do, and refuse any other layout
    (:func:`check_single_process`) rather than ignore it.  A mesh is built
    with ``parallel.mesh.make_mesh`` for ``shard_train_step`` and the
    sharded decodes."""

    data_axis: int = -1   # -1: every rank the model axis leaves
    model_axis: int = 1   # 1: no tensor parallelism
    # JAX's field, read by neither package (ModelConfig.remat is the switch):
    # refused as set
    remat: bool = False


@dataclass(frozen=True)
class Config:
    experiment: str = "tpu_rebuild"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    results_dir: str = "./results"
    # the checkpoint the command line starts from: a reference ``.pth``/``.pt``
    # or a directory of train/checkpoint.save_checkpoint
    saved_model: Optional[str] = None


def _coerce(current: Any, raw: str) -> Any:
    """``raw`` as the type of the field's current value; a field that is
    None takes None, an int, a float or the string, in that order."""
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if current is None:
        if raw.lower() in ("none", "null"):
            return None
        try:
            return int(raw)
        except ValueError:
            try:
                return float(raw)
            except ValueError:
                return raw
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    return raw


def check_single_process(cfg: Config) -> None:
    """Raise ValueError where ``cfg.parallel`` is not the default layout:
    what takes a whole ``Config`` runs one process's step (see
    :class:`ParallelConfig`), so a mesh asked for there would be ignored."""
    if cfg.parallel != ParallelConfig():
        raise ValueError(f"{cfg.parallel}: the command line, train/loop.train and api run "
                         "one process's step; build the mesh with parallel.mesh.make_mesh for "
                         "train.steps.shard_train_step and the sharded decodes (remat: "
                         "model.remat)")


def apply_overrides(cfg: Config, overrides: Union[Dict[str, Any], List[str]]) -> Config:
    """``cfg`` with dotted-path overrides applied, e.g. ``model.encoder=lstm``
    (a list of ``key=value`` items, or a dict whose string values are
    coerced and others taken as they are).  An item without ``=`` raises
    ValueError, an unknown field AttributeError."""
    if isinstance(overrides, list):
        pairs = {}
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"override must be key=value, got {item!r}")
            k, v = item.split("=", 1)
            pairs[k.strip()] = v.strip()
        overrides = pairs
    for path, raw in overrides.items():
        parts = path.split(".")
        objs = [cfg]
        for p in parts[:-1]:
            objs.append(getattr(objs[-1], p))
        current = getattr(objs[-1], parts[-1])
        updated = dataclasses.replace(
            objs[-1], **{parts[-1]: _coerce(current, raw) if isinstance(raw, str) else raw})
        for obj, name in zip(reversed(objs[:-1]), reversed(parts[:-1])):
            updated = dataclasses.replace(obj, **{name: updated})
        cfg = updated
    return cfg


# The flagship that serving runs: bf16 compute, whole-loop fused decode.
FLAGSHIP = ModelConfig(decode_fused=True)
