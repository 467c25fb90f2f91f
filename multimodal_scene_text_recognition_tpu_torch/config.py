"""Model and training configuration: the fields of the JAX package's
``ModelConfig`` and ``TrainConfig`` that the serving paths (greedy and beam)
and the train step read, with the same defaults (JAX counterpart:
core/config.py)."""

from __future__ import annotations

import string
from dataclasses import dataclass
from typing import Optional

# 94 printable characters: string.printable minus the 6 trailing whitespace
# controls.
DEFAULT_CHARS: str = string.printable[:-6]


@dataclass(frozen=True)
class ModelConfig:
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
    num_obj_classes: int = 2000
    max_overlap_objs: int = 15
    # greedy decode and beam search stop once every row (every beam of a
    # row) has emitted [s]; [s]-pruned strings and beam scores are those of
    # the full-length loop.  The greedy loop runs only as the fused decode
    # kernel (decode_fused=True); the scan stepper serves beam search alone.
    decode_early_stop: bool = False
    decode_fused: bool = False
    # run beam search as the fused beam kernel (ops/fused_beam.py) instead
    # of the stepper's ancestry scan
    decode_beam_fused: bool = False
    # the semantic CLS step-0 input of the decoder is not ported;
    # SceneTextModel refuses True
    cls_decoder_init: bool = False
    max_text_length: int = 25
    chars: str = DEFAULT_CHARS
    compute_dtype: str = "bfloat16"
    # dropout of the encoder and decoder in train mode
    dropout: float = 0.1
    # the default of the train-mode BatchNorm backward reduction on CUDA
    # tensors: the CUDA kernel (ops/batchnorm.py), or with False its plain
    # version; SceneTextModel.set_use_kernels switches it at run time
    fused_bn: bool = True

    @property
    def num_classes(self) -> int:
        # [GO], [s], [PAD] + charset
        return 3 + len(self.chars)

    @property
    def num_cols(self) -> int:
        # encoder column count: backbone width for a 100-wide crop
        return self.img_w // 4 + 1


@dataclass(frozen=True)
class TrainConfig:
    """Optimisation settings the train step reads (train/state.py,
    train/steps.py)."""

    batch_size: int = 192
    lr: float = 1e-4
    weight_decay: float = 0.01
    grad_clip_norm: float = 2.0
    # StepLR: lr * lr_gamma ** (steps after warmup // lr_step_size); None = constant
    lr_step_size: Optional[int] = None
    lr_gamma: float = 0.1
    # linear warmup from 0 over this many steps (0 = none)
    warmup_steps: int = 0
    seed: int = 999
    # the loss ignores [GO] targets and counts [PAD] ones; False masks [PAD] too
    loss_counts_pad: bool = True
    label_smoothing: float = 0.0


# The flagship that serving runs: bf16 compute, whole-loop fused decode.
FLAGSHIP = ModelConfig(decode_fused=True)
